"""Hand-written Hopper kernels, each beside its plain PyTorch version.

| wrapper | kernel | replaces (TPU) |
| --- | --- | --- |
| :func:`ancestral_update` | Triton | ``meshdiffusion_tpu/ops/sampler_step.py:52`` |
| :func:`gn_affine` | CUDA C++, sm_90a (gn_stats, one launch) | statistics phase of ``ops/groupnorm.py:94`` |
| :func:`groupnorm_silu` | Triton (apply) | ``meshdiffusion_tpu/ops/groupnorm.py:94`` |
| :func:`gn_silu_conv3d` | CUDA C++, sm_90a (wgmma) | ``meshdiffusion_tpu/ops/gn_silu_conv.py:142`` |
| :func:`gn_silu_conv3d_halo` | the same kernel, depth-halo mode | the same, on a depth slab |
| :func:`gn_moments` | the gn_stats kernel, moments mode | the statistics, on a depth slab |
| :func:`tile_zmin` | CUDA C++, sm_90a (every depth layer in one launch) | ``meshdiffusion_tpu/ops/tile_raster.py:126`` |
| :func:`nin_residual` | CUDA C++, sm_90a (wgmma) | none: the plain NIN shortcut + residual sum of ``meshdiffusion_tpu/models/layers.py:275-276`` |
| :func:`dit_attention` | CUDA C++, sm_90a (TMA producer warp, wgmma consumer warpgroups in turns, online softmax; dh 72 and 128) | none: the DiT's and FLUX's multi-head attention (``models/dit3d.py``, ``models/flux3d.py``); the JAX package has no transformer |
| :func:`qk_norm_rope` | CUDA C++, sm_90a (one row a block, a head's RMS by shuffles) | none: FLUX's QK RMSNorm and 3-axis RoPE into the joint sequence (``models/flux3d.py``) |
| :func:`moe_experts` | CUDA C++, sm_90a (wgmma, grouped over the experts; two launches) | none: the routed experts of the sparse-expert DiT (``models/moe.py``) |

Every wrapper takes its route (its plain version, its kernel, or its
kernel forward with the plain version's backward) by the one rule written
in ``ops/_build.py``, where :func:`._build.kernel_wrapper` declares it;
within :func:`plain` every wrapper runs its plain version.
``<wrapper>.launches`` counts kernel launches
(``gn_silu_conv3d.descriptor_launches`` and ``gn_silu_conv3d_halo``'s the
launches of those whose A operand took the descriptor route), and each call,
on any route, is an ``ops.<wrapper>`` span (``utils/trace.py``).
Each kernel module also has a ``*_cost`` helper, the (FLOP, bytes) of a
call, from which ``roofline.bound_ms`` gives the least time an H100 could
take for it (the z-test's counts fp32 and ALU operations apart, and
``tile_zmin_bound_ms`` takes the busier pipe).
"""

from ._build import KERNEL_WRAPPERS, plain  # noqa: F401
from .dit_attention import (dit_attention, dit_attention_cost,  # noqa: F401
                            dit_attention_kv_bytes, dit_attention_reference)
from .gn_silu_conv import (conv3d_depth_valid, conv3d_same, gn_silu_conv3d,  # noqa: F401
                           gn_silu_conv3d_cost, gn_silu_conv3d_halo,
                           gn_silu_conv3d_halo_reference, gn_silu_conv3d_reference,
                           pack_conv_weights)
from .groupnorm import (affine_from_moments, gn_affine, gn_affine_cost,  # noqa: F401
                        gn_affine_reference, gn_moments, gn_moments_cost,
                        gn_moments_reference, groupnorm_reference, groupnorm_silu,
                        groupnorm_silu_cost, groupnorm_silu_reference, merge_moments)
from .moe_experts import (moe_experts, moe_experts_cost, moe_experts_reference,  # noqa: F401
                          pack_gate_up, unpack_gate_up)
from .nin_residual import (nin_reference, nin_residual, nin_residual_cost,  # noqa: F401
                           nin_residual_reference)
from .qk_norm_rope import (qk_norm_rope, qk_norm_rope_cost,  # noqa: F401
                           qk_norm_rope_reference)
from .sampler_step import (ancestral_update, ancestral_update_cost,  # noqa: F401
                           ancestral_update_reference)
from .tile_zmin import (tile_zmin, tile_zmin_bound_ms, tile_zmin_cost,  # noqa: F401
                        tile_zmin_reference)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    gn_silu_conv3d.descriptor_launches = gn_silu_conv3d_halo.descriptor_launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
