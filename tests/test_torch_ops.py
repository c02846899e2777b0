"""The port's kernel modules (meshdiffusion_tpu_torch.ops) against the JAX
package: each plain PyTorch version against its JAX oracle and against the
Pallas kernel in interpret mode, on the CPU in float32. The hand-written
kernels themselves run only on a CUDA card: tests/test_torch_kernels.py
holds them against these plain versions there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.ops import (ancestral_update as pallas_ancestral_update,
                                   ancestral_update_reference as jax_ancestral_reference,
                                   fused_groupnorm_silu as pallas_groupnorm_silu,
                                   groupnorm_silu_reference as jax_groupnorm_silu)
from meshdiffusion_tpu.ops.gn_silu_conv import (_gn_affine as jax_gn_affine,
                                                gn_silu_conv3d_pallas,
                                                gn_silu_conv3d_reference as jax_gsc_reference)
from meshdiffusion_tpu_torch import ops
from meshdiffusion_tpu_torch.ops.gn_silu_conv import _plan

pytest_plugins = ('torch_rules',)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- K1: ancestral_update (tolerance rtol 1e-6, atol 1e-6) ----

def _ancestral_inputs(rng, shape=(2, 8, 8, 8, 4)):
    x, e, n = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    mask = (rng.random((1,) + shape[1:4] + (1,)) > 0.3).astype(np.float32)
    return x, e, mask, n, np.float32(0.0123), np.float32(0.87)


def test_ancestral_update_plain_matches_jax(rng):
    x, e, mask, n, beta, std = _ancestral_inputs(rng)
    px, pm = ops.ancestral_update(_t(x), _t(e), _t(mask), _t(n), beta, std)
    args = [jnp.asarray(a) for a in (x, e, mask, n, beta, std)]
    for jx, jm in (jax_ancestral_reference(*args),
                   pallas_ancestral_update(*args, interpret=True)):
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(px.numpy() * (1 - mask), 0.0)


# ---- K2: gn_stats + groupnorm_silu (tolerance rtol 1e-5, atol 1e-5) ----

@pytest.mark.parametrize('shape,groups,block', [
    ((2, 6, 6, 6, 64), 32, 64),
    ((1, 5, 5, 3, 32), 8, 32),      # 75 rows: a ragged last block in the Pallas grid
])
def test_groupnorm_silu_plain_matches_jax(rng, shape, groups, block):
    C = shape[-1]
    x = rng.normal(size=shape).astype(np.float32) * 2 + 0.5
    scale = rng.normal(size=(C,)).astype(np.float32)
    bias = rng.normal(size=(C,)).astype(np.float32)
    got = ops.groupnorm_silu(_t(x), _t(scale), _t(bias), num_groups=groups).numpy()
    for want in (jax_groupnorm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                    num_groups=groups),
                 pallas_groupnorm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                       num_groups=groups, block=block, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_gn_affine_plain_matches_jax(rng):
    x = rng.normal(size=(2, 4, 5, 6, 96)).astype(np.float32) + 1.0
    scale = rng.normal(size=(96,)).astype(np.float32)
    bias = rng.normal(size=(96,)).astype(np.float32)
    a, b = ops.gn_affine(_t(x), _t(scale), _t(bias))
    ja, jb = jax_gn_affine(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)
    # the fold is GroupNorm: x*a + b == groupnorm_reference(x)
    folded = _t(x) * a[:, None, None, None] + b[:, None, None, None]
    np.testing.assert_allclose(folded.numpy(),
                               ops.groupnorm_reference(_t(x), _t(scale), _t(bias)).numpy(),
                               rtol=1e-5, atol=1e-5)


# ---- K3: gn_silu_conv3d (tolerance rtol 2e-4, atol 2e-5) ----

def _gsc_inputs(rng, B, D, H, W, C, O):
    x = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    sc = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bi = (0.1 * rng.standard_normal(C)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, C, O)) * 0.05).astype(np.float32)
    cb = (0.1 * rng.standard_normal(O)).astype(np.float32)
    return x, sc, bi, k, cb


@pytest.mark.parametrize('shape', [
    (1, 6, 8, 8, 128, 64),    # the shapes of tests/test_gn_silu_conv.py
    (2, 4, 8, 16, 128, 128),
    (1, 3, 8, 8, 256, 32),
])
def test_gn_silu_conv3d_plain_matches_jax(rng, shape):
    args = _gsc_inputs(rng, *shape)
    got = ops.gn_silu_conv3d(*map(_t, args), dtype=torch.float32).numpy()
    jargs = [jnp.asarray(a) for a in args]
    for want in (jax_gsc_reference(*jargs, dtype=jnp.float32),
                 gn_silu_conv3d_pallas(*jargs, dtype=jnp.float32, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize('shape', [
    (1, 64, 64, 64, 128, 128), (1, 64, 64, 64, 256, 128), (1, 32, 32, 32, 384, 128),
    (1, 16, 16, 16, 768, 256), (1, 8, 8, 8, 1024, 512), (1, 4, 4, 4, 512, 512),
    (1, 4, 4, 4, 1024, 512), (2, 5, 6, 7, 64, 32), (4, 64, 64, 64, 128, 128)])
def test_conv_launch_plan(shape):
    """The output tile holds at most its tiling's voxels within the volume,
    shared memory fits, and the split covers every k-step (27 taps x
    64-channel chunks) with none empty."""
    from meshdiffusion_tpu_torch.ops.gn_silu_conv import _TILINGS, SMEM_LIMIT
    B, D, H, W, C, O = shape
    p = _plan(*shape)
    assert p.TD * p.TH * p.TW <= _TILINGS[p.tiling][0] and p.smem <= SMEM_LIMIT
    assert p.TD <= D and p.TH <= H and p.TW <= W
    assert p.KS == 27 * -(-C // 64)
    assert 1 <= p.splits <= p.KS and p.splits * p.per >= p.KS and (p.splits - 1) * p.per < p.KS


def test_wrappers_route_by_device(rng):
    """CPU tensors run the plain version and launch nothing; tensors on
    another device or on mixed devices raise rather than fall back."""
    ops.reset_launch_counts()
    x, sc, bi, k, cb = map(_t, _gsc_inputs(rng, 1, 2, 4, 4, 32, 8))
    ops.gn_silu_conv3d(x, sc, bi, k, cb)
    ops.groupnorm_silu(x, sc, bi)
    w, h = torch.ones(32, 8), torch.ones(1, 2, 4, 4, 8)
    ops.nin_residual(x, w, cb, h)
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    with pytest.raises(RuntimeError):
        ops.gn_silu_conv3d(x.to('meta'), sc, bi, k, cb)
    with pytest.raises(RuntimeError):
        ops.groupnorm_silu(x.to('meta'), sc, bi)
    with pytest.raises(RuntimeError):
        ops.nin_residual(x.to('meta'), w, cb, h)


# ---- the NIN shortcut + residual sum (ops.nin_residual): bit for bit NIN(x) + h ----

@pytest.mark.parametrize('case,K,N,x_dtype', [
    ('op', 256, 128, torch.float32), ('op', 256, 128, torch.bfloat16),
    ('op', 384, 128, torch.float32), ('op', 384, 128, torch.bfloat16),
    ('op', 768, 256, torch.float32), ('op', 768, 256, torch.bfloat16),
    ('op', 1024, 512, torch.float32), ('op', 1024, 512, torch.bfloat16),
    ('block', 256, 128, torch.float32), ('block', 128, 256, torch.bfloat16),
    ('block_under_autograd', 256, 128, torch.float32)])
def test_nin_residual_plain_is_nin_plus_h(rng, monkeypatch, case, K, N, x_dtype):
    """On CPU tensors ``ops.nin_residual`` is the composition it replaces,
    ``NIN_0(x) + h``, bit for bit, at the main path's widths; a res64-width
    ResnetBlock with a shortcut calls the wrapper once, with no gradient and
    under autograd, and returns that composition of its own h, under
    autograd with the NIN weight's gradient."""
    from meshdiffusion_tpu_torch.models.layers import NIN, ResnetBlockDDPM
    x = _t(rng.normal(size=(2, 4, 4, 4, K)).astype(np.float32)).to(x_dtype)
    if case == 'op':
        nin = NIN(K, N, dtype=torch.bfloat16)
        nin.reset_parameters_ddpm()
        with torch.no_grad():
            nin.b.uniform_(-0.1, 0.1)
            h = _t(rng.normal(size=(2, 4, 4, 4, N)).astype(np.float32)).to(torch.bfloat16)
            got = ops.nin_residual(x, nin.cast_weight(), nin.b, h)
            assert got.dtype == torch.float32 and torch.equal(got, nin(x) + h)
        return
    torch.manual_seed(0)
    block = ResnetBlockDDPM(K, N, temb_dim=64, dtype=torch.bfloat16, dropout=0.0)
    block.NIN_0.reset_parameters_ddpm()
    temb = torch.randn(2, 64)
    seen = []

    def rec(x, W, b, h, dtype, real=ops.nin_residual):
        seen.append(h)
        return real(x, W, b, h, dtype)
    monkeypatch.setattr(ops, 'nin_residual', rec)
    grad = case == 'block_under_autograd'
    with torch.set_grad_enabled(grad):
        y = block(x, temb)
        assert len(seen) == 1 and y.dtype == torch.float32 and torch.isfinite(y).all()
        assert torch.equal(y, block.NIN_0(x) + seen[0]) and y.requires_grad == grad
    if grad:
        y.sum().backward()
        assert block.NIN_0.W.grad is not None and block.NIN_0.W.grad.abs().sum() > 0


# ---- the route rule (ops/_build.py): every wrapper under autograd ----

def _wrapper_args(name, g):
    """Tiny arguments of each kernel wrapper, its float tensors random."""
    r = lambda *shape: torch.randn(shape, generator=g)
    if name == 'ancestral_update':
        mask = (torch.rand((1, 4, 4, 4, 1), generator=g) > 0.3).float()
        return r(2, 4, 4, 4, 3), r(2, 4, 4, 4, 3), mask, r(2, 4, 4, 4, 3), 0.0123, 0.87
    if name in ('gn_affine', 'groupnorm_silu'):
        return r(2, 2, 3, 4, 64), 1 + 0.1 * r(64), 0.1 * r(64)
    if name == 'gn_moments':
        return r(2, 2, 3, 4, 64), 32
    if name == 'gn_silu_conv3d':
        return (r(2, 2, 3, 4, 32), 1 + 0.1 * r(32), 0.1 * r(32), 0.05 * r(3, 3, 3, 32, 8),
                0.1 * r(8), 32, 1e-6, torch.float32)
    if name == 'gn_silu_conv3d_halo':
        return (r(1, 4, 3, 4, 32), r(1, 32), r(1, 32), 0.05 * r(3, 3, 3, 32, 8), 0.1 * r(8),
                (1, 1), torch.float32)
    if name == 'nin_residual':
        return r(2, 3, 4, 64), r(64, 128), r(128), r(2, 3, 4, 128)
    if name == 'dit_attention':
        return r(2, 5, 3 * 2 * 8), 2
    if name == 'moe_experts':
        from meshdiffusion_tpu_torch.models.moe import route
        p, _, order, offsets = route(r(5, 3), 2)
        return r(5, 8), r(3, 2 * 4, 8), r(3, 8, 4), order, offsets, p.reshape(-1), 2
    if name == 'qk_norm_rope':
        ang = 6.3 * torch.rand((3 + 4, 4), generator=g)
        pe = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
        return (r(2, 3, 3 * 2 * 8), 1 + 0.1 * r(8), 1 + 0.1 * r(8), pe, 2, r(2, 4, 3 * 2 * 8),
                1 + 0.1 * r(8), 1 + 0.1 * r(8))
    assert name == 'tile_zmin', name
    coords = torch.tensor([[[2., 2., .1, 30., 4., .2, 5., 28., .3],
                            [0., 0., .5, 32., 0., .4, 0., 32., .6]]])
    return (coords, torch.tensor([[0, 1, -1, -1]], dtype=torch.int32),
            torch.tensor([2], dtype=torch.int32), torch.tensor([[1]], dtype=torch.int32),
            torch.tensor([0], dtype=torch.int32), (32, 32))


@pytest.mark.parametrize('fn', ops.KERNEL_WRAPPERS, ids=lambda fn: fn.__name__)
def test_wrapper_under_autograd_is_its_plain_version(fn):
    """Under autograd every wrapper gives its plain version's outputs and
    input gradients, through the backward it declares: the conv's two modes
    the plain version's recomputed (PlainBackward), gn_moments its own exact
    one, every other wrapper the plain version itself."""
    reference = getattr(ops, fn.__name__ + '_reference')
    args = _wrapper_args(fn.__name__, torch.Generator().manual_seed(0))
    n0 = ops.launch_counts()
    got = []
    for op in (fn, reference):
        leaves = [a.clone().requires_grad_(True) if torch.is_tensor(a) and a.is_floating_point()
                  else a for a in args]
        outs = op(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        g = torch.Generator().manual_seed(1)
        loss = sum((o * torch.randn(o.shape, generator=g)).sum() for o in outs if o.requires_grad)
        wrt = [t for t in leaves if torch.is_tensor(t) and t.requires_grad]
        got.append((outs, torch.autograd.grad(loss, wrt), outs[0].grad_fn))
    (y1, g1, node), (y2, g2, _) = got
    declared = {'gn_silu_conv3d': 'PlainBackwardBackward',
                'gn_silu_conv3d_halo': 'PlainBackwardBackward',
                'gn_moments': '_GnMomentsBackward'}.get(fn.__name__)
    if declared:
        assert type(node).__name__ == declared
    for a, b in zip(y1, y2):
        assert torch.equal(a, b)
    assert len(g1) == len(g2) > 0
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert ops.launch_counts() == n0
