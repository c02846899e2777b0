"""The port's 3D diffusion transformer (``models/dit3d.py``) on the CPU at a
tiny size: R 16 in 4^3 patches (64 tokens), width 48, 2 blocks of 4 heads.

The model is held to the benchmark's plain reference
(``portbench/reference/dit.py``, written from the published equations in
plain fp32 torch) on the reference's seeded non-zero weights: in fp32 at
rtol 2e-4 / atol 2e-5 (as tests/test_torch_parity.py), and in bf16 against
the fp32 reference at a relative L2 of 2e-2 (every Linear's operands and
results rounded to bf16, 2^-9 each, over 2 blocks: ~4e-3 measured). Then
the attention's plain version against per-head attention at dh 72, the
state_dict and the full width's parameter count, generation through
``evaler.uncond_gen``, a training step through ``losses.py``, the spans of
a profiled forward, and a checkpoint written as the trainer writes it and
loaded back for generation.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from meshdiffusion_tpu_torch import ops
from meshdiffusion_tpu_torch.config import get_config
from meshdiffusion_tpu_torch.models import create_model, get_model
from meshdiffusion_tpu_torch.utils import trace
from portbench.reference import dit as ref_dit

pytest_plugins = ('torch_rules',)

R, D, DEPTH, HEADS = 16, 48, 2, 4
VAL = dict(rtol=2e-4, atol=2e-5)


def tiny_config(dtype='float32', num_scales=1000, beta_max=20.0):
    cfg = get_config('dit3d_xl4_res64')
    cfg.data.image_size = R
    cfg.model.hidden_size, cfg.model.depth, cfg.model.num_heads = D, DEPTH, HEADS
    cfg.model.num_scales, cfg.model.beta_max = num_scales, beta_max
    cfg.gpu.compute_dtype = dtype
    return cfg


def tiny_model(dtype='float32', seed=123, **kw):
    """(model, the reference's architecture, its weights) with the
    reference's seeded weights loaded."""
    cfg = tiny_config(dtype, **kw)
    model = create_model(cfg, device='cpu').eval()
    a = ref_dit.arch({'model': dict(cfg.model), 'data': dict(cfg.data)})
    _, w = ref_dit.make_weights(a, seed, 'cpu')
    model.load_state_dict(w, strict=True)
    return model, a, w


def _inputs(B=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, R, R, R, 4, generator=g)
    mask = (torch.rand(R, R, R, generator=g) > 0.3).float()
    return x, torch.tensor([3.0, 871.5])[:B], mask


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_forward_matches_reference(dtype):
    model, a, w = tiny_model(dtype)
    x, labels, mask = _inputs()
    with torch.no_grad():
        y = model(x, labels, mask[None, ..., None])
        ref = ref_dit.forward(w, a, x, labels, mask)
    assert y.dtype == torch.float32 and y.shape == x.shape
    if dtype == 'float32':
        torch.testing.assert_close(y, ref, **VAL)
    else:
        assert ((y - ref).norm() / ref.norm()) <= 2e-2


def test_attention_reference_is_per_head_attention():
    """``dit_attention_reference`` against each head's softmax(q k^T /
    sqrt(72)) v, at dh 72 and T 100 (no multiple of the kernel's tiles)."""
    B, T, H, dh = 2, 100, 3, 72
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(B, T, 3 * H * dh, generator=g)
    y = ops.dit_attention_reference(qkv, H)
    q, k, v = qkv.reshape(B, T, 3, H, dh).unbind(2)
    for b in range(B):
        for h in range(H):
            w = torch.softmax(q[b, :, h] @ k[b, :, h].T / np.sqrt(dh), dim=-1)
            torch.testing.assert_close(y[b, :, h * dh:(h + 1) * dh], w @ v[b, :, h], **VAL)
    assert ops.dit_attention(qkv, H).equal(y) and ops.dit_attention.launches == 0


@pytest.mark.parametrize('B,T,H,expected', [(4, 4096, 16, 4 * 16 * 22 * 4096 * 288),
                                            (1, 50, 3, 3 * 50 * 288),
                                            (1, 193, 2, 2 * 2 * 193 * 288)])
def test_attention_kv_bytes_count_each_item_reading_its_head(B, T, H, expected):
    """The kernel's K and V traffic: each (sample, head, 192-query tile)
    reads its head's T keys and values, 2 x 72 bf16 each; 1.66 GB at the
    DiT cell's b4 call, where 128-query tiles read 2.42."""
    assert ops.dit_attention_kv_bytes(B, T, H, 72) == expected
    if T == 4096:
        assert round(expected / 1e9, 2) == 1.66


def test_state_dict_and_full_width_parameter_count():
    """DiT's names plus ``mask_embedder``, no buffer saved (the positions are
    fixed), and 674,291,200 parameters at the preset's full width, built on
    the meta device."""
    model, a, w = tiny_model()
    assert list(model.state_dict()) == list(w)
    keys = set(w)
    assert {'x_embedder.proj.weight', 'mask_embedder.proj.weight', 't_embedder.mlp.2.bias',
            'blocks.1.attn.qkv.weight', 'blocks.1.attn.proj.bias', 'blocks.0.mlp.fc1.weight',
            'blocks.0.adaLN_modulation.1.weight', 'final_layer.linear.weight',
            'final_layer.adaLN_modulation.1.bias'} <= keys
    cfg = get_config('dit3d_xl4_res64')
    with torch.device('meta'):
        full = get_model(cfg.model.name).from_config(cfg)
    assert sum(p.numel() for p in full.parameters()) == 674_291_200
    assert len(full.blocks) == 28 and full.pos_embed.shape == (4096, 1152)


def test_dit_initialisation_zeroes_the_modulation_and_output():
    """``create_model`` draws DiT's own initialisation: adaLN and the final
    layer zero (so the output is zero), the other Linears non-zero."""
    cfg = tiny_config()
    model = create_model(cfg, device='cpu', generator=torch.Generator().manual_seed(0))
    assert not model.blocks[0].adaLN_modulation[1].weight.any()
    assert not model.final_layer.linear.weight.any()
    assert model.blocks[0].attn.qkv.weight.abs().max() > 0
    x, labels, mask = _inputs()
    with torch.no_grad():
        assert not model(x, labels, mask[None, ..., None]).any()


def test_uncond_gen_runs_the_dit(tmp_path):
    """``evaler.uncond_gen`` with the tiny DiT (its own initialisation, a
    10-scale schedule) through the PC sampler: a finite, masked sample."""
    from meshdiffusion_tpu_torch.diffusion import evaler
    cfg = tiny_config(num_scales=10, beta_max=2.0)
    cfg.eval.batch_size = 2
    cfg.eval.eval_dir = str(tmp_path)
    cfg.data.grid_mask_path = str(tmp_path / 'mask.npy')
    mask = np.ones((R, R, R), np.float32)
    mask[0] = 0
    np.save(cfg.data.grid_mask_path, mask)
    out = np.load(evaler.uncond_gen(cfg, idx='d', device='cpu'))
    assert out.shape == (2, 4, R, R, R) and np.isfinite(out).all()
    assert not out[:, :, 0].any() and out[:, :, 1:].any()


def test_training_step_through_losses():
    """One step of ``losses.make_train_step`` (``train=True``: the plain
    attention, under autograd), no warm-up: a finite loss and gradient
    norm, and every parameter moved."""
    from meshdiffusion_tpu_torch.diffusion import losses
    from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
    cfg = tiny_config(num_scales=10, beta_max=2.0)
    cfg.optim.warmup = 0
    model, _, _ = tiny_model(num_scales=10, beta_max=2.0)
    model.train()
    state = losses.TrainState.create(model, cfg, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = losses.make_train_step(VPSDE(beta_min=0.1, beta_max=2.0, N=10),
                                  torch.ones(1, R, R, R, 1))
    batch = torch.randn(1, 2, R, R, R, 4, generator=torch.Generator().manual_seed(2))
    out = step(state, batch)
    assert torch.isfinite(out['loss']) and out['grad_norm'] > 0 and state.step == 1
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) == len(before)


def test_profiled_forward_records_the_spans():
    """A profiled forward records ``dit.forward`` once, ``dit.block`` once a
    block (attribute ``index``), and a ``dit.attn``, ``dit.mlp`` and
    ``ops.dit_attention`` inside each block."""
    model, _, _ = tiny_model()
    x, labels, mask = _inputs()
    trace.clear()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        model(x, labels, mask[None, ..., None])
    sp = trace.spans()
    trace.clear()
    names = [s.name for s in sp]
    assert names.count('dit.forward') == 1
    blocks = [i for i, s in enumerate(sp) if s.name == 'dit.block']
    assert [sp[i].attrs['index'] for i in blocks] == list(range(DEPTH))
    for i in blocks:
        inner = [s.name for s in sp if s.parent == i]
        assert inner == ['dit.attn', 'dit.mlp']
    attn = {i for i, s in enumerate(sp) if s.name == 'dit.attn'}
    assert sum(s.name == 'ops.dit_attention' and s.parent in attn for s in sp) == DEPTH


def test_checkpoint_round_trip_loads_for_generation(tmp_path):
    """A checkpoint written as the trainer writes it (model, EMA, optimizer)
    lists the DiT's parameters in its own order and loads back through the
    generation path's loader: the EMA weights, every key of the DiT's."""
    from meshdiffusion_tpu_torch.diffusion import losses
    from meshdiffusion_tpu_torch.utils.checkpoint import load_eval_weights, save_checkpoint
    cfg = tiny_config()
    model, _, w = tiny_model()
    state = losses.TrainState.create(model, cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for v in state.ema.shadow.values():
            v.mul_(0.5)
    path = save_checkpoint(str(tmp_path / 'c.pth'), {'model': model, 'ema': state.ema,
                                                     'optimizer': state.optimizer, 'step': 7},
                           cfg)
    raw = torch.load(path, weights_only=True)
    assert [k[len('module.'):] for k in raw['model']] == list(w)
    fresh = create_model(cfg, device='cpu')
    assert load_eval_weights(path, fresh, cfg) == 7
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, w[k] * 0.5, rtol=0, atol=0)
