"""The port's FLUX MMDiT (``models/flux3d.py``) on the CPU at a tiny size: R
16 in 4^3 patches (64 img tokens), width 64, 2 heads of 32, ``axes_dim``
(8, 12, 12), 1 double-stream and 2 single-stream blocks, 8 txt tokens of
16 features, a pooled vector of 8.

The model is held to the benchmark's plain reference
(``portbench/reference/flux.py``, written from FLUX's published equations
in plain fp32 torch, one head at a time) on the reference's seeded weights:
in fp32 at a relative L2 of 1e-5 (the same arithmetic in another order:
~2e-7 measured), and in bf16 against the fp32 reference at 2e-2 (every
Linear's operands and results rounded to bf16, 2^-9 each, over 3 blocks:
~5e-3 measured). Then the plain versions of ``ops.qk_norm_rope`` (both
modes) and of ``ops.dit_attention`` at head dimension 128 against cases
written out by hand at odd T, the rotation table against FLUX's angles,
the parameter counts of the cut and of the published depths, the
condition's path through ``evaler.uncond_gen``, the spans of a profiled
forward, and a checkpoint written as the trainer writes it and loaded back
for generation.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from meshdiffusion_tpu_torch import ops
from meshdiffusion_tpu_torch.config import get_config
from meshdiffusion_tpu_torch.models import create_model, get_model
from meshdiffusion_tpu_torch.models import flux3d
from meshdiffusion_tpu_torch.utils import trace
from portbench.reference import flux as ref_flux

pytest_plugins = ('torch_rules',)

R, D, HEADS, AXES, DOUBLE, SINGLE = 16, 64, 2, (8, 12, 12), 1, 2
CTX, CTX_LEN, VEC = 16, 8, 8


def tiny_config(dtype='float32', num_scales=1000, beta_max=20.0):
    cfg = get_config('flux3d_dev_res64')
    cfg.data.image_size = R
    m = cfg.model
    m.hidden_size, m.num_heads, m.axes_dim = D, HEADS, AXES
    m.depth, m.depth_single_blocks = DOUBLE, SINGLE
    m.context_in_dim, m.context_len, m.vec_in_dim = CTX, CTX_LEN, VEC
    m.num_scales, m.beta_max = num_scales, beta_max
    cfg.gpu.compute_dtype = dtype
    return cfg


def tiny_model(dtype='float32', seed=123, **kw):
    """(model, the reference's architecture, its weights) with the
    reference's seeded weights loaded."""
    cfg = tiny_config(dtype, **kw)
    model = create_model(cfg, device='cpu').eval()
    a = ref_flux.arch({'model': dict(cfg.model), 'data': dict(cfg.data)})
    _, w = ref_flux.make_weights(a, seed, 'cpu')
    model.load_state_dict(w, strict=True)
    return model, a, w


def _inputs(B=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, R, R, R, 4, generator=g)
    mask = (torch.rand(R, R, R, generator=g) > 0.3).float()
    cond = dict(txt=torch.randn(B, CTX_LEN, CTX, generator=g), y=torch.randn(B, VEC, generator=g),
                guidance=torch.tensor([3.5, 1.25])[:B])
    return x, torch.tensor([3.0, 871.5])[:B], mask, cond


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_forward_matches_reference(dtype):
    model, a, w = tiny_model(dtype)
    x, labels, mask, cond = _inputs()
    with torch.no_grad():
        y = model(x, labels, mask[None, ..., None], **cond)
        ref = ref_flux.forward(w, a, x, labels, mask, cond['txt'], cond['y'], cond['guidance'])
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert _rel(y, ref) <= (1e-5 if dtype == 'float32' else 2e-2)


def test_forward_without_its_condition_raises():
    model, _, _ = tiny_model()
    x, labels, mask, cond = _inputs()
    with pytest.raises(ValueError, match='condition'):
        model(x, labels, mask[None, ..., None])
    with pytest.raises(ValueError, match='condition'):
        model(x, labels, mask[None, ..., None], txt=cond['txt'], y=cond['y'])


def _rot(t, cos, sin):
    """Each adjacent pair (2 i, 2 i + 1) of t's last axis turned by (cos_i,
    sin_i), written out pair by pair."""
    out = torch.empty_like(t)
    for i in range(t.shape[-1] // 2):
        x0, x1 = t[..., 2 * i], t[..., 2 * i + 1]
        out[..., 2 * i] = cos[..., i] * x0 - sin[..., i] * x1
        out[..., 2 * i + 1] = sin[..., i] * x0 + cos[..., i] * x1
    return out


@pytest.mark.parametrize('single', [False, True], ids=['two_sources', 'one_source'])
def test_qk_norm_rope_reference_against_cases_written_out(single):
    """The plain version at odd T (3 + 5 tokens, 3 heads of 8): each
    source's q and k over its RMS with its own scales, each pair turned by
    its row of pe, v copied; one source read from the first 3 D of a wider
    row (linear1's 7 D)."""
    B, T1, T2, H, dh = 2, 3, 5, 3, 8
    Dm = H * dh
    g = torch.Generator().manual_seed(4)
    sc = [0.5 + torch.rand(dh, generator=g) for _ in range(4)]
    ang = torch.rand(T1 + T2, dh // 2, generator=g) * 6.3
    pe = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
    if single:
        x = torch.randn(B, T1 + T2, 7 * Dm, generator=g)
        y = ops.qk_norm_rope(x, sc[0], sc[1], pe, H)
        rows = [(x[:, t], sc[0], sc[1]) for t in range(T1 + T2)]
    else:
        x, x2 = torch.randn(B, T1, 3 * Dm, generator=g), torch.randn(B, T2, 3 * Dm, generator=g)
        y = ops.qk_norm_rope(x, sc[0], sc[1], pe, H, x2, sc[2], sc[3])
        rows = [(x[:, t], sc[0], sc[1]) for t in range(T1)] + \
            [(x2[:, t], sc[2], sc[3]) for t in range(T2)]
    assert y.shape == (B, T1 + T2, 3 * Dm) and ops.qk_norm_rope.launches == 0
    for t, (row, qs, ks) in enumerate(rows):
        for h in range(H):
            for part, s in ((0, qs), (1, ks)):
                v = row[:, part * Dm + h * dh:part * Dm + (h + 1) * dh]
                n = v / torch.sqrt((v * v).mean(-1, keepdim=True) + 1e-6) * s
                want = _rot(n, pe[t, :, 0], pe[t, :, 1])
                got = y[:, t, part * Dm + h * dh:part * Dm + (h + 1) * dh]
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        assert torch.equal(y[:, t, 2 * Dm:], row[:, 2 * Dm:3 * Dm])


def test_attention_reference_at_head_dimension_128():
    """``dit_attention_reference`` against each head's softmax(q k^T /
    sqrt(128)) v at T 37, no multiple of either instantiation's tiles."""
    B, T, H, dh = 2, 37, 2, 128
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(B, T, 3 * H * dh, generator=g)
    y = ops.dit_attention_reference(qkv, H)
    q, k, v = qkv.reshape(B, T, 3, H, dh).unbind(2)
    for b in range(B):
        for h in range(H):
            w = torch.softmax(q[b, :, h] @ k[b, :, h].T / np.sqrt(dh), dim=-1)
            torch.testing.assert_close(y[b, :, h * dh:(h + 1) * dh], w @ v[b, :, h],
                                       rtol=2e-4, atol=2e-5)
    assert ops.dit_attention(qkv, H).equal(y) and ops.dit_attention.launches == 0
    assert ops.dit_attention_kv_bytes(4, 4608, 24, 128) == 4 * 24 * 36 * 4608 * 512


def test_rotation_table_is_fluxs():
    """The model's table: text tokens at angle 0, image token (d, h, w)
    turning pair j of axis a by pos_a theta^(-2 j / d_a), the axes' pairs
    one after another; the reference's cos and sin the same."""
    cfg = tiny_config()
    model = create_model(cfg, device='cpu')
    pe = model.rope(CTX_LEN, torch.device('cpu'))
    n = R // 4
    assert pe.shape == (CTX_LEN + n ** 3, sum(AXES) // 2, 2)
    assert torch.equal(pe[:CTX_LEN, :, 0], torch.ones(CTX_LEN, sum(AXES) // 2))
    assert not pe[:CTX_LEN, :, 1].any()
    d, h, w = 2, 1, 3
    tok = CTX_LEN + (d * n + h) * n + w
    want = []
    for pos, width in zip((d, h, w), AXES):
        want += [pos * 10000.0 ** (-2.0 * j / width) for j in range(width // 2)]
    want = torch.tensor(want, dtype=torch.float64)
    torch.testing.assert_close(pe[tok, :, 0], torch.cos(want).float())
    torch.testing.assert_close(pe[tok, :, 1], torch.sin(want).float())
    a = ref_flux.arch({'model': dict(cfg.model), 'data': dict(cfg.data)})
    cos, sin = ref_flux.rotation(a, CTX_LEN, 'cpu')
    assert torch.equal(cos, pe[..., 0]) and torch.equal(sin, pe[..., 1])


@pytest.mark.parametrize('depths,expected', [((10, 20), 6_295_653_632),
                                             ((19, 38), 11_902_787_840)])
def test_parameter_count_and_state_dict(depths, expected):
    """The preset's cut (10 double, 20 single blocks) and the published
    depths (19, 38), built on the meta device: FLUX's names plus
    ``mask_embedder``, the reference's specs in the same order."""
    cfg = get_config('flux3d_dev_res64')
    cfg.model.depth, cfg.model.depth_single_blocks = depths
    with torch.device('meta'):
        full = get_model(cfg.model.name).from_config(cfg)
    assert sum(p.numel() for p in full.parameters()) == expected
    a = ref_flux.arch({'model': dict(cfg.model), 'data': dict(cfg.data)})
    specs = ref_flux.param_specs(a)
    assert [s[0] for s in specs] == list(full.state_dict())
    assert sum(int(np.prod(s[1])) for s in specs) == expected
    keys = set(full.state_dict())
    assert {'img_in.weight', 'txt_in.bias', 'time_in.in_layer.weight', 'vector_in.out_layer.bias',
            'guidance_in.out_layer.weight', 'double_blocks.0.img_mod.lin.weight',
            'double_blocks.0.txt_attn.qkv.bias', 'double_blocks.1.img_attn.norm.key_norm.scale',
            'double_blocks.0.txt_attn.proj.weight', 'double_blocks.0.img_mlp.2.bias',
            'single_blocks.0.linear1.weight', 'single_blocks.3.linear2.bias',
            'single_blocks.0.norm.query_norm.scale', 'single_blocks.0.modulation.lin.weight',
            'final_layer.linear.weight', 'final_layer.adaLN_modulation.1.bias',
            'mask_embedder.proj.weight'} <= keys


def test_initialisation_zeroes_the_modulation_and_output():
    """``create_model`` draws DiT's adaLN-Zero initialisation: modulations
    and the final layer zero (so the output is zero), RMSNorm scales 1, the
    other Linears non-zero."""
    model = create_model(tiny_config(), device='cpu', generator=torch.Generator().manual_seed(0))
    assert not model.double_blocks[0].img_mod.lin.weight.any()
    assert not model.single_blocks[1].modulation.lin.weight.any()
    assert not model.final_layer.linear.weight.any()
    assert torch.equal(model.single_blocks[0].norm.query_norm.scale, torch.ones(D // HEADS))
    assert model.double_blocks[0].txt_attn.qkv.weight.abs().max() > 0
    x, labels, mask, cond = _inputs()
    with torch.no_grad():
        assert not model(x, labels, mask[None, ..., None], **cond).any()


def _gen_config(tmp_path):
    cfg = tiny_config(num_scales=10, beta_max=2.0)
    cfg.eval.batch_size = 2
    cfg.eval.eval_dir = str(tmp_path)
    cfg.data.grid_mask_path = str(tmp_path / 'mask.npy')
    mask = np.ones((R, R, R), np.float32)
    mask[0] = 0
    np.save(cfg.data.grid_mask_path, mask)
    return cfg


def test_uncond_gen_passes_the_condition_at_every_step(tmp_path, monkeypatch):
    """``evaler.uncond_gen`` with the tiny FLUX through the PC sampler: the
    condition drawn from the seed at ``model.guidance`` reaches every
    forward of the chain unchanged, and one read from
    ``eval.condition_path`` likewise; a finite, masked sample."""
    from meshdiffusion_tpu_torch.diffusion import evaler
    cfg = _gen_config(tmp_path)
    seen = []
    forward = flux3d.Flux3D.forward

    def spy(self, x, labels, mask=None, train=False, **cond):
        seen.append({k: v.clone() for k, v in cond.items()})
        return forward(self, x, labels, mask, train, **cond)
    monkeypatch.setattr(flux3d.Flux3D, 'forward', spy)
    out = np.load(evaler.uncond_gen(cfg, idx='f', device='cpu'))
    assert out.shape == (2, 4, R, R, R) and np.isfinite(out).all()
    assert not out[:, :, 0].any() and out[:, :, 1:].any()
    assert len(seen) == 9 and seen[0]['txt'].shape == (2, CTX_LEN, CTX)
    assert torch.equal(seen[0]['guidance'], torch.full((2,), 3.5))
    assert all(torch.equal(s[k], seen[0][k]) for s in seen for k in s)
    _, _, _, cond = _inputs()
    cfg.eval.condition_path = str(tmp_path / 'cond.pt')
    torch.save(cond, cfg.eval.condition_path)
    seen.clear()
    evaler.uncond_gen(cfg, idx='g', device='cpu')
    assert all(torch.equal(s[k], cond[k]) for s in seen for k in s)


def test_profiled_forward_records_the_spans():
    """A profiled forward records ``flux.forward`` and ``flux.cond`` once,
    ``flux.double`` and ``flux.single`` once a block (attribute ``index``),
    each holding a ``flux.attn`` and a ``flux.mlp``, and the ``flux.attn``
    spans one ``ops.qk_norm_rope`` and one ``ops.dit_attention`` each."""
    model, _, _ = tiny_model()
    x, labels, mask, cond = _inputs()
    trace.clear()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        model(x, labels, mask[None, ..., None], **cond)
    sp = trace.spans()
    trace.clear()
    names = [s.name for s in sp]
    assert names.count('flux.forward') == 1 and names.count('flux.cond') == 1
    for kind, n in (('flux.double', DOUBLE), ('flux.single', SINGLE)):
        blocks = [i for i, s in enumerate(sp) if s.name == kind]
        assert [sp[i].attrs['index'] for i in blocks] == list(range(n))
        for i in blocks:
            assert [s.name for s in sp if s.parent == i] == ['flux.attn', 'flux.mlp']
    attn = {i for i, s in enumerate(sp) if s.name == 'flux.attn'}
    for op in ('ops.qk_norm_rope', 'ops.dit_attention'):
        assert sum(s.name == op and s.parent in attn for s in sp) == DOUBLE + SINGLE


def test_checkpoint_round_trip_loads_for_generation(tmp_path):
    """A checkpoint written as the trainer writes it (model, EMA, optimizer)
    lists FLUX's parameters in its own order and loads back through the
    generation path's loader: the EMA weights, every key of the model's."""
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
