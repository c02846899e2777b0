"""The port's sparse-expert DiT (``models/dit3d.py`` with ``models/moe.py``,
DiT-MoE's block) on the CPU at a tiny size: R 16 in 4^3 patches (64
tokens), width 48, 2 blocks of 4 heads, 4 experts of width 96, the top 2 a
token, a shared expert of width 96.

The model is held to the benchmark's plain reference
(``portbench/reference/dit_moe.py``, plain fp32 torch from the published
equations) on the reference's seeded non-zero weights, with the reference
choosing its own experts (free) and following the program's (forced): in
fp32 at rtol 2e-4 / atol 2e-5 (as tests/test_torch_dit.py), and in bf16
against the fp32 reference at a relative L2 of 2e-2 (every product's
operands rounded to bf16, 2^-9 each, over 2 blocks: ~4e-3 measured). Then
a planted skew (every token to the same experts, the others with no row),
the routing and the experts' plain version, the state_dict and the full
width's parameter count, generation through ``evaler.uncond_gen``, the
spans of a profiled forward, and a checkpoint written as the trainer writes
it and loaded back.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from meshdiffusion_tpu_torch import ops
from meshdiffusion_tpu_torch.config import get_config
from meshdiffusion_tpu_torch.models import create_model, get_model
from meshdiffusion_tpu_torch.models.moe import SparseMoeBlock, route
from meshdiffusion_tpu_torch.utils import trace
from portbench.reference import dit_moe as ref_moe

pytest_plugins = ('torch_rules',)

R, D, DEPTH, HEADS, E, K, FE, FS = 16, 48, 2, 4, 4, 2, 96, 96
VAL = dict(rtol=2e-4, atol=2e-5)


def tiny_config(dtype='float32', num_scales=1000, beta_max=20.0):
    cfg = get_config('dit3d_moe_xl4_res64')
    cfg.data.image_size = R
    m = cfg.model
    m.hidden_size, m.depth, m.num_heads = D, DEPTH, HEADS
    m.num_experts, m.experts_per_token, m.expert_hidden, m.shared_expert_hidden = E, K, FE, FS
    m.num_scales, m.beta_max = num_scales, beta_max
    cfg.gpu.compute_dtype = dtype
    return cfg


def tiny_model(dtype='float32', seed=123, **kw):
    """(model, the reference's architecture, its weights) with the
    reference's seeded weights loaded."""
    cfg = tiny_config(dtype, **kw)
    model = create_model(cfg, device='cpu').eval()
    a = ref_moe.arch({'model': dict(cfg.model), 'data': dict(cfg.data)})
    _, w = ref_moe.make_weights(a, seed, 'cpu')
    model.load_state_dict(w, strict=True)
    return model, a, w


def _inputs(B=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, R, R, R, 4, generator=g)
    mask = (torch.rand(R, R, R, generator=g) > 0.3).float()
    return x, torch.tensor([3.0, 871.5])[:B], mask


def _as_sets(top):
    return top.sort(dim=1).values


@pytest.mark.parametrize('routing', ['free', 'forced'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_forward_matches_reference(dtype, routing):
    """The program against the reference choosing its own experts (free)
    and following the program's captured ones (forced). In fp32 the
    program's top-2 sets are the reference's own at every token and block;
    in bf16 they may differ at a near-tie alone (a gap under 0.05 between the
    reference's 2nd and 3rd probability, the cell's ``route_flip_gap``), at
    under 2 % of the pairs."""
    model, a, w = tiny_model(dtype)
    x, labels, mask = _inputs()
    routes = []
    model.capture_routes(routes)
    with torch.no_grad():
        y = model(x, labels, mask[None, ..., None])
        ref, info = ref_moe.forward(w, a, x, labels, mask,
                                    routes=routes if routing == 'forced' else None)
    model.capture_routes(None)
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert len(routes) == DEPTH and all(r.shape == (2 * (R // 4) ** 3, K) for r in routes)
    flips = 0
    for got, own, gap in zip(routes, info['top'], info['gap']):
        diff = (_as_sets(got) != _as_sets(own)).any(dim=1)
        flips += int(diff.sum())
        assert (gap[diff] < 0.05).all()
    assert flips == 0 if dtype == 'float32' else flips <= 0.02 * DEPTH * routes[0].shape[0]
    if dtype == 'float32':
        torch.testing.assert_close(y, ref, **VAL)
    else:
        assert ((y - ref).norm() / ref.norm()) <= 2e-2


def test_forced_routes_steer_the_reference():
    """Given routes other than its own, the reference follows them: its
    output moves, its own top-2 sets stay its own, and with its own routes
    given it is bit for bit its free forward."""
    model, a, w = tiny_model()
    x, labels, mask = _inputs()
    free, info = ref_moe.forward(w, a, x, labels, mask)
    same, info2 = ref_moe.forward(w, a, x, labels, mask, routes=info['top'])
    assert torch.equal(free, same)
    other = [(t + 1) % E for t in info['top']]
    moved, info3 = ref_moe.forward(w, a, x, labels, mask, routes=other)
    assert (moved - free).norm() / free.norm() > 1e-2
    assert torch.equal(_as_sets(info3['top'][0]), _as_sets(info['top'][0]))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_planted_skew_routes_every_token_alike(dtype):
    """Identical tokens all take the same two experts: those get every row,
    the other two none, and the layer still equals the reference's (no token
    dropped, no expert with rows left out)."""
    model, a, w = tiny_model(dtype)
    block = model.blocks[1].moe
    h = torch.randn(1, 1, D, generator=torch.Generator().manual_seed(3)).expand(2, 40, D)
    h = h.contiguous()
    block.routes = []
    with torch.no_grad():
        y = block(h)
        ref, top, _ = ref_moe.moe_layer(w, a, 'blocks.1.moe', h.reshape(-1, D))
    picked = block.routes.pop()
    block.routes = None
    counts = torch.bincount(picked.reshape(-1), minlength=E)
    assert sorted(counts.tolist()) == [0, 0, 80, 80]
    assert torch.equal(_as_sets(picked), _as_sets(top))
    err = (y.reshape(-1, D) - ref).norm() / ref.norm()
    assert err <= (1e-6 if dtype == 'float32' else 2e-2), err


def test_route_offsets_permutation_and_plain_experts():
    """``route``: counts and exclusive offsets of the top-2 ids, the pairs
    in a stable sort by expert, every pair once, an expert with no row
    allowed. The experts' plain version: each pair's p E_e(x) (checked pair
    by pair), the packed weights' round trip at a width GROUP divides and at
    one it does not, bit-equal reruns, no launch."""
    g = torch.Generator().manual_seed(5)
    N, Dx, F = 50, 32, 96
    logits = torch.randn(N, E, generator=g)
    logits[:, 2] -= 100.0                                   # expert 2 gets no row
    p, top, order, offsets = route(logits, K)
    flat = top.reshape(-1)
    counts = torch.bincount(flat, minlength=E)
    assert counts[2] == 0 and offsets.tolist() == [0] + counts.cumsum(0).tolist()
    assert order.dtype == offsets.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(N * K))
    for e in range(E):
        seg = order[offsets[e]:offsets[e + 1]].long()
        assert (flat[seg] == e).all() and (seg.diff() > 0).all()
    torch.testing.assert_close(p, torch.softmax(logits, -1).gather(1, top), rtol=0, atol=0)
    for f in (F, 128):
        gate, up = torch.randn(2, E, f, Dx, generator=g)
        back = ops.unpack_gate_up(ops.pack_gate_up(gate, up))
        assert torch.equal(back[0], gate) and torch.equal(back[1], up)
    x = torch.randn(N, Dx, generator=g)
    gate, up = torch.randn(2, E, F, Dx, generator=g) * Dx ** -0.5
    down = torch.randn(E, Dx, F, generator=g) * F ** -0.5
    w_gu = ops.pack_gate_up(gate, up)
    n0 = ops.moe_experts.launches
    y = ops.moe_experts(x, w_gu, down, order, offsets, p.reshape(-1), K)
    assert torch.equal(y, ops.moe_experts(x, w_gu, down, order, offsets, p.reshape(-1), K))
    assert ops.moe_experts.launches == n0 and y.shape == (N * K, Dx)
    for t, s in [(0, 0), (7, 1), (N - 1, 1)]:
        e = int(top[t, s])
        want = p[t, s] * (torch.nn.functional.silu(gate[e] @ x[t]) * (up[e] @ x[t])) @ down[e].T
        torch.testing.assert_close(y[t * K + s], want, **VAL)


def test_packed_experts_follow_the_weights():
    """The routed experts are their three weights alone (no cache or
    forward of their own; the shared expert keeps both); ``packed`` gives
    them in the kernel's bf16 layout, kept between calls and rebuilt only
    when an expert's weight changes in place."""
    from meshdiffusion_tpu_torch.models.moe import Expert, MoeMLP
    block = SparseMoeBlock(D, E, K, FE, FS, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for prm in block.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g))
    assert all(type(ex) is Expert for ex in block.experts)
    assert [n for n, _ in block.experts[0].named_parameters()] == [
        'gate_proj.weight', 'up_proj.weight', 'down_proj.weight']
    assert isinstance(block.shared_experts, MoeMLP)

    def stacked(name):
        return torch.stack([getattr(ex, name).weight for ex in block.experts]).bfloat16()
    with torch.no_grad():
        w_gu, down = block.packed()
        assert block.packed()[0] is w_gu and w_gu.dtype == down.dtype == torch.bfloat16
        gate, up = ops.unpack_gate_up(w_gu)
        assert torch.equal(gate, stacked('gate_proj')) and torch.equal(up, stacked('up_proj'))
        assert torch.equal(down, stacked('down_proj'))
        block.experts[E - 1].down_proj.weight.mul_(2.0)
        w_gu2, down2 = block.packed()
    assert down2 is not down and torch.equal(down2, stacked('down_proj'))
    assert torch.equal(w_gu2, w_gu)


def test_state_dict_and_full_width_parameter_count():
    """DiT-MoE's names under each block's ``moe`` (experts, router, shared
    expert), no bias in them, no ``mlp``; the reference's specs in the same
    order; and 4,167,325,696 parameters at the preset's full width, built on
    the meta device, as reckoned from the config."""
    model, a, w = tiny_model()
    assert list(model.state_dict()) == list(w)
    keys = set(w)
    assert {'blocks.1.moe.gate.weight', 'blocks.0.moe.experts.3.gate_proj.weight',
            'blocks.0.moe.experts.0.up_proj.weight', 'blocks.1.moe.experts.2.down_proj.weight',
            'blocks.0.moe.shared_experts.down_proj.weight'} <= keys
    assert not [k for k in keys if '.mlp.' in k and k.startswith('blocks.')]
    assert not [k for k in keys if '.moe.' in k and k.endswith('.bias')]
    assert w['blocks.0.moe.gate.weight'].shape == (E, D)
    cfg = get_config('dit3d_moe_xl4_res64')
    with torch.device('meta'):
        full = get_model(cfg.model.name).from_config(cfg)
    m = cfg.model
    Dw, Fw, Fsw = m.hidden_size, m.expert_hidden, m.shared_expert_hidden
    dense_mlp = 2 * Dw * int(Dw * m.mlp_ratio) + int(Dw * m.mlp_ratio) + Dw
    moe = m.num_experts * 3 * Dw * Fw + m.num_experts * Dw + 3 * Dw * Fsw
    reckoned = 674_291_200 + m.depth * (moe - dense_mlp)
    assert sum(p.numel() for p in full.parameters()) == reckoned == 4_167_325_696
    assert (m.num_experts, m.experts_per_token, Fw, Fsw) == (8, 2, 4608, 2304)
    assert all(isinstance(b.moe, SparseMoeBlock) for b in full.blocks) and len(full.blocks) == 28


def test_uncond_gen_runs_the_moe_dit(tmp_path):
    """``evaler.uncond_gen`` through the preset at tiny size (its own
    initialisation, a 10-scale schedule): a finite, masked sample."""
    from meshdiffusion_tpu_torch.diffusion import evaler
    cfg = tiny_config(num_scales=10, beta_max=2.0)
    cfg.eval.batch_size = 2
    cfg.eval.eval_dir = str(tmp_path)
    cfg.data.grid_mask_path = str(tmp_path / 'mask.npy')
    mask = np.ones((R, R, R), np.float32)
    mask[0] = 0
    np.save(cfg.data.grid_mask_path, mask)
    out = np.load(evaler.uncond_gen(cfg, idx='m', device='cpu'))
    assert out.shape == (2, 4, R, R, R) and np.isfinite(out).all()
    assert not out[:, :, 0].any() and out[:, :, 1:].any()


def test_profiled_forward_records_the_spans():
    """Each block holds a ``dit.attn`` and a ``dit.moe`` span (no
    ``dit.mlp``); each ``dit.moe`` holds ``moe.route``, ``ops.moe_experts``
    and ``moe.combine`` in that order; the packing counts ``rebuild.pack``
    once a block, on the first forward alone."""
    model, _, _ = tiny_model()
    x, labels, mask = _inputs()
    trace.clear()
    before = trace.counts().get('rebuild.pack', 0)
    with torch.no_grad():
        model(x, labels, mask[None, ..., None])
        packed = trace.counts().get('rebuild.pack', 0)
        with profile(activities=[ProfilerActivity.CPU]):
            model(x, labels, mask[None, ..., None])
    sp = trace.spans()
    trace.clear()
    assert trace.counts().get('rebuild.pack', 0) == packed and packed - before >= DEPTH
    blocks = [i for i, s in enumerate(sp) if s.name == 'dit.block']
    assert len(blocks) == DEPTH
    for i in blocks:
        assert [s.name for s in sp if s.parent == i] == ['dit.attn', 'dit.moe']
    for i in (j for j, s in enumerate(sp) if s.name == 'dit.moe'):
        assert [s.name for s in sp if s.parent == i] == ['moe.route', 'ops.moe_experts',
                                                         'moe.combine']


def test_checkpoint_round_trip_loads_for_generation(tmp_path):
    """A checkpoint written as the trainer writes it (model, EMA, optimizer)
    lists the model's parameters in its own order and loads back through
    the generation path's loader: the EMA weights, every expert's."""
    from meshdiffusion_tpu_torch.diffusion import losses
    from meshdiffusion_tpu_torch.utils.checkpoint import load_eval_weights, save_checkpoint
    cfg = tiny_config()
    model, _, w = tiny_model()
    state = losses.TrainState.create(model, cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for v in state.ema.shadow.values():
            v.mul_(0.5)
    path = save_checkpoint(str(tmp_path / 'c.pth'), {'model': model, 'ema': state.ema,
                                                     'optimizer': state.optimizer, 'step': 9},
                           cfg)
    raw = torch.load(path, weights_only=True)
    assert [k[len('module.'):] for k in raw['model']] == list(w)
    fresh = create_model(cfg, device='cpu')
    assert load_eval_weights(path, fresh, cfg) == 9
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, w[k] * 0.5, rtol=0, atol=0)
