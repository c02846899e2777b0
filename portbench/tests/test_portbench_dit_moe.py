"""The sparse-expert DiT cell's files on the CPU: the configuration against
the preset and the published widths, the counts at those widths and
against torch's own counter, the plain reference's isolation from the
program, its forced and free routing and its slots against the uncut
expert mixture, and whole runs of the ``gen_dit_moe`` driver at a tiny
size: sound, it comes out correct; with the control in the program's place,
or with a fault planted under each new limit, it does not."""

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.counts import dit_moe as moe_counts
from portbench.drivers import gen_dit_moe
from portbench.reference import dit_moe as ref_moe
from portbench.reference.unet import fp8_round

CELL = 'gen-ditmoe64-b4'

# Inside an xdist worker, torch's pools get the worker's share of the cores:
# at torch's default each of four workers spins a pool as wide as the
# machine, and a tiny run's 3-s window then held 4 steps, not ~100, too few
# for its checked steps.
if 'PYTEST_XDIST_WORKER' in os.environ:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              // int(os.environ['PYTEST_XDIST_WORKER_COUNT'])))
TINY = dict(hidden_size=48, depth=12, num_heads=4, num_scales=50, num_experts=8,
            experts_per_token=2, expert_hidden=128, shared_expert_hidden=96)


def tiny_cell(batch: int = 2) -> harness.Cell:
    """The cell at R 16 (4^3 patches: 64 tokens), width 48, 12 blocks of 4
    heads (deep enough that the experts' rounding adds up as over the cell's
    28), 8 experts of width 128 (the top 2 a token), a shared expert of 96,
    50 scales, the generated lattice's mask."""
    cell = harness.Cell.load(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg['model'].update(TINY)
    cfg['data']['image_size'] = 16
    cfg['tet_file'] = ''
    cell.config = cfg
    cell.traffic = dict(cell.traffic, batch=batch, warmup_steps=1, check_steps=1,
                        check_within=3, trace_at=2, trace_steps=2, trace_tries=1)
    return cell


def _run(cell, seed=2 ** 33 + 17, control=False):
    return gen_dit_moe.run(cell, seed=seed, seconds=3.0, trace=False, device=torch.device('cpu'),
                           t_start=0.0, control=control)


def test_config_is_dit_moe_xl_at_full_width():
    """DiT-MoE-XL/2-8E2A's widths, nothing cut, and 4,167,325,696
    parameters by the reference's specs and by the program's model built on
    the meta device, in the same order."""
    from meshdiffusion_tpu_torch.config import get_config
    from meshdiffusion_tpu_torch.models import get_model
    cell = harness.Cell.load(CELL)
    m = cell.config['model']
    assert (m['hidden_size'], m['depth'], m['num_heads'], m['patch_size']) == (1152, 28, 16, 4)
    assert (m['num_experts'], m['experts_per_token'], m['expert_hidden'],
            m['shared_expert_hidden']) == (8, 2, 4608, 2304)
    assert cell.config['reduced'] == [] and cell.traffic['batch'] == 4
    a = ref_moe.arch(cell.config)
    n_ref = sum(torch.Size(s[1]).numel() for s in ref_moe.param_specs(a))
    with torch.device('meta'):
        model = get_model(m['name']).from_config(get_config(cell.config['preset']))
    assert n_ref == sum(p.numel() for p in model.parameters()) == 4_167_325_696
    assert [s[0] for s in ref_moe.param_specs(a)] == list(model.state_dict())


def test_counts_at_published_widths():
    """A b4 forward's 50.09 TFLOP as reckoned from the shapes (routed experts
    29.22, shared 7.31, attention 8.66, qkv and proj 4.87), each expert
    call's two modes, and the frozen cost equal to the port's own."""
    from meshdiffusion_tpu_torch import ops
    a = ref_moe.arch(harness.Cell.load(CELL).config)
    w = moe_counts.walk(a, 4)
    N, D, L = 4 * 4096, 1152, 28
    routed = L * 2 * N * 6 * D * 4608
    shared = L * N * 6 * D * 2304
    attn = L * 4 * 4 * 16 * 4096 ** 2 * 72
    qkv_proj = L * 2 * N * D * 4 * D
    assert (round(routed / 1e12, 2), round(shared / 1e12, 2), round(attn / 1e12, 2),
            round(qkv_proj / 1e12, 2)) == (29.22, 7.31, 8.66, 4.87)
    assert round(w['flops'] / 1e12, 2) == 50.09
    assert w['experts'] == [(32768, 1152, 4608, 8)] * 28
    cost = moe_counts.experts_cost(*w['experts'][0])
    assert cost == ops.moe_experts_cost(*w['experts'][0])
    assert cost['gate_up'][0] == 2 * 32768 * 1152 * 9216 and cost['down'][0] == 2 * 32768 * 4608 * 1152
    bound = sum(max(f / 989e12, b / 3.35e12) for f, b in cost.values())
    assert 1.05e-3 < bound < 1.06e-3                       # compute-bound: 29.5 ms a forward


def test_flop_count_matches_torch_counter():
    """``counts/dit_moe.py`` against ``torch.utils.flop_counter`` over the
    tiny program's plain forward (patch projections, Linears, router,
    routed experts on their rows, shared expert, attention matmuls)."""
    from torch.utils.flop_counter import FlopCounterMode

    from meshdiffusion_tpu_torch.models import create_model
    cell = tiny_cell()
    config = gen_dit_moe.port_config(cell.config, 3)
    config.gpu.compute_dtype = 'float32'
    model = create_model(config, device='cpu').eval()
    R = config.data.image_size
    x = torch.randn(3, R, R, R, 4)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(x, torch.tensor([1.0, 20.0, 40.0]), torch.ones(1, R, R, R, 1))
    assert fc.get_total_flops() == moe_counts.walk(ref_moe.arch(cell.config), 3)['flops']


def test_reference_loads_nothing_of_the_program():
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    out = subprocess.run([sys.executable, '-c', 'import json, sys, portbench.reference.dit_moe\n'
                          'print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))'],
                         capture_output=True, text=True, env=env, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {'meshdiffusion_tpu_torch', 'meshdiffusion_tpu', 'jax', 'jaxlib'}


def _tiny_reference(seed=11):
    a = ref_moe.arch(tiny_cell().config)
    _, p = ref_moe.make_weights(a, seed, 'cpu')
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 16, 16, 16, 4, generator=g)
    mask = (torch.rand(16, 16, 16, generator=g) > 0.3).float()
    return a, p, x, torch.tensor([5.0, 40.0]), mask


def test_forced_routing_with_its_own_routes_is_free_routing():
    a, p, x, labels, mask = _tiny_reference()
    free, info = ref_moe.forward(p, a, x, labels, mask)
    forced, info2 = ref_moe.forward(p, a, x, labels, mask, routes=info['top'])
    assert torch.equal(free, forced)
    for t, t2, g in zip(info['top'], info2['top'], info['gap']):
        assert torch.equal(t, t2) and (g >= 0).all()


def test_slots_sum_to_the_uncut_mixture():
    """The layer's two weighted slots and the shared expert add up to the
    uncut mixture: every expert run on every token, weighted by its softmax
    probability where it is among the token's top 2 and by 0 elsewhere,
    plus the shared expert."""
    a, p, _, _, _ = _tiny_reference()
    h = torch.randn(300, a['D'], generator=torch.Generator().manual_seed(2))
    key = 'blocks.1.moe'
    y, top, _ = ref_moe.moe_layer(p, a, key, h)
    probs = torch.softmax(h @ p[key + '.gate.weight'].T, dim=-1)
    gates = torch.zeros_like(probs).scatter(1, top, probs.gather(1, top))
    mix = sum(gates[:, e, None] * ref_moe._swiglu(p, f'{key}.experts.{e}', h, lambda t: t)
              for e in range(a['E']))
    torch.testing.assert_close(y, mix + ref_moe._swiglu(p, key + '.shared_experts', h,
                                                        lambda t: t), rtol=1e-5, atol=1e-6)


def test_sound_run_is_correct_and_control_is_not():
    cell = tiny_cell()
    out = _run(cell, control=True)
    assert all(c.ok for c in out.checks), [(c.name, c.value, c.limit) for c in out.checks]
    assert out.attempted > 0 and out.failed == 0
    r = cell.readings
    assert min(r['ctrl_eps_rel_l2']) > cell.limits['eps_rel_l2']
    assert min(r['ctrl_update_rel_err']) > cell.limits['update_rel_err']
    assert max(r['ctrl_route_flip_gap']) > cell.limits['route_flip_gap']


def _faulty(name, monkeypatch):
    """Plant one fault under the program: the 3rd choice in the 2nd's
    place (``wrong_expert``), the batch's last token routed as its first
    (``last_token``: one token a block, at no near-tie), the top 2's weights
    renormalised to sum to 1 (``renormalized_top2``), or the experts'
    operands in fp8 (``fp8_experts``)."""
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.models import moe
    route = moe.route
    if name == 'wrong_expert':
        def f(logits, k):
            return route(logits.scatter(1, logits.topk(k, -1).indices[:, 1:2], -1e9), k)
    elif name == 'last_token':
        def f(logits, k):
            logits = logits.clone()
            logits[-1] = logits[0]
            return route(logits, k)
    elif name == 'renormalized_top2':
        def f(logits, k):
            p, *rest = route(logits, k)
            return (p / p.sum(-1, keepdim=True), *rest)
    else:
        plain = ops.moe_experts

        def g(x, w_gu, w_down, order, offsets, weights, k):
            q = lambda t: fp8_round(t.float())                          # noqa: E731
            return plain(q(x), q(w_gu), q(w_down), order, offsets, weights, k)
        monkeypatch.setattr(moe.ops, 'moe_experts', g)
        return
    monkeypatch.setattr(moe, 'route', f)


@pytest.mark.parametrize('fault,check', [('wrong_expert', 'route_disagree'),
                                         ('last_token', 'route_flip_gap'),
                                         ('renormalized_top2', 'eps_rel_l2'),
                                         ('fp8_experts', 'eps_rel_l2')])
def test_faults_fail_their_limit(fault, check, monkeypatch):
    _faulty(fault, monkeypatch)
    out = _run(tiny_cell())
    checks = {c.name: c for c in out.checks}
    assert not checks[check].ok, (checks[check].value, checks[check].limit)
    assert checks['update_rel_err'].ok and out.failed > 0
    if fault == 'last_token':                  # one token: too few pairs for the share
        assert checks['route_disagree'].ok

