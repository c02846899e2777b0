"""The FLUX cell's files on the CPU: the configuration against the preset,
the published widths and the cut, the FLOP count against the shapes'
reckoning and torch's own counter, the readers on windows without the
kernels, the plain reference's isolation from the program, and whole runs
of the ``gen_flux`` driver at a tiny size: sound, it comes out correct;
with RoPE turning half-split pairs, an RMSNorm scale dropped, the txt
stream left out of the joint attention, or the reference one rounding down
(the control) in the program's place, it does not."""

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.counts import flux as flux_counts
from portbench.drivers import gen_flux
from portbench.reference import flux as ref_flux
from portbench.reference.unet import fp8_round

CELL = 'gen-flux64-b4'

# Inside an xdist worker, torch's pools get the worker's share of the cores,
# so that a tiny run's 3-s window reaches its checked steps (as
# test_portbench_dit_moe.py does).
if 'PYTEST_XDIST_WORKER' in os.environ:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              // int(os.environ['PYTEST_XDIST_WORKER_COUNT'])))
TINY = dict(hidden_size=64, num_heads=2, axes_dim=[8, 12, 12], depth=3, depth_single_blocks=6,
            context_in_dim=16, context_len=32, vec_in_dim=8, num_scales=50)


def tiny_cell(batch: int = 2) -> harness.Cell:
    """The cell at R 16 (4^3 patches: 64 img tokens), width 64, 2 heads of
    32, 3 double and 6 single blocks (the published 1 : 2), 32 txt tokens of
    16, 50 scales, the generated lattice's mask."""
    cell = harness.Cell.load(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg['model'].update(TINY)
    cfg['data']['image_size'] = 16
    cfg['tet_file'] = ''
    cell.config = cfg
    cell.traffic = dict(cell.traffic, batch=batch, warmup_steps=1, check_steps=1,
                        check_within=3, trace_at=2, trace_steps=2, trace_tries=1)
    return cell


def _run(cell, seed=2 ** 33 + 29, control=False, trace=False):
    return gen_flux.run(cell, seed=seed, seconds=3.0, trace=trace, device=torch.device('cpu'),
                        t_start=0.0, control=control)


def test_config_is_flux_dev_cut_in_depth_alone():
    """Every value of the file is the preset's; FLUX-dev's published
    widths; ``reduced`` names the two depths, cut to half (both kinds in
    the published 1 : 2 ratio), with the published values beside them;
    6,295,653,632 parameters by the reference's specs and by the program's
    model on the meta device."""
    from meshdiffusion_tpu_torch.config import get_config
    from meshdiffusion_tpu_torch.models import get_model
    m = json.load(open(os.path.join(harness.ROOT, 'BENCHMARK.json')))
    entry = {c['name']: c for c in m['configs']}['flux-dev-d10s20-res64']
    cell = harness.Cell.load(CELL)
    f = cell.config
    assert f['source'] == entry['source'] and f['reduced'] == entry['reduced'] == \
        ['depth', 'depth_single_blocks']
    preset = get_config(f['preset'])
    for sec in ('model', 'data', 'sampling', 'eval', 'gpu'):
        for k, v in f[sec].items():
            pv = preset[sec][k]
            assert (list(pv) if isinstance(pv, tuple) else pv) == v, (sec, k)
    mm = f['model']
    assert (mm['hidden_size'], mm['num_heads'], mm['mlp_ratio'], mm['axes_dim'], mm['theta'],
            mm['context_in_dim'], mm['vec_in_dim']) == (3072, 24, 4.0, [16, 56, 56], 10000,
                                                         4096, 768)
    assert (mm['depth'], mm['depth_single_blocks']) == (10, 20)
    assert f['published'] == {'depth': 19, 'depth_single_blocks': 38, 'parameters': 11902787840}
    assert cell.traffic['batch'] == 4 and cell.traffic['guidance'] == 3.5
    a = ref_flux.arch(f)
    n_ref = sum(torch.Size(s[1]).numel() for s in ref_flux.param_specs(a))
    with torch.device('meta'):
        model = get_model(mm['name']).from_config(get_config(f['preset']))
    assert n_ref == sum(p.numel() for p in model.parameters()) == 6_295_653_632


def test_flop_count_is_the_reckoning():
    """One b4 forward of the cut model by part, in TFLOP: the img stream's
    Linears 37.11, the txt stream's 4.64, the single blocks' 83.49, 30
    attention calls of 1.0437 each (31.31), the rest ~0.12; each call's
    bound; a QK norm and RoPE call 0.68 GB."""
    a = ref_flux.arch(harness.Cell.load(CELL).config)
    parts = {k: v / 1e12 for k, v in flux_counts.parts(a, 4).items()}
    assert {k: round(v, 2) for k, v in parts.items() if k != 'rest'} == \
        {'img': 37.11, 'txt': 4.64, 'single': 83.49, 'attn': 31.31}
    assert 0.1 < parts['rest'] < 0.2
    assert 156.6 < sum(parts.values()) < 156.8
    walk = flux_counts.walk(a, 4)
    assert walk['attn'] == walk['qkrope'] == [(4, 4608, 24, 128)] * 30
    from portbench.counts.dit import attention_cost
    from portbench.counts.roofline import PEAK_BF16_FLOPS, bound_s
    flop, nbytes = attention_cost(*walk['attn'][0])
    assert round(flop / 1e12, 4) == 1.0437
    assert round(bound_s(flop, nbytes, PEAK_BF16_FLOPS)[0] * 1e3, 3) == 1.055
    flop, nbytes = flux_counts.qk_norm_rope_cost(*walk['qkrope'][0])
    assert round(nbytes / 1e9, 2) == 0.68
    assert bound_s(flop, nbytes, PEAK_BF16_FLOPS)[1] == 'bytes'


def test_flop_count_matches_torch_counter():
    """``counts/flux.py`` against ``torch.utils.flop_counter`` over the tiny
    program's plain forward (Linears, the mask projection, attention
    matmuls)."""
    from torch.utils.flop_counter import FlopCounterMode

    from meshdiffusion_tpu_torch.models import create_model
    cell = tiny_cell()
    config = gen_flux.port_config(cell.config, 3)
    config.gpu.compute_dtype = 'float32'
    model = create_model(config, device='cpu').eval()
    a = ref_flux.arch(cell.config)
    R = config.data.image_size
    x = torch.randn(3, R, R, R, 4)
    cond = dict(txt=torch.randn(3, a['ctx_len'], a['ctx']), y=torch.randn(3, a['vec']),
                guidance=torch.full((3,), 3.5))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(x, torch.tensor([1.0, 20.0, 40.0]), torch.ones(1, R, R, R, 1), **cond)
    assert fc.get_total_flops() == flux_counts.walk(a, 3)['flops']


class _Window:
    """A profiled window that recorded nothing of the given kernels."""
    steps = 2

    def count(self, names):
        return 0

    def device_s(self, names=None):
        return 0.0


def test_device_readers_read_nothing_without_their_kernels():
    """On a window without the dh-128 attention or the QK norm and RoPE
    kernel (a program without them, or a window that dropped records), the
    rooflines read None; without the program's spans the idle split does."""
    a = ref_flux.arch(tiny_cell().config)

    class Ctx:
        window, walk, forwards, step_s = _Window(), flux_counts.walk(a, 2), 2, 1.0
    for metric in ('attn_roofline.flux', 'qkrope_roofline.flux'):
        assert harness.reader(metric)(Ctx) is None
    assert harness.reader('mfu.flux')(Ctx) > 0


def test_reference_loads_nothing_of_the_program():
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    out = subprocess.run([sys.executable, '-c', 'import json, sys, portbench.reference.flux\n'
                          'print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))'],
                         capture_output=True, text=True, env=env, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {'meshdiffusion_tpu_torch', 'meshdiffusion_tpu', 'jax', 'jaxlib'}


def test_sound_run_is_correct_and_control_is_not():
    cell = tiny_cell()
    out = _run(cell, control=True)
    assert all(c.ok for c in out.checks), [(c.name, c.value, c.limit) for c in out.checks]
    assert out.attempted > 0 and out.failed == 0
    r = cell.readings
    assert min(r['ctrl_eps_rel_l2']) > cell.limits['eps_rel_l2']
    assert min(r['ctrl_update_rel_err']) > cell.limits['update_rel_err']


def _half_split(x, q_scale, k_scale, pe, num_heads, x2=None, q_scale2=None, k_scale2=None):
    """The QK norm with RoPE turning (i, i + dh/2) pairs, the half-split
    layout, in place of FLUX's adjacent ones."""
    from meshdiffusion_tpu_torch import ops
    out = ops.qk_norm_rope_reference(x, q_scale, k_scale, torch.stack(
        [torch.ones_like(pe[..., 0]), torch.zeros_like(pe[..., 0])], -1), num_heads, x2,
        q_scale2, k_scale2)
    dh = q_scale.shape[-1]
    B, L, D3 = out.shape
    t = out.reshape(B, L, 3, num_heads, dh).clone()
    c, s = pe[None, :, None, :, 0], pe[None, :, None, :, 1]
    for part in (0, 1):
        x0, x1 = t[:, :, part, :, :dh // 2].clone(), t[:, :, part, :, dh // 2:].clone()
        t[:, :, part, :, :dh // 2] = c * x0 - s * x1
        t[:, :, part, :, dh // 2:] = s * x0 + c * x1
    return t.reshape(B, L, D3)


def _scale_dropped(x, q_scale, k_scale, pe, num_heads, x2=None, q_scale2=None, k_scale2=None):
    """The QK norm with the RMSNorms' learned scales left out."""
    from meshdiffusion_tpu_torch import ops
    one = torch.ones_like(q_scale)
    return ops.qk_norm_rope_reference(x, one, one, pe, num_heads, x2,
                                      None if x2 is None else one, None if x2 is None else one)


def _txt_left_out(forward):
    """A double block whose joint attention sees the img tokens alone."""
    def f(self, img, txt, vec, pe):
        from meshdiffusion_tpu_torch import ops
        real = ops.dit_attention

        def img_only(joint, H):
            Tt = txt.shape[1]
            return torch.cat([real(joint[:, :Tt], H), real(joint[:, Tt:], H)], dim=1)
        ops.dit_attention = img_only
        try:
            return forward(self, img, txt, vec, pe)
        finally:
            ops.dit_attention = real
    return f


def _control_in_place(a):
    """The program's forward replaced by the reference with fp8 operands
    (one rounding further down than the configuration's bf16)."""
    def f(self, x, labels, mask=None, train=False, *, txt=None, y=None, guidance=None):
        _, p = ref_flux.make_weights(a, self._seed, 'cpu')
        m = mask[0, ..., 0]
        return torch.cat([ref_flux.forward(p, a, x[b:b + 1], labels[b:b + 1], m, txt[b:b + 1],
                                           y[b:b + 1], guidance[b:b + 1], q=fp8_round)
                          for b in range(x.shape[0])])
    return f


@pytest.mark.parametrize('fault', ['rope_half_split', 'rms_scale_dropped', 'txt_left_out',
                                   'control_in_place'])
def test_faults_fail_eps_rel_l2(fault, monkeypatch):
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.models import flux3d
    cell = tiny_cell()
    if fault == 'rope_half_split':
        monkeypatch.setattr(ops, 'qk_norm_rope', _half_split)
    elif fault == 'rms_scale_dropped':
        monkeypatch.setattr(ops, 'qk_norm_rope', _scale_dropped)
    elif fault == 'txt_left_out':
        monkeypatch.setattr(flux3d.DoubleStreamBlock, 'forward',
                            _txt_left_out(flux3d.DoubleStreamBlock.forward))
    else:
        seed = 2 ** 33 + 29
        monkeypatch.setattr(flux3d.Flux3D, '_seed', gen_flux.seeds(seed)['weights'],
                            raising=False)
        monkeypatch.setattr(flux3d.Flux3D, 'forward', _control_in_place(
            ref_flux.arch(cell.config)))
    out = _run(cell)
    checks = {c.name: c for c in out.checks}
    assert not checks['eps_rel_l2'].ok and checks['update_rel_err'].ok
    assert out.failed > 0


def test_traced_run_prints_its_line_on_the_cpu():
    """The traced path end to end where there is no card: the profiled
    window records no device operation, so each device reader returns
    nothing and mfu.flux (host clock) reads a positive share."""
    cell = tiny_cell()
    out = _run(cell, seed=5, trace=True)
    line = harness.result(cell, out, True, 'cpu')
    assert set(line['metrics']) == {'mfu.flux'} and line['metrics']['mfu.flux']['value'] > 0
    assert list(line)[-1] == 'checks' and line['correct']
