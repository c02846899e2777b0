"""The DiT cell's files on the CPU: the configuration against the preset and
the published widths, the FLOP count against torch's own counter, the plain
reference's isolation from the program, and whole runs of the ``gen_dit``
driver at a tiny size: sound, it comes out correct; with a gate dropped or
the modulation's scale wrong underneath, or with the control in the
program's place, it does not."""

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.counts import dit as dit_counts
from portbench.drivers import gen_dit
from portbench.reference import dit as ref_dit

CELL = 'gen-dit64-b4'
TINY = dict(hidden_size=48, depth=2, num_heads=4, num_scales=50)


def tiny_cell(batch: int = 2) -> harness.Cell:
    """The cell at R 16 (4^3 patches: 64 tokens), width 48, 2 blocks of 4
    heads, 50 scales, the generated lattice's mask."""
    cell = harness.Cell.load(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg['model'].update(TINY)
    cfg['data']['image_size'] = 16
    cfg['tet_file'] = ''
    cell.config = cfg
    cell.traffic = dict(cell.traffic, batch=batch, warmup_steps=1, check_steps=1,
                        check_within=3, trace_at=2, trace_steps=2, trace_tries=1)
    return cell


def _run(cell, seed=2 ** 33 + 17, control=False, trace=False):
    return gen_dit.run(cell, seed=seed, seconds=3.0, trace=trace, device=torch.device('cpu'),
                       t_start=0.0, control=control)


def test_config_is_dit_xl4_at_full_width():
    """DiT_XL_4's published widths, nothing cut, and 674,291,200 parameters
    (without the fixed positions) by the reference's specs and by the
    program's model built on the meta device."""
    from meshdiffusion_tpu_torch.config import get_config
    from meshdiffusion_tpu_torch.models import get_model
    cell = harness.Cell.load(CELL)
    m = cell.config['model']
    assert (m['hidden_size'], m['depth'], m['num_heads'], m['mlp_ratio'], m['patch_size']) == \
        (1152, 28, 16, 4.0, 4)
    assert cell.config['reduced'] == [] and cell.traffic['batch'] == 4
    a = ref_dit.arch(cell.config)
    n_ref = sum(torch.Size(s[1]).numel() for s in ref_dit.param_specs(a))
    with torch.device('meta'):
        model = get_model(m['name']).from_config(get_config(cell.config['preset']))
    assert n_ref == sum(p.numel() for p in model.parameters()) == 674_291_200
    assert [s[0] for s in ref_dit.param_specs(a)] == list(model.state_dict())


def test_flop_count_matches_torch_counter():
    """``counts/dit.py`` against ``torch.utils.flop_counter`` over the tiny
    program's plain forward (patch projections, Linears, attention
    matmuls)."""
    from torch.utils.flop_counter import FlopCounterMode

    from meshdiffusion_tpu_torch.models import create_model
    cell = tiny_cell()
    config = gen_dit.port_config(cell.config, 3)
    config.gpu.compute_dtype = 'float32'
    model = create_model(config, device='cpu').eval()
    R = config.data.image_size
    x = torch.randn(3, R, R, R, 4)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(x, torch.tensor([1.0, 20.0, 40.0]), torch.ones(1, R, R, R, 1))
    assert fc.get_total_flops() == dit_counts.walk(ref_dit.arch(cell.config), 3)['flops']


def test_reference_loads_nothing_of_the_program():
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    out = subprocess.run([sys.executable, '-c', 'import json, sys, portbench.reference.dit\n'
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


def _no_gate(forward):
    """A block whose attention half leaves out its gate."""
    def f(self, x, c, plain):
        from meshdiffusion_tpu_torch.models import dit3d
        shift1, scale1, _, shift2, scale2, gate2 = \
            self.adaLN_modulation(c).float().chunk(6, dim=-1)
        x = x + self.attn(dit3d.modulate(dit3d._layer_norm(x), shift1, scale1), plain)
        y = self.mlp(dit3d.modulate(dit3d._layer_norm(x), shift2, scale2))
        return torch.addcmul(x, gate2[:, None], y)
    return f


def _scale_without_one(y, shift, scale):
    """The modulation y scale + shift, the 1 + left out of the scale."""
    return torch.addcmul(shift[:, None], y, scale[:, None])


@pytest.mark.parametrize('fault', ['gate_dropped', 'modulation_scale'])
def test_faults_fail_eps_rel_l2(fault, monkeypatch):
    from meshdiffusion_tpu_torch.models import dit3d
    if fault == 'gate_dropped':
        monkeypatch.setattr(dit3d.DiTBlock, 'forward', _no_gate(dit3d.DiTBlock.forward))
    else:
        monkeypatch.setattr(dit3d, 'modulate', _scale_without_one)
    out = _run(tiny_cell())
    checks = {c.name: c for c in out.checks}
    assert not checks['eps_rel_l2'].ok and checks['update_rel_err'].ok
    assert out.failed > 0


def test_traced_run_prints_its_line_on_the_cpu():
    """The traced path end to end where there is no card: the profiled
    window records no device operation, so each device reader returns
    nothing and mfu.dit (host clock) reads a positive share."""
    cell = tiny_cell()
    out = _run(cell, seed=5, trace=True)
    line = harness.result(cell, out, True, 'cpu')
    assert set(line['metrics']) == {'mfu.dit'} and line['metrics']['mfu.dit']['value'] > 0
    assert list(line)[-1] == 'checks' and line['correct']
