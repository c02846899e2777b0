"""A whole run of the generation driver on the CPU at a tiny size, without
the harness's look for a card: sound it comes out correct; with the timed
path broken underneath, or with the control (the reference in fp8 and
bf16) in the program's place, it does not."""

import pytest
import torch

from portbench.drivers import gen
from portbench.tests.tiny import tiny_cell


def _run(cell, seed=2 ** 33 + 17, control=False):
    return gen.run(cell, seed=seed, seconds=1.0, trace=False, device=torch.device('cpu'),
                   t_start=0.0, control=control)


def test_sound_run_is_correct_and_control_is_not():
    cell = tiny_cell()
    out = _run(cell, control=True)
    assert all(c.ok for c in out.checks), [(c.name, c.value, c.limit) for c in out.checks]
    assert out.attempted > 0 and out.failed == 0
    r = cell.readings
    assert min(r['ctrl_eps_rel_l2']) > cell.limits['eps_rel_l2']
    assert min(r['ctrl_update_rel_err']) > cell.limits['update_rel_err']


def _unchanged(x, eps_hat, mask, noise, beta, std):
    return x.clone(), x.clone()


def _half_batch(forward):
    def f(self, x, labels, mask=None, train=False):
        h = x.shape[0] // 2
        y = forward(self, x[:h], labels[:h], mask, train)
        return torch.cat([y, y[:x.shape[0] - h]])
    return f


def _altered(forward):
    def f(self, x, labels, mask=None, train=False):
        y = forward(self, x, labels, mask, train)
        y[-1] = y[-1] * 1.1
        return y
    return f


@pytest.mark.parametrize('fault', ['state_unchanged', 'half_batch', 'answer_altered'])
def test_faults_are_caught(fault, monkeypatch):
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.models.unet3d import UNet3D
    if fault == 'state_unchanged':
        monkeypatch.setattr(ops, 'ancestral_update', _unchanged)
    elif fault == 'half_batch':
        monkeypatch.setattr(UNet3D, 'forward', _half_batch(UNet3D.forward))
    else:
        monkeypatch.setattr(UNet3D, 'forward', _altered(UNet3D.forward))
    out = _run(tiny_cell())
    assert not all(c.ok for c in out.checks)
    assert out.failed > 0


def test_traced_run_prints_its_line_on_the_cpu():
    """The traced path end to end where there is no card: the profiled
    window records no device operation, so each device reader returns
    nothing and mfu.gen (host clock) reads a positive share."""
    from portbench import harness
    cell = tiny_cell()
    out = gen.run(cell, seed=5, seconds=0.5, trace=True, device=torch.device('cpu'),
                  t_start=0.0)
    line = harness.result(cell, out, True, 'cpu')
    assert set(line['metrics']) == {'mfu.gen'} and line['metrics']['mfu.gen']['value'] > 0
    assert list(line)[-1] == 'checks' and line['correct']
