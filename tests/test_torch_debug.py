"""The port's debug helpers against the JAX package's, on the CPU:
``check_finite`` (the anomaly tripwire, switched on in code or by
MESHDIFFUSION_DETECT_ANOMALY=1), ``StepTimer`` / ``_fmt_time`` (the same
strings under a patched clock) and ``profile_trace`` (a trace file written
on the CPU; nothing on '')."""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.utils import debug as JD
from meshdiffusion_tpu_torch.utils import debug as D


@pytest.fixture
def anomaly_off(monkeypatch):
    monkeypatch.delenv('MESHDIFFUSION_DETECT_ANOMALY', raising=False)
    yield
    D.set_detect_anomaly(False)
    JD.set_detect_anomaly(False)


def _trees():
    good = {'a': torch.ones(3), 'b': [torch.zeros(2, 2), (torch.arange(4.0), 7)]}
    bad = {'a': torch.ones(3), 'b': [torch.zeros(2, 2), (torch.tensor([1.0, float('nan')]), 7)]}
    return good, bad, {'x': torch.tensor([float('inf')])}, torch.tensor([0.0, -float('inf')])


@pytest.mark.parametrize('switch', ['code', 'env'])
def test_check_finite_raises_when_on(anomaly_off, monkeypatch, switch):
    """On: a nested tree with a NaN or inf anywhere raises JAX's
    FloatingPointError message; a finite tree comes back as it is."""
    if switch == 'code':
        D.set_detect_anomaly(True)
        JD.set_detect_anomaly(True)
    else:
        monkeypatch.setenv('MESHDIFFUSION_DETECT_ANOMALY', '1')
    assert D.anomaly_enabled() and JD.anomaly_enabled()
    good, *bads = _trees()
    assert D.check_finite(good, 'g') is good
    for bad in bads:
        with pytest.raises(FloatingPointError, match='non-finite values in grads'):
            D.check_finite(bad, 'grads')
    with pytest.raises(FloatingPointError, match='non-finite values in grads'):
        JD.check_finite({'x': jnp.asarray([1.0, np.nan])}, 'grads')


def test_check_finite_is_identity_when_off(anomaly_off, monkeypatch):
    """Off (and MESHDIFFUSION_DETECT_ANOMALY other than '1'): the input
    itself comes back, NaNs and all, and no tensor is read."""
    monkeypatch.setenv('MESHDIFFUSION_DETECT_ANOMALY', '0')
    assert not D.anomaly_enabled() and not JD.anomaly_enabled()
    reads = []
    monkeypatch.setattr(D.torch, 'isfinite', lambda x: reads.append(x))
    for tree in _trees():
        assert D.check_finite(tree) is tree
    assert reads == []


def test_step_timer_and_fmt_time_match_jax(monkeypatch):
    """The same strings as JAX's under a patched clock: the mean over the
    last ``window`` steps in ms and the remaining time in s, min or h."""
    import time
    for seconds in (0.0, 12.345, 59.99, 60.5, 3599.0, 3600.5, 86400.0):
        assert D._fmt_time(seconds) == JD._fmt_time(seconds)
    durations = [0.25, 1.0, 0.5, 30.0, 2.0, 0.1, 7.0, 0.3, 900.0, 0.02]
    now = [0.0]
    monkeypatch.setattr(time, 'time', lambda: now[0])

    def run(timer):
        lines = []
        for it, d in enumerate(durations):
            timer.start()
            now[0] += d
            lines.append(timer.stop(it))
        return lines
    got = run(D.StepTimer(5000, window=3))
    assert got == run(JD.StepTimer(5000, window=3))
    assert got[0] == '250.0 ms/iter, rem=20.8 min' and 'h' in got[8]


def test_profile_trace_writes_a_trace(tmp_path):
    """A trace under log_dir on the CPU, holding the profiled op; nothing
    written and no profiler started on ''."""
    with D.profile_trace(''):
        assert not torch.autograd._profiler_enabled()
    log_dir = tmp_path / 'prof'
    with D.profile_trace(str(log_dir)):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    files = glob.glob(os.path.join(log_dir, '*.json'))
    assert len(files) == 1, files
    events = json.load(open(files[0]))['traceEvents']
    assert any('mm' in e.get('name', '') for e in events)
