"""The port's debug helpers against the JAX package's, on the CPU:
``check_finite`` (the anomaly tripwire, switched on in code or by
MESHDIFFUSION_DETECT_ANOMALY=1) and ``profile_trace`` (a trace file written
on the CPU, holding the program's spans; nothing on '')."""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.utils import debug as JD
from meshdiffusion_tpu_torch.utils import debug as D

pytest_plugins = ('torch_rules',)


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


def test_profile_trace_writes_a_trace(tmp_path):
    """A trace under log_dir on the CPU, holding the profiled op and, in
    the trace's own time base, the program's span around it as an ``X``
    event that brackets the op's; nothing written and no profiler started
    on ''."""
    from meshdiffusion_tpu_torch.utils import trace
    with D.profile_trace(''):
        assert not torch.autograd._profiler_enabled()
    log_dir = tmp_path / 'prof'
    with D.profile_trace(str(log_dir)):
        with trace.span('test.mm'):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    files = glob.glob(os.path.join(log_dir, '*.json'))
    assert len(files) == 1, files
    events = json.load(open(files[0]))['traceEvents']
    mm = [e for e in events if e.get('name') == 'aten::mm']
    (sp,) = [e for e in events if e.get('name') == 'test.mm']
    assert mm and sp['ph'] == 'X' and sp['cat'] == 'program'
    for e in mm:
        assert sp['ts'] <= e['ts'] and e['ts'] + e['dur'] <= sp['ts'] + sp['dur']


def test_profile_trace_writes_its_trace_when_the_body_raises(tmp_path):
    """A scope that raises still leaves its trace, with the program's span
    that the exception closed, and the exception goes on to the caller."""
    from meshdiffusion_tpu_torch.utils import trace
    log_dir = tmp_path / 'prof'
    with pytest.raises(ValueError):
        with D.profile_trace(str(log_dir)):
            with trace.span('test.raises'):
                torch.mm(torch.ones(8, 8), torch.ones(8, 8))
                raise ValueError
    assert not torch.autograd._profiler_enabled()
    files = glob.glob(os.path.join(log_dir, '*.json'))
    assert len(files) == 1, files
    events = json.load(open(files[0]))['traceEvents']
    assert any(e.get('name') == 'aten::mm' for e in events)
    (sp,) = [e for e in events if e.get('name') == 'test.raises']
    assert sp['ph'] == 'X'
