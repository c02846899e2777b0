"""``nin_roofline.gen`` on a synthetic window: None unless the window holds
every shortcut kernel's launch of its forwards (a program without the kernel
reads None too), else the calls' summed bound over their device time. Its
list of calls and their cost against the port's own calls at a tiny width."""

import pytest
import torch

from portbench import harness
from portbench.counts import unet as unet_counts
from portbench.reference import unet as ref_unet
from portbench.tests.test_portbench_counts import _cfg, _port_model
from portbench.counts.roofline import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S
from portbench.trace import Window

# two shortcut blocks (input width != output width) and two plain K3 calls
WALK = {'k3': [((2, 8, 8, 8, 256), 'float32', 128), ((2, 8, 8, 8, 128), 'bfloat16', 128),
               ((2, 4, 4, 4, 128), 'bfloat16', 256), ((2, 4, 4, 4, 256), 'bfloat16', 256)]}


class Ctx:
    def __init__(self, device, forwards):
        w = object.__new__(Window)
        w.steps, w.runtime, w._rt_starts = forwards, [], []
        w.device = sorted(device, key=lambda r: r[1])
        w.t0 = min(s for _, s, _ in w.device)
        w.t1 = max(e for _, _, e in w.device)
        self.window, self.walk, self.forwards = w, WALK, forwards


def _bound_s(M, K, N, esize):
    nbytes = M * K * esize + K * N * 2 + N * 4 + M * N * 2 + M * N * 4
    return max(nbytes / PEAK_BYTES_PER_S, 2.0 * M * K * N / PEAK_BF16_FLOPS)


def _device(forwards, drop=0):
    rows, t = [], 0
    for _ in range(forwards):
        for name in ('gn_silu_conv3d_kernel', '_nin_residual_kernel', 'gn_silu_conv3d_kernel',
                     '_nin_residual_kernel', 'elementwise_kernel'):
            rows.append((name, t, t + 1000))
            t += 1500
    nin = [k for k, r in enumerate(rows) if 'nin_residual' in r[0]]
    return [r for k, r in enumerate(rows) if k not in nin[:drop]]


@pytest.mark.parametrize('forwards', [1, 3])
def test_nin_roofline_reads_the_share_of_a_complete_window(forwards):
    read = harness.reader('nin_roofline.gen')
    bound = forwards * (_bound_s(2 * 512, 256, 128, 4) + _bound_s(2 * 64, 128, 256, 2))
    device_s = forwards * 2 * 1000e-9
    assert read(Ctx(_device(forwards), forwards)) == pytest.approx(100.0 * bound / device_s)
    assert harness.reader('nin_roofline.gen.b1')(Ctx(_device(forwards), forwards)) == \
        pytest.approx(100.0 * bound / device_s)


def test_nin_roofline_is_none_when_a_launch_is_missing():
    read = harness.reader('nin_roofline.gen')
    assert read(Ctx(_device(2, drop=1), 2)) is None
    no_kernel = [r for r in _device(2) if 'nin_residual' not in r[0]]
    assert read(Ctx(no_kernel, 2)) is None


@pytest.mark.parametrize('cell', ['gen64-b1', 'gen128-b7'])
def test_nin_calls_and_cost_match_the_port(cell, monkeypatch):
    """At a tiny width on the CPU, a forward with no gradient makes the
    shortcut calls the reader counts (x's shape and dtype, the output
    width), and the reader's cost of each is the port's own helper's."""
    from meshdiffusion_tpu_torch import ops
    cost = harness.reader('nin_roofline.gen').__globals__['cost']
    cfg = _cfg(cell)
    a = ref_unet.arch(cfg)
    R, B = a['R'], 2
    model = _port_model(cfg, B, 'bfloat16')
    seen, real = [], ops.nin_residual

    def rec(x, W, b, h, dtype):
        seen.append((tuple(x.shape), str(x.dtype).split('.')[-1], W.shape[-1]))
        return real(x, W, b, h, dtype)
    monkeypatch.setattr(ops, 'nin_residual', rec)
    with torch.no_grad():
        model(torch.randn(B, R, R, R, a['C']), torch.tensor([3.0, 9.0]),
              torch.ones(1, R, R, R, 1))
    want = [(x, dt, o) for x, dt, o in unet_counts.walk(a, B)['k3'] if x[-1] != o]
    assert seen == want and want
    for x, dt, o in want:
        assert cost(x, dt, o) == ops.nin_residual_cost(x, getattr(torch, dt), o)
