"""The readers of the program's spans (``portbench/spans.py`` and the
``idle_*_ms``, ``launches_per_forward`` and ``rebuilds_per_step`` metrics)
on a synthetic window and synthetic spans: the idle split partitions the
window's idle time, the innermost span wins, spans are clipped to the
window, a gap that crosses a span's edge is split, and the counts take
only what lies in the window."""

import sys

import pytest

from portbench import harness, spans as S
from portbench.trace import Window
from meshdiffusion_tpu_torch.utils import trace
from meshdiffusion_tpu_torch.utils.trace import Instant, Span


def window(device, runtime=(), steps=1):
    w = object.__new__(Window)
    w.steps = steps
    w.device = sorted(device, key=lambda r: r[1])
    w.runtime = sorted(runtime, key=lambda r: r[1])
    w._rt_starts = [s for _, s, _ in w.runtime]
    w.t0 = min(s for _, s, _ in w.device)
    w.t1 = max(e for _, _, e in w.device)
    return w


class Ctx:
    def __init__(self, w):
        self.window, self.forwards = w, w.steps


def sp(name, t0, t1, parent=-1):
    return Span(name, t0, t1, parent, 0, None)


@pytest.fixture
def recorded(monkeypatch):
    """Put synthetic spans and instants in the program's recorder."""
    def put(spans, instants=()):
        monkeypatch.setattr(trace, 'spans', lambda: list(spans))
        monkeypatch.setattr(trace, 'instants', lambda: list(instants))
    return put


# device busy [100, 200], [300, 400], [450, 600], [700, 1000]: idle 100 + 50 + 100 = 250
DEVICE = [('k', 100, 200), ('k', 150, 180), ('k', 300, 400), ('k', 450, 600), ('k', 700, 1000)]
SPANS = [sp('sampler.step', 50, 1100), sp('unet.forward', 120, 680, 0),
         sp('unet.resblock', 210, 640, 1), sp('ops.gn_silu_conv3d', 250, 420, 2),
         sp('ops.gn_affine', 260, 270, 3), sp('ops.ancestral_update', 690, 720, 0)]


def test_idle_split_partitions_the_window_idle_time():
    w = window(DEVICE)
    idle = round(w.window_s * 1e9 - w.busy_s() * 1e9)
    got = S.idle_by_layer(w, SPANS)
    assert sum(got.values()) == idle == 250
    # [200, 300): unet 200-250, ops 250-300; [400, 450): ops 400-420, unet 420-450;
    # [600, 700): unet 600-680, sampler 680-690, ops 690-700
    assert got == {'unet': 50 + 30 + 80, 'ops': 50 + 20 + 10, 'sampler': 10}
    assert S.idle_by_layer(w, []) == {'outside': 250}


def test_innermost_span_wins_and_ties_go_to_the_later():
    w = window([('k', 0, 10), ('k', 50, 60)])
    nested = [sp('sampler.step', 0, 60), sp('unet.forward', 5, 58, 0),
              sp('unet.attn', 20, 40, 1), sp('ops.gn_affine', 20, 30, 2)]
    # both start at 20: the wrapper, recorded after the block, is the inner one
    assert S.idle_by_layer(w, nested) == {'unet': 10 + 10 + 10, 'ops': 10}
    assert S.idle_by_layer(w, nested[:3]) == {'unet': 40}


def test_spans_are_clipped_to_the_window(recorded):
    w = window([('k', 100, 200), ('k', 300, 400)], steps=2)
    recorded([sp('sampler.step', 0, 250), sp('ops.groupnorm_silu', 250, 1000),
              sp('unet.forward', 500, 900), sp('unet.forward', 10, 90)])
    ctx = Ctx(w)
    # in the window, 200-250 is the sampler's, 250-300 the wrapper's; spans wholly
    # outside the window are not read
    assert S.idle_ms(ctx, 'sampler') == pytest.approx(50e-6 / 2)
    assert S.idle_ms(ctx, 'ops') == pytest.approx(50e-6 / 2)
    assert S.idle_ms(ctx, 'unet') == 0
    segs = S.segments(S.program(ctx)[0], w.t0, w.t1)
    assert segs[0][0] == 100 and segs[-1][1] == 400


def test_a_gap_crossing_a_span_edge_is_split():
    w = window([('k', 0, 40), ('k', 60, 100)])
    got = S.idle_by_layer(w, [sp('unet.forward', 0, 100), sp('ops.gn_silu_conv3d', 30, 50, 0)])
    assert got == {'ops': 10, 'unet': 10}


def test_launches_per_forward_counts_launches_inside_forwards(recorded):
    runtime = [('cudaLaunchKernel', 110, 112), ('cuLaunchKernel', 150, 151),
               ('cudaMemcpyAsync', 160, 161), ('cudaLaunchKernelExC', 170, 171),
               ('cudaLaunchKernel', 205, 206), ('cudaLaunchKernel', 310, 311),
               ('cudaLaunchKernel', 5000, 5001)]
    w = window([('k', 100, 200), ('k', 300, 400)], runtime, steps=2)
    recorded([sp('sampler.step', 100, 400), sp('unet.forward', 105, 180, 0),
              sp('unet.forward', 300, 350, 0), sp('unet.forward', 4900, 5100)])
    # three launches in the first forward, one in the second; the memcpy, the launch
    # between forwards and the one past the window are not counted
    assert S.launches_per_forward(Ctx(w)) == 4 / 2
    assert harness.reader('launches_per_forward.gen.b1')(Ctx(w)) == 2.0


def test_rebuilds_per_step_counts_the_window_instants(recorded):
    w = window([('k', 100, 200), ('k', 300, 400)], steps=4)
    recorded([sp('sampler.step', 100, 400)],
             [Instant('rebuild.pack', 50, 1), Instant('rebuild.plan', 150, 1),
              Instant('rebuild.triton', 390, 2), Instant('other.count', 200, 5),
              Instant('rebuild.nvcc', 401, 1)])
    assert S.rebuilds_per_step(Ctx(w)) == 3 / 4
    assert harness.reader('rebuilds_per_step.gen')(Ctx(w)) == 3 / 4


def test_readers_give_none_without_the_program_recorder(recorded, monkeypatch):
    """No span in the window, or a program without a recorder (a tree that
    predates it): every new metric reads None, and none raises."""
    w = window([('k', 100, 200), ('k', 300, 400)], [('cudaLaunchKernel', 150, 151)])
    names = [f'{m}.gen{b}' for m in ('idle_ops_ms', 'idle_unet_ms', 'idle_sampler_ms',
                                     'launches_per_forward', 'rebuilds_per_step')
             for b in ('', '.b1')]
    recorded([sp('unet.forward', 500, 600)])
    assert all(harness.reader(n)(Ctx(w)) is None for n in names)
    monkeypatch.setitem(sys.modules, 'meshdiffusion_tpu_torch.utils.trace', None)
    recorded([sp('unet.forward', 100, 400)])
    assert all(harness.reader(n)(Ctx(w)) is None for n in names)
