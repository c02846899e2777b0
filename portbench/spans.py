"""Reading the program's own spans and counters over a profiled window.

The port records spans around its layers' host code while a profiler
records (``meshdiffusion_tpu_torch/utils/trace.py``): ``sampler.step``,
``unet.forward``, ``unet.resblock``, ``unet.attn`` and ``ops.<wrapper>``,
and an instant at each rebuild (``rebuild.*``), on the clock of the
profiler's records (``time.time_ns()``). The readers here run in the
run's process after the window and read the recorder's buffer: the spans
and instants that fall in the window ``[t0, t1]``, clipped to it. A tree
whose program has no recorder, or that recorded nothing in the window,
gives None, and its metrics are left out of the line.

A span's layer is the first part of its name (``ops``, ``unet``,
``sampler``). Each device-idle gap of the window (between
``Window.busy_intervals()``) is split at the spans' edges, and each piece
goes to the layer of the innermost span open over it, or to ``outside``
where none is (the harness's own code: the noise draws, the captures, the
trace's ticks); the pieces add up to the window's idle time exactly.
"""

from __future__ import annotations

import heapq
import importlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


def program(ctx) -> Optional[Tuple[list, list]]:
    """(spans, instants) of the program's recorder in ``ctx.window``: the
    spans closed that overlap it, and the instants inside it; None where
    there is no recorder or no span in the window."""
    try:
        trace = importlib.import_module('meshdiffusion_tpu_torch.utils.trace')
    except ImportError:
        return None
    w = ctx.window
    sp = [s for s in trace.spans() if s.t1 is not None and s.t1 > w.t0 and s.t0 < w.t1]
    if not sp:
        return None
    return sp, [x for x in trace.instants() if w.t0 <= x.t <= w.t1]


def layer(name: str) -> str:
    return name.split('.')[0]


def segments(spans: list, t0: int, t1: int, key=layer) -> List[Tuple[int, int, str]]:
    """[(a, b, key(name))] covering [t0, t1] in order, cut at every span's
    edge: the key (by default the layer) of the innermost span open over
    each piece (the latest started; of two started together, the later
    recorded), ``outside`` where none is."""
    cuts = sorted({t0, t1, *(min(t1, max(t0, t)) for s in spans for t in (s.t0, s.t1))})
    order = sorted(range(len(spans)), key=lambda k: (spans[k].t0, k))
    heap: List[Tuple[int, int]] = []
    out, j = [], 0
    for a, b in zip(cuts, cuts[1:]):
        while j < len(order) and spans[order[j]].t0 <= a:
            heapq.heappush(heap, (-spans[order[j]].t0, -order[j]))
            j += 1
        while heap and spans[-heap[0][1]].t1 <= a:
            heapq.heappop(heap)
        out.append((a, b, key(spans[-heap[0][1]].name) if heap else 'outside'))
    return out


def gaps(window) -> List[Tuple[int, int]]:
    """The window's device-idle intervals, in order."""
    out, prev = [], window.t0
    for s, e in window.busy_intervals():
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    if window.t1 > prev:
        out.append((prev, window.t1))
    return out


def idle_by_layer(window, spans: list, key=layer) -> Dict[str, int]:
    """The window's device-idle ns by the layer (or another ``key`` of the
    name) of the innermost program span open at the time (``outside`` where
    none is); the values add up to the window's idle ns."""
    out: Dict[str, int] = defaultdict(int)
    segs = segments(spans, window.t0, window.t1, key)
    i = 0
    for g0, g1 in gaps(window):
        while segs[i][1] <= g0:
            i += 1
        k = i
        while k < len(segs) and segs[k][0] < g1:
            a, b, name = segs[k]
            out[name] += min(b, g1) - max(a, g0)
            k += 1
    return dict(out)


def idle_ms(ctx, name: str) -> Optional[float]:
    """Device-idle ms a step under the ``name`` layer's spans."""
    got = program(ctx)
    if got is None:
        return None
    return idle_by_layer(ctx.window, got[0]).get(name, 0) * 1e-6 / ctx.forwards


def launches_per_forward(ctx) -> Optional[float]:
    """Kernel launch records of the window's host side (CUDA runtime calls
    whose names hold ``LaunchKernel``) that start inside a ``unet.forward``
    span, over the window's forwards."""
    got = program(ctx)
    if got is None or not ctx.window.runtime:
        return None
    w = ctx.window
    fwd = sorted((max(s.t0, w.t0), min(s.t1, w.t1)) for s in got[0] if s.name == 'unet.forward')
    n = sum(1 for name, s, _ in w.runtime if 'LaunchKernel' in name
            and any(a <= s <= b for a, b in fwd))
    return n / ctx.forwards


def rebuilds_per_step(ctx) -> Optional[float]:
    """``rebuild.*`` instants in the window, per step."""
    got = program(ctx)
    if got is None:
        return None
    return sum(x.n for x in got[1] if x.name.startswith('rebuild.')) / ctx.forwards
