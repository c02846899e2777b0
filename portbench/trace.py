"""Reading a torch.profiler window over the card.

In a ``--trace 1`` run the harness profiles a few steps in the middle of
the window with the profiler's CUDA activity alone: kernels, copies and
sets on the device, and the CUDA runtime calls on the host. (Recording
every host op as well costs tens of microseconds an op, which at res64 and
batch 1 doubled a step and made the device idle half the time.) The steps
begin after a ``torch.cuda.synchronize()`` and end with one, so the window
is the span from the first device operation's start to the last one's end.

The profiler has been seen to drop records of some launches late in a long
run; a per-kernel figure is read only from a window that recorded every
launch expected of its kernel (the counts check of ``chip_smoke.py``'s
``_window_full`` at commit 5c79c5a): the readers return None otherwise.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

# the port's hand-written kernels, by substrings of their names in a trace
OWN_KERNELS = {
    'gn_silu_conv3d': ('gn_silu_conv3d_kernel', 'splitk_reduce_kernel'),
    'gn_stats': ('gn_stats_kernel',),
    'groupnorm_silu_apply': ('_gn_silu_apply_kernel',),
    'ancestral_update': ('_ancestral_kernel',),
    'tile_zmin': ('tile_zmin_kernel',),
}


def short(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and
    template and call arguments."""
    name = re.sub(r'^void ', '', name)
    name = re.sub(r'\(anonymous namespace\)::', '', name)
    for sep in ('<', '('):
        name = name.split(sep)[0]
    return name[:120]


class Window:
    """One profiled window: ``device`` [(name, start_ns, end_ns)] sorted by
    start, the host's CUDA runtime calls ``runtime`` [(name, start_ns,
    end_ns)], the window (t0, t1) in ns, and ``steps``, the sampler steps
    it covers."""

    def __init__(self, prof, steps: int):
        from torch.autograd import DeviceType
        self.steps = steps
        self.device: List[Tuple[str, int, int]] = []
        self.runtime: List[Tuple[str, int, int]] = []
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns()
            row = (e.name(), s, s + e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    self.device.append(row)
            elif row[0].startswith('cu'):
                self.runtime.append(row)
        self.device.sort(key=lambda r: r[1])
        self.runtime.sort(key=lambda r: r[1])
        self.t0 = min((s for _, s, _ in self.device), default=0)
        self.t1 = max((e for _, _, e in self.device), default=0)
        self._rt_starts = [s for _, s, _ in self.runtime]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for _, s, e in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def count(self, names: Iterable[str]) -> int:
        """Launches recorded of the kernel whose name holds ``names[0]``."""
        first = tuple(names)[0]
        return sum(1 for n, _, _ in self.device if first in n)

    def device_s(self, names: Optional[Iterable[str]] = None) -> float:
        """Device seconds of the operations whose name holds one of
        ``names`` (all operations when None)."""
        names = None if names is None else tuple(names)
        return sum(e - s for n, s, e in self.device
                   if names is None or any(k in n for k in names)) * 1e-9

    def own_s(self) -> float:
        return self.device_s(tuple(k for ks in OWN_KERNELS.values() for k in ks))

    def host_at(self, t: int) -> str:
        """The CUDA runtime call the host was in at ``t``, or ``python``."""
        i = bisect.bisect_right(self._rt_starts, t) - 1
        if i >= 0 and self.runtime[i][2] >= t:
            return self.runtime[i][0]
        return 'python'

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """{'device_ops': [[kernel, s]], 'idle_gaps': [[what the host was
        doing, before which device operation, s]]}, the ``top`` largest of
        each, summed by name."""
        ops: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            ops[short(n)] += (e - s) * 1e-9
        gaps: Dict[str, float] = defaultdict(float)
        nxt = {s: n for n, s, _ in reversed(self.device)}
        prev = self.t0
        for s, e in self.busy_intervals():
            if s > prev:
                key = f'host in {self.host_at((prev + s) // 2)}; device then runs {short(nxt[s])}'
                gaps[key] += (s - prev) * 1e-9
            prev = max(prev, e)

        def best(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {'device_ops': best(ops), 'idle_gaps': best(gaps)}
