"""Debug and observability helpers: a NaN tripwire, profiler traces, a
step timer.

Counterpart of ``meshdiffusion_tpu/utils/debug.py`` (the reference's
``torch.is_anomaly_enabled()`` finite checks inside every renderutils
wrapper, renderutils/ops.py:109-110, the shader's NaN raises,
render.py:116-122, and fit_dmtets.py:518-531's per-iteration timing).
No path of the package calls these; a caller wraps what it wants checked
or traced.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Optional

import torch

logger = logging.getLogger(__name__)

_ANOMALY = [False]


def set_detect_anomaly(enabled: bool) -> None:
    """The global switch, as ``torch.autograd.set_detect_anomaly``."""
    _ANOMALY[0] = enabled


def anomaly_enabled() -> bool:
    """On when switched on, or when ``MESHDIFFUSION_DETECT_ANOMALY=1``."""
    return _ANOMALY[0] or os.environ.get('MESHDIFFUSION_DETECT_ANOMALY') == '1'


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def check_finite(tree: Any, name: str = 'tensor') -> Any:
    """With anomaly detection on, raise ``FloatingPointError`` if a tensor
    of ``tree`` (a tensor, or a dict, list or tuple nesting them) holds a
    non-finite value; this waits for the device. With it off, return
    ``tree`` untouched, reading nothing."""
    if anomaly_enabled():
        for x in _tensors(tree):
            if not bool(torch.isfinite(x).all()):
                raise FloatingPointError(f'non-finite values in {name}')
    return tree


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` scope (the host, and the card where there is
    one) whose Chrome trace is written under ``log_dir`` when it closes;
    nothing when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    logger.info('profiler trace written to %s', log_dir)


class StepTimer:
    """Per-iteration wall-clock averaging with the remaining time
    (reference fit_dmtets.py:518-531)."""

    def __init__(self, total_iters: int, window: int = 10):
        self.total = total_iters
        self.window = window
        self.durations = []
        self._t0 = None

    def start(self):
        self._t0 = time.time()

    def stop(self, it: int) -> str:
        self.durations.append(time.time() - self._t0)
        recent = self.durations[-self.window:]
        avg = sum(recent) / len(recent)
        remaining = (self.total - it) * avg
        return f'{avg * 1000:.1f} ms/iter, rem={_fmt_time(remaining)}'


def _fmt_time(seconds: float) -> str:
    if seconds > 3600:
        return f'{seconds / 3600:.1f} h'
    if seconds > 60:
        return f'{seconds / 60:.1f} min'
    return f'{seconds:.1f} s'
