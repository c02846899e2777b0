"""Debug helpers: a NaN tripwire, and profiler traces.

Counterpart of ``meshdiffusion_tpu/utils/debug.py`` (the reference's
``torch.is_anomaly_enabled()`` finite checks inside every renderutils
wrapper, renderutils/ops.py:109-110, and the shader's NaN raises,
render.py:116-122). No path of the package calls these; a caller wraps
what it wants checked or traced. :func:`profile_trace` is the recorder's
exporter (``utils/trace.py``): its Chrome trace holds the program's own
spans beside the profiler's events. The reference's per-iteration timer
(fit_dmtets.py:518-531) has no counterpart: the fit logs each pass's time
and the steps it ran itself (``fitting/fit.py``, the ``fit_pass`` record).
"""

from __future__ import annotations

import os
from typing import Any

import torch

from .trace import profile_trace  # noqa: F401

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
