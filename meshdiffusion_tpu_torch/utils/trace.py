"""The program's own spans and counters, on the profiler's clock.

A span (:class:`span`) marks a piece of the program's host code: a sampler
step (``sampler.step``), a U-Net forward and its blocks (``unet.forward``,
``unet.resblock``, ``unet.attn``), a kernel wrapper's call (``ops.<wrapper>``).
It records only while a ``torch.profiler`` records
(``torch.autograd._profiler_enabled()``, whatever the profiler's
activities); otherwise that check is all it costs. A recorded span is
``Span(name, t0, t1, parent, step, attrs)`` in a bounded buffer on the
host: its start and end in ``time.time_ns()``, the clock on which kineto
stamps its host and device records; the index of the enclosing recorded
span (-1 at the top); and the sampler step in force, the ``i`` attribute of
the nearest enclosing span that has one (-1 outside any). A span reads no
tensor, never synchronizes the device and allocates nothing on it.

A counter (:func:`count`) is a plain integer, always on, bumped only where
something is built again: a conv's weights repacked or relaid
(``rebuild.pack``, ``rebuild.dhwio``), a launch plan made (``rebuild.plan``),
a kernel scratch grown (``rebuild.scratch``), a Triton kernel compiled for a
new specialization (``rebuild.triton``), the nvcc library built or loaded
(``rebuild.nvcc``). While a profiler records, each bump also leaves an
``Instant(name, t, n)`` in the buffer, so that a reader can count those of
a window.

The buffer and the stack of open spans are the process's, one for all
callers: spans that two threads opened at once would nest into each
other. The program opens them from the one thread that runs its steps.

Readers: :func:`spans`, :func:`instants`, :func:`counts`, :func:`dropped`;
:func:`clear` empties the buffer. :func:`profile_trace` is the operator's
exporter: a profiler scope whose Chrome trace also holds the program's
spans and instants of its window.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import socket
import time
from typing import Dict, List, NamedTuple, Optional

import torch

logger = logging.getLogger(__name__)

CAPACITY = 1 << 19       # spans and instants the buffer holds; past it they are dropped

_enabled = torch.autograd._profiler_enabled
_now = time.time_ns


class Span(NamedTuple):
    name: str
    t0: int                   # ns, time.time_ns()
    t1: Optional[int]         # None while the span is open
    parent: int               # index in spans() of the enclosing recorded span, or -1
    step: int                 # the sampler step in force, or -1
    attrs: Optional[dict]


class Instant(NamedTuple):
    name: str
    t: int
    n: int


_spans: List[list] = []       # [name, t0, t1, parent, step, attrs] in the order opened
_instants: List[Instant] = []
_stack: List[int] = []        # indices of the open recorded spans, innermost last
_counts: Dict[str, int] = {}
_step = -1                    # the sampler step in force
_dropped = 0


def _open(name: str, attrs: Optional[dict]) -> Optional[list]:
    global _dropped
    if len(_spans) >= CAPACITY:
        _dropped += 1
        return None
    rec = [name, _now(), None, _stack[-1] if _stack else -1, _step, attrs]
    _stack.append(len(_spans))
    _spans.append(rec)
    return rec


def _close(rec: list) -> None:
    rec[2] = _now()
    if _stack and _spans[_stack[-1]] is rec:
        _stack.pop()


class span:
    """``with span(name, **attrs):`` records the block as a span while a
    profiler records; ``@span(name)`` does so for every call of a function.
    An ``i`` attribute sets the sampler step of the spans inside (even when
    nothing records, so that a profiler started inside a step still ties
    that step's spans to it). A span object is entered once; the decorator
    form may nest and recurse."""

    __slots__ = ('name', 'attrs', '_rec', '_prev')

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs or None

    def __enter__(self) -> 'span':
        global _step
        attrs = self.attrs
        if attrs is not None and 'i' in attrs:
            self._prev, _step = _step, attrs['i']
        self._rec = _open(self.name, attrs) if _enabled() else None
        return self

    def __exit__(self, *exc) -> None:
        global _step
        if self._rec is not None:
            _close(self._rec)
        if self.attrs is not None and 'i' in self.attrs:
            _step = self._prev

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _enabled():
                return fn(*args, **kwargs)
            rec = _open(name, None)
            try:
                return fn(*args, **kwargs)
            finally:
                if rec is not None:
                    _close(rec)
        return wrapper


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``; while a profiler records, also leave an
    instant of it in the buffer."""
    global _dropped
    _counts[name] = _counts.get(name, 0) + n
    if _enabled():
        if len(_instants) < CAPACITY:
            _instants.append(Instant(name, _now(), n))
        else:
            _dropped += 1


def spans() -> List[Span]:
    """The recorded spans in the order they were opened (``parent`` indexes
    this list)."""
    return [Span(*r) for r in _spans]


def instants() -> List[Instant]:
    return list(_instants)


def counts() -> Dict[str, int]:
    """Every counter's total since the process started."""
    return dict(_counts)


def dropped() -> int:
    """Spans and instants not recorded because the buffer was full."""
    return _dropped


def clear() -> None:
    """Empty the buffer (the counters keep their totals)."""
    global _dropped
    _spans.clear()
    _instants.clear()
    _stack.clear()
    _dropped = 0


def chrome_events(t_from: int, base_ns: int = 0) -> List[dict]:
    """The spans closed and instants taken since ``t_from`` (ns) as Chrome
    trace events, ``ts`` in µs from ``base_ns``, on a track of their own."""
    pid, tid = os.getpid(), 0
    out = [{'name': 'thread_name', 'ph': 'M', 'pid': pid, 'tid': tid,
            'args': {'name': 'meshdiffusion_tpu_torch spans'}}]
    for s in spans():
        if s.t1 is not None and s.t0 >= t_from:
            out.append({'name': s.name, 'cat': 'program', 'ph': 'X', 'pid': pid, 'tid': tid,
                        'ts': (s.t0 - base_ns) / 1e3, 'dur': (s.t1 - s.t0) / 1e3,
                        'args': dict(s.attrs or {}, step=s.step)})
    for x in _instants:
        if x.t >= t_from:
            out.append({'name': x.name, 'cat': 'program', 'ph': 'i', 's': 't', 'pid': pid,
                        'tid': tid, 'ts': (x.t - base_ns) / 1e3, 'args': {'n': x.n}})
    return out


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` scope (the host, and the card where there is
    one) whose Chrome trace is written under ``log_dir`` when it closes,
    also when the scope raises, with the program's spans and instants of
    the scope beside the profiler's events; nothing when ``log_dir`` is
    falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t_from, started = _now(), False
    try:
        with profile(activities=activities) as prof:
            started = True
            yield
    finally:
        if started:
            _export(prof, log_dir, t_from)


def _export(prof, log_dir: str, t_from: int) -> None:
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f'{socket.gethostname()}_{os.getpid()}.{t_from // 10 ** 6}'
                                 '.pt.trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc['traceEvents'].extend(chrome_events(t_from, int(doc.get('baseTimeNanoseconds', 0))))
    with open(path, 'w') as f:
        json.dump(doc, f)
    logger.info('profiler trace written to %s', path)
