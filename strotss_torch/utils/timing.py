"""Timing: the reference's start/stop wall clock, a CUDA-event timer, and
the program's spans and counters.

PyTorch returns before the card finishes its work, so a host clock around
CUDA work measures the enqueue; ``CudaTimer`` records events on the
current stream and reads the time between them once they have completed.

Spans mark the layer boundaries of a stylization on the host (the call,
each scale and its set-up, each step and its parts: see ``PERF.md`` §3
for the names). :func:`span` is one flag check while no :func:`tracing`
block is open: it returns a shared no-op object, reads no clock and
records nothing. Inside one, on the thread that opened it, each span is
kept in memory as a :class:`Span`, its times on the clock of
``torch.profiler``'s host events (``perf_counter_ns`` shifted to Unix
epoch ns by an offset taken once when tracing starts), so that a span
lines up with the operators and runtime calls a profile records inside
it. Spans are not ``torch.profiler.record_function`` ranges: those cost
~14 µs each with no profiler running and are mirrored onto the device's
timeline, where they would read as device activity.

Counters (:func:`count`) are always on: a dict of integers the kernels'
wrappers add their launches to (``launch.<kernel>``). They are
incremented from the autograd engine's thread too, while the thread that
called the backward pass waits for it. A step replayed from a CUDA graph
(:mod:`strotss_torch.graphs`) runs no Python: its launches count once,
when the graph is captured, and the graph counters count the rest
(``graph.capture``, ``graph.replay`` a step; ``graph.hit``,
``graph.miss`` a step-layer call that found its graph captured or not).
Such a step's span is ``step``, holding ``step.capture`` (the step's own
spans inside it) where it is captured and ``step.replay``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch


class Timer:
    """start()/stop() wall clock; elapsed rounded to 3 decimals."""

    def __init__(self):
        self._start = 0.0
        self._elapsed = 0.0

    def start(self):
        self._start = time.time()

    def stop(self):
        self._elapsed = round(time.time() - self._start, 3)
        self._start = 0.0

    @property
    def elapsed_time(self) -> float:
        return self._elapsed


class CudaTimer:
    """Device time of the work enqueued between ``start()`` and ``stop()``.

    ``seconds()`` waits for the stop event. Use it only on a CUDA device.
    """

    def __init__(self):
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)

    def start(self):
        self._start.record()

    def stop(self):
        self._end.record()

    def seconds(self) -> float:
        self._end.synchronize()
        return self._start.elapsed_time(self._end) / 1e3


class Span(NamedTuple):
    """One recorded span: Unix-epoch ns on the profiler's host clock, the
    index of the enclosing span in :attr:`Trace.spans` (-1 at the top),
    the id of the ``call`` span it lies in (0 outside any) and the
    keyword attributes it was opened with."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    call_id: int
    attrs: dict


class Trace:
    """What a :func:`tracing` block recorded: ``spans``, in the order they
    were opened (a parent before its children), and ``counts``, each
    counter's change over the block (both final once the block closes)."""

    def __init__(self):
        # plain tuples while recording, made :class:`Span` at the close
        self.spans: List = []
        self.counts: Dict[str, int] = {}
        self.thread = threading.get_ident()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.open: List[int] = []  # indices of the open spans
        self.call = 0  # id of the open ``call`` span, 0 outside one
        self.calls = 0


_trace: Optional[Trace] = None
_counts: Dict[str, int] = {}
_now = time.perf_counter_ns
_thread = threading.get_ident


class _Null:
    """The span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """A span being timed, recorded into ``trace`` when that is not
    None."""

    __slots__ = ("trace", "name", "attrs", "index", "start", "end")

    def __init__(self, trace: Optional[Trace], name: str, attrs: dict):
        self.trace, self.name, self.attrs = trace, name, attrs

    @property
    def seconds(self) -> float:
        """The block's seconds, once it has ended."""
        return (self.end - self.start) / 1e9

    def __enter__(self):
        tr = self.trace
        if tr is not None:
            self.index = len(tr.spans)
            tr.spans.append(None)
            tr.open.append(self.index)
        self.start = _now()
        return self

    def __exit__(self, *exc):
        self.end = end = _now()
        tr = self.trace
        if tr is not None:
            stack = tr.open
            stack.pop()
            off = tr.offset_ns
            tr.spans[self.index] = (self.name, self.start + off, end + off,
                                    stack[-1] if stack else -1, tr.call,
                                    self.attrs)
        return False


class _Call(_Open):
    """The ``call`` span: a new call id for the spans inside it."""

    __slots__ = ()

    def __enter__(self):
        self.trace.calls += 1
        self.trace.call = self.trace.calls
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.trace.call = 0
        return False


def span(name: str, **attrs):
    """A context manager around one piece of a layer: recorded as a
    :class:`Span` inside a :func:`tracing` block on this thread, a shared
    no-op otherwise. A span named ``call`` starts a new call id, which
    every span inside it carries."""
    tr = _trace
    if tr is None or tr.thread != _thread():
        return _NULL
    return (_Call if name == "call" else _Open)(tr, name, attrs)


def timed(name: str, **attrs) -> _Open:
    """:func:`span` for a piece whose seconds the program reports itself
    (a scale's ``info`` entry): it always reads the clock, and its
    ``seconds`` (once the block has ended) and the recorded span come
    from the same two reads."""
    tr = _trace
    return _Open(tr if tr is not None and tr.thread == _thread() else None,
                 name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Every counter's value since the process started."""
    return dict(_counts)


@contextlib.contextmanager
def tracing():
    """Record spans on this thread for the body of the ``with``; yields
    the :class:`Trace`, whose ``counts`` hold the counters' changes once
    the block has closed. A block inside another records for itself and
    hands the outer one back when it closes."""
    global _trace
    outer, before = _trace, counters()
    trace = Trace()
    _trace = trace
    try:
        yield trace
    finally:
        _trace = outer
        trace.spans = [Span._make(t) for t in trace.spans]
        trace.counts = {k: v - before.get(k, 0) for k, v in _counts.items()
                        if v != before.get(k, 0)}
