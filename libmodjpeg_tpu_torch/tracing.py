"""Spans inside libmodjpeg_tpu_torch: where the program's own time goes.

A span is a named interval on the host clock (``time.perf_counter``) with
its thread, the span that enclosed it on that thread (its parent) and the
ids of the request it belongs to (``stream``, ``batch`` and ``file`` in
``watermark_stream``, ``session`` in ``GridSession``; a span without ids
of its own takes its parent's).  A device span also brackets the work
queued on a CUDA stream with a pair of timing events, resolved to
milliseconds only when it is read (``Span.device_ms``), so taking one adds
no synchronisation.

Spans are taken only while tracing is on: while a torch profiler records,
or inside ``with recording():``.  Then each host span is also a
``torch.profiler.record_function`` of its name, so it lands in the
profiler's trace on the profiler's clock.  With tracing off, ``span`` and
``device_span`` read the flag and return a shared no-op context: no span,
no event, no annotation.

Every span closed goes into one bounded in-memory buffer (``CAPACITY``
spans, the oldest dropped first); ``spans(since, until)`` reads it.
Names are stable, start with ``mjt.``, and carry no ids.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 65536

_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_lock = threading.Lock()
_dropped = 0                 # spans pushed out of the full buffer
_last_dropped_end = float("-inf")
_recording = 0               # open recording() blocks, all threads
_local = threading.local()   # per thread: the stack of open spans
_OFF = contextlib.nullcontext()


def on() -> bool:
    """True while a torch profiler records or a ``recording()`` is open."""
    return _recording > 0 or _profiler._is_profiler_enabled


@contextlib.contextmanager
def recording():
    """Take spans inside this block, with or without a profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


class Span:
    """One span; also the context manager that takes it."""

    __slots__ = ("name", "start", "end", "thread", "parent", "ids",
                 "_stream", "_events", "_ms", "_annotation")

    def __init__(self, name: str, ids: dict, stream=None):
        self.name = name
        self.ids = ids
        self.start = self.end = None
        self.thread = threading.get_ident()
        self.parent = None
        self._stream = stream
        self._events = None
        self._ms = None
        self._annotation = None

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent = stack[-1].name
            if not self.ids:
                self.ids = stack[-1].ids
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        if self._stream is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record(self._stream)
            self._stream = None
        self.end = time.perf_counter()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        _local.stack.pop()
        _push(self)

    @property
    def end_event(self):
        """The CUDA event recorded where a device span closed, or None."""
        return None if self._events is None else self._events[1]

    @property
    def device_ms(self):
        """Milliseconds between a device span's two events on its stream
        (waits for the second), or None for a host span."""
        if self._ms is None and self._events is not None:
            self._events[1].synchronize()
            self._ms = self._events[0].elapsed_time(self._events[1])
        return self._ms


def _push(sp: Span) -> None:
    global _dropped, _last_dropped_end
    with _lock:
        if len(_buffer) == CAPACITY:
            _dropped += 1
            _last_dropped_end = max(_last_dropped_end, _buffer[0].end)
        _buffer.append(sp)


def span(name: str, **ids):
    """A host span of the ``with`` block, while tracing is on."""
    if not on():
        return _OFF
    return Span(name, ids)


def device_span(name: str, stream=None, **ids):
    """A host span of the ``with`` block that also brackets the work it
    queues on a CUDA stream with a pair of timing events, while tracing is
    on.  ``stream``: a CUDA stream, or a device (its current stream; on a
    CPU device, where work is synchronous, the span is a host span), or
    None (the current CUDA stream)."""
    if not on():
        return _OFF
    if stream is None:
        stream = torch.cuda.current_stream()
    elif isinstance(stream, torch.device):
        stream = (torch.cuda.current_stream(stream)
                  if stream.type == "cuda" else None)
    return Span(name, ids, stream)


class timed:
    """Times a ``with`` block on ``time.perf_counter``: adds its seconds to
    ``stats[key]`` and, while tracing is on, records the same interval as
    the span ``name``."""

    __slots__ = ("stats", "key", "span", "t0")

    def __init__(self, stats: dict, key: str, name: str, **ids):
        self.stats = stats
        self.key = key
        self.span = Span(name, ids) if on() else None

    def __enter__(self) -> "timed":
        if self.span is None:
            self.t0 = time.perf_counter()
        else:
            self.t0 = self.span.__enter__().start
        return self

    def __exit__(self, *exc) -> None:
        if self.span is None:
            t1 = time.perf_counter()
        else:
            self.span.__exit__(*exc)
            t1 = self.span.end
        self.stats[self.key] += t1 - self.t0


def spans(since: float = float("-inf"), until: float = float("inf")):
    """(the spans that ended in [since, until], in the order they ended;
    the number of spans the full buffer dropped, or 0 when every dropped
    span ended before ``since``)."""
    with _lock:
        got = [s for s in _buffer if since <= s.end <= until]
        dropped = _dropped if _last_dropped_end >= since else 0
    return got, dropped


def clear() -> None:
    """Empty the buffer and its count of dropped spans."""
    global _dropped, _last_dropped_end
    with _lock:
        _buffer.clear()
        _dropped = 0
        _last_dropped_end = float("-inf")
