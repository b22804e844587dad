"""What the program counts and spans about itself, for the metric readers
(metrics/<name>.py): the stream's ``last_stream_stats`` counters per batch
or per call, and the spans of ``libmodjpeg_tpu_torch.tracing`` that ended
inside the measured window, per frame.

Each reader returns None, never a partial figure, when its counter or its
spans are missing (a program without them, or an untraced run) or when
the program's span buffer dropped spans inside the window.
"""

from __future__ import annotations


def stream_ms(rec, key: str):
    """The stream's counter ``key`` (seconds) per batch, in ms."""
    st = rec["counters"].get("stream")
    if not st or not st.get("batches") or key not in st:
        return None
    return st[key] / st["batches"] * 1e3


def call_mean_ms(rec, *keys: str):
    """The mean per watermark() call of the sum of the stream's counters
    ``keys`` (seconds), in ms."""
    calls = rec["counters"].get("calls")
    if not calls or any(k not in c for c in calls for k in keys):
        return None
    return sum(c[k] for c in calls for k in keys) / len(calls) * 1e3


def window_spans(rec, names):
    """The program's spans named in ``names`` that ended between the
    window's first request and its end, or None."""
    if not rec["starts"] or "window_end" not in rec:
        return None
    try:
        from libmodjpeg_tpu_torch import tracing
    except ImportError:             # a program without spans
        return None
    got, dropped = tracing.spans(min(rec["starts"]), rec["window_end"])
    if dropped:
        return None
    return [s for s in got if s.name in names] or None


def frame_ms(rec, names, device: bool = False):
    """The spans ``names`` of the window per completed frame, in ms: their
    host durations, or with ``device`` their device times (None when one
    of them has none)."""
    spans = window_spans(rec, names)
    if spans is None or not rec["ends"]:
        return None
    if device:
        ms = [s.device_ms for s in spans]
        if any(m is None for m in ms):
            return None
        total = sum(ms)
    else:
        total = sum(s.end - s.start for s in spans) * 1e3
    return total / len(rec["ends"])
