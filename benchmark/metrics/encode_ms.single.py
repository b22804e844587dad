"""encode_ms.single: the mean seconds per watermark() call spent in the
program's encoders (``codec.encode``, ``codec.encode_splice_band``), from
the benchmark's span around them in the traced run (drivers/call.py)."""


def read(rec):
    calls = rec["counters"].get("calls")
    if not calls:
        return None
    return sum(c["encode_span_s"] for c in calls) / len(calls) * 1e3
