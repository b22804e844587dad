"""decode_ms.single: the program's decode seconds per watermark() call
(last_stream_stats decode_s after each call)."""


def read(rec):
    calls = rec["counters"].get("calls")
    if not calls:
        return None
    return sum(c["decode_s"] for c in calls) / len(calls) * 1e3
