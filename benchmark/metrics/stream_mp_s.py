"""stream_mp_s: megapixels of every answer over the whole window, from
the first file the stream takes to the last output it yields."""

from benchmark import stats


def read(rec):
    s = stats.span_s(rec)
    return sum(rec["pixels"]) / s / 1e6 if s else None
