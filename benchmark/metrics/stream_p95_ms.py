"""stream_p95_ms: the 95th percentile, over every file of the window, of
the time from when the stream's producer takes a file from the input
iterator to when its output is yielded."""

from benchmark import stats


def read(rec):
    return stats.p95_ms(rec)
