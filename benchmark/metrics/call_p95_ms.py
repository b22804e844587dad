"""call_p95_ms: the 95th percentile of every watermark() call of the
window, one caller, closed loop."""

from benchmark import stats


def read(rec):
    return stats.p95_ms(rec)
