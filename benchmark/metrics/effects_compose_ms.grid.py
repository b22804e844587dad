"""effects_compose_ms.grid: the mean seconds per frame of the benchmark's
``effects_compose`` span around that step of the chain."""

from benchmark import stats


def read(rec):
    return stats.span_mean_ms(rec, "effects_compose")
