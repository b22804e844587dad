"""device_idle.grid: the share of the traced window in which no
operation (kernel, copy or memset) ran on the card."""

from benchmark import stats


def read(rec):
    return stats.device_idle_pct(rec)
