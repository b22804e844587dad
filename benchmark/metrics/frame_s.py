"""frame_s: the whole window (first frame started to last frame done)
over the frames completed in it."""

from benchmark import stats


def read(rec):
    s = stats.span_s(rec)
    return s / len(rec["ends"]) if s else None
