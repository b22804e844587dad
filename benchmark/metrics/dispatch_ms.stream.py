"""dispatch_ms.stream: the dispatcher's pack + host->device seconds per
batch (last_stream_stats pack_dispatch_s / batches)."""

from benchmark import stats


def read(rec):
    return stats.stream_stage_ms(rec, "pack_dispatch_s")
