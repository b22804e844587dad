"""decode_ms.stream: the stream producer's decode seconds per batch
(last_stream_stats decode_s / batches)."""

from benchmark import stats


def read(rec):
    return stats.stream_stage_ms(rec, "decode_s")
