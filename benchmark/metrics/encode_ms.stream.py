"""encode_ms.stream: the consumer's encode seconds per batch
(last_stream_stats encode_s / batches)."""

from benchmark import stats


def read(rec):
    return stats.stream_stage_ms(rec, "encode_s")
