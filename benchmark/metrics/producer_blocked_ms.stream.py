"""producer_blocked_ms.stream: the stream's producer waiting to hand a
decoded batch on, per batch (last_stream_stats producer_blocked_s /
batches)."""

from benchmark import program_trace


def read(rec):
    return program_trace.stream_ms(rec, "producer_blocked_s")
