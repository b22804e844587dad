"""consumer_starved_ms.stream: the stream's consumer waiting for a fetched
batch, per batch (last_stream_stats consumer_idle_s / batches)."""

from benchmark import program_trace


def read(rec):
    return program_trace.stream_ms(rec, "consumer_idle_s")
