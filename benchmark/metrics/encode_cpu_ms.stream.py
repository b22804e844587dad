"""encode_cpu_ms.stream: the thread CPU time of the stream's encode tasks
per batch (last_stream_stats encode_cpu_s / batches)."""

from benchmark import program_trace


def read(rec):
    return program_trace.stream_ms(rec, "encode_cpu_s")
