"""decode_cpu_ms.stream: the thread CPU time of the stream's decode tasks
per batch (last_stream_stats decode_cpu_s / batches)."""

from benchmark import program_trace


def read(rec):
    return program_trace.stream_ms(rec, "decode_cpu_s")
