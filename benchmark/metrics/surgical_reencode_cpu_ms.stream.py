"""surgical_reencode_cpu_ms.stream: the thread CPU time of the surgical
re-encodes (mini encode, its re-scan, the splice join) per batch
(last_stream_stats surgical_reencode_cpu_s / batches), part of
encode_cpu_ms.stream."""

from benchmark import program_trace


def read(rec):
    return program_trace.stream_ms(rec, "surgical_reencode_cpu_s")
