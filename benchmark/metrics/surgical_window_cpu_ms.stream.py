"""surgical_window_cpu_ms.stream: the thread CPU time of the surgical
window decodes (the crafted mini-JPEGs) per batch (last_stream_stats
surgical_window_cpu_s / batches), part of decode_cpu_ms.stream."""

from benchmark import program_trace


def read(rec):
    return program_trace.stream_ms(rec, "surgical_window_cpu_s")
