"""surgical_extract_ms.stream: the stream producer's wall seconds in the
surgical extracts (whole-file parse, restart-marker scan, crafted
mini-JPEGs) per batch (last_stream_stats surgical_extract_s / batches),
part of decode_ms.stream."""

from benchmark import program_trace


def read(rec):
    return program_trace.stream_ms(rec, "surgical_extract_s")
