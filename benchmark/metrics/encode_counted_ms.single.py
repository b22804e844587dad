"""encode_counted_ms.single: the mean per watermark() call of the stream's
own encode seconds (last_stream_stats encode_s, timed up to the output's
yield)."""

from benchmark import program_trace


def read(rec):
    return program_trace.call_mean_ms(rec, "encode_s")
