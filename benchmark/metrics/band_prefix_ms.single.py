"""band_prefix_ms.single: the mean per watermark() call of the native band
decode's first phase, the destuff and the prefix skip walk
(last_stream_stats band_prefix_s)."""

from benchmark import program_trace


def read(rec):
    return program_trace.call_mean_ms(rec, "band_prefix_s")
