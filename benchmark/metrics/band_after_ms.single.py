"""band_after_ms.single: the mean per watermark() call of the native band
decode's third phase, the band-end re-walk and the suffix skip walk
(last_stream_stats band_after_s)."""

from benchmark import program_trace


def read(rec):
    return program_trace.call_mean_ms(rec, "band_after_s")
