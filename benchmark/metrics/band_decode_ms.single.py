"""band_decode_ms.single: the mean per watermark() call of the native band
decode's second phase, the decode of the band's MCU rows
(last_stream_stats band_decode_s)."""

from benchmark import program_trace


def read(rec):
    return program_trace.call_mean_ms(rec, "band_decode_s")
