"""stream_setup_ms.single: the mean per watermark() call of the stream's
start (pool, queues, route, three threads) and stop (joins, pool
shutdown): last_stream_stats start_s + stop_s."""

from benchmark import program_trace


def read(rec):
    return program_trace.call_mean_ms(rec, "start_s", "stop_s")
