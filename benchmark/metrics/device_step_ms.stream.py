"""device_step_ms.stream: the device step per batch: from before its first
host->device copy to the end of its device->host copy, CUDA events on
the composer's stream (last_stream_stats device_step_s / batches, traced
runs)."""

from benchmark import program_trace


def read(rec):
    return program_trace.stream_ms(rec, "device_step_s")
