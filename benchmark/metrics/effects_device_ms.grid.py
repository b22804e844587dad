"""effects_device_ms.grid: the device time of the program's mjt.grid.effect
and mjt.grid.compose device spans (CUDA events) of the window, per
frame."""

from benchmark import program_trace


def read(rec):
    return program_trace.frame_ms(
        rec, {"mjt.grid.effect", "mjt.grid.compose"}, device=True)
