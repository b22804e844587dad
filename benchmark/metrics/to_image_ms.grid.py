"""to_image_ms.grid: the program's mjt.grid.to_image spans (the grids' copy
to the host and the host image) of the window, per frame."""

from benchmark import program_trace


def read(rec):
    return program_trace.frame_ms(rec, {"mjt.grid.to_image"})
