"""grid_encode_ms.grid: the program's mjt.grid.encode spans (the host
encode in to_jpeg) of the window, per frame."""

from benchmark import program_trace


def read(rec):
    return program_trace.frame_ms(rec, {"mjt.grid.encode"})
