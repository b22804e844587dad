"""histogram_ms.grid: the device time of the program's mjt.grid.histogram
device spans (the Huffman statistics' counting, CUDA events) of the
window, per frame."""

from benchmark import program_trace


def read(rec):
    return program_trace.frame_ms(rec, {"mjt.grid.histogram"}, device=True)
