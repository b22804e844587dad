"""dropon_compile_ms.grid: the program's mjt.grid.compile spans (the logo's
placement and compile in GridSession.compose) of the window, per frame."""

from benchmark import program_trace


def read(rec):
    return program_trace.frame_ms(rec, {"mjt.grid.compile"})
