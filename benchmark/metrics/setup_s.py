"""setup_s: seconds from the start of the process to the start of the
window (imports, CUDA start-up, the inputs made from the seed, the
program's set-up and warm-up, and any build or compile)."""


def read(rec):
    return rec["setup_s"]
