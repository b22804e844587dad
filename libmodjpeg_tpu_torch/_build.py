"""Build and load the package's hand-written CUDA kernels.

The sources under ``csrc/`` export a plain C interface, so they are compiled
by ``nvcc`` alone (no PyTorch headers) into one shared library at first use
and loaded with ``ctypes``.  The library lives in ``build/torch_kernels/``
at the repository root and its file name carries a hash of the sources and
flags, so an edited source never loads a stale build.  There is no fallback:
a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = (os.path.join(CSRC, "compose.cu"),)
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")

# argtypes of each C entry point: pointers and the stream as c_void_p (a
# Python int passed without them would be cut to 32 bits), counts as
# c_longlong; every entry point returns a CUDA error code as int
_P, _N = ctypes.c_void_p, ctypes.c_longlong
SIGNATURES = {
    # region, region_si, region_sy, quant, quant_si, dropon, mask, dm_si,
    # out, out_si, out_sy, n, h, w, u, ut, stream
    "mjt_compose_rows": [_P, _N, _N, _P, _N, _P, _P, _N, _P, _N, _N, _N,
                         _N, _N, _P, _P, _P],
    # image, x0, mask, out, n, stream
    "mjt_blend_blocks": [_P, _P, _P, _P, _N, _P],
}

_lock = threading.Lock()
_lib = None
# what the last build in this process reported: seconds and compiler output
last_build: dict = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def nvcc_command(nvcc: str, out_path: str, sources=SOURCES) -> list:
    """The nvcc command line that builds ``sources`` into ``out_path``."""
    return [nvcc, *NVCC_FLAGS, "-o", out_path, *sources]


def library_path(sources=SOURCES) -> str:
    """Build-output path keyed by the sources' contents and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmjt_torch_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless this exact build exists; return its path.
    Records the seconds taken and nvcc's output in ``last_build``."""
    path = library_path()
    if os.path.exists(path):
        last_build.update(seconds=0.0, output="(cached)", path=path)
        return path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        r = subprocess.run(nvcc_command(nvcc, tmp), capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                               f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    last_build.update(seconds=time.perf_counter() - t0,
                      output=(r.stdout + r.stderr).strip(), path=path)
    return path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _lib = lib
        return _lib
