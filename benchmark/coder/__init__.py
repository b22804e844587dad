"""Frozen copy of the ctypes layer of libmodjpeg_tpu_torch/codec (decode and
encode only), around a frozen copy of its native sources in ``native/``
cut to what this layer calls: sequential and progressive Huffman decode,
and baseline, optimized and progressive Huffman encode with restart
markers.

The benchmark's own JPEG coder.  It makes the benchmark's input files from
coefficients the benchmark computed, and it reads back the files the
program wrote so that the reference can judge them.  It is built with g++
at first use into ``build/benchmark_coder/`` at the root of the checkout,
under a file name that carries a hash of the sources and flags, and it
shares nothing with the program's own build.  Images are plain dicts of
numpy arrays, not the program's types.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "native")
SOURCES = ("codec.cpp", "decoder.inc", "encoder.inc", "api.inc")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-w", "-shared",
             "-pthread")
# <checkout>/build/benchmark_coder, beside the program's own build outputs
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(NATIVE_DIR))), "build",
    "benchmark_coder")

OPTION_OPTIMIZE = 1
OPTION_PROGRESSIVE = 2

_lib = None
_lock = threading.Lock()
# seconds the last build in this process took (0.0 when it was cached)
last_build: dict = {}


class CoderError(RuntimeError):
    """The frozen coder refused a file or an image."""


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libbenchcoder_{h.hexdigest()[:16]}.so")


def _build() -> str:
    path = library_path()
    if os.path.exists(path):
        last_build.update(seconds=0.0, path=path)
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        r = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS,
                            os.path.join(NATIVE_DIR, "codec.cpp"), "-o", tmp],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"benchmark coder build failed:\n{r.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    last_build.update(seconds=time.perf_counter() - t0, path=path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.mjt_decode_begin.restype = P
        lib.mjt_decode_begin.argtypes = [ctypes.c_char_p, I64, I32, I64,
                                         ctypes.c_char_p, I64]
        lib.mjt_decode_finish.restype = I32
        lib.mjt_decode_finish.argtypes = [P, ctypes.POINTER(P), I32,
                                          ctypes.c_char_p, I64]
        lib.mjt_free_image.argtypes = [P]
        lib.mjt_get_info.argtypes = [P, ctypes.POINTER(I32)]
        lib.mjt_get_comp_info.argtypes = [P, I32, ctypes.POINTER(I32)]
        lib.mjt_get_qtable.argtypes = [P, I32, ctypes.POINTER(ctypes.c_uint16),
                                       ctypes.POINTER(I32)]
        lib.mjt_get_marker_len.restype = I64
        lib.mjt_get_marker_len.argtypes = [P, I32]
        lib.mjt_get_marker.argtypes = [P, I32, ctypes.POINTER(I32),
                                       ctypes.POINTER(ctypes.c_uint8)]
        lib.mjt_free_buffer.argtypes = [P]
        lib.mjt_encode_ptrs.restype = I32
        lib.mjt_encode_ptrs.argtypes = [
            I32, I32, I32, I32, ctypes.POINTER(I32),
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(P), I32, I32, I32, ctypes.c_char_p, I64,
            ctypes.POINTER(P), ctypes.POINTER(I64), ctypes.c_char_p, I64]
        _lib = lib
        return lib


def decode(data: bytes, nthreads: int = 1) -> dict:
    """JPEG bytes -> {"width", "height", "comps": [(id, h, v, tq)],
    "coefs": [int16 [rows, cols, 8, 8] per component, natural order],
    "qtables": {slot: uint16 [8, 8]}, "markers": [(code, payload)],
    "progressive", "restart_interval"}."""
    lib = _load()
    err = ctypes.create_string_buffer(512)
    h = lib.mjt_decode_begin(data, len(data), nthreads, 0, err, len(err))
    if not h:
        raise CoderError(err.value.decode("utf-8", "replace"))
    try:
        info = (ctypes.c_int32 * 9)()
        lib.mjt_get_info(h, info)
        width, height, ncomps, _jcs, prog = list(info)[:5]
        comps, coefs = [], []
        for c in range(ncomps):
            ci = (ctypes.c_int32 * 8)()
            lib.mjt_get_comp_info(h, c, ci)
            cid, hs, vs, tq, _wib, _hib, pw, ph = list(ci)
            comps.append((cid, hs, vs, tq))
            coefs.append(np.zeros((ph, pw, 8, 8), np.int16))
        ptrs = (ctypes.c_void_p * max(ncomps, 1))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in coefs])
        if lib.mjt_decode_finish(h, ptrs, 1, err, len(err)) != 0:
            raise CoderError(err.value.decode("utf-8", "replace"))
        qtables = {}
        for t in range(4):
            tbl = np.empty((8, 8), np.uint16)
            present = ctypes.c_int32(0)
            lib.mjt_get_qtable(
                h, t, tbl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                ctypes.byref(present))
            if present.value:
                qtables[t] = tbl
        lib.mjt_get_info(h, info)
        markers = []
        for i in range(info[7]):
            n = lib.mjt_get_marker_len(h, i)
            buf = (ctypes.c_uint8 * max(n, 1))()
            code = ctypes.c_int32(0)
            lib.mjt_get_marker(h, i, ctypes.byref(code), buf)
            markers.append((code.value, bytes(buf[:n])))
        return {"width": width, "height": height, "comps": comps,
                "coefs": coefs, "qtables": qtables, "markers": markers,
                "progressive": bool(prog), "restart_interval": info[6]}
    finally:
        lib.mjt_free_image(h)


def encode(img: dict, options: int = 0, restart_interval: int = 0,
           nthreads: int = 1) -> bytes:
    """An image dict as ``decode`` returns it -> JPEG bytes (standard Annex K
    Huffman tables unless ``options`` has OPTION_OPTIMIZE)."""
    lib = _load()
    comps = img["comps"]
    meta = np.asarray([v for c in comps for v in c], np.int32)
    planes = [np.ascontiguousarray(a, np.int16) for a in img["coefs"]]
    ptrs = (ctypes.c_void_p * len(planes))(
        *[p.ctypes.data_as(ctypes.c_void_p).value for p in planes])
    qt = np.zeros((4, 64), np.uint16)
    present = np.zeros(4, np.uint8)
    for t, tbl in img["qtables"].items():
        qt[t] = np.asarray(tbl, np.uint16).reshape(64)
        present[t] = 1
    blob = b"".join(int(code).to_bytes(2, "big") + len(p).to_bytes(4, "big")
                    + p for code, p in img.get("markers", ()))
    out, n = ctypes.c_void_p(), ctypes.c_int64()
    err = ctypes.create_string_buffer(512)
    rc = lib.mjt_encode_ptrs(
        img["width"], img["height"], len(comps), 8,
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        qt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        present.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ptrs,
        int(options), int(restart_interval), int(nthreads), blob, len(blob),
        ctypes.byref(out), ctypes.byref(n), err, len(err))
    if rc != 0:
        raise CoderError(err.value.decode("utf-8", "replace"))
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.mjt_free_buffer(out)
