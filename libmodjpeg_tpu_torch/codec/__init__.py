"""The port's copy of libmodjpeg_tpu.codec (ctypes binding to the native
entropy codec).

The native library is the package's only non-Python host component: a
from-scratch T.81 entropy codec whose sources under native/ are the JAX
package's, copied (two comments differ: they named a checkout path of the
reference library).  It is built with g++ at first use into
``build/torch_codec/`` at the repository root, under a file name that
carries a hash of the sources and flags, and loaded once per process.  The
JAX package's own library is never loaded.  A fix to the codec goes to the
JAX package first, then to this copy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from ..errors import DecodeError, EncodeError, ImageSizeError
from ..model import CoefImage, ComponentInfo, Sampling

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_SOURCES = ("codec.cpp", "decoder.inc", "arith.inc", "encoder.inc",
            "api.inc")
# the JAX package's Makefile flags
_CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
              "-Wextra", "-Wno-unused-parameter", "-shared", "-pthread")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "torch_codec")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> str:
    """Build-output path keyed by the sources' contents and the flags."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmjtcodec_{h.hexdigest()[:16]}.so")


def _build_native() -> str:
    """Compile the codec with g++ unless this exact build exists; return
    its path.  Concurrent builders (test workers) each compile into a temp
    file and rename it into place, so none ever loads half a library."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(
            [os.environ.get("CXX", "g++"), *_CXX_FLAGS,
             os.path.join(_NATIVE_DIR, "codec.cpp"), "-o", tmp],
            capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"codec build failed ({r.returncode}):\n"
                               f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build_native())
        lib.mjt_decode.restype = ctypes.c_void_p
        lib.mjt_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.mjt_free_image.argtypes = [ctypes.c_void_p]
        lib.mjt_decode_begin.restype = ctypes.c_void_p
        lib.mjt_decode_begin.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.mjt_decode_finish.restype = ctypes.c_int32
        lib.mjt_decode_finish.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.mjt_get_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.mjt_get_comp_info.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.mjt_get_coefs.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int16),
        ]
        lib.mjt_get_qtable.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.mjt_get_marker_len.restype = ctypes.c_int64
        lib.mjt_get_marker_len.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.mjt_get_marker.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.mjt_free_buffer.argtypes = [ctypes.c_void_p]
        lib.mjt_encode_ptrs.restype = ctypes.c_int32
        lib.mjt_encode_ptrs.argtypes = [
            ctypes.c_int32,  # width
            ctypes.c_int32,  # height
            ctypes.c_int32,  # ncomps
            ctypes.c_int32,  # precision
            ctypes.POINTER(ctypes.c_int32),   # comp_meta
            ctypes.POINTER(ctypes.c_uint16),  # qtables
            ctypes.POINTER(ctypes.c_uint8),   # qt_present
            ctypes.POINTER(ctypes.c_void_p),  # per-comp coef pointers
            ctypes.c_int32,  # options
            ctypes.c_int32,  # restart_interval
            ctypes.c_int32,  # nthreads
            ctypes.c_char_p,  # markers blob
            ctypes.c_int64,  # markers len
            ctypes.POINTER(ctypes.c_void_p),  # out buf
            ctypes.POINTER(ctypes.c_int64),  # out len
            ctypes.c_char_p,  # errbuf
            ctypes.c_int64,  # errbuf len
        ]
        lib.mjt_encode_ptrs_tables.restype = ctypes.c_int32
        lib.mjt_encode_ptrs_tables.argtypes = (
            lib.mjt_encode_ptrs.argtypes[:13]
            + [ctypes.c_char_p, ctypes.c_int64]   # preset tables blob
            + lib.mjt_encode_ptrs.argtypes[13:]
        )
        lib.mjt_encode_ptrs_script.restype = ctypes.c_int32
        lib.mjt_encode_ptrs_script.argtypes = (
            lib.mjt_encode_ptrs.argtypes[:13]
            + [ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]  # scan script
            + lib.mjt_encode_ptrs.argtypes[13:]
        )
        lib.mjt_decode_tail.restype = ctypes.c_int32
        lib.mjt_decode_tail.argtypes = [
            ctypes.c_void_p,                   # handle
            ctypes.c_int64,                    # mcu_row
            ctypes.POINTER(ctypes.c_void_p),   # out planes
            ctypes.c_int32,                    # prezeroed
            ctypes.POINTER(ctypes.c_int64),    # out splice [7]
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.mjt_encode_splice.restype = ctypes.c_void_p
        lib.mjt_encode_splice.argtypes = [
            ctypes.c_char_p,                   # original file bytes
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),    # splice [7]
            ctypes.c_int64,                    # mcu_row
            ctypes.POINTER(ctypes.c_void_p),   # per-comp coef pointers
            ctypes.POINTER(ctypes.c_int64),    # out len
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.mjt_decode_band.restype = ctypes.c_int32
        lib.mjt_decode_band.argtypes = [
            ctypes.c_void_p,                   # handle
            ctypes.c_int64,                    # row0
            ctypes.c_int64,                    # row1 (-1 = bottom)
            ctypes.POINTER(ctypes.c_void_p),   # out planes
            ctypes.c_int32,                    # prezeroed
            ctypes.POINTER(ctypes.c_int64),    # out splice [16]
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.mjt_encode_splice_band.restype = ctypes.c_void_p
        lib.mjt_encode_splice_band.argtypes = [
            ctypes.c_char_p,                   # original file bytes
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),    # splice [16]
            ctypes.c_int64,                    # row0
            ctypes.c_int64,                    # row1
            ctypes.POINTER(ctypes.c_void_p),   # per-comp coef pointers
            ctypes.POINTER(ctypes.c_int64),    # out len
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.mjt_build_optimal_table.restype = ctypes.c_int32
        lib.mjt_build_optimal_table.argtypes = [
            ctypes.POINTER(ctypes.c_int64),   # freq[257]
            ctypes.POINTER(ctypes.c_uint8),   # counts[16] (lengths 1..16)
            ctypes.POINTER(ctypes.c_uint8),   # symbols[256]
            ctypes.POINTER(ctypes.c_int32),   # nsyms
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.mjt_encode.restype = ctypes.c_int32
        lib.mjt_encode.argtypes = [
            ctypes.c_int32,  # width
            ctypes.c_int32,  # height
            ctypes.c_int32,  # ncomps
            ctypes.c_int32,  # precision
            ctypes.POINTER(ctypes.c_int32),  # comp_meta
            ctypes.POINTER(ctypes.c_uint16),  # qtables
            ctypes.POINTER(ctypes.c_uint8),  # qt_present
            ctypes.POINTER(ctypes.c_int16),  # coefs
            ctypes.c_int32,  # options
            ctypes.c_int32,  # restart_interval
            ctypes.c_int32,  # nthreads
            ctypes.c_char_p,  # markers blob
            ctypes.c_int64,  # markers len
            ctypes.POINTER(ctypes.c_void_p),  # out buf
            ctypes.POINTER(ctypes.c_int64),  # out len
            ctypes.c_char_p,  # errbuf
            ctypes.c_int64,  # errbuf len
        ]
        _lib = lib
        return lib


def _available_ram_bytes():
    """MemAvailable from /proc/meminfo, or None off-Linux (guard disabled)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def decode(data: bytes, nthreads: int = 0, max_pixel: int = 0) -> CoefImage:
    """Decode a JPEG bitstream into a CoefImage (coefficients + metadata).

    Two-phase zero-copy: the native decoder parses the frame header, we
    allocate the numpy coefficient planes, and the entropy decoder writes
    into them directly.  max_pixel > 0 aborts at the frame header before any
    entropy decoding (the reference's anti-DoS guard, image.c:79-82).
    """
    lib = _load()
    errbuf = ctypes.create_string_buffer(512)
    handle = lib.mjt_decode_begin(data, len(data), nthreads, max_pixel,
                                  errbuf, len(errbuf))
    if not handle:
        msg = errbuf.value.decode("utf-8", "replace")
        if "max_pixel" in msg:
            raise ImageSizeError(msg)
        raise DecodeError(msg)
    try:
        info = (ctypes.c_int32 * 9)()
        lib.mjt_get_info(handle, info)
        (width, height, ncomps, jcs, prog, arith, ri, nmarkers,
         precision) = list(info)

        components = []
        coefs = []
        max_h = max_v = 1
        for c in range(ncomps):
            ci = (ctypes.c_int32 * 8)()
            lib.mjt_get_comp_info(handle, c, ci)
            comp_id, h, v, qno, wib, hib, pw, ph = list(ci)
            components.append(
                ComponentInfo(
                    component_id=comp_id,
                    h_samp=h,
                    v_samp=v,
                    quant_tbl_no=qno,
                    width_in_blocks=wib,
                    height_in_blocks=hib,
                    padded_width_in_blocks=pw,
                    padded_height_in_blocks=ph,
                )
            )
            max_h = max(max_h, h)
            max_v = max(max_v, v)
        # Host-RAM bound (docs/SCALING.md "dense planes, no virtual-array
        # spill"): every coefficient plane is dense in host RAM — unlike
        # libjpeg's jmemmgr, which pages virtual block arrays to temp files
        # for images larger than memory (SURVEY.md §3.5).  Refuse with a
        # clear error instead of dying to the OOM killer; max_pixel remains
        # the first-line guard at the frame header.
        need = sum(c.padded_height_in_blocks * c.padded_width_in_blocks * 128
                   for c in components)
        avail = _available_ram_bytes()
        if avail is not None and need > avail:
            raise ImageSizeError(
                f"frame needs {need >> 20} MiB of coefficient planes but "
                f"only {avail >> 20} MiB of host RAM is available; this "
                "build holds planes dense in RAM (no libjpeg-style "
                "virtual-array spill) — set max_pixel to bound inputs, "
                "or split the image (docs/SCALING.md)")
        for c in components:
            # np.zeros -> calloc: zero pages stay unmapped until a scan
            # writes them (tiny crafted files can claim enormous frames)
            coefs.append(np.zeros((c.padded_height_in_blocks,
                                   c.padded_width_in_blocks, 8, 8),
                                  dtype=np.int16))

        ptrs = (ctypes.c_void_p * max(ncomps, 1))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in coefs])
        rc = lib.mjt_decode_finish(handle, ptrs, 1, errbuf, len(errbuf))
        if rc != 0:
            raise DecodeError(errbuf.value.decode("utf-8", "replace"))

        quant_tables = {}
        for t in range(4):
            tbl = np.empty((8, 8), dtype=np.uint16)
            present = ctypes.c_int32(0)
            lib.mjt_get_qtable(
                handle,
                t,
                tbl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                ctypes.byref(present),
            )
            if present.value:
                quant_tables[t] = tbl

        # markers (and a mid-file DRI) may arrive after begin(): re-read
        lib.mjt_get_info(handle, info)
        nmarkers = info[7]
        ri = info[6]
        markers = []
        for i in range(nmarkers):
            mlen = lib.mjt_get_marker_len(handle, i)
            buf = (ctypes.c_uint8 * max(mlen, 1))()
            code = ctypes.c_int32(0)
            lib.mjt_get_marker(handle, i, ctypes.byref(code), buf)
            markers.append((code.value, bytes(buf[:mlen])))

        return CoefImage(
            width=width,
            height=height,
            jpeg_color_space=jcs,
            components=components,
            coefs=coefs,
            quant_tables=quant_tables,
            sampling=Sampling(max_h_samp=max_h, max_v_samp=max_v),
            markers=markers,
            progressive=bool(prog),
            arithmetic=bool(arith),
            restart_interval=ri,
            precision=precision,
        )
    finally:
        lib.mjt_free_image(handle)


class SpliceIneligible(Exception):
    """The stream is outside the restart-free splice envelope."""


def decode_tail(data: bytes, mcu_row: int, max_pixel: int = 0):
    """Prefix-splice decode: the decode_band shape with the band running
    to the bottom.  Returns (CoefImage, 7-tuple splice) for
    encode_splice; the native layer delegates finish_tail -> finish_band
    the same way."""
    img, band = decode_band(data, mcu_row, -1, max_pixel=max_pixel)
    return img, band[:7]


def decode_band(data: bytes, row0: int, row1: int, max_pixel: int = 0):
    """Band-splice decode (generalizes decode_tail): fully decode only MCU
    rows [row0, row1); the prefix is skip-indexed (byte-copied at encode
    time) and the suffix is skip-indexed only (bit-shift-copied at encode
    time with a one-MCU DC seam fix).  Returns (CoefImage, band_splice)
    where rows outside the band are ZERO (never read by splice users).
    row1 < 0 means "to the bottom" (the decode_tail shape).  Raises
    SpliceIneligible outside the envelope."""
    lib = _load()
    errbuf = ctypes.create_string_buffer(512)
    handle = lib.mjt_decode_begin(data, len(data), 0, max_pixel, errbuf,
                                  len(errbuf))
    if not handle:
        msg = errbuf.value.decode("utf-8", "replace")
        if "max_pixel" in msg:
            raise ImageSizeError(msg)
        raise DecodeError(msg)
    try:
        info = (ctypes.c_int32 * 9)()
        lib.mjt_get_info(handle, info)
        (width, height, ncomps, jcs, prog, arith, ri, nmarkers,
         precision) = list(info)
        components = []
        coefs = []
        max_h = max_v = 1
        for c in range(ncomps):
            ci = (ctypes.c_int32 * 8)()
            lib.mjt_get_comp_info(handle, c, ci)
            comp_id, h, v, qno, wib, hib, pw, ph = list(ci)
            components.append(ComponentInfo(
                component_id=comp_id, h_samp=h, v_samp=v, quant_tbl_no=qno,
                width_in_blocks=wib, height_in_blocks=hib,
                padded_width_in_blocks=pw, padded_height_in_blocks=ph))
            max_h = max(max_h, h)
            max_v = max(max_v, v)
        # same host-RAM bound as decode() (docs/SCALING.md)
        need = sum(c.padded_height_in_blocks * c.padded_width_in_blocks * 128
                   for c in components)
        avail = _available_ram_bytes()
        if avail is not None and need > avail:
            raise ImageSizeError(
                f"frame needs {need >> 20} MiB of coefficient planes but "
                f"only {avail >> 20} MiB of host RAM is available "
                "(docs/SCALING.md)")
        for c in components:
            coefs.append(np.zeros((c.padded_height_in_blocks,
                                   c.padded_width_in_blocks, 8, 8),
                                  dtype=np.int16))
        ptrs = (ctypes.c_void_p * max(ncomps, 1))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in coefs])
        splice = (ctypes.c_int64 * 16)()
        rc = lib.mjt_decode_band(handle, row0, row1, ptrs, 1, splice,
                                 errbuf, len(errbuf))
        if rc != 0:
            msg = errbuf.value.decode("utf-8", "replace")
            if msg.startswith("splice:"):
                raise SpliceIneligible(msg)
            raise DecodeError(msg)
        quant_tables = {}
        for t in range(4):
            tbl = np.empty((8, 8), dtype=np.uint16)
            present = ctypes.c_int32(0)
            lib.mjt_get_qtable(
                handle, t,
                tbl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                ctypes.byref(present))
            if present.value:
                quant_tables[t] = tbl
        lib.mjt_get_info(handle, info)
        markers = []
        for i in range(info[7]):
            mlen = lib.mjt_get_marker_len(handle, i)
            buf = (ctypes.c_uint8 * max(mlen, 1))()
            code = ctypes.c_int32(0)
            lib.mjt_get_marker(handle, i, ctypes.byref(code), buf)
            markers.append((code.value, bytes(buf[:mlen])))
        img = CoefImage(
            width=width, height=height, jpeg_color_space=jcs,
            components=components, coefs=coefs, quant_tables=quant_tables,
            sampling=Sampling(max_h_samp=max_h, max_v_samp=max_v),
            markers=markers, progressive=bool(prog), arithmetic=bool(arith),
            restart_interval=info[6], precision=precision)
        return img, tuple(splice)
    finally:
        lib.mjt_free_image(handle)


def encode_splice_band(data: bytes, img: CoefImage, row0: int, row1: int,
                       splice) -> bytes:
    """Band-splice re-encode: byte-copy the prefix, re-encode rows
    [row0, row1) from ``img``'s planes, re-code the first suffix MCU (the
    DC-predictor seam), bit-shift-copy the rest.  Output byte-identical to
    the full decode -> re-encode pipeline."""
    lib = _load()
    errbuf = ctypes.create_string_buffer(512)
    planes = [np.ascontiguousarray(c, np.int16) for c in img.coefs]
    ptrs = (ctypes.c_void_p * max(len(planes), 1))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in planes])
    sp = (ctypes.c_int64 * 16)(*splice)
    out_len = ctypes.c_int64(0)
    buf = lib.mjt_encode_splice_band(data, len(data), sp, row0, row1, ptrs,
                                     ctypes.byref(out_len), errbuf,
                                     len(errbuf))
    if not buf:
        raise EncodeError(errbuf.value.decode("utf-8", "replace"))
    try:
        return ctypes.string_at(buf, out_len.value)
    finally:
        lib.mjt_free_buffer(buf)


def encode_splice(data: bytes, img: CoefImage, mcu_row: int,
                  splice) -> bytes:
    """Prefix-splice re-encode: the original bytes up to the splice point
    are copied verbatim (bit-identical by the determinism argument — same
    coefficients, tables, predictors re-encode to the same bits) and MCU
    rows >= mcu_row re-encode from ``img``'s coefficient planes with the
    original file's Huffman tables."""
    lib = _load()
    errbuf = ctypes.create_string_buffer(512)
    planes = [np.ascontiguousarray(c, np.int16) for c in img.coefs]
    ptrs = (ctypes.c_void_p * max(len(planes), 1))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in planes])
    sp = (ctypes.c_int64 * 7)(*splice)
    out_len = ctypes.c_int64(0)
    buf = lib.mjt_encode_splice(data, len(data), sp, mcu_row, ptrs,
                                ctypes.byref(out_len), errbuf, len(errbuf))
    if not buf:
        raise EncodeError(errbuf.value.decode("utf-8", "replace"))
    try:
        return ctypes.string_at(buf, out_len.value)
    finally:
        lib.mjt_free_buffer(buf)


def build_optimal_table(freq) -> tuple[bytes, bytes]:
    """Build a length-limited optimal Huffman table from 257-entry symbol
    frequencies (entry 256 is the reserved codepoint; pass real counts in
    0..255).  Returns (counts, symbols): counts[i] = number of codes of
    length i+1.  Uses the native encoder's own table builder so the
    tie-breaking matches the optimize pass exactly — tables built from a
    device-side histogram (ops/histogram.py) produce byte-identical files.
    """
    lib = _load()
    f = np.ascontiguousarray(freq, dtype=np.int64)
    if f.shape != (257,):
        raise ValueError("freq must have 257 entries")
    counts = (ctypes.c_uint8 * 16)()
    syms = (ctypes.c_uint8 * 256)()
    nsyms = ctypes.c_int32(0)
    errbuf = ctypes.create_string_buffer(512)
    rc = lib.mjt_build_optimal_table(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), counts, syms,
        ctypes.byref(nsyms), errbuf, len(errbuf))
    if rc != 0:
        raise EncodeError(errbuf.value.decode("utf-8", "replace"))
    return bytes(counts), bytes(syms[: nsyms.value])


def pack_preset_tables(tables) -> bytes:
    """Serialize [(tc, th, counts16, symbols)] into the native preset blob."""
    blob = bytearray()
    for tc, th, counts, symbols in tables:
        counts = bytes(counts)
        symbols = bytes(symbols)
        if len(counts) != 16 or sum(counts) != len(symbols):
            raise ValueError("malformed Huffman table")
        blob += bytes([tc, th]) + counts + symbols
    return bytes(blob)


def encode(
    img: CoefImage,
    options: int = 0,
    restart_interval: int | None = None,
    nthreads: int = 0,
    ref_markers: bool = False,
    preset_tables=None,
    scan_script=None,
) -> bytes:
    """Encode a CoefImage back to a JPEG bitstream.

    ``options`` is an OR of C.OPTION_* flags (optimize/progressive/arithmetic,
    matching image.c:170-189 semantics).  ``restart_interval=None`` preserves
    the image's own interval; pass 0 to strip restart markers.

    ``scan_script`` (cjpeg/mozjpeg ``-scans`` parity): a list of
    ``(comps, Ss, Se, Ah, Al)`` tuples, where ``comps`` is an iterable of
    component indices in frame order.  A script with any partial band or
    successive-approximation pass produces a progressive file (overriding
    OPTION_PROGRESSIVE); full-band-only scripts produce multi-scan
    sequential output.  Validated against T.81 B.2.3 / jcmaster.c rules.
    Mutually exclusive with ``preset_tables``.

    ``ref_markers=True`` reproduces libjpeg's marker emission exactly for
    byte-parity with the reference binary: libjpeg writes its own generated
    JFIF APP0 (version/density copied from the source per
    jpeg_copy_critical_parameters) and THEN mj_write_jpeg re-emits the saved
    source markers, so reference outputs carry a duplicated APP0.
    """
    lib = _load()
    ncomps = img.num_components
    comp_meta = np.zeros(4 * ncomps, dtype=np.int32)
    for c, ci in enumerate(img.components):
        comp_meta[c * 4 : c * 4 + 4] = [
            ci.component_id,
            ci.h_samp,
            ci.v_samp,
            ci.quant_tbl_no,
        ]

    # zero-copy: hand the C encoder per-component plane pointers directly
    planes = [np.ascontiguousarray(img.coefs[c], dtype=np.int16)
              for c in range(ncomps)]
    ptrs = (ctypes.c_void_p * ncomps)(
        *[p.ctypes.data_as(ctypes.c_void_p).value for p in planes])

    qtables = np.zeros((4, 64), dtype=np.uint16)
    qt_present = np.zeros(4, dtype=np.uint8)
    for t, tbl in img.quant_tables.items():
        qtables[t] = np.asarray(tbl, dtype=np.uint16).reshape(-1)
        qt_present[t] = 1

    markers = list(img.markers)
    if ref_markers and img.jpeg_color_space in (1, 3):  # GRAYSCALE/YCbCr
        gen = None
        for code, payload in markers:
            if code == 0xFFE0 and payload[:5] == b"JFIF\x00":
                # generated header mirrors the source's version + density,
                # thumbnail dropped (jpeg_copy_critical_parameters + emit)
                gen = payload[:12] + b"\x00\x00"
                break
        if gen is None:
            gen = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
        markers.insert(0, (0xFFE0, gen))
    if ncomps == 4 and not any(code == 0xFFEE for code, _ in markers):
        # 4-component frames need an Adobe APP14 so downstream decoders
        # identify CMYK (transform 0) vs YCCK (transform 2)
        transform = 2 if img.jpeg_color_space == 5 else 0
        markers.insert(0, (0xFFEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                           + bytes([transform])))

    blob = bytearray()
    for code, payload in markers:
        blob += int(code).to_bytes(2, "big")
        blob += len(payload).to_bytes(4, "big")
        blob += payload
    blob = bytes(blob)

    ri = img.restart_interval if restart_interval is None else restart_interval

    out_buf = ctypes.c_void_p()
    out_len = ctypes.c_int64()
    errbuf = ctypes.create_string_buffer(512)
    common = (
        img.width,
        img.height,
        ncomps,
        int(getattr(img, "precision", 8)),
        comp_meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        qtables.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        qt_present.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ptrs,
        int(options),
        int(ri),
        int(nthreads),
        blob,
        len(blob),
    )
    tail = (ctypes.byref(out_buf), ctypes.byref(out_len), errbuf, len(errbuf))
    if preset_tables is not None and scan_script is not None:
        raise ValueError("preset_tables and scan_script are mutually "
                         "exclusive")
    if preset_tables is not None:
        pblob = (preset_tables if isinstance(preset_tables, bytes)
                 else pack_preset_tables(preset_tables))
        rc = lib.mjt_encode_ptrs_tables(*common, pblob, len(pblob), *tail)
    elif scan_script is not None:
        if len(scan_script) == 0:
            raise ValueError("scan_script must contain at least one scan")
        entries = []
        for comps, ss, se, ah, al in scan_script:
            comps = list(comps)
            if not 1 <= len(comps) <= 4:
                raise ValueError("scan must name 1-4 components")
            entries += ([len(comps)] + comps + [0] * (4 - len(comps))
                        + [int(ss), int(se), int(ah), int(al)])
        script_arr = np.asarray(entries, dtype=np.int32)
        rc = lib.mjt_encode_ptrs_script(
            *common, script_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(scan_script), *tail)
    else:
        rc = lib.mjt_encode_ptrs(*common, *tail)
    if rc != 0:
        raise EncodeError(errbuf.value.decode("utf-8", "replace"))
    try:
        return ctypes.string_at(out_buf, out_len.value)
    finally:
        lib.mjt_free_buffer(out_buf)
