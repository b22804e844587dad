"""The port's copy of libmodjpeg_tpu.jpegio (JPEG read/write in
coefficient space).

Mirrors the reference's L1 I/O layer (image.c) but returns self-contained
CoefImage values instead of keeping a live decoder open
(image.c:33-134,136-233).
"""

from __future__ import annotations

import os
from typing import Optional, Union

from . import constants as C
from . import codec
from .errors import (
    FileIOError,
    ImageSizeError,
    NullDataError,
    UnsupportedColorspaceError,
)
from .model import CoefImage


def _read_bytes(source: Union[str, bytes, os.PathLike]) -> bytes:
    if isinstance(source, (bytes, bytearray, memoryview)):
        return bytes(source)
    try:
        with open(source, "rb") as f:
            return f.read()
    except OSError as e:
        raise FileIOError(str(e)) from e


def read_jpeg(source, max_pixel: int = 0, nthreads: int = 0,
              allow_cmyk: bool = False) -> CoefImage:
    """Read a JPEG into coefficient space.

    allow_cmyk=False mirrors the reference's colorspace guard (image.c:84-92,
    GRAYSCALE/RGB/YCbCr only); True additionally admits 4-component Adobe
    CMYK/YCCK frames, which compose/effects/pixel paths handle natively —
    a capability extension over the reference.
    """
    data = _read_bytes(source)
    if not data:
        raise NullDataError("empty input")
    img = codec.decode(data, nthreads=nthreads, max_pixel=max_pixel)
    allowed = (C.JCS_GRAYSCALE, C.JCS_RGB, C.JCS_YCbCr)
    if allow_cmyk:
        allowed += (C.JCS_CMYK, C.JCS_YCCK)
    if img.jpeg_color_space not in allowed:
        raise UnsupportedColorspaceError(
            f"unsupported jpeg colorspace {img.jpeg_color_space}")
    return img


def write_jpeg(img: CoefImage, dest: Optional[Union[str, os.PathLike]] = None,
               options: int = 0, restart_interval: Optional[int] = None,
               nthreads: int = 0, ref_markers: bool = False):
    if img is None:
        raise NullDataError("no image")
    opts = 0
    if options & C.OPTION_OPTIMIZE:
        opts |= 1
    if options & C.OPTION_PROGRESSIVE:
        opts |= 2
    if options & C.OPTION_ARITHMETRIC:
        opts |= 4
    data = codec.encode(img, options=opts, restart_interval=restart_interval,
                        nthreads=nthreads, ref_markers=ref_markers)
    if dest is None:
        return data
    try:
        with open(dest, "wb") as f:
            f.write(data)
    except OSError as e:
        raise FileIOError(str(e)) from e
    return None
