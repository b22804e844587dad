"""Dropon ingestion (PyTorch port of libmodjpeg_tpu.dropon).

JPEG dropons, and their optional JPEG masks, decode to pixels through the
port's ``to_pixels`` on a torch ``device``.  PNG and raw input go through
the host readers below, copies of the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import codec
from . import constants as C
from .errors import (DroponDimensionsError, NullDataError,
                     UnsupportedColorspaceError, UnsupportedFiletypeError)
from .model import Dropon
from .pixels import to_pixels
from .png_reader import PNG_SIGNATURE, decode_png


def _read_bytes(source) -> bytes:
    if isinstance(source, (bytes, bytearray, memoryview)):
        return bytes(source)
    from .jpegio import _read_bytes as rb

    return rb(source)


def read_dropon(source, mask=None, blend: int = C.BLEND_FULL,
                device="cuda") -> Dropon:
    """mj_read_dropon_from_file/_memory (dropon.c:34,66): sniff JPEG vs PNG
    by the magic bytes.  A PNG carries its own alpha and ignores ``mask``."""
    data = _read_bytes(source)
    if data is None or len(data) < 8:
        raise NullDataError("dropon data too short")
    maskdata = _read_bytes(mask) if mask is not None else None
    if data[0] == 0xFF and data[1] == 0xD8 and data[2] == 0xFF:
        return _read_dropon_from_jpeg(data, maskdata, blend, device)
    if data.startswith(PNG_SIGNATURE):
        return _read_dropon_from_png(data)
    raise UnsupportedFiletypeError("dropon is neither JPEG nor PNG")


def _read_dropon_from_jpeg(data: bytes, maskdata: Optional[bytes],
                           blend: int, device) -> Dropon:
    """dropon.c:101-161: decode image to RGB; optional mask as GRAYSCALE."""
    img = codec.decode(data)
    rgb = to_pixels(img, C.COLORSPACE_RGB, device=device)
    if maskdata:
        mimg = codec.decode(maskdata)
        gray = to_pixels(mimg, C.COLORSPACE_GRAYSCALE, device=device)
        if (mimg.width, mimg.height) != (img.width, img.height):
            raise DroponDimensionsError(
                "dropon and mask dimensions do not match")
        rgba = np.dstack([rgb, gray[..., 0]])
        return read_dropon_from_raw(rgba, C.COLORSPACE_RGBA, img.width,
                                    img.height, blend)
    return read_dropon_from_raw(rgb, C.COLORSPACE_RGB, img.width, img.height,
                                blend)


def _read_dropon_from_png(data: bytes) -> Dropon:
    """dropon.c:164-201: PNG always decodes to RGBA with per-pixel alpha."""
    rgba = decode_png(data)
    h, w = rgba.shape[:2]
    return read_dropon_from_raw(rgba, C.COLORSPACE_RGBA, w, h,
                                C.BLEND_NONUNIFORM)


def read_dropon_from_raw(rawdata, colorspace: int, width: int, height: int,
                         blend: int = C.BLEND_FULL) -> Dropon:
    """mj_read_dropon_from_raw (dropon.c:203-323).

    Normalizes to image[h,w,3] + alpha[h,w,3].  Quirk preserved: the blend
    argument is clamped to [0,255] first, so explicitly passing
    BLEND_NONUNIFORM (-1) degrades to BLEND_NONE — nonuniform blending is
    only set internally by alpha-channel colorspaces (dropon.c:214-219,278).
    """
    if rawdata is None:
        raise NullDataError("no raw data")
    blend = max(C.BLEND_NONE, min(C.BLEND_FULL, int(blend)))

    arr = np.asarray(rawdata, dtype=np.uint8)
    nchan = {
        C.COLORSPACE_RGB: 3,
        C.COLORSPACE_RGBA: 4,
        C.COLORSPACE_GRAYSCALE: 1,
        C.COLORSPACE_GRAYSCALEA: 2,
        C.COLORSPACE_YCC: 3,
        C.COLORSPACE_YCCA: 4,
    }.get(colorspace)
    if nchan is None:
        raise UnsupportedColorspaceError(str(colorspace))
    arr = arr.reshape(height, width, nchan)

    if colorspace in (C.COLORSPACE_RGBA, C.COLORSPACE_YCCA):
        image = arr[..., :3].copy()
        alpha = np.repeat(arr[..., 3:4], 3, axis=-1)
        stored_cs = (C.COLORSPACE_RGB if colorspace == C.COLORSPACE_RGBA
                     else C.COLORSPACE_YCC)
        stored_blend = C.BLEND_NONUNIFORM
    elif colorspace in (C.COLORSPACE_RGB, C.COLORSPACE_YCC):
        image = arr.copy()
        alpha = np.full((height, width, 3), blend, dtype=np.uint8)
        stored_cs = colorspace
        stored_blend = blend
    elif colorspace == C.COLORSPACE_GRAYSCALEA:
        image = np.repeat(arr[..., 0:1], 3, axis=-1)
        alpha = np.repeat(arr[..., 1:2], 3, axis=-1)
        stored_cs = C.COLORSPACE_GRAYSCALE
        stored_blend = C.BLEND_NONUNIFORM
    else:  # GRAYSCALE
        image = np.repeat(arr[..., 0:1], 3, axis=-1)
        alpha = np.full((height, width, 3), blend, dtype=np.uint8)
        stored_cs = C.COLORSPACE_GRAYSCALE
        stored_blend = blend

    return Dropon(image=image, alpha=alpha, width=width, height=height,
                  colorspace=stored_cs, blend=stored_blend)
