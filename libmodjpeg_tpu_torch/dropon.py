"""Dropon ingestion (PyTorch port of libmodjpeg_tpu.dropon.read_dropon).

JPEG dropons, and their optional JPEG masks, decode to pixels through the
port's ``to_pixels`` on a torch ``device``.  PNG and raw input reuse the JAX
package's host readers, which import no JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from libmodjpeg_tpu import codec
from libmodjpeg_tpu import constants as C
from libmodjpeg_tpu.dropon import (_read_bytes, _read_dropon_from_png,
                                   read_dropon_from_raw)
from libmodjpeg_tpu.errors import (DroponDimensionsError, NullDataError,
                                   UnsupportedFiletypeError)
from libmodjpeg_tpu.model import Dropon
from libmodjpeg_tpu.png_reader import PNG_SIGNATURE

from .pixels import to_pixels


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
