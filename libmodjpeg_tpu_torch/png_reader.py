"""The port's copy of libmodjpeg_tpu.png_reader (the PNG decoder).

The reference uses libpng's simplified API forced to RGBA
(dropon.c:164-201).  We decode the critical chunks ourselves — IHDR, PLTE,
tRNS, IDAT, IEND — supporting the common color types at 8/16-bit depth and
palette depths 1/2/4/8, always producing RGBA uint8.  Adam7 interlacing is
supported by deinterleaving passes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .errors import DroponDimensionsError, FileIOError

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth(a, b, c):
    p = int(a) + int(b) - int(c)
    pa, pb, pc = abs(p - int(a)), abs(p - int(b)), abs(p - int(c))
    if pa <= pb and pa <= pc:
        return a
    if pb <= pc:
        return b
    return c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG scanline filters; returns [height, stride] uint8."""
    out = np.zeros((height, stride), dtype=np.uint8)
    pos = 0
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        ftype = raw[pos]
        pos += 1
        line = np.frombuffer(raw, np.uint8, stride, pos).copy()
        pos += stride
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub
            for i in range(bpp, stride):
                line[i] = (int(line[i]) + int(line[i - bpp])) & 0xFF
        elif ftype == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 3:  # Average
            for i in range(stride):
                left = int(line[i - bpp]) if i >= bpp else 0
                line[i] = (int(line[i]) + ((left + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(stride):
                left = int(line[i - bpp]) if i >= bpp else 0
                ul = int(prev[i - bpp]) if i >= bpp else 0
                line[i] = (int(line[i]) + _paeth(left, int(prev[i]), ul)) & 0xFF
        else:
            raise FileIOError(f"bad PNG filter type {ftype}")
        out[y] = line
        prev = out[y]
    return out


def _expand_bits(row_bytes: np.ndarray, bit_depth: int, width: int) -> np.ndarray:
    """Expand sub-byte samples to one value per entry."""
    if bit_depth == 8:
        return row_bytes[..., :width]
    per_byte = 8 // bit_depth
    shifts = np.arange(per_byte - 1, -1, -1) * bit_depth
    mask = (1 << bit_depth) - 1
    vals = (row_bytes[..., :, None] >> shifts) & mask
    return vals.reshape(row_bytes.shape[0], -1)[..., :width]


# Adam7 pass geometry: (x_start, y_start, x_step, y_step)
_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes -> RGBA uint8 [height, width, 4]."""
    if not data.startswith(PNG_SIGNATURE):
        raise FileIOError("not a PNG")
    pos = len(PNG_SIGNATURE)
    width = height = None
    bit_depth = color_type = interlace = 0
    palette = None
    trns = None
    idat = bytearray()
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length  # skip CRC
        if ctype == b"IHDR":
            width, height, bit_depth, color_type, _comp, _filt, interlace = \
                struct.unpack(">IIBBBBB", body)
            if width >= (2 << 16) or height >= (2 << 16):
                # same guard as the reference (dropon.c:174)
                raise DroponDimensionsError("PNG too large")
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif ctype == b"IDAT":
            idat += body
        elif ctype == b"IEND":
            break
    if width is None:
        raise FileIOError("PNG missing IHDR")
    if bit_depth not in (1, 2, 4, 8, 16):
        raise FileIOError(f"unsupported PNG bit depth {bit_depth}")
    nchan = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color_type)
    if nchan is None:
        raise FileIOError(f"unsupported PNG color type {color_type}")
    if color_type != 3 and bit_depth < 8:
        raise FileIOError("sub-8-bit non-palette PNG not supported")
    raw = zlib.decompress(bytes(idat))
    sample_bytes = 2 if bit_depth == 16 else 1

    def decode_region(raw_bytes, w, h):
        """Decode one (sub)image of w x h pixels; returns [h, w, nchan] u8."""
        bits_per_pixel = nchan * bit_depth
        stride = (w * bits_per_pixel + 7) // 8
        bpp = max(1, bits_per_pixel // 8)
        arr = _unfilter(raw_bytes, h, stride, bpp)
        if bit_depth == 16:
            arr = arr.reshape(h, -1, 2)[:, :, 0]  # take high byte
            arr = arr.reshape(h, w, nchan)
        elif bit_depth == 8:
            arr = arr.reshape(h, w, nchan)
        else:
            arr = _expand_bits(arr, bit_depth, w)[..., None]
        return arr, (h * (stride + 1))

    if interlace == 0:
        img, _ = decode_region(raw, width, height)
    elif interlace == 1:
        img = np.zeros((height, width, nchan), dtype=np.uint8)
        off = 0
        for (x0, y0, dx, dy) in _ADAM7:
            pw = (width - x0 + dx - 1) // dx
            ph = (height - y0 + dy - 1) // dy
            if pw == 0 or ph == 0:
                continue
            sub, used = decode_region(raw[off:], pw, ph)
            off += used
            img[y0::dy, x0::dx] = sub
        img = img
    else:
        raise FileIOError(f"unsupported PNG interlace {interlace}")

    # scale sub-8-bit samples to 0..255 (palette indices are not scaled)
    if bit_depth < 8 and color_type == 0:
        img = (img.astype(np.uint16) * 255 // ((1 << bit_depth) - 1)).astype(np.uint8)

    # normalize to RGBA
    h, w = img.shape[:2]
    if color_type == 3:
        if palette is None:
            raise FileIOError("palette PNG without PLTE")
        idx = img[..., 0]
        rgb = palette[idx]
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[: len(trns)] = trns
            a = alpha[idx]
        else:
            a = np.full((h, w), 255, np.uint8)
        return np.dstack([rgb, a])
    if color_type == 0:
        g = img[..., 0]
        return np.dstack([g, g, g, np.full((h, w), 255, np.uint8)])
    if color_type == 2:
        return np.dstack([img, np.full((h, w), 255, np.uint8)])
    if color_type == 4:
        g, a = img[..., 0], img[..., 1]
        return np.dstack([g, g, g, a])
    return img  # color_type 6, already RGBA
