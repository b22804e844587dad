"""CoefImage -> pixels on a torch ``device`` (PyTorch port of
libmodjpeg_tpu.pixels): dequantize, IDCT, fancy upsample, colour convert.

Every step is plain torch; none of it was a TPU kernel.  The IDCT is written
as fixed-order elementwise passes (ops.dct.idct_blocks), so the card and the
CPU decode a JPEG dropon to the same pixels.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from .errors import UnsupportedColorspaceError
from .model import CoefImage

from .ops import dct as dctops


def _plane_from_coefs(coefs: torch.Tensor, quant: torch.Tensor, comp_w: int,
                      comp_h: int, fh: int, fv: int,
                      center: float) -> torch.Tensor:
    """[bh, bw, 8, 8] int16 + [8, 8] quant -> float32 plane, cropped to
    comp_h x comp_w BEFORE the (fh, fv) fancy upsample (the order matters
    for odd sizes)."""
    deq = coefs.to(torch.float32) * quant
    pix = dctops.idct_blocks(deq, center)
    plane = dctops.untile_blocks(pix)[:comp_h, :comp_w]
    return dctops.upsample_plane_fancy(plane, fh, fv)


def to_pixels(img: CoefImage, colorspace: int = C.COLORSPACE_RGB,
              device="cuda") -> np.ndarray:
    """Decode to raw pixels on ``device``.

    colorspace: COLORSPACE_RGB, COLORSPACE_YCC or COLORSPACE_GRAYSCALE
    (mirrors mj_decode_jpeg_to_raw's want_colorspace, image.c:412-427).
    Returns uint8 [H, W, 3] (or [H, W, 1] for grayscale); 12-bit frames
    return uint16 samples in [0, 4095].
    """
    precision = getattr(img, "precision", 8)
    center = float(1 << (precision - 1))
    maxval = (1 << precision) - 1
    max_h, max_v = img.sampling.max_h_samp, img.sampling.max_v_samp
    planes = []
    for c, ci in enumerate(img.components):
        comp_w = -(-(img.width * ci.h_samp) // max_h)
        comp_h = -(-(img.height * ci.v_samp) // max_v)
        # torch takes only writable arrays; copies only a read-only one
        coefs = torch.from_numpy(
            np.require(img.coefs[c], requirements=("C", "W"))).to(device)
        quant = torch.from_numpy(
            np.asarray(img.quant_table_for(c), np.float32)).to(device)
        plane = _plane_from_coefs(coefs, quant, comp_w, comp_h,
                                  max_h // ci.h_samp, max_v // ci.v_samp,
                                  center)
        planes.append(plane[:img.height, :img.width])

    jcs = img.jpeg_color_space
    if jcs == C.JCS_GRAYSCALE:
        y = planes[0]
        if colorspace == C.COLORSPACE_GRAYSCALE:
            out = y[..., None]
        elif colorspace == C.COLORSPACE_RGB:
            out = torch.stack([y, y, y], dim=-1)
        elif colorspace == C.COLORSPACE_YCC:
            out = torch.stack([y, torch.full_like(y, center),
                               torch.full_like(y, center)], dim=-1)
        else:
            raise UnsupportedColorspaceError(str(colorspace))
    elif jcs == C.JCS_YCbCr:
        ycc = torch.stack(planes, dim=-1)
        if colorspace == C.COLORSPACE_YCC:
            out = ycc
        elif colorspace == C.COLORSPACE_RGB:
            out = dctops.ycc_to_rgb(ycc, center)
        elif colorspace == C.COLORSPACE_GRAYSCALE:
            out = ycc[..., :1]
        else:
            raise UnsupportedColorspaceError(str(colorspace))
    elif jcs == C.JCS_RGB:
        rgb = torch.stack(planes, dim=-1)
        if colorspace == C.COLORSPACE_RGB:
            out = rgb
        elif colorspace == C.COLORSPACE_YCC:
            out = dctops.rgb_to_ycc(rgb, center)
        elif colorspace == C.COLORSPACE_GRAYSCALE:
            out = dctops.rgb_to_ycc(rgb, center)[..., :1]
        else:
            raise UnsupportedColorspaceError(str(colorspace))
    elif jcs in (C.JCS_CMYK, C.JCS_YCCK):
        # Adobe convention: samples stored inverted (255 = no ink), so
        # R = C' * K' / maxval; YCCK additionally YCC-transforms C'M'Y'
        maxf = float(maxval)
        cmy = torch.stack(planes[:3], dim=-1)
        if jcs == C.JCS_YCCK:
            cmy = dctops.ycc_to_rgb(cmy, center)
        k = planes[3].clamp(0.0, maxf)[..., None]
        rgb = cmy.clamp(0.0, maxf) * k / maxf
        if colorspace == C.COLORSPACE_RGB:
            out = rgb
        elif colorspace == C.COLORSPACE_YCC:
            out = dctops.rgb_to_ycc(rgb, center)
        elif colorspace == C.COLORSPACE_GRAYSCALE:
            out = dctops.rgb_to_ycc(rgb, center)[..., :1]
        else:
            raise UnsupportedColorspaceError(str(colorspace))
    else:
        raise UnsupportedColorspaceError(f"jpeg colorspace {jcs}")
    dtype = np.uint8 if precision == 8 else np.uint16
    out = torch.round(out).clamp(0, maxval)
    return out.cpu().numpy().astype(dtype)
