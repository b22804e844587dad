"""Pixels -> CoefImage (PyTorch port of libmodjpeg_tpu.encode_pixels).

Color convert, subsample, forward-DCT and quantize a pixel image at any
quality on ``device``, producing a CoefImage ready for the entropy encoder
(libmodjpeg_tpu.codec.encode).
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from .errors import UnsupportedColorspaceError
from .model import CoefImage, ComponentInfo, Sampling

from .ops import dct as dctops

# Annex K.1 base quantization tables (natural order)
_STD_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.int32)
_STD_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99]], dtype=np.int32)


def quality_scaling(quality: int) -> int:
    """libjpeg jpeg_quality_scaling."""
    quality = max(1, min(100, quality))
    return 5000 // quality if quality < 50 else 200 - quality * 2


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    sf = quality_scaling(quality)
    q = (base * sf + 50) // 100
    return np.clip(q, 1, 255).astype(np.uint16)


def _plane_to_quantized(plane: torch.Tensor, quant: torch.Tensor, fh: int,
                        fv: int, center: float = 128.0) -> torch.Tensor:
    sub = dctops.subsample_plane(plane, fh, fv)
    coefs = dctops.fdct_blocks(dctops.tile_blocks(sub), center)
    return torch.round(coefs / quant.to(torch.float32)).to(torch.int16)


def from_pixels(pixels, quality: int = 85, subsampling: str = "420",
                colorspace: int = C.COLORSPACE_RGB, precision: int = 8,
                device="cuda") -> CoefImage:
    """Encode raw pixels to coefficient space on ``device``.

    pixels: uint8 [H, W, 3] (RGB or YCC per `colorspace`) or [H, W]/[H, W, 1]
    grayscale.  subsampling: '444' | '422' | '420' | 'gray'.
    precision: 8, or 12 for high-bit-depth samples in [0, 4095] (uint16
    input; the base quant tables scale by 16).
    """
    if precision not in (8, 12):
        raise ValueError(f"bad precision {precision}")
    arr = np.asarray(pixels)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w = arr.shape[:2]
    center = float(1 << (precision - 1))
    qscale = 1 << (precision - 8)

    if subsampling == "gray" or arr.shape[2] == 1:
        samp = [(1, 1)]
        gray = True
    elif subsampling == "444":
        samp = [(1, 1), (1, 1), (1, 1)]
        gray = False
    elif subsampling == "422":
        samp = [(2, 1), (1, 1), (1, 1)]
        gray = False
    elif subsampling == "420":
        samp = [(2, 2), (1, 1), (1, 1)]
        gray = False
    else:
        raise ValueError(f"bad subsampling {subsampling}")
    max_h = max(s[0] for s in samp)
    max_v = max(s[1] for s in samp)

    def to_ycc(a):
        t = torch.from_numpy(a.astype(np.float32)).to(device)
        return dctops.rgb_to_ycc(t, center).cpu().numpy()

    if gray:
        if arr.shape[2] == 3 and colorspace == C.COLORSPACE_RGB:
            planes = [to_ycc(arr)[..., 0]]
        else:
            planes = [arr[..., 0].astype(np.float32)]
        jcs = C.JCS_GRAYSCALE
    else:
        if colorspace == C.COLORSPACE_RGB:
            ycc = to_ycc(arr)
        elif colorspace == C.COLORSPACE_YCC:
            ycc = arr.astype(np.float32)
        else:
            raise UnsupportedColorspaceError(str(colorspace))
        planes = [ycc[..., i] for i in range(3)]
        jcs = C.JCS_YCbCr

    mcu_w, mcu_h = 8 * max_h, 8 * max_v
    pad_w = -(-w // mcu_w) * mcu_w
    pad_h = -(-h // mcu_h) * mcu_h

    qtables = {0: quant_table(_STD_LUMA, quality)}
    if not gray:
        qtables[1] = quant_table(_STD_CHROMA, quality)
    if qscale != 1:
        qtables = {t: np.clip(q.astype(np.int64) * qscale, 1, 65535)
                   .astype(np.uint16) for t, q in qtables.items()}

    comps, coefs = [], []
    for c, (sh, sv) in enumerate(samp):
        # edge-replicate pad to the MCU multiple (libjpeg convention)
        p = np.pad(planes[c], ((0, pad_h - h), (0, pad_w - w)), mode="edge")
        qno = 0 if c == 0 or gray else 1
        fh, fv = max_h // sh, max_v // sv
        q = torch.from_numpy(qtables[qno].astype(np.int32)).to(device)
        blocks = np.ascontiguousarray(_plane_to_quantized(
            torch.from_numpy(p).to(device), q, fh, fv, center).cpu())
        comps.append(ComponentInfo(
            component_id=c + 1, h_samp=sh, v_samp=sv, quant_tbl_no=qno,
            width_in_blocks=-(-(w * sh) // (8 * max_h)),
            height_in_blocks=-(-(h * sv) // (8 * max_v)),
            padded_width_in_blocks=blocks.shape[1],
            padded_height_in_blocks=blocks.shape[0]))
        coefs.append(blocks)

    return CoefImage(
        width=w, height=h, jpeg_color_space=jcs, components=comps,
        coefs=coefs, quant_tables=qtables,
        sampling=Sampling(max_h_samp=max_h, max_v_samp=max_v),
        precision=precision)
