"""API-level effects on CoefImage, computed on a torch ``device`` (PyTorch
port of libmodjpeg_tpu.effects, effect.c:28-222 parity).

Quirk preserved: grayscale/tint/luminance silently return the image
unchanged for non-YCbCr JPEGs instead of raising (effect.c:39-41,126-128,
195-197).
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from .errors import NullDataError
from .model import CoefImage

from .ops import effects as fx


def _require(img: CoefImage) -> None:
    if img is None or not img.coefs:
        raise NullDataError("no image")


def _dc_clamp(img: CoefImage) -> int:
    """Dequantized-DC clamp range: +-2047 for 8-bit samples (the reference's
    hardcoded value, effect.c:149), +-32767 for 12-bit frames."""
    return (1 << (getattr(img, "precision", 8) + 3)) - 1


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _back(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def grayscale(img: CoefImage, device="cuda") -> CoefImage:
    _require(img)
    if img.jpeg_color_space != C.JCS_YCbCr:
        return img.copy()
    out = img.copy()
    for c in range(1, out.num_components):
        out.coefs[c] = _back(fx.zero_component(_on(out.coefs[c], device)))
    return out


def pixelate(img: CoefImage, device="cuda") -> CoefImage:
    _require(img)
    out = img.copy()
    for c in range(out.num_components):
        out.coefs[c] = _back(fx.zero_ac(_on(out.coefs[c], device)))
    return out


def _add_to_dc(out: CoefImage, c: int, value: int, clamp: int, device):
    q = np.asarray(out.quant_table_for(c), np.int32)
    out.coefs[c] = _back(fx.add_to_dc(_on(out.coefs[c], device),
                                      _on(q, device), value, clamp))


def tint(img: CoefImage, cb_value: int, cr_value: int,
         device="cuda") -> CoefImage:
    _require(img)
    if img.jpeg_color_space != C.JCS_YCbCr:
        return img.copy()
    if cb_value == 0 and cr_value == 0:
        return img.copy()
    out = img.copy()
    clamp = _dc_clamp(img)
    if cb_value != 0 and out.num_components > 1:
        _add_to_dc(out, 1, cb_value, clamp, device)
    if cr_value != 0 and out.num_components > 2:
        _add_to_dc(out, 2, cr_value, clamp, device)
    return out


def luminance(img: CoefImage, value: int, device="cuda") -> CoefImage:
    _require(img)
    if img.jpeg_color_space != C.JCS_YCbCr:
        return img.copy()
    out = img.copy()
    _add_to_dc(out, 0, value, _dc_clamp(img), device)
    return out
