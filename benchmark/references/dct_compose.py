"""Plain reference of the DCT-domain watermark: placement, dropon
compilation, the masked compose with its truncating requantization, and the
DC effects, in plain torch and numpy.

It copies the arithmetic the reference library states (compose.c:57-172
placement, dropon.c:325-576 compilation, convolve.c's blend read as the
pixel-domain mask m = C^T (w * g) C, compose.c:327-336 requantization,
effect.c:28-68 grayscale, 70-114 pixelate, 143-153 and 207-217 DC
edits) as libmodjpeg_tpu_torch's
``composer``, ``ops/compose.py``, ``ops/dct.py`` and ``ops/effects.py``
hold it, written out again for the benchmark.  It imports nothing of the
program and takes nothing the program made: it reads the logo's pixels and
the input's coefficients and works the compiled dropon out itself.

``matmul`` is the one place where the precision is chosen: "f32" is plain
float32 (the configuration's precision), "tf32" rounds both operands of
every product to TF32's 10-bit mantissa first, as a tensor core does, and
is the benchmark's control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# libmodjpeg.h's MJ_ALIGN_* bits
ALIGN_LEFT, ALIGN_RIGHT, ALIGN_TOP, ALIGN_BOTTOM, ALIGN_CENTER = 1, 2, 4, 8, 16
ALIGNS = {"LEFT": ALIGN_LEFT, "RIGHT": ALIGN_RIGHT, "TOP": ALIGN_TOP,
          "BOTTOM": ALIGN_BOTTOM, "CENTER": ALIGN_CENTER}


def align_bits(names) -> int:
    bits = 0
    for n in names:
        bits |= ALIGNS[n]
    return bits


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (TF32), ties
    away from zero, as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    elif precision != "f32":
        raise ValueError(precision)
    return a @ b


def placement(img_w, img_h, mcu_w, mcu_h, logo_w, logo_h, align, ox, oy):
    """compose.c:57-172 -> None when nothing is composed, else (crop_x,
    crop_y, crop_w, crop_h, blockoffset_x, blockoffset_y, block_x,
    block_y), block_* in MCUs."""
    if align & ALIGN_LEFT:
        px = 0
    elif align & ALIGN_RIGHT:
        px = img_w - logo_w
    else:
        px = img_w // 2 - logo_w // 2
    px += ox
    if align & ALIGN_TOP:
        py = 0
    elif align & ALIGN_BOTTOM:
        py = img_h - logo_h
    else:
        py = img_h // 2 - logo_h // 2
    py += oy
    crop_x = -px if px < 0 else 0
    crop_w = logo_w - crop_x
    if crop_x > logo_w or px > img_w:
        crop_w = 0
    elif px + crop_x + crop_w > img_w:
        crop_w = img_w - crop_x - px
    crop_y = -py if py < 0 else 0
    crop_h = logo_h - crop_y
    if crop_y > logo_h or py > img_h:
        crop_h = 0
    elif py + crop_y + crop_h > img_h:
        crop_h = img_h - crop_y - py
    if crop_w <= 0 or crop_h <= 0:
        return None
    return (crop_x, crop_y, crop_w, crop_h,
            px % mcu_w if px >= 0 else 0, py % mcu_h if py >= 0 else 0,
            max(0, int(math.trunc(px / mcu_w))),
            max(0, int(math.trunc(py / mcu_h))))


def _dct64() -> np.ndarray:
    """Orthonormal 8x8 DCT-II C, float64: coefficients are C @ X @ C.T."""
    return np.array([[(math.sqrt(1 / 8) if i == 0 else math.sqrt(2 / 8))
                      * math.cos((2 * j + 1) * i * math.pi / 16)
                      for j in range(8)] for i in range(8)])


def _dct_t(device) -> torch.Tensor:
    return torch.from_numpy(_dct64().astype(np.float32)).to(device)


def _blocks_dct(plane: torch.Tensor, fh: int, fv: int,
                precision: str) -> torch.Tensor:
    """Box-subsample an [H, W] float32 plane by (fh, fv), tile it into 8x8
    blocks and take the rounded forward DCT of the level-shifted samples:
    [H/8fv, W/8fh, 8, 8]."""
    h, w = plane.shape
    if fh != 1 or fv != 1:
        plane = plane.reshape(h // fv, fv, w // fh, fh).mean(dim=(1, 3))
        h, w = plane.shape
    blk = plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3) - 128.0
    t = _dct_t(plane.device)
    return torch.round(matmul(matmul(t, blk, precision), t.T, precision))


def _alpha_factors() -> torch.Tensor:
    """dropon.c:544-566's c(i)c(j)/1020 normalization, float32."""
    factors = np.full((8, 8), 0.25 / 1020.0, np.float32)
    factors[0, :] = 0.3535534 * 0.5 / 1020.0
    factors[:, 0] = 0.5 * 0.3535534 / 1020.0
    factors[0, 0] = 0.3535534 * 0.3535534 / 1020.0
    return torch.from_numpy(factors)


def _mask_gain() -> np.ndarray:
    """g = 16 f f^T, f = [sqrt2, 1, ..., 1]: the normalized weights times g
    are the blend operator's diagonal in the orthonormal basis."""
    f = np.array([math.sqrt(2.0)] + [1.0] * 7)
    return 16.0 * np.outer(f, f)


def compile_logo(rgba: np.ndarray, comps, mcu_w: int, mcu_h: int, place,
                 precision: str = "f32", device="cpu") -> list:
    """The logo's pixels against a YCbCr target -> per component (dropon
    blocks, pixel mask), each float32 [h, w, 64], as dropon.c compiles
    them: the cropped logo padded by the block offset and up to the MCU
    multiple with transparent pixels, converted to YCbCr, box-subsampled,
    rounded Q100 DCT; alpha likewise without the colour transform, its DCT
    DC shifted by +1024, scaled by c(i)c(j)/1020, and carried to the pixel
    domain (float64, stored as float32)."""
    crop_x, crop_y, crop_w, crop_h, box, boy = place[:6]
    width = -(-(crop_w + box) // mcu_w) * mcu_w
    height = -(-(crop_h + boy) // mcu_h) * mcu_h
    img = np.zeros((height, width, 3), np.float32)
    alpha = np.zeros((height, width), np.float32)
    img[boy:boy + crop_h, box:box + crop_w] = \
        rgba[crop_y:crop_y + crop_h, crop_x:crop_x + crop_w, :3]
    alpha[boy:boy + crop_h, box:box + crop_w] = \
        rgba[crop_y:crop_y + crop_h, crop_x:crop_x + crop_w, 3]
    rgb = torch.from_numpy(img).to(device)
    r, g, b = rgb.unbind(-1)
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0,
              0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0]
    a = torch.from_numpy(alpha).to(device)
    max_h = max(c[1] for c in comps)
    max_v = max(c[2] for c in comps)
    c64, gain = _dct64(), _mask_gain()
    out = []
    for c, (_cid, hs, vs, _tq) in enumerate(comps):
        fh, fv = max_h // hs, max_v // vs
        drop = _blocks_dct(planes[c], fh, fv, precision)
        wts = _blocks_dct(a, fh, fv, precision)
        wts[..., 0, 0] += 1024.0
        wts = wts * _alpha_factors().to(wts.device)
        wg = wts.cpu().double().numpy() * gain
        mask = np.einsum("ki,...kl,lj->...ij", c64, wg, c64)
        hb, wb = drop.shape[:2]
        out.append((drop.reshape(hb, wb, 64).float(),
                    torch.from_numpy(mask.astype(np.float32))
                    .reshape(hb, wb, 64).to(device)))
    return out


def _kron_u(device) -> torch.Tensor:
    """U = C (x) C on row-major flattened blocks, float32 [64, 64]."""
    c = _dct64()
    return torch.from_numpy(np.kron(c, c).astype(np.float32)).to(device)


def compose_blocks(region: np.ndarray, quant: np.ndarray, drop: torch.Tensor,
                   mask: torch.Tensor, precision: str = "f32",
                   device="cpu") -> np.ndarray:
    """One component's footprint: region int16 [h, w, 8, 8], quant [8, 8];
    drop/mask float32 [h, w, 64].  Dequantize, blend in the pixel domain
    (x1 + ((x0 - x1) U * m) U^T), truncate the correction, requantize by
    truncating division, saturate to int16."""
    h, w = region.shape[:2]
    r = torch.from_numpy(region.reshape(h * w, 64).astype(np.int32)).to(device)
    q = torch.from_numpy(quant.reshape(1, 64).astype(np.int32)).to(device)
    x1 = (r * q).to(torch.float32)
    u = _kron_u(device)
    d = drop.reshape(h * w, 64).to(device) - x1
    y = matmul(matmul(d, u, precision) * mask.reshape(h * w, 64).to(device),
               u.T, precision)
    # the correction is read off the blended value, as the library computes
    # it: trunc((x1 + delta) - x1), not trunc(delta)
    corr = torch.trunc((x1 + y) - x1).to(torch.int32)
    v = r * q + corr
    out = torch.sign(v) * torch.div(v.abs(), q, rounding_mode="floor")
    return out.clamp(-32768, 32767).to(torch.int16).cpu().numpy().reshape(
        h, w, 8, 8)


def dc_add(plane: np.ndarray, q0: int, value: int,
           clamp: int = 2047) -> np.ndarray:
    """tint / luminance on one component: dequantized DC + value, clamped
    to +-clamp, requantized by truncating division."""
    out = plane.copy()
    dc = plane[:, :, 0, 0].astype(np.int64) * q0 + value
    dc = np.clip(dc, -clamp, clamp)
    out[:, :, 0, 0] = (np.sign(dc) * (np.abs(dc) // q0)).astype(np.int16)
    return out


def apply_effects(img: dict, effects) -> None:
    """The configuration's effects in order, in place of img["coefs"]
    (a YCbCr image): ["grayscale"] zeroes every coefficient of the chroma
    components, ["pixelate"] the 63 AC coefficients of every block of
    every component, ["luminance", value] edits Y's DC, ["tint", cb, cr]
    Cb's and Cr's."""
    for name, *args in effects:
        if name == "grayscale":
            for c in range(1, len(img["coefs"])):
                img["coefs"][c] = np.zeros_like(img["coefs"][c])
            continue
        if name == "pixelate":
            for c, plane in enumerate(img["coefs"]):
                out = np.zeros_like(plane)
                out[:, :, 0, 0] = plane[:, :, 0, 0]
                img["coefs"][c] = out
            continue
        if name == "luminance":
            steps = [(0, args[0])]
        elif name == "tint":
            steps = [(1, args[0]), (2, args[1] if len(args) > 1 else 0)]
        else:
            raise ValueError(f"effect {name!r} has no reference")
        for c, value in steps:
            if value:
                q0 = int(img["qtables"][img["comps"][c][3]][0, 0])
                img["coefs"][c] = dc_add(img["coefs"][c], q0, value)


def footprints(img: dict, logo: np.ndarray, align: int, ox: int, oy: int,
               precision: str = "f32", device="cpu"):
    """Per component (row0, col0, dropon, mask) of the logo on ``img``, or
    [] when the placement composes nothing."""
    comps = img["comps"]
    max_h = max(c[1] for c in comps)
    max_v = max(c[2] for c in comps)
    mcu_w, mcu_h = 8 * max_h, 8 * max_v
    place = placement(img["width"], img["height"], mcu_w, mcu_h,
                      logo.shape[1], logo.shape[0], align, ox, oy)
    if place is None:
        return []
    block_x, block_y = place[6], place[7]
    compiled = compile_logo(logo, comps, mcu_w, mcu_h, place, precision,
                            device)
    return [(block_y * vs, block_x * hs, drop, mask)
            for (_cid, hs, vs, _tq), (drop, mask) in zip(comps, compiled)]


def expected(img: dict, effects, fps, precision: str = "f32",
             device="cpu") -> list:
    """The coefficients the chain should give: ``effects`` on the whole
    image, then the footprints ``fps`` composed.  Returns new planes."""
    work = dict(img, coefs=[a.copy() for a in img["coefs"]])
    apply_effects(work, effects)
    for c, (r0, c0, drop, mask) in enumerate(fps):
        h, w = drop.shape[:2]
        q = work["qtables"][work["comps"][c][3]]
        plane = work["coefs"][c]
        plane[r0:r0 + h, c0:c0 + w] = compose_blocks(
            plane[r0:r0 + h, c0:c0 + w], q, drop, mask, precision, device)
    return work["coefs"]
