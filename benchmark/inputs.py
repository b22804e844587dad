"""The benchmark's inputs, made from ``--seed`` by the benchmark alone:
pixels, logos and JPEG files.

The picture generator copies ``make_test_image`` and the logo generator
``make_logo`` of bench.py (and of libmodjpeg_tpu_torch/scripts/bench.py),
with two changes: the picture runs in torch on the run's device, in one
call for many pictures, and it adds a per-pixel texture and a per-picture
phase so that the files code to about the bits per pixel of a photo.  The
pixels go to JPEG coefficients by the baseline arithmetic (JFIF colour
transform, 2x2 box subsampling, the orthonormal 8x8 DCT in float64,
libjpeg's quality-scaled Annex K tables, round to nearest) and to bytes by
the benchmark's frozen coder, with the standard Huffman tables as libjpeg
writes them by default.  Nothing here calls the program.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import coder

# T.81 Annex K tables K.1 and K.2 (natural order)
STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64).reshape(8, 8)
STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32, np.int64).reshape(8, 8)

JFIF_APP0 = (0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def substream(seed: int, tag: int) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``; any
    whole number, however large or negative, maps to one."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), tag])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def quant_table(std: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling + jpeg_add_quant_table (baseline)."""
    q = max(1, min(100, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((std * scale + 50) // 100, 1, 255).astype(np.uint16)


def dct_matrix() -> np.ndarray:
    """Orthonormal 8x8 DCT-II; JPEG coefficients are T @ X @ T.T."""
    t = np.zeros((8, 8))
    for u in range(8):
        cu = math.sqrt(0.5) if u == 0 else 1.0
        for x in range(8):
            t[u, x] = 0.5 * cu * math.cos((2 * x + 1) * u * math.pi / 16)
    return t


def photo_pixels(gen: torch.Generator, n: int, w: int, h: int,
                texture: float, device) -> torch.Tensor:
    """``n`` photo-like RGB pictures, float64 [n, h, w, 3] in [0, 255]:
    bench.py's smooth gradients and 8x8-block texture, shifted by a phase
    per picture, plus a per-pixel texture of standard deviation
    ``texture`` shared by the three channels (detail is mostly in luma)."""
    f64 = torch.float64
    yy = torch.arange(h, dtype=f64, device=device).view(1, h, 1)
    xx = torch.arange(w, dtype=f64, device=device).view(1, 1, w)
    phase = torch.rand((n, 2, 1, 1), generator=gen, dtype=f64,
                       device=device) * 997.0
    px, py = xx + phase[:, 0], yy + phase[:, 1]
    base = (128 + 80 * torch.sin(px / 97.0) * torch.cos(py / 71.0)
            + 40 * torch.sin((px + py) / 31.0))
    tex = torch.randn((n, h // 8 + 1, w // 8 + 1), generator=gen, dtype=f64,
                      device=device) * 14
    tex = tex.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :h, :w]
    fine = torch.randn((n, h, w), generator=gen, dtype=f64,
                       device=device) * texture
    img = torch.stack([
        base + tex + fine,
        base * 0.9 + tex + 10 * torch.sin(yy / 53.0) + fine,
        base * 1.05 - tex * 0.5 + fine,
    ], dim=-1)
    return img.clamp(0, 255).round()


def make_logo(rng: np.random.Generator, w: int, h: int) -> np.ndarray:
    """bench.py's make_logo: noise colours, soft alpha (opaque core, a
    transparent border ramping in over 11 pixels); uint8 [h, w, 4]."""
    logo = rng.integers(0, 255, (h, w, 4), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    d = np.minimum.reduce([xx, yy, w - 1 - xx, h - 1 - yy]).astype(np.float32)
    logo[..., 3] = np.clip(d * 24, 0, 255).astype(np.uint8)
    return logo


def pad_to_mcu(rgb: torch.Tensor, mcu: int = 16) -> torch.Tensor:
    """[n, h, w, 3] -> [n, H, W, 3] with H, W the next multiples of
    ``mcu``, the last row and column repeated into the padding, as libjpeg
    expands a picture's edges to whole MCUs before the DCT."""
    n, h, w, _ = rgb.shape
    ph, pw = -h % mcu, -w % mcu
    if ph:
        rgb = torch.cat([rgb, rgb[:, -1:].expand(n, ph, w, 3)], dim=1)
    if pw:
        rgb = torch.cat([rgb, rgb[:, :, -1:].expand(n, h + ph, pw, 3)],
                        dim=2)
    return rgb


def to_coefficients(rgb: torch.Tensor, quality: int) -> list:
    """[n, h, w, 3] float64 RGB -> per component int16 [n, rows, cols, 8,
    8] quantized coefficients of a 4:2:0 YCbCr JPEG (Y at 2x2, Cb and Cr at
    1x1), on the host; sides that are not multiples of 16 are padded to
    whole MCUs first (``pad_to_mcu``)."""
    rgb = pad_to_mcu(rgb)
    n, h, w, _ = rgb.shape
    r, g, b = rgb.unbind(-1)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    t = torch.from_numpy(dct_matrix()).to(rgb.device)
    out = []
    for plane, std, sub in ((y, STD_LUMA, 1), (cb, STD_CHROMA, 2),
                            (cr, STD_CHROMA, 2)):
        if sub == 2:
            plane = plane.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
        ph, pw = plane.shape[1:]
        blocks = plane.reshape(n, ph // 8, 8, pw // 8, 8).permute(0, 1, 3, 2, 4)
        coef = t @ (blocks - 128.0) @ t.T
        q = torch.from_numpy(quant_table(std, quality).astype(np.float64))
        out.append(torch.round(coef / q.to(rgb.device)).clamp(-1023, 1023)
                   .to(torch.int16).cpu().numpy())
    return out


def image_dict(coefs: list, w: int, h: int, quality: int) -> dict:
    """One picture's planes as the frozen coder's image dict."""
    return {"width": w, "height": h,
            "comps": [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)],
            "coefs": coefs,
            "qtables": {0: quant_table(STD_LUMA, quality).reshape(8, 8),
                        1: quant_table(STD_CHROMA, quality).reshape(8, 8)},
            "markers": [JFIF_APP0]}


def jpeg_files(seed: int, count: int, w: int, h: int, quality: int,
               texture: float, options: int, restart_interval: int,
               device, chunk: int = 16, workers: int = 8) -> list:
    """``count`` distinct JPEG files (bytes) drawn from ``seed``: pictures
    made ``chunk`` at a time on ``device``, coded by the frozen coder on
    ``workers`` threads (ctypes releases the GIL)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(substream(seed, 1))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = []
        for start in range(0, count, chunk):
            k = min(chunk, count - start)
            planes = to_coefficients(
                photo_pixels(gen, k, w, h, texture, device), quality)
            for i in range(k):
                img = image_dict([p[i] for p in planes], w, h, quality)
                futures.append(pool.submit(coder.encode, img, options,
                                           restart_interval))
        return [f.result() for f in futures]


def logo_pixels(seed: int, w: int, h: int) -> np.ndarray:
    return make_logo(np.random.default_rng(substream(seed, 2)), w, h)
