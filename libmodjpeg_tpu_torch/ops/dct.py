"""DCT, color conversion and resampling primitives (PyTorch port of
libmodjpeg_tpu.ops.dct).

At quality 100 every libjpeg quantval is 1, so the dropon's "quantized at
Q100" coefficients are the forward DCT rounded to the nearest integer.
All functions take and return float32 tensors on any device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def dct_matrix_np() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix T; JPEG coefficients are T @ X @ T.T."""
    T = np.zeros((8, 8), dtype=np.float64)
    for u in range(8):
        cu = np.sqrt(0.5) if u == 0 else 1.0
        for x in range(8):
            T[u, x] = 0.5 * cu * np.cos((2 * x + 1) * u * np.pi / 16)
    return T


@functools.lru_cache(maxsize=1)
def _t32() -> np.ndarray:
    return dct_matrix_np().astype(np.float32)


@functools.lru_cache(maxsize=None)
def _t32_on(device: torch.device) -> torch.Tensor:
    """_t32() on ``device``, made once per device (nobody writes to it): a
    copy to the card on every call would synchronise the stream."""
    return torch.from_numpy(_t32()).to(device)


def fdct_blocks(pixels: torch.Tensor, center: float = 128.0) -> torch.Tensor:
    """Forward DCT of level-shifted pixel blocks.

    pixels: [..., 8, 8] float32 sample values in [0, 2^P - 1]; ``center`` is
    the level shift 2^(P-1).  Returns [..., 8, 8] float32 unquantized
    JPEG-scale coefficients.
    """
    x = pixels - center
    T = _t32_on(pixels.device)
    return torch.einsum("ux,...xy,vy->...uv", T, x, T)


def idct_blocks(coefs: torch.Tensor, center: float = 128.0) -> torch.Tensor:
    """Inverse DCT: [..., 8, 8] float32 coefficients -> [..., 8, 8] pixel
    values, T.T @ X @ T + center.

    Each 8-term sum is written out as separate multiply and add passes in a
    fixed order rather than a matmul: every elementwise op is one IEEE f32
    operation on any device, so the card and the CPU give the same bits and
    the later rint cannot tip differently on the two (a matmul library sums
    in its own order, and a DC-only block lands exactly on a .5 tie).
    """
    T = torch.from_numpy(_t32()).to(coefs.device)
    # rows: tmp[..., u, y] = sum_v X[..., u, v] * T[v, y]
    tmp = coefs[..., :, 0:1] * T[0]
    for v in range(1, 8):
        tmp = tmp + coefs[..., :, v:v + 1] * T[v]
    # columns: out[..., x, y] = sum_u T[u, x] * tmp[..., u, y]
    out = T[0][:, None] * tmp[..., 0:1, :]
    for u in range(1, 8):
        out = out + T[u][:, None] * tmp[..., u:u + 1, :]
    return out + center


def tile_blocks(plane: torch.Tensor) -> torch.Tensor:
    """[H, W] plane (H, W multiples of 8) -> [H/8, W/8, 8, 8] blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)


def untile_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """[bh, bw, 8, 8] -> [bh*8, bw*8]."""
    bh, bw = blocks.shape[:2]
    return blocks.permute(0, 2, 1, 3).reshape(bh * 8, bw * 8)


def rgb_to_ycc(rgb: torch.Tensor, center: float = 128.0) -> torch.Tensor:
    """[..., 3] float32 RGB in [0, 2^P - 1] -> [..., 3] YCbCr; ``center`` is
    the chroma zero point 2^(P-1)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + center
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + center
    return torch.stack([y, cb, cr], dim=-1)


def ycc_to_rgb(ycc: torch.Tensor, center: float = 128.0) -> torch.Tensor:
    """[..., 3] YCbCr -> RGB (JFIF inverse)."""
    y, cb, cr = ycc[..., 0], ycc[..., 1] - center, ycc[..., 2] - center
    r = y + 1.402 * cr
    g = y - 0.344136286 * cb - 0.714136286 * cr
    b = y + 1.772 * cb
    return torch.stack([r, g, b], dim=-1)


def subsample_plane(plane: torch.Tensor, fh: int, fv: int) -> torch.Tensor:
    """Box-average downsample [H, W] by integer factors (fh, fv)."""
    if fh == 1 and fv == 1:
        return plane
    h, w = plane.shape
    return plane.reshape(h // fv, fv, w // fh, fh).mean(dim=(1, 3))


def upsample_plane_fancy(plane: torch.Tensor, fh: int,
                         fv: int) -> torch.Tensor:
    """Triangle-filter ("fancy") upsample of [H, W] by factors 1 or 2, with
    the JAX package's float formulas ((3a + b + 1) / 4 and (3a + b + 2) / 4,
    edges replicated), not libjpeg's integer shifts; other factors repeat
    samples."""
    out = plane
    if fh == 2:
        right = torch.cat([out[:, :1], out[:, :-1]], dim=1)
        nxt = torch.cat([out[:, 1:], out[:, -1:]], dim=1)
        a = (3.0 * out + right + 1.0) / 4.0
        b = (3.0 * out + nxt + 2.0) / 4.0
        out = torch.stack([a, b], dim=-1).reshape(out.shape[0], -1)
    elif fh != 1:
        out = torch.repeat_interleave(out, fh, dim=1)
    if fv == 2:
        up = torch.cat([out[:1], out[:-1]], dim=0)
        down = torch.cat([out[1:], out[-1:]], dim=0)
        a = (3.0 * out + up + 1.0) / 4.0
        b = (3.0 * out + down + 2.0) / 4.0
        out = torch.stack([a, b], dim=1).reshape(-1, out.shape[1])
    elif fv != 1:
        out = torch.repeat_interleave(out, fv, dim=0)
    return out
