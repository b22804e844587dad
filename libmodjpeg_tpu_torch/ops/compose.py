"""Masked DCT-domain composition (PyTorch port of libmodjpeg_tpu.ops.compose).

The blend operator sum_{kl} w_kl S_k (x) S_l read off the reference's
convolve.c is exactly diagonal in the orthonormal 2-D DCT basis, so with the
per-coefficient pixel-domain mask m (mask_pix_np) the blend is

  Y = x1 + U^T diag(m) U (x0 - x1),   U = C (x) C

two GEMMs per block.  ``compose_blocks_ref`` is the full quantized compose
step (dequantize, blend, truncating correction, truncating requantize) on
the TPU kernel's [N, 64] operands.  ``compose_rows`` is the step every
compose path runs, on the packed batch's compact operands (a strided block
region, one quant table per image, the dropon and mask shared or per
image): it launches the hand-written CUDA kernel (compose_kernel.py) on a
CUDA tensor and the plain-torch ``compose_rows_ref`` on a CPU tensor.
``blend_blocks_auto`` routes the bare f32 blend the same way (kernel bench
and parity only).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SQRT2 = float(np.sqrt(2.0))


@functools.lru_cache(maxsize=1)
def _dct_kron() -> np.ndarray:
    """U = C (x) C, the orthonormal 2-D DCT-II operator on row-major
    flattened 8x8 blocks, float32 [64, 64] (built in float64)."""
    C = np.zeros((8, 8), dtype=np.float64)
    for i in range(8):
        for j in range(8):
            c = np.sqrt(1 / 8) if i == 0 else np.sqrt(2 / 8)
            C[i, j] = c * np.cos((2 * j + 1) * i * np.pi / 16)
    return np.kron(C, C).astype(np.float32)


# mask-DCT weight -> pixel-mask scale: diagonal m = C^T (w * g) C where
# g = 16 f f^T, f = [sqrt2, 1, ..., 1]
_MASK_GAIN = 16.0 * np.outer(*([np.array([SQRT2] + [1.0] * 7)] * 2))


def mask_pix_np(w_alpha: np.ndarray) -> np.ndarray:
    """Normalized mask-DCT weights [..., 8, 8] -> the equivalent per-
    coefficient PIXEL-domain mask m [..., 8, 8] (float64 math, f32 out).
    Opaque mask -> m == 1, zero mask -> m == 0 exactly."""
    C = np.zeros((8, 8), dtype=np.float64)
    for i in range(8):
        for j in range(8):
            c = np.sqrt(1 / 8) if i == 0 else np.sqrt(2 / 8)
            C[i, j] = c * np.cos((2 * j + 1) * i * np.pi / 16)
    wg = np.asarray(w_alpha, np.float64) * _MASK_GAIN
    m = np.einsum("ki,...kl,lj->...ij", C, wg, C)
    return np.ascontiguousarray(m, np.float32)


@functools.lru_cache(maxsize=None)
def _dct_kron_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_dct_kron()).to(device)


def dct_kron(device) -> torch.Tensor:
    """_dct_kron() as a float32 tensor on ``device``, made once per device
    and shared by every caller (nobody writes to it): a copy to the card on
    every call would synchronise the stream."""
    return _dct_kron_on(torch.device(device))


@functools.lru_cache(maxsize=None)
def dct_kron_t(device) -> torch.Tensor:
    """The contiguous transpose of dct_kron(device), made once per device
    (the compose kernel's dense rows for opaque blocks)."""
    return dct_kron(device).t().contiguous()


def blend_blocks_m(x_image: torch.Tensor, x_dropon: torch.Tensor,
                   mask_pix: torch.Tensor) -> torch.Tensor:
    """Masked blend via the pixel-domain mask: x1 + IDCT2(m * DCT2(x0 - x1)).

    x_image/x_dropon/mask_pix: [N, 8, 8] float32.  Returns [N, 8, 8].  The
    plain version of the blend kernel (compose_kernel.blend_blocks_cuda).
    """
    n = x_image.shape[0]
    U = dct_kron(x_image.device)
    X = (x_dropon - x_image).reshape(n, 64)
    # row-vector convention: pixels p = X @ U, mask, back via @ U^T
    t = (X @ U) * mask_pix.reshape(n, 64)
    Y = t @ U.T
    return x_image + Y.reshape(n, 8, 8)


def blend_blocks_auto(x_image: torch.Tensor, x_dropon: torch.Tensor,
                      mask_pix: torch.Tensor) -> torch.Tensor:
    """The f32 blend on [N, 8, 8] operands (pixel-mask contract): a CPU
    tensor runs blend_blocks_m, a CUDA tensor the kernel's blend mode
    (compose_kernel.blend_blocks_cuda), which raises rather than fall back.

    No compose path calls it: every compose runs the fused compose_blocks.
    It exists for the kernel bench and for parity with the TPU blend kernel.
    """
    if x_image.device.type == "cpu":
        return blend_blocks_m(x_image, x_dropon, mask_pix)
    from .compose_kernel import blend_blocks_cuda

    n = x_image.shape[0]
    y = blend_blocks_cuda(x_image.reshape(n, 64).contiguous(),
                          x_dropon.reshape(n, 64).contiguous(),
                          mask_pix.reshape(n, 64).contiguous())
    return y.reshape(n, 8, 8)


def requant_trunc(values: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """C-style truncating integer division in int32 (compose.c:327-336):
    sign(v) * (|v| // q).  The operand of // is non-negative, so floor and
    truncating division agree."""
    q = quant.to(torch.int32)
    v = values.to(torch.int32)
    return torch.sign(v) * torch.div(v.abs(), q, rounding_mode="floor")


def compose_blocks_ref(region: torch.Tensor, x_dropon: torch.Tensor,
                       mask_pix: torch.Tensor,
                       quant: torch.Tensor) -> torch.Tensor:
    """Plain-torch fused compose step, the CUDA kernel's reference.

    region: [N, 64] int16/int32 quantized coefficients; x_dropon/mask_pix:
    [N, 64] float32; quant: [N, 64] int32 (per block, already broadcast).
    Returns [N, 64] int16.  An exactly-zero mask block reproduces its input
    exactly (the delta is 0 and sign(r*q)*(|r*q|//q) == r).
    """
    n = region.shape[0]
    reg = region.to(torch.int32)
    qi = quant.to(torch.int32)
    x1 = reg.to(torch.float32) * qi.to(torch.float32)
    y = blend_blocks_m(x1.reshape(n, 8, 8),
                       x_dropon.to(torch.float32).reshape(n, 8, 8),
                       mask_pix.to(torch.float32).reshape(n, 8, 8))
    corr = torch.trunc(y.reshape(n, 64) - x1).to(torch.int32)
    out = requant_trunc(reg * qi + corr, qi)
    return out.clamp(-32768, 32767).to(torch.int16)


def compose_rows_ref(region: torch.Tensor, quant: torch.Tensor,
                     dropon: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's compose mode: broadcasts the compact
    operands to the [N, 64] form and runs compose_blocks_ref.

    region: int16 [n, h, w, 64] (any strides); quant: [n, 64] or [1, 64];
    dropon/mask: [h * w, 64] (shared) or [n, h * w, 64] (per image).
    Returns a new int16 [n, h, w, 64] tensor.
    """
    n, h, w, _ = region.shape
    hw = h * w

    def blocks(t, rows):  # [1 or n, rows, 64] -> [n * hw, 64]
        return t.reshape(-1, rows, 64).expand(n, hw, 64).reshape(n * hw, 64)

    out = compose_blocks_ref(region.reshape(n * hw, 64), blocks(dropon, hw),
                             blocks(mask, hw), blocks(quant, 1))
    return out.reshape(n, h, w, 64)


def compose_rows(region: torch.Tensor, quant: torch.Tensor,
                 dropon: torch.Tensor, mask: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The compose step on compact operands (the port of
    compose_region_auto, as the packed batch calls it).

    region: int16 [n, h, w, 64] (a view of the packed row or of a grid's
    footprint window); quant: int32 [n, 64] or [1, 64]; dropon/mask:
    float32 [h * w, 64] or [n, h * w, 64]; ``out``: where the result goes
    (may be region itself), a new tensor when None.  A CPU tensor runs
    compose_rows_ref; a CUDA tensor launches the CUDA kernel
    (compose_kernel.compose_rows_cuda), which raises rather than fall back.
    Returns the result.
    """
    if region.device.type == "cpu":
        res = compose_rows_ref(region, quant, dropon, mask)
        if out is None:
            return res
        out.copy_(res)
        return out
    from .compose_kernel import compose_rows_cuda

    return compose_rows_cuda(region, quant, dropon, mask, out)
