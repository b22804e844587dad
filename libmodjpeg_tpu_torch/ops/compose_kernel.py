"""Wrappers of the hand-written Hopper kernel (csrc/compose.cu).

``compose_rows_cuda`` launches its compose mode and adds one to
``launches``; ``blend_blocks_cuda`` launches its blend mode and adds one to
``blend_launches``.  Both launch on PyTorch's current stream.  Their plain
PyTorch versions, the CPU path and the kernels' test oracles, are
``compose_rows_ref`` (which broadcasts the compact operands and calls the
TPU kernel's [N, 64] form ``compose_blocks_ref``) and ``blend_blocks_m``
(ops/compose.py).  The library is built by ``_build.load`` at the first
launch, never at import.
"""

from __future__ import annotations

import torch

from .compose import blend_blocks_m, compose_rows_ref  # noqa: F401
from .compose import dct_kron, dct_kron_t

# kernel launches so far in this process, per mode (a run resets them to 0
# to show that its path went through the kernel)
launches = 0
blend_launches = 0


def _check(who: str, dev: torch.device, name: str, t: torch.Tensor,
           dtype: torch.dtype) -> None:
    """Raise unless ``t`` is a ``dtype`` tensor on the CUDA device ``dev``
    whose data pointer is 16-byte aligned."""
    if dev.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {dev}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, first operand on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _block_strides(name: str, t: torch.Tensor, shape: tuple) -> tuple:
    """(image stride, block-row stride) in elements of a [n, h, w, 64]
    block view: each block's 64 values contiguous, the blocks of a block
    row adjacent, the two outer strides multiples of 64."""
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {list(shape)}, got "
                         f"{list(t.shape)}")
    n, h, w, _ = shape
    si, sy, sb, sc = t.stride()
    if sc != 1 or (w > 1 and sb != 64):
        raise ValueError(f"{name}: each block row must be w contiguous "
                         f"blocks of 64 values, got strides {t.stride()}")
    for size, st in ((n, si), (h, sy)):
        if size > 1 and (st % 64 or st <= 0):
            raise ValueError(f"{name}: outer strides must be positive "
                             f"multiples of 64, got {t.stride()}")
    return (si if n > 1 else 0), (sy if h > 1 else 0)


def _per_image(name: str, t: torch.Tensor, n: int, inner: tuple) -> int:
    """Element stride between images of an operand given per image
    ([n, *inner]) or shared ([1, *inner], stride 0), inner contiguous."""
    if t.dim() != 1 + len(inner) or tuple(t.shape[1:]) != inner \
            or t.shape[0] not in (1, n):
        raise ValueError(f"{name} must be [1 or {n}, "
                         f"{', '.join(map(str, inner))}], got "
                         f"{list(t.shape)}")
    if not t[0].is_contiguous():
        raise ValueError(f"{name}: each image's operand must be contiguous")
    if t.shape[0] == 1 or n == 1:
        return 0
    if t.stride(0) % 64 or t.stride(0) <= 0:
        raise ValueError(f"{name}: image stride must be a positive multiple "
                         f"of 64, got {t.stride(0)}")
    return t.stride(0)


def _launch(entry: str, dev: torch.device, *args) -> None:
    """Call the C entry point with ``args`` (tensors as their data
    pointers) and the current stream of ``dev``."""
    from .. import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        rc = getattr(lib, entry)(*vals, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


def compose_rows_cuda(region: torch.Tensor, quant: torch.Tensor,
                      dropon: torch.Tensor, mask: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Fused dequant + masked blend + truncating requant on the card, on
    compact operands read where they lie.

    region: int16 [n, h, w, 64], a view whose blocks are 64 contiguous
    values and whose block rows hold w adjacent blocks; images and block
    rows may sit at any stride that is a multiple of 64 (a component's
    slice of the packed [n, per_file] row, or a footprint window of an
    [N, H, W, 8, 8] grid).  quant: int32 [n, 64] (one table per image) or
    [1, 64] (shared), every value >= 1.  dropon/mask: float32 [h * w, 64]
    (shared by every image) or [n, h * w, 64] (per image).  out: int16 of
    region's shape and the same layout rules, written in place; it may be
    region itself but must not otherwise overlap it; a new contiguous
    tensor when None.  All on one CUDA device.  Returns out.
    """
    global launches
    dev = region.device
    if region.dim() != 4:
        raise ValueError(f"region must be [n, h, w, 64], got "
                         f"{list(region.shape)}")
    n, h, w, _ = region.shape
    if out is None:
        out = torch.empty(region.shape, dtype=torch.int16, device=dev)
    dropon = dropon if dropon.dim() == 3 else dropon.unsqueeze(0)
    mask = mask if mask.dim() == 3 else mask.unsqueeze(0)
    quant = quant if quant.dim() == 2 else quant.reshape(1, 64)
    # the layout first (device-independent), then devices, types, alignment
    shape = (n, h, w, 64)
    r_si, r_sy = _block_strides("region", region, shape)
    o_si, o_sy = _block_strides("out", out, shape)
    q_si = _per_image("quant", quant, n, (64,))
    d_si = _per_image("dropon", dropon, n, (h * w, 64))
    m_si = _per_image("mask", mask, n, (h * w, 64))
    if d_si != m_si or dropon.shape[0] != mask.shape[0]:
        raise ValueError("dropon and mask must both be shared or both be "
                         "per image, at one stride")
    if h * w >= 2 ** 31:
        raise ValueError(f"{h * w} blocks per image is too many")
    for name, t, dt in (("region", region, torch.int16),
                        ("out", out, torch.int16),
                        ("quant", quant, torch.int32),
                        ("dropon", dropon, torch.float32),
                        ("mask", mask, torch.float32)):
        _check("compose_rows_cuda", dev, name, t, dt)
    if n * h * w == 0:
        return out
    _launch("mjt_compose_rows", dev, region, r_si, r_sy, quant, q_si,
            dropon, mask, d_si, out, o_si, o_sy, n, h, w, dct_kron(dev),
            dct_kron_t(dev))
    launches += 1
    return out


def blend_blocks_cuda(x_image: torch.Tensor, x_dropon: torch.Tensor,
                      mask_pix: torch.Tensor) -> torch.Tensor:
    """The f32 masked blend alone on the card:
    y = x1 + ((x0 - x1) @ U * m) @ U^T.

    x_image (x1)/x_dropon (x0)/mask_pix (m): [N, 64] float32, contiguous on
    one CUDA device.  Returns a new [N, 64] float32 tensor.  An all-zero
    mask block returns x1 exactly.
    """
    global blend_launches
    dev, n = x_image.device, x_image.shape[0]
    for name, t in (("x_image", x_image), ("x_dropon", x_dropon),
                    ("mask_pix", mask_pix)):
        _check("blend_blocks_cuda", dev, name, t, torch.float32)
        if tuple(t.shape) != (n, 64):
            raise ValueError(f"{name} must be [{n}, 64], got "
                             f"{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(x_image)
    if n == 0:
        return out
    _launch("mjt_blend_blocks", dev, x_image, x_dropon, mask_pix, out, n)
    blend_launches += 1
    return out
