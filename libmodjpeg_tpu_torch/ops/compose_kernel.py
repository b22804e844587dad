"""Wrappers of the hand-written Hopper kernel (csrc/compose.cu).

``compose_blocks_cuda`` launches its compose mode and adds one to
``launches``; ``blend_blocks_cuda`` launches its blend mode and adds one to
``blend_launches``.  Both launch on PyTorch's current stream.  Their plain
PyTorch versions, the CPU path and the kernels' test oracles, are
``compose_blocks_ref`` and ``blend_blocks_m`` (ops/compose.py).  The
library is built by ``_build.load`` at the first launch, never at import.
"""

from __future__ import annotations

import torch

from .compose import blend_blocks_m, compose_blocks_ref, dct_kron  # noqa: F401

# kernel launches so far in this process, per mode (a run resets them to 0
# to show that its path went through the kernel)
launches = 0
blend_launches = 0


def _check(operands, dev: torch.device, n: int, who: str) -> None:
    """Raise unless every (name, tensor, dtype) is a contiguous [n, 64]
    tensor of that dtype on the CUDA device ``dev``."""
    if dev.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {dev}")
    for name, t, dt in operands:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, first operand on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.shape != (n, 64):
            raise ValueError(f"{name} must be [{n}, 64], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(entry: str, dev: torch.device, *tensors, n: int) -> None:
    """Call the C entry point on the current stream of ``dev`` with the
    tensors' pointers and the resident U after the first operands."""
    from .. import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        u = dct_kron(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        *ins, out = [t.data_ptr() for t in tensors]
        rc = getattr(lib, entry)(*ins, u.data_ptr(), out, n, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


def compose_blocks_cuda(region: torch.Tensor, x_dropon: torch.Tensor,
                        mask_pix: torch.Tensor,
                        quant: torch.Tensor) -> torch.Tensor:
    """Fused dequant + masked blend + truncating requant on the card.

    region: [N, 64] int16; x_dropon/mask_pix: [N, 64] float32; quant:
    [N, 64] int32 with every value >= 1.  All contiguous on one CUDA
    device.  Returns a new [N, 64] int16 tensor.
    """
    global launches
    dev, n = region.device, region.shape[0]
    _check((("region", region, torch.int16),
            ("x_dropon", x_dropon, torch.float32),
            ("mask_pix", mask_pix, torch.float32),
            ("quant", quant, torch.int32)), dev, n, "compose_blocks_cuda")
    out = torch.empty_like(region)
    if n == 0:
        return out
    _launch("mjt_compose_blocks", dev, region, x_dropon, mask_pix, quant,
            out, n=n)
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
    _check((("x_image", x_image, torch.float32),
            ("x_dropon", x_dropon, torch.float32),
            ("mask_pix", mask_pix, torch.float32)), dev, n,
           "blend_blocks_cuda")
    out = torch.empty_like(x_image)
    if n == 0:
        return out
    _launch("mjt_blend_blocks", dev, x_image, x_dropon, mask_pix, out, n=n)
    blend_launches += 1
    return out
