"""DCT-domain effects as elementwise torch ops (PyTorch port of
libmodjpeg_tpu.ops.effects, effect.c parity).  Integer arithmetic only, so
every device gives the same coefficients; each returns a new tensor."""

from __future__ import annotations

import torch


def zero_component(comp_grid: torch.Tensor) -> torch.Tensor:
    """grayscale: zero every coefficient of a chroma component
    (effect.c:44-65)."""
    return torch.zeros_like(comp_grid)


def zero_ac(comp_grid: torch.Tensor) -> torch.Tensor:
    """pixelate: zero all 63 AC coefficients of every block
    (effect.c:88-108)."""
    out = torch.zeros_like(comp_grid)
    out[..., 0, 0] = comp_grid[..., 0, 0]
    return out


def add_to_dc(comp_grid: torch.Tensor, quant: torch.Tensor, value: int,
              clamp: int = 2047) -> torch.Tensor:
    """tint / luminance: dequantize DC, add value, clamp to +-clamp,
    requantize with truncating division (effect.c:143-153,207-217).

    comp_grid: [bh, bw, 8, 8] int16; quant: [8, 8].  The DC is widened to
    int32 before ``dc * q0 + value``.  The reference hardcodes +-2047, the
    dequantized DC range for 8-bit samples; 12-bit frames use +-32767
    ((1 << (precision + 3)) - 1)."""
    q0 = quant[0, 0].to(torch.int32)
    dc = comp_grid[:, :, 0, 0].to(torch.int32)
    dc = dc * q0 + torch.tensor(value, dtype=torch.int32,
                                device=comp_grid.device)
    dc = dc.clamp(-clamp, clamp)
    dc = torch.sign(dc) * torch.div(dc.abs(), q0, rounding_mode="floor")
    out = comp_grid.clone()  # a view would write through to the input
    out[:, :, 0, 0] = dc.to(comp_grid.dtype)
    return out
