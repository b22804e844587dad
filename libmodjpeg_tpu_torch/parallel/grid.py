"""MCU-grid sharding: one huge image split over a mesh (PyTorch port of
libmodjpeg_tpu.parallel.grid).

Each component's block-row axis is split into one row slab per mesh device
(``_shard_grid``).  The effects are block-local, so each slab runs them on
its own device.  A compose gathers the footprint's rows from the slabs that
hold them to one device, runs ``compose_rows`` there and writes each row
back to its own slab: the data movement GSPMD inserts on the TPU, written
out.  A footprint inside one slab on the compose device (every
single-device session) is composed in place, read where it lies.  The results equal the single-device ones bit for bit.

Quirk kept from the JAX grid path: tint and luminance clamp the
dequantized DC to +-2047 whatever the frame's precision (the API-level
effects use +-32767 for 12-bit frames).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..model import CoefImage

from ..ops import effects as fx
from ..ops.compose import compose_rows
from .mesh import Mesh, ShardedRows, shard_rows


def _shard_grid(mesh: Mesh, arr) -> ShardedRows:
    """Split a [H, W, 8, 8] block grid's row axis over the whole mesh.

    The row axis is zero-padded up to the device-count multiple so exact
    divisibility is never required; readers trim back to the real row count
    (zero blocks are inert: every effect maps zero to zero modulo a DC shift
    that is dropped with the padding, and compose never addresses them)."""
    return shard_rows(arr, mesh.device_list)


def _apply_effect(grid: torch.Tensor, quant: torch.Tensor, value: int,
                  effect: str) -> torch.Tensor:
    if effect == "zero":
        return fx.zero_component(grid)
    if effect == "pixelate":
        return fx.zero_ac(grid)
    if effect == "dc_add":
        return fx.add_to_dc(grid, quant, value)      # +-2047: see above
    raise ValueError(effect)


def _effect_steps(img: CoefImage, name: str, value: int, cb_value: int,
                  cr_value: int) -> list:
    """[(component, effect, value)] that effect ``name`` applies, with the
    branches and quirks of the JAX grid path."""
    jcs_ok = img.jpeg_color_space == C.JCS_YCbCr
    steps = []
    for c in range(img.num_components):
        if name == "grayscale" and jcs_ok and c > 0:
            steps.append((c, "zero", 0))
        elif name == "pixelate":
            steps.append((c, "pixelate", 0))
        elif name == "tint" and jcs_ok and c == 1 and cb_value:
            steps.append((c, "dc_add", cb_value))
        elif name == "tint" and jcs_ok and c == 2 and cr_value:
            steps.append((c, "dc_add", cr_value))
        elif name == "luminance" and jcs_ok and c == 0:
            steps.append((c, "dc_add", value))
    return steps


def _effect_rows(grid: ShardedRows, quant: np.ndarray, value: int,
                 effect: str) -> None:
    """Apply an effect to every slab on the slab's own device, in place of
    the slabs."""
    q = torch.from_numpy(np.asarray(quant, np.int32))
    for k, slab in enumerate(grid.slabs):
        grid.slabs[k] = _apply_effect(slab, q.to(slab.device), value, effect)


def effects_sharded(img: CoefImage, effect: str, mesh: Mesh,
                    value: int = 0, cb_value: int = 0,
                    cr_value: int = 0) -> CoefImage:
    """Apply an effect with each component's block-row axis split over the
    whole mesh.  effect: 'grayscale' | 'pixelate' | 'tint' | 'luminance'."""
    out = img.copy()
    for c, name, v in _effect_steps(img, effect, value, cb_value, cr_value):
        grid = _shard_grid(mesh, out.coefs[c])
        _effect_rows(grid, out.quant_table_for(c), v, name)
        out.coefs[c] = grid.numpy()
    return out


def _compose_rows(grid: ShardedRows, dropon: torch.Tensor,
                  mask_pix: torch.Tensor, quant: np.ndarray, row0: int,
                  col0: int) -> None:
    """Compose the block footprint at (row0, col0) of a row-split grid, in
    place of its slabs.

    ``dropon``/``mask_pix``: [h, w, 8, 8] float32 on the device the compose
    runs on.  When one slab on that device holds the whole footprint,
    ``compose_rows`` (the kernel on a CUDA device) composes the window in
    place of the slab.  Otherwise the footprint's rows are gathered from
    the slabs that hold them into one region there, composed, and each row
    is written back to its own slab.
    """
    dev = dropon.device
    h, w = dropon.shape[:2]
    per = grid.slab_rows
    pieces = []                                # (slab, first row, end row)
    for k in range(row0 // per, (row0 + h - 1) // per + 1):
        pieces.append((k, max(row0, k * per) - k * per,
                       min(row0 + h, (k + 1) * per) - k * per))
    q = torch.from_numpy(np.asarray(quant, np.int32).reshape(1, 64)).to(dev)
    ops = (q, dropon.reshape(h * w, 64), mask_pix.reshape(h * w, 64))
    k, a, b = pieces[0]
    if len(pieces) == 1 and grid.slabs[k].device == dev:
        window = grid.slabs[k][a:b, col0:col0 + w].view(1, h, w, 64)
        compose_rows(window, *ops, out=window)
        return
    region = torch.cat([grid.slabs[k][a:b, col0:col0 + w].to(dev)
                        for k, a, b in pieces])
    out = compose_rows(region.view(1, h, w, 64), *ops).view(h, w, 8, 8)
    off = 0
    for k, a, b in pieces:
        slab = grid.slabs[k]
        slab[a:b, col0:col0 + w] = out[off:off + b - a].to(slab.device)
        off += b - a


def _compiled_footprints(img: CoefImage, dropon, align: int, offset_x: int,
                         offset_y: int, device, compiled=None):
    """Placement and compile of a dropon against ``img`` on ``device``.

    Returns None when the placement is a no-op, else per component
    (row0, col0, dropon, mask_pix), the last two [h, w, 8, 8] float32 on
    ``device``.  ``compiled``: a ready CompiledDropon (a JAX-package one
    carried over by state.from_reference) to use instead of compiling.
    """
    from ..composer import compile_dropon, plan_placement
    from ..state import compiled_dropon_to_torch

    p = plan_placement(img, dropon, align, offset_x, offset_y)
    if p.noop:
        return None
    if compiled is None:
        compiled = compile_dropon(dropon, img, p.blockoffset_x,
                                  p.blockoffset_y, p.crop_x, p.crop_y,
                                  p.crop_w, p.crop_h, device=device)
    dd = compiled_dropon_to_torch(compiled, device)
    out = []
    for c, (h, w) in enumerate(dd.shapes):
        ci = img.components[c]
        out.append((p.block_y * ci.v_samp, p.block_x * ci.h_samp,
                    dd.drops[c].reshape(h, w, 8, 8),
                    dd.masks[c].reshape(h, w, 8, 8)))
    return out


def compose_sharded(img: CoefImage, dropon, align: int, offset_x: int,
                    offset_y: int, mesh: Mesh, *,
                    compiled=None) -> CoefImage:
    """Compose onto a grid split over the whole mesh.  The overlay may span
    slab borders: its rows are gathered to the mesh's first device,
    composed there and written back (_compose_rows).  ``compiled``: a ready
    CompiledDropon to use instead of compiling one."""
    out = img.copy()
    dev = mesh.device_list[0]
    fps = _compiled_footprints(img, dropon, align, offset_x, offset_y, dev,
                               compiled)
    for c, (row0, col0, drop, mask) in enumerate(fps or ()):
        grid = _shard_grid(mesh, out.coefs[c])
        _compose_rows(grid, drop, mask, out.quant_table_for(c), row0, col0)
        out.coefs[c] = grid.numpy()
    return out
