"""Device-resident pipeline session for huge images (PyTorch port of
libmodjpeg_tpu.parallel.session).

For the 100 MP tiled-JPEG workload (BASELINE config-4) the coefficient
grids go to the device (or are split over a mesh) once, flow through a
chain of effects and composes there, and come back once at the end; the
Huffman-optimize statistics are computed from the resident grids.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .. import constants as C
from ..model import CoefImage, Dropon

from .grid import (_compiled_footprints, _compose_rows, _effect_rows,
                   _effect_steps, _shard_grid)
from .mesh import Mesh, ShardedRows


def _require_device(device: torch.device) -> torch.device:
    """Raise, rather than run elsewhere, when a CUDA device was asked for
    and none is visible."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} requested but no CUDA device is "
                           f"available")
    return device


class GridSession:
    """Holds one image's component grids on ``device``, or split over the
    rows of ``mesh`` (whose devices then replace ``device``).

    Usage::

        sess = GridSession(img, device="cuda")
        sess.effect("luminance", value=40).effect("pixelate")
        sess.compose(dropon, ALIGN_CENTER)
        out = sess.to_image()
    """

    def __init__(self, img: CoefImage, mesh: Optional[Mesh] = None, *,
                 device="cuda"):
        self.meta = img
        self.mesh = mesh
        if mesh is None:
            self.device = _require_device(torch.device(device))
            # one slab: the whole grid on the device, no padding
            self.grids = [ShardedRows([torch.from_numpy(a).to(
                self.device, copy=True)], a.shape[0]) for a in img.coefs]
        else:
            for d in mesh.device_list:
                _require_device(d)
            self.device = mesh.device_list[0]
            # block-row axis padded to the mesh multiple (zero blocks are
            # inert under every effect, and compose never writes past the
            # real rows), so any image geometry splits over any mesh
            self.grids = [_shard_grid(mesh, a) for a in img.coefs]

    def effect(self, name: str, value: int = 0, cb_value: int = 0,
               cr_value: int = 0) -> "GridSession":
        """'grayscale' | 'pixelate' | 'tint' | 'luminance', with the JAX
        grid path's branches and its +-2047 DC clamp at any precision."""
        for c, step, v in _effect_steps(self.meta, name, value, cb_value,
                                        cr_value):
            _effect_rows(self.grids[c], self.meta.quant_table_for(c), v,
                         step)
        return self

    def compose(self, dropon: Dropon, align: int = 0, offset_x: int = 0,
                offset_y: int = 0, *, compiled=None) -> "GridSession":
        """Compose in place on the resident grids.  The footprint is
        composed on the session's first device (the kernel on a CUDA
        device).  ``compiled``: a ready CompiledDropon (a JAX-package one
        carried over by state.from_reference) to use instead of compiling
        one."""
        fps = _compiled_footprints(self.meta, dropon, align, offset_x,
                                   offset_y, self.device, compiled)
        for c, (row0, col0, drop, mask) in enumerate(fps or ()):
            _compose_rows(self.grids[c], drop, mask,
                          self.meta.quant_table_for(c), row0, col0)
        return self

    def block_until_ready(self) -> "GridSession":
        """Wait for the work queued on the grids' CUDA devices."""
        devices = {s.device for g in self.grids for s in g.slabs}
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return self

    def optimized_tables(self, restart_interval: int = 0) -> list:
        """Huffman-optimize statistics computed on the resident grids.

        The symbol histograms (ops/histogram.py) run where the grids live
        and only the 257-entry totals come back for the table build.  Feed
        the result to ``to_jpeg``/``codec.encode(preset_tables=...)``: the
        file is byte-identical to the host ``OPTION_OPTIMIZE`` pass.
        """
        from ..ops.histogram import optimal_tables

        c0 = self.meta.components[0]
        return optimal_tables(self.grids, self.meta.components,
                              c0.padded_width_in_blocks // c0.h_samp,
                              restart_interval)

    def to_jpeg(self, options: int = 0, restart_interval: int = 0,
                nthreads: int = 0) -> bytes:
        """Encode the session's image; the OPTION_OPTIMIZE statistics of a
        sequential Huffman encode run on the device (optimized_tables)
        instead of as a host walk."""
        from .. import codec

        preset = None
        if (options & C.OPTION_OPTIMIZE) and not (
                options & (C.OPTION_PROGRESSIVE | C.OPTION_ARITHMETRIC)):
            preset = self.optimized_tables(restart_interval)
        return codec.encode(self.to_image(), options=options,
                            restart_interval=restart_interval,
                            nthreads=nthreads, preset_tables=preset)

    def to_image(self) -> CoefImage:
        """The session's image on the host (ShardedRows.numpy trims the
        padding rows)."""
        out = self.meta.copy()
        for c, g in enumerate(self.grids):
            out.coefs[c] = g.numpy()
        return out


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     cpu_collectives: Optional[str] = None) -> bool:
    """Join a multi-process group with torch.distributed.

    Reads MJT_COORDINATOR ("host:port") / MJT_NUM_PROCS / MJT_PROC_ID /
    MJT_CPU_COLLECTIVES where the arguments are None; a no-op returning
    False when no coordinator is configured, so single-host runs need no
    special casing.  The backend is nccl when a CUDA device is visible and
    gloo otherwise, or the backend ``cpu_collectives`` names (e.g.
    "gloo").
    """
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("MJT_COORDINATOR")
    if not coordinator:
        return False
    num_processes = num_processes or int(os.environ.get("MJT_NUM_PROCS", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("MJT_PROC_ID", "0"))
    cpu_collectives = cpu_collectives or os.environ.get("MJT_CPU_COLLECTIVES")
    backend = cpu_collectives or (
        "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True
