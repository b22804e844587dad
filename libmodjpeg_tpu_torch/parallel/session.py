"""Device-resident pipeline session for huge images (PyTorch port of
libmodjpeg_tpu.parallel.session).

For the 100 MP tiled-JPEG workload (BASELINE config-4) the coefficient
grids go to the device (or are split over a mesh) once, flow through a
chain of effects and composes there, and come back once at the end; the
Huffman-optimize statistics are computed from the resident grids.

While tracing is on (``tracing``) each step is a span with the session's
id: ``mjt.grid.effect`` and ``mjt.grid.compose`` are device spans on the
session's first device, ``mjt.grid.upload`` (with the byte counts of
``last_upload``), ``mjt.grid.compile`` (the logo's placement and
compile, with the counts of ``last_compile``), ``mjt.grid.to_image``
(with the byte counts of ``last_to_image``) and ``mjt.grid.encode`` host
spans.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Optional

import torch

from .. import constants as C
from .. import tracing
from ..model import CoefImage, Dropon

from .grid import (_compiled_footprints, _compose_rows, _effect_rows,
                   _effect_steps, _shard_grid)
from .mesh import Mesh, ShardedRows

_SESSIONS = itertools.count()  # the ``session`` id of each GridSession


def _copied_pinned(plane, devices) -> bool:
    """Whether ``plane`` goes up to ``devices`` (a row slab each) straight
    from page-locked memory: every device a card, rows that split evenly
    (shard_rows stages padding rows through a new tensor) and a page-locked
    plane, asked last, since asking a host plane is_pinned() would start a
    CUDA context."""
    return (all(d.type == "cuda" for d in devices)
            and plane.shape[0] % len(devices) == 0
            and torch.from_numpy(plane).is_pinned())


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

    ``last_upload`` counts the copy up: ``bytes`` of the image's planes, of
    them ``pinned_bytes`` copied to the cards straight from page-locked
    memory (``pinned_bytes / bytes``: how often the pinned copy engages;
    codec.decode gives a large frame such planes); while tracing is on the
    ``mjt.grid.upload`` span carries both as ids.

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
        self._ids = {"session": next(_SESSIONS)}
        self.last_to_image: Optional[dict] = None
        self.last_compile: Optional[dict] = None
        with tracing.span("mjt.grid.upload", **self._ids) as sp:
            if mesh is None:
                devices = [_require_device(torch.device(device))]
                # one slab: the whole grid on the device, no padding
                self.grids = [ShardedRows([torch.from_numpy(a).to(
                    devices[0], copy=True)], a.shape[0]) for a in img.coefs]
            else:
                devices = [_require_device(d) for d in mesh.device_list]
                # block-row axis padded to the mesh multiple (zero blocks
                # are inert under every effect, and compose never writes
                # past the real rows), so any image geometry splits over
                # any mesh
                self.grids = [_shard_grid(mesh, a) for a in img.coefs]
            self.device = devices[0]
            self.last_upload = {
                "bytes": sum(a.nbytes for a in img.coefs),
                "pinned_bytes": sum(a.nbytes for a in img.coefs
                                    if _copied_pinned(a, devices))}
            if sp is not None:
                sp.ids.update(self.last_upload)

    def effect(self, name: str, value: int = 0, cb_value: int = 0,
               cr_value: int = 0) -> "GridSession":
        """'grayscale' | 'pixelate' | 'tint' | 'luminance', with the JAX
        grid path's branches and its +-2047 DC clamp at any precision."""
        with tracing.device_span("mjt.grid.effect", self.device,
                                 **self._ids):
            for c, step, v in _effect_steps(self.meta, name, value,
                                            cb_value, cr_value):
                _effect_rows(self.grids[c], self.meta.quant_table_for(c), v,
                             step)
        return self

    def compose(self, dropon: Dropon, align: int = 0, offset_x: int = 0,
                offset_y: int = 0, *, compiled=None) -> "GridSession":
        """Compose in place on the resident grids.  The dropon is compiled
        and the footprint composed on the session's first device (the
        kernel on a CUDA device); the compile's results stay there.
        ``compiled``: a ready CompiledDropon (a JAX-package one carried
        over by state.from_reference) to use instead of compiling one.

        ``last_compile`` counts the call: ``blocks`` compiled over all
        components (0 for a no-op placement) and ``host_bytes`` of the
        compiled dropon that passed through host memory (0 when compiled
        here, the drops and masks copied up from ``compiled`` otherwise);
        while tracing is on the ``mjt.grid.compile`` span carries both as
        ids."""
        with tracing.span("mjt.grid.compile", **self._ids) as sp:
            fps, host_bytes = _compiled_footprints(
                self.meta, dropon, align, offset_x, offset_y, self.device,
                compiled)
            self.last_compile = {
                "blocks": sum(d.shape[0] * d.shape[1]
                              for _, _, d, _ in fps or ()),
                "host_bytes": host_bytes}
            if sp is not None:
                sp.ids.update(self.last_compile)
        with tracing.device_span("mjt.grid.compose", self.device,
                                 **self._ids):
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
        image = self.to_image()
        with tracing.span("mjt.grid.encode", **self._ids):
            return codec.encode(image, options=options,
                                restart_interval=restart_interval,
                                nthreads=nthreads, preset_tables=preset)

    def to_image(self) -> CoefImage:
        """The session's image on the host (ShardedRows.numpy trims the
        padding rows).  Its planes are new arrays that own their memory,
        page-locked when the grids are on a CUDA device; the rest is a copy
        of the input image's fields, whose planes are neither copied nor
        touched.

        ``last_to_image`` counts the call: ``bytes`` of the planes, of them
        ``pinned_bytes`` in page-locked memory and ``host_copy_bytes``
        merged from slabs on the host; while tracing is on the span
        carries the same three numbers as ids."""
        m = self.meta
        with tracing.span("mjt.grid.to_image", **self._ids) as sp:
            planes = [g.numpy() for g in self.grids]
            out = dataclasses.replace(
                m, coefs=planes,
                components=[dataclasses.replace(ci) for ci in m.components],
                quant_tables={k: v.copy() for k, v in m.quant_tables.items()},
                sampling=dataclasses.replace(m.sampling),
                markers=list(m.markers))
            # asking a host plane is_pinned() would start a CUDA context
            host = [any(s.device.type != "cuda" for s in g.slabs)
                    for g in self.grids]
            self.last_to_image = {
                "bytes": sum(p.nbytes for p in planes),
                "pinned_bytes": sum(
                    p.nbytes for p, h in zip(planes, host)
                    if not h and torch.from_numpy(p).is_pinned()),
                "host_copy_bytes": sum(
                    p.nbytes for p, h in zip(planes, host) if h)}
            if sp is not None:
                sp.ids.update(self.last_to_image)
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
