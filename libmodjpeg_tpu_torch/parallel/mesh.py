"""Device meshes and row shardings (PyTorch port of
libmodjpeg_tpu.parallel.mesh).

One process drives all of its local devices, as JAX's single controller
does, so a mesh is a plain grid of ``torch.device``s and a sharded tensor is
a list of row slabs, one per device, that the helpers move and merge
explicitly (there is no GSPMD to do it).  A mesh may list one device more
than once (``[torch.device("cpu")] * 8``): the split, pad and merge logic
then runs for real on a machine with one device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: object array of ``torch.device``, one axis per name in
    ``axis_names`` (("batch", "grid") from make_mesh, ("batch",) from
    stream_mesh)."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> list:
        """Every device of the mesh in row-major order."""
        return list(self.devices.reshape(-1))


def _device_array(devices: Sequence, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr.reshape(shape)


def make_mesh(devices: Optional[Sequence] = None,
              batch: Optional[int] = None,
              grid: Optional[int] = None) -> Mesh:
    """Create a ("batch", "grid") mesh over the given devices, or over every
    visible CUDA device.

    batch x grid must equal the device count; by default all devices go to
    the batch axis (the common watermarking-fleet shape).
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices= explicitly")
    devices = list(devices)
    n = len(devices)
    if batch is None and grid is None:
        batch, grid = n, 1
    elif batch is None:
        batch = n // grid
    elif grid is None:
        grid = n // batch
    if batch * grid != n:
        raise ValueError(f"mesh {batch}x{grid} != {n} devices")
    return Mesh(_device_array(devices, (batch, grid)), ("batch", "grid"))


def stream_mesh() -> Optional[Mesh]:
    """1-D "batch" mesh over this process's CUDA devices for the streaming
    compose path, or None when fewer than two are visible.

    BatchComposer's packed compose splits each batch's rows over this mesh,
    so a host with several cards drives all of them.  MJT_STREAM_CHIPS=k
    caps the mesh to the first k devices (0 or 1 disables the split).
    """
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    cap = os.environ.get("MJT_STREAM_CHIPS")
    if cap is not None:
        devices = devices[:max(0, int(cap))]
    if len(devices) < 2:
        return None
    return Mesh(_device_array(devices, (len(devices),)), ("batch",))


def batch_sharding(mesh: Mesh) -> tuple:
    """[N, Hb, Wb, 8, 8] image batches: the devices that hold the slabs of
    the leading batch axis, one per index of the mesh's "batch" axis (a
    slab JAX would replicate over the "grid" axis lives on that axis's
    first device only)."""
    d = mesh.devices
    return tuple(d[:, 0] if d.ndim == 2 else d)


def grid_sharding(mesh: Mesh) -> tuple:
    """[Hb, Wb, 8, 8] single-image block grid: the devices that hold the
    block-row slabs, one per index of the mesh's "grid" axis (block-local
    compose needs no halo; compose_sharded moves the rows an overlay
    crossing slab borders needs)."""
    return tuple(mesh.devices[0, :])


@dataclasses.dataclass
class ShardedRows:
    """A tensor split along its leading axis into equal ``slabs``, slab k on
    its own device; ``rows`` is the real row count (the last slabs end in
    zero padding rows)."""

    slabs: list
    rows: int

    @property
    def slab_rows(self) -> int:
        return self.slabs[0].shape[0]

    def real_slabs(self) -> list:
        """Per slab, the part that holds real rows (maybe empty)."""
        out = []
        for k, s in enumerate(self.slabs):
            out.append(s[:max(0, min(self.slab_rows,
                                     self.rows - k * self.slab_rows))])
        return out

    def numpy(self) -> np.ndarray:
        """The real rows merged on the host, each slab copied once into its
        rows of one new host tensor.  From a CUDA device that tensor is
        page-locked (torch's caching host allocator) and each slab comes
        down by an asynchronous copy, with no pageable staging and no host
        copy after it.  The array returned keeps its tensor alive."""
        s0 = self.slabs[0]
        cuda = {s.device for s in self.slabs if s.device.type == "cuda"}
        pinned = bool(cuda)
        dest = torch.empty((self.rows,) + tuple(s0.shape[1:]),
                           dtype=s0.dtype, pin_memory=pinned)
        row = 0
        for s in self.real_slabs():
            dest[row:row + s.shape[0]].copy_(s, non_blocking=pinned)
            row += s.shape[0]
        for d in cuda:
            torch.cuda.synchronize(d)
        return dest.numpy()


def shard_rows(arr, devices: Sequence) -> ShardedRows:
    """Zero-pad the leading axis of ``arr`` (numpy array or tensor) up to a
    multiple of len(devices) and place one slab on each device (the
    devices of batch_sharding, grid_sharding or a whole mesh)."""
    t = torch.as_tensor(arr)
    n = len(devices)
    rows = t.shape[0]
    per = -(-rows // n)
    pad = per * n - rows
    if pad:
        t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
    # copy=True: a slab never aliases the caller's array, even on its device
    return ShardedRows([t[k * per:(k + 1) * per].to(d, copy=True)
                        for k, d in enumerate(devices)], rows)
