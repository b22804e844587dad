"""Batched compose: many same-geometry images, one dropon (PyTorch port
of libmodjpeg_tpu.parallel.batch).

Only the overlay footprint of each image travels to the device and back,
packed batch-major: one host->device and one device->host transfer per
batch and device.  The device step (``packed_compose``) restores the
int8+exceptions uplink with one scatter, runs the compose kernel once per
component and packs the downlink the same way.  On a CUDA device the step
runs on the composer's own stream for that device, fed from pinned host
buffers, and a CUDA event marks the end of its device->host copy; on the
CPU it runs synchronously.  With a stream mesh (several local cards, or an
explicit ``mesh``) the packed rows of a batch are split into one equal
slab per device of the mesh's "batch" axis.

``put_batch``/``compose_arrays``/``compose_batch`` compose whole
[N, H, W, 8, 8] image batches that stay on the device (split over the
mesh's "batch" axis when one is given).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..model import CoefImage, Dropon

from ..ops.compose import compose_rows
from ..state import DeviceDropon, compiled_dropon_to_torch
from .mesh import Mesh, ShardedRows, batch_sharding, shard_rows, stream_mesh


def _compose_batch_component(grids: torch.Tensor, dropon_blocks: torch.Tensor,
                             mask_pix: torch.Tensor, quant: torch.Tensor,
                             row0: int, col0: int) -> torch.Tensor:
    """Compose the footprint at (row0, col0) of every image of a batch, in
    place (the JAX version donates its input) and returned.

    grids: contiguous [N, H, W, 8, 8] int16; dropon_blocks/mask_pix:
    [h, w, 8, 8] float32 (shared by the batch) or [N, h, w, 8, 8] per
    image; quant: [8, 8].  All on one device.  One compose_rows call reads
    and writes the footprint window where it lies in ``grids``.
    """
    n = grids.shape[0]
    h, w = dropon_blocks.shape[-4:-2]
    region = grids[:, row0:row0 + h, col0:col0 + w].view(n, h, w, 64)
    compose_rows(region, quant.reshape(1, 64).to(torch.int32),
                 dropon_blocks.reshape(-1, h * w, 64),
                 mask_pix.reshape(-1, h * w, 64), out=region)
    return grids


def _wirepack(flat: np.ndarray):
    """Exact int8+exceptions packing of the host->device region payload.

    Quantized DCT coefficients are tiny (<0.2% of real footprint values fall
    outside int8), so the wire carries ``lo`` = clip(v, -128, 127) as int8
    plus a fixed-capacity per-row exception list; the device restores exact
    int16 with one scatter (pad slots index past the row end and are
    dropped).  Capacity quantizes to power-of-two buckets.  Returns (lo,
    eidx, evals) or None when the payload is exception-heavy (use the raw
    int16 wire).
    """
    n, sz = flat.shape
    lo = np.clip(flat, -128, 127).astype(np.int8)
    mask = flat != lo
    counts = mask.sum(axis=1)
    mx = int(counts.max()) if n else 0
    if mx * 4 > sz:  # degenerate content: packing would not pay
        return None
    cap = 8
    while cap < mx:
        cap *= 2
    # pad slots point one past the row end, where the restore drops them
    eidx = np.full((n, cap), sz, np.int32)
    evals = np.zeros((n, cap), np.int16)
    rows, cols = np.nonzero(mask)
    if rows.size:
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(rows.size) - starts[rows]
        eidx[rows, slot] = cols.astype(np.int32)
        evals[rows, slot] = flat[rows, cols]
    return lo, eidx, evals


def _downunpack(wire: np.ndarray, cap: int):
    """Host restore of the packed downlink wire (see _pack_down): returns
    (flat int16 [n, sz], counts int32 [n]).  Rows with counts > cap are
    incomplete and must be refetched from the raw output."""
    sz = wire.shape[1] - cap * 6 - 4
    lo = wire[:, :sz]
    eidx = wire[:, sz:sz + cap * 4].copy().view(np.int32)
    evals = wire[:, sz + cap * 4:sz + cap * 6].copy().view(np.int16)
    counts = wire[:, sz + cap * 6:].copy().view(np.int32)[:, 0]
    flat = lo.astype(np.int16)
    # pad slots index sz-1 and carry its true value, so the scatter is
    # unconditional
    np.put_along_axis(flat, eidx, evals, axis=1)
    return flat, counts


def _restore_uplink(lo: torch.Tensor, eidx: torch.Tensor,
                    evals: torch.Tensor) -> torch.Tensor:
    """Exact int16 [n, sz] from the int8 wire + exception scatter.  Pad
    slots index sz: they land in a pad block that is sliced off (a whole
    block, so every row's blocks stay 16-byte aligned for the kernel)."""
    n, sz = lo.shape
    flat = torch.zeros((n, sz + 64), dtype=torch.int16, device=lo.device)
    flat[:, :sz] = lo
    flat.scatter_(1, eidx.long(), evals)
    return flat[:, :sz]


def _compose_body(meta, flat, qstack, drops, masks) -> torch.Tensor:
    """Compose every component of the packed rows into one new packed
    [n, sum(meta) * 64] int16 tensor.

    flat: [n, sum(meta) * 64] int16, per row (file) the components'
    footprint blocks back to back; qstack: [n, ncomps * 64] int32, each
    file's own quant tables; drops[c]/masks[c]: [meta[c], 64] float32,
    shared by every row.  One compose_rows call per component reads its
    slice of ``flat`` and its quant column of ``qstack`` where they lie
    and writes the same slice of the output: nothing is broadcast, copied
    or concatenated.  An all-zero mask block (transparent padding) is an
    exact pass-through.
    """
    n = flat.shape[0]
    out = torch.empty_like(flat)
    off = 0
    for c, hw in enumerate(meta):
        sz = hw * 64
        compose_rows(flat[:, off:off + sz].view(n, 1, hw, 64),
                     qstack[:, c * 64:(c + 1) * 64], drops[c], masks[c],
                     out=out[:, off:off + sz].view(n, 1, hw, 64))
        off += sz
    return out


def _pack_down(out: torch.Tensor, cap: int):
    """Device epilogue: one int8 downlink wire + the raw output.

      wire = [ lo = clip(out,-128,127) | eidx i32 | evals i16 | counts i32 ]

    viewed as bytes, with a fixed per-row exception capacity ``cap``.  Pad
    slots of eidx point at sz-1 and evals carries the TRUE value at every
    listed index, so the host restore is one unconditional scatter.  Rows
    whose exception count overflows ``cap`` are restored from ``out``.
    """
    n, sz = out.shape
    dev = out.device
    lo = out.clamp(-128, 127).to(torch.int8)
    exc = out != lo.to(torch.int16)
    pos = torch.cumsum(exc.to(torch.int32), dim=1, dtype=torch.int32)
    # non-exceptions and beyond-capacity exceptions land on the pad slot
    # cap, which is sliced off
    slot = torch.where(exc, (pos - 1).clamp(max=cap), cap)
    col = torch.arange(sz, dtype=torch.int32, device=dev).expand(n, sz)
    eidx = torch.full((n, cap + 1), sz - 1, dtype=torch.int32, device=dev)
    eidx.scatter_(1, slot.long(), col)
    eidx = eidx[:, :cap].contiguous()
    evals = torch.gather(out, 1, eidx.long())
    counts = pos[:, -1:].contiguous()
    wire = torch.cat([lo, eidx.view(torch.int8), evals.view(torch.int8),
                      counts.view(torch.int8)], dim=1)
    return wire, out


def packed_compose(meta, wire, qstack, drops, masks, down_cap):
    """The device step for one batch (the port of _packed_compose_fn).

    wire: the raw int16 [n, per_file] region tensor, or the (lo, eidx,
    evals) tuple of _wirepack.  Returns (downlink wire, raw output): the
    downlink packed with per-row exception capacity ``down_cap``.
    """
    flat = _restore_uplink(*wire) if isinstance(wire, tuple) else wire
    return _pack_down(_compose_body(meta, flat, qstack, drops, masks),
                      down_cap)


class BatchComposer:
    """Reusable compiled-dropon compose over batches of same-geometry images.

    Compiles the dropon once against the template's geometry (or takes a
    ready ``compiled`` CompiledDropon, a JAX-package one carried over
    by state.from_reference) and applies it
    to any number of batches, on ``device`` (default "cuda").  With a
    ``mesh`` the batches are split over its "batch" axis and ``device``
    defaults to the mesh's first device (another device raises).  Without
    one, a composer on a CUDA device splits the streaming path's batches
    over every local card (``stream_mesh``) when there are several.
    """

    def __init__(self, template: CoefImage, dropon: Dropon, align: int = 0,
                 offset_x: int = 0, offset_y: int = 0,
                 mesh: Optional[Mesh] = None, *, device=None, compiled=None):
        from ..composer import compile_dropon, plan_placement

        self.template = template
        self.mesh = mesh
        if mesh is not None:
            first = mesh.device_list[0]
            if device is not None and torch.device(device) != first:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {first}")
            device = first
        self.device = torch.device("cuda" if device is None else device)
        p = plan_placement(template, dropon, align, offset_x, offset_y)
        self.noop = p.noop
        if self.noop:
            return
        if compiled is None:
            compiled = compile_dropon(dropon, template, p.blockoffset_x,
                                      p.blockoffset_y, p.crop_x, p.crop_y,
                                      p.crop_w, p.crop_h, device=self.device)
        self.cd = compiled
        self.block_x = p.block_x
        self.block_y = p.block_y
        self._dev = compiled_dropon_to_torch(self.cd, self.device)
        self._dev_dropons = {self.device: self._dev}
        self._comp_shapes = list(self._dev.shapes)
        self._meta = self._dev.meta
        # per component (zero, DC-only, general) mask-block counts, for
        # diagnostics only: one kernel serves every class
        self.mask_block_classes = []
        for weights in self.cd.alpha_weights:
            h, w = weights.shape[:2]
            nz = np.ascontiguousarray(weights, np.float32).reshape(
                h * w, 64) != 0.0
            zero = ~nz.any(axis=1)
            dc = nz[:, 0] & ~nz[:, 1:].any(axis=1)
            self.mask_block_classes.append(
                (int(zero.sum()), int(dc.sum()), int((~zero & ~dc).sum())))
        # downlink exception capacity (power-of-two buckets, widened when a
        # batch overflows; overflowed rows restore from the raw output)
        self._down_cap = 32
        # the packed path's row split: the mesh's "batch" axis, or every
        # local card; a single device runs the step unsplit
        self._stream_mesh = mesh if mesh is not None else (
            stream_mesh() if self.device.type == "cuda" else None)
        self._shard_devices = (
            [self.device] if self._stream_mesh is None
            else list(batch_sharding(self._stream_mesh)))
        self._streams = {d: torch.cuda.Stream(d)
                         for d in self._shard_devices if d.type == "cuda"}
        self.last_dispatch_devices = 1

    def _dropon_on(self, device) -> DeviceDropon:
        """The compiled dropon on ``device``, moved there at first use."""
        dd = self._dev_dropons.get(device)
        if dd is None:
            dd = compiled_dropon_to_torch(self.cd, device)
            self._dev_dropons[device] = dd
        return dd

    def compose_images(self, images: Sequence[CoefImage]) -> None:
        """In-place batched compose: only the overlay footprint travels to
        the device and back, all components in one device step."""
        self.finish(self.compose_images_async(images), images)

    def _region_origins(self) -> list:
        """Per component (r0, c0, h, w) block rectangles of the footprint."""
        origins = []
        for c, (h, w) in enumerate(self._comp_shapes):
            ci = self.template.components[c]
            origins.append((self.block_y * ci.v_samp,
                            self.block_x * ci.h_samp, h, w))
        return origins

    def _pack_regions(self, regions, quants):
        """Dispatch the packed compose for per-file footprint regions.

        regions[i][c]: [h_c, w_c, 8, 8] int16 for file i, component c;
        quants[i][c]: that file's [8, 8] quant table.  Returns a pending
        handle for _unpack_regions; on CUDA the work is queued on the
        composer's stream and the call does not wait for it.
        """
        ncomps = len(self._meta)
        n = len(regions)
        parts = [np.stack([np.asarray(regions[i][c], np.int16)
                           for i in range(n)]).reshape(n, -1)
                 for c in range(ncomps)]
        flat = parts[0] if ncomps == 1 else np.concatenate(parts, axis=1)
        qstack = np.concatenate(
            [np.stack([np.asarray(quants[i][c], np.int32).reshape(64)
                       for i in range(n)]) for c in range(ncomps)], axis=1)
        if self._stream_mesh is not None:
            shards = len(self._shard_devices)
            n_pad = -(-n // shards) * shards
            if n_pad != n:
                flat = np.concatenate(
                    [flat, np.zeros((n_pad - n, flat.shape[1]), np.int16)])
                # q=1 keeps the padded rows' requant division well-defined
                qstack = np.concatenate(
                    [qstack,
                     np.ones((n_pad - n, qstack.shape[1]), np.int32)])
        packed = _wirepack(flat)
        host = (packed if packed is not None else (flat,)) + (qstack,)
        cap = self._down_cap
        per = flat.shape[0] // len(self._shard_devices)
        parts = [self._dispatch(dev, [a[k * per:(k + 1) * per] for a in host],
                                packed is not None, cap)
                 for k, dev in enumerate(self._shard_devices)]
        self.last_dispatch_devices = len(parts)
        return (parts, n, cap)

    def _dispatch(self, dev, host, packed: bool, cap: int):
        """Queue the device step for one slab of rows on ``dev``: host =
        the wire arrays then qstack.  Returns (dev, downlink wire on the
        host, raw output on dev, event or None, what must stay referenced
        until the event has been waited on)."""
        dd = self._dropon_on(dev)
        stream = self._streams.get(dev)
        if stream is None:
            t = [torch.from_numpy(a).to(dev) for a in host]
            wire = tuple(t[:-1]) if packed else t[0]
            down, raw = packed_compose(self._meta, wire, t[-1], dd.drops,
                                       dd.masks, cap)
            return (dev, down.cpu(), raw, None, ())
        with torch.cuda.stream(stream):
            t = [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
                 for a in host]
            wire = tuple(t[:-1]) if packed else t[0]
            down_dev, raw = packed_compose(self._meta, wire, t[-1], dd.drops,
                                           dd.masks, cap)
            down = torch.empty(down_dev.shape, dtype=down_dev.dtype,
                               pin_memory=True)
            down.copy_(down_dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return (dev, down, raw, event, (t, down_dev))

    def _fetch_rows(self, dev, raw: torch.Tensor, idx: np.ndarray):
        """Rows ``idx`` of a slab's raw output, copied to the host on the
        slab's stream."""
        index = torch.from_numpy(idx).to(raw.device)
        stream = self._streams.get(dev)
        if stream is None:
            return raw[index].cpu().numpy()
        with torch.cuda.stream(stream):
            return raw[index].cpu().numpy()

    def _unpack_regions(self, pending) -> list:
        """Wait for a _pack_regions result: parts[c][i] = [h, w, 8, 8]."""
        parts, n, cap = pending
        downs = []
        for _dev, down, _raw, event, _keep in parts:
            if event is not None:
                event.synchronize()  # releases the GIL while it waits
            downs.append(down.numpy())
        flat, counts = _downunpack(
            downs[0] if len(downs) == 1 else np.concatenate(downs), cap)
        over = np.nonzero(counts > cap)[0]
        if over.size:
            # rare: restore overflowed rows from the raw output still on the
            # device, then widen the capacity bucket for the next batches
            per = parts[0][2].shape[0]
            for k, (dev, _down, raw, _event, _keep) in enumerate(parts):
                rows = over[(over >= k * per) & (over < (k + 1) * per)]
                if rows.size:
                    flat[rows] = self._fetch_rows(dev, raw, rows - k * per)
            cap = self._down_cap
            mx = int(counts.max())
            while cap < mx:
                cap *= 2
            self._down_cap = cap
        flat = flat[:n]
        off, parts = 0, []
        for (h, w) in self._comp_shapes:
            sz = h * w * 64
            parts.append(flat[:, off:off + sz].reshape(n, h, w, 8, 8))
            off += sz
        return parts

    def compose_images_async(self, images: Sequence[CoefImage]):
        """Dispatch the region compose without waiting; returns a pending
        handle for finish().  Each image composes with its OWN quant
        tables."""
        if self.noop:
            return None
        origins = self._region_origins()
        regions = [[im.coefs[c][r0:r0 + h, c0:c0 + w]
                    for c, (r0, c0, h, w) in enumerate(origins)]
                   for im in images]
        quants = [[im.quant_table_for(c) for c in range(len(origins))]
                  for im in images]
        return self._pack_regions(regions, quants)

    def finish(self, pending, images: Sequence[CoefImage]) -> None:
        """Fetch a compose_images_async result and scatter it back."""
        if pending is None:
            return
        parts = self._unpack_regions(pending)
        origins = self._region_origins()
        for c, (r0, c0, h, w) in enumerate(origins):
            for i, im in enumerate(images):
                im.coefs[c][r0:r0 + h, c0:c0 + w] = parts[c][i]

    def _surgical_plan(self):
        """Lazily built surgical splice plan (libmodjpeg_tpu.surgical);
        plan.ok is False when the template is outside the surgical
        envelope."""
        if not hasattr(self, "_splan"):
            from ..surgical import SurgicalPlan

            self._splan = SurgicalPlan(self.template, self._region_origins(),
                                       self.template.restart_interval)
        return self._splan

    def _compose_surgical_async(self, plan, planes_list, quants_list):
        """Pack the gathered footprint regions of a batch of window planes
        and dispatch the same packed compose the full path uses."""
        regions = [plan.gather(p) for p in planes_list]
        return self._pack_regions(regions, quants_list)

    def _finish_surgical(self, plan, pending, planes_list) -> None:
        parts = self._unpack_regions(pending)
        for i, planes in enumerate(planes_list):
            plan.scatter(planes, [p[i] for p in parts])

    def watermark_stream(self, datas, *, batch: int = 32, pool=None,
                         options: int = 0, restart_interval=None,
                         lookahead: int = 2, surgical=None,
                         max_pixel: int = 0):
        """Streaming watermark pipeline: JPEG bytes in -> JPEG bytes out.

        Four overlapped stages, each on its own thread: host entropy decode
        (thread pool), pack + host->device dispatch, device->host fetch,
        and host scatter + entropy encode (thread pool).  Yields encoded
        bytes in input order.

        Routing is per file.  Sequential-Huffman input with restart markers
        and no re-encode options takes the surgical splice (only the restart
        segments the footprint touches are entropy-coded); restart-free
        sequential input takes the band splice (only the footprint's MCU
        rows are decoded and re-encoded); every other file, and every file
        under ``surgical=False``, takes the full decode/re-encode path.
        Output coefficients are identical on every path.  A file that cannot
        take its batch's splice falls back to the full path and is counted
        by reason in ``last_fallback_reasons``.  ``last_stream_path`` is
        "surgical", "splice", "mixed" or "full", and ``last_stream_stats``
        holds per-stage cumulative seconds.
        """
        import os
        import queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        from .. import codec

        own_pool = pool is None
        if own_pool:
            pool = ThreadPoolExecutor(max_workers=max(2, os.cpu_count() or 2))
        # three hand-off queues: producer (decode) -> dispatcher (pack +
        # host->device) -> fetcher (device->host) -> consumer (scatter +
        # encode)
        q0: queue.Queue = queue.Queue(maxsize=1)
        q: queue.Queue = queue.Queue(
            maxsize=max(1, lookahead - lookahead // 2))
        q2: queue.Queue = queue.Queue(maxsize=max(1, lookahead // 2))
        stop = object()
        closed = threading.Event()

        def put_to(dst, item) -> bool:
            while not closed.is_set():
                try:
                    dst.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        def put(item) -> bool:
            return put_to(q, item)

        plan = None
        if surgical is not False and not self.noop and options == 0 and (
                restart_interval is None
                or restart_interval == self.template.restart_interval):
            plan = self._surgical_plan()
            if not plan.ok:
                plan = None
        # Restart-free BAND splice (codec.decode_band/encode_splice_band):
        # when the surgical plan does not apply, only the footprint's MCU
        # rows are decoded and re-encoded; the prefix is byte-copied and the
        # suffix bit-shift-copied — output bytes identical to the full path.
        splice_band = None
        if (plan is None and surgical is not False and not self.noop
                and options == 0
                and not self.template.progressive
                and not self.template.arithmetic
                and self.template.restart_interval == 0
                and (restart_interval is None or restart_interval == 0)):
            t = self.template
            rows_total = -(-t.height // (8 * t.sampling.max_v_samp))
            mcu_rows = max(
                -(-h // t.components[c].v_samp)
                for c, (h, _) in enumerate(self._comp_shapes))
            row0 = self.block_y
            row1 = min(self.block_y + mcu_rows, rows_total)
            if row0 > 0 or row1 < rows_total:
                splice_band = (row0, row1)
        self.last_stream_path = ("surgical" if plan is not None else
                                 "splice" if splice_band is not None else
                                 "full")
        self.last_fallback_reasons = {}
        # per-stage cumulative wall clocks (seconds): stage sums exceeding
        # total wall = good overlap
        stats = {"decode_s": 0.0, "pack_dispatch_s": 0.0, "fetch_s": 0.0,
                 "scatter_s": 0.0, "encode_s": 0.0, "wall_s": 0.0,
                 "batches": 0}
        self.last_stream_stats = stats
        t_start = time.perf_counter()
        origins = None if self.noop else self._region_origins()

        reasons_lock = threading.Lock()  # pool threads count fallbacks

        def fallback(reason):
            with reasons_lock:
                self.last_fallback_reasons[reason] = \
                    self.last_fallback_reasons.get(reason, 0) + 1
                self.last_stream_path = "mixed"

        def decode_batch(chunk):
            """Decode a batch: surgical windows / splice bands where
            eligible, full decode otherwise."""
            n = len(chunk)
            payloads = [None] * n
            splices = [None] * n
            if plan is not None:
                for i, (payload, reason) in enumerate(
                        pool.map(plan.extract, chunk)):
                    if payload is None:
                        fallback(reason)
                    else:
                        payloads[i] = payload

            def prep_one(i):
                if payloads[i] is not None:
                    return plan.decode_windows(payloads[i])
                if splice_band is not None:
                    try:
                        img, sp = codec.decode_band(chunk[i],
                                                    splice_band[0],
                                                    splice_band[1],
                                                    max_pixel=max_pixel)
                        splices[i] = sp
                        return img
                    except codec.SpliceIneligible as e:
                        fallback(str(e))
                # the pool already decodes files concurrently; intra-file
                # thread parallelism on top would oversubscribe
                return codec.decode(chunk[i], max_pixel=max_pixel,
                                    nthreads=1 if n > 1 else 0)

            t0 = time.perf_counter()
            prepped = list(pool.map(prep_one, range(n)))
            stats["decode_s"] += time.perf_counter() - t0
            return payloads, splices, prepped

        def dispatch_batch(payloads, prepped):
            """Gather footprint regions and dispatch the packed device step
            (one host->device transfer) — every path shares it."""
            if self.noop:
                return None
            regions, quants = [], []
            for i in range(len(prepped)):
                if payloads[i] is not None:
                    regions.append(plan.gather(prepped[i]))
                    quants.append(payloads[i][4])
                else:
                    im = prepped[i]
                    regions.append([im.coefs[c][r0:r0 + h, c0:c0 + w]
                                    for c, (r0, c0, h, w)
                                    in enumerate(origins)])
                    quants.append([im.quant_table_for(c)
                                   for c in range(len(origins))])
            t0 = time.perf_counter()
            pending = self._pack_regions(regions, quants)
            stats["pack_dispatch_s"] += time.perf_counter() - t0
            return pending

        def producer():
            try:
                it = iter(datas)
                while not closed.is_set():
                    chunk = []
                    for _ in range(batch):
                        try:
                            chunk.append(next(it))
                        except StopIteration:
                            break
                    if not chunk:
                        break
                    payloads, splices, prepped = decode_batch(chunk)
                    if not put_to(q0, (chunk, payloads, splices, prepped)):
                        return
                put_to(q0, stop)
            except BaseException as e:  # surface decode errors to the consumer
                put_to(q0, e)

        def dispatcher():
            """Pack + host->device dispatch off the decode thread, so batch
            i's upload overlaps batch i+1's decode."""
            try:
                while not closed.is_set():
                    try:
                        item = q0.get(timeout=0.2)
                    except queue.Empty:
                        continue
                    if item is stop or isinstance(item, BaseException):
                        put(item)
                        return
                    chunk, payloads, splices, prepped = item
                    pending = dispatch_batch(payloads, prepped)
                    if not put((chunk, payloads, splices, prepped, pending)):
                        return
            except BaseException as e:
                put(e)

        def fetcher():
            """Wait for the device->host transfer off the consumer thread, so
            batch i's wait overlaps batch i-1's (CPU-bound) encode."""
            try:
                while not closed.is_set():
                    try:
                        item = q.get(timeout=0.2)
                    except queue.Empty:
                        continue
                    if item is stop or isinstance(item, BaseException):
                        put_to(q2, item)
                        return
                    chunk, payloads, splices, prepped, pending = item
                    parts = None
                    if pending is not None:
                        t0 = time.perf_counter()
                        parts = self._unpack_regions(pending)
                        stats["fetch_s"] += time.perf_counter() - t0
                    if not put_to(q2,
                                  (chunk, payloads, splices, prepped, parts)):
                        return
            except BaseException as e:
                put_to(q2, e)

        def graft_full(i, composed):
            """Full decode of file i with the composed footprint grafted in,
            re-encoded with fresh tables."""
            full_im = codec.decode(chunk[i], max_pixel=max_pixel, nthreads=1)
            for c, (r0, c0, h, w) in enumerate(origins):
                full_im.coefs[c][r0:r0 + h, c0:c0 + w] = composed[c]
            return codec.encode(full_im, options=options,
                                restart_interval=restart_interval)

        def enc_one(i):
            if payloads[i] is not None:
                try:
                    return plan.reencode(chunk[i], payloads[i], prepped[i])
                except codec.EncodeError:
                    # the original (optimized) tables lack a code the
                    # composed segment now needs: redo on the full path
                    fallback("surgical: original tables lack a needed "
                             "symbol")
                    return graft_full(i, plan.gather(prepped[i]))
            if splices[i] is not None:
                try:
                    return codec.encode_splice_band(
                        chunk[i], prepped[i], splice_band[0],
                        splice_band[1], splices[i])
                except codec.EncodeError as e:
                    # same hazard for the band splice, which must keep the
                    # original tables for bit-identity; any other encode
                    # error is counted under its own message
                    fallback("splice: original tables lack a needed symbol"
                             if "has no Huffman code" in str(e)
                             else f"splice: {e}")
                    return graft_full(
                        i, [prepped[i].coefs[c][r0:r0 + h, c0:c0 + w]
                            for c, (r0, c0, h, w) in enumerate(origins)])
            return codec.encode(prepped[i], options=options,
                                restart_interval=restart_interval)

        threads = [threading.Thread(target=f, daemon=True)
                   for f in (producer, dispatcher, fetcher)]
        for th in threads:
            th.start()
        try:
            while True:
                item = q2.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                chunk, payloads, splices, prepped, parts = item
                stats["batches"] += 1
                if parts is not None:
                    t0 = time.perf_counter()
                    for i in range(len(chunk)):
                        regions_i = [p[i] for p in parts]
                        if payloads[i] is not None:
                            plan.scatter(prepped[i], regions_i)
                        else:
                            im = prepped[i]
                            for c, (r0, c0, h, w) in enumerate(origins):
                                im.coefs[c][r0:r0 + h, c0:c0 + w] = \
                                    regions_i[c]
                    stats["scatter_s"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                yield from pool.map(enc_one, range(len(chunk)))
                stats["encode_s"] += time.perf_counter() - t0
        finally:
            stats["wall_s"] = time.perf_counter() - t_start
            closed.set()
            for th in threads:
                th.join(timeout=2.0)
            if own_pool:
                pool.shutdown(wait=False)

    def put_batch(self, images: Sequence[CoefImage]) -> list:
        """Stack host images into device batches: per component an
        [N, H, W, 8, 8] int16 tensor on the composer's device, or with a
        mesh a ShardedRows split over its "batch" axis (N zero-padded to a
        multiple of its size)."""
        batches = []
        for c in range(self.template.num_components):
            arr = np.stack([im.coefs[c] for im in images])
            if self.mesh is not None:
                batches.append(shard_rows(arr, batch_sharding(self.mesh)))
            else:
                batches.append(torch.from_numpy(arr).to(self.device))
        return batches

    def compose_arrays(self, comp_batches: Sequence) -> list:
        """comp_batches[c]: the [N, H, W, 8, 8] int16 batch of component c
        (a tensor, or a ShardedRows from put_batch), matching the template
        geometry.  Composes the footprint of every image with the
        template's quant tables, each slab on its own device, in place, and
        returns the batches."""
        if self.noop:
            return list(comp_batches)
        for c, (r0, c0, h, w) in enumerate(self._region_origins()):
            grids = comp_batches[c]
            slabs = (grids.slabs if isinstance(grids, ShardedRows)
                     else [grids])
            quant = np.asarray(self.template.quant_table_for(c), np.int32)
            for slab in slabs:
                dd = self._dropon_on(slab.device)
                _compose_batch_component(
                    slab, dd.drops[c].reshape(h, w, 8, 8),
                    dd.masks[c].reshape(h, w, 8, 8),
                    torch.from_numpy(quant).to(slab.device), r0, c0)
        return list(comp_batches)


def compose_batch(images: Sequence[CoefImage], dropon: Dropon, align: int = 0,
                  offset_x: int = 0, offset_y: int = 0,
                  mesh: Optional[Mesh] = None, *, device=None,
                  compiled=None) -> list:
    """One-shot batched compose of whole images on the device (split over
    ``mesh``'s "batch" axis when given); returns new CoefImages."""
    bc = BatchComposer(images[0], dropon, align, offset_x, offset_y, mesh,
                       device=device, compiled=compiled)
    results = bc.compose_arrays(bc.put_batch(images))
    host = [r.numpy() if isinstance(r, ShardedRows) else r.cpu().numpy()
            for r in results]
    outs = []
    for i, im in enumerate(images):
        o = im.copy()
        for c in range(o.num_components):
            o.coefs[c] = host[c][i]
        outs.append(o)
    return outs
