"""Batched compose: many same-geometry images, one dropon (PyTorch port
of libmodjpeg_tpu.parallel.batch).

Only the overlay footprint of each image travels to the device and back,
packed batch-major: one host->device and one device->host transfer per
batch and device.  The device step (``packed_compose``) restores the
int8+exceptions uplink with one scatter, runs the compose kernel once per
component and packs the downlink the same way.  On a CUDA device the step
runs on the composer's own stream for that device, fed from pinned host
buffers, and a CUDA event marks the end of its device->host copy; on the
CPU it runs synchronously.  While tracing is on (``tracing``), the step
is a device span from before its first host->device copy to that event.
With a stream mesh (several local cards, or an explicit ``mesh``) the
packed rows of a batch are split into one equal slab per device of the
mesh's "batch" axis.

``put_batch``/``compose_arrays``/``compose_batch`` compose whole
[N, H, W, 8, 8] image batches that stay on the device (split over the
mesh's "batch" axis when one is given).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import codec, tracing
from ..model import CoefImage, Dropon

from ..ops.compose import compose_rows
from ..state import DeviceDropon
from .mesh import Mesh, ShardedRows, batch_sharding, shard_rows, stream_mesh

_STREAMS = itertools.count()  # the ``stream`` id of each watermark_stream


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


def _footprint(im: CoefImage, origins, regions=None) -> list:
    """The footprint of ``im`` at ``origins`` (per component (r0, c0, h, w)
    in blocks), one view per component; with ``regions``, written there
    first."""
    views = [im.coefs[c][r0:r0 + h, c0:c0 + w]
             for c, (r0, c0, h, w) in enumerate(origins)]
    for view, region in zip(views, regions or ()):
        view[...] = region
    return views


class _Route:
    """What the files of one watermark_stream share: the composer's route
    for the stream (a surgical plan, the band's MCU rows, or neither), the
    footprint's origins, the encode settings and the fallback count."""

    def __init__(self, bc, plan, band, options, restart_interval,
                 max_pixel):
        self.bc, self.plan, self.band = bc, plan, band
        self.origins = None if bc.noop else bc._origins
        self.options, self.restart_interval = options, restart_interval
        self.max_pixel = max_pixel
        self._lock = threading.Lock()  # pool threads count fallbacks

    def fallback(self, reason: str) -> None:
        with self._lock:
            reasons = self.bc.last_fallback_reasons
            reasons[reason] = reasons.get(reason, 0) + 1
            self.bc.last_stream_path = "mixed"

    def decode(self, data: bytes, payload, ids: dict, nthreads: int):
        """One file decoded on the route it can take (a pool task):
        surgical with an extract ``payload``, else the band when the stream
        has one and the file fits it, else the full path."""
        if payload is not None:
            return _SurgicalFile(self, data, ids, payload)
        if self.band is not None:
            try:
                img, info = codec.decode_band(data, self.band[0],
                                              self.band[1],
                                              max_pixel=self.max_pixel)
                return _BandFile(self, data, ids, img, info)
            except codec.SpliceIneligible as e:
                self.fallback(str(e))
        return _FullFile(self, data, ids, codec.decode(
            data, max_pixel=self.max_pixel, nthreads=nthreads))

    def encode(self, img: CoefImage) -> bytes:
        return codec.encode(img, options=self.options,
                            restart_interval=self.restart_interval)

    def graft(self, data: bytes, regions) -> bytes:
        """Full decode of ``data`` with the composed footprint ``regions``
        grafted in, re-encoded with fresh tables: a splice's fallback."""
        img = codec.decode(data, max_pixel=self.max_pixel, nthreads=1)
        _footprint(img, self.origins, regions)
        return self.encode(img)


class _FullFile:
    """A stream file on the full path: its decoded image, re-encoded whole.
    ``ids`` are its span ids (stream, batch, file)."""

    def __init__(self, route: _Route, data: bytes, ids: dict,
                 img: CoefImage):
        self.route, self.data, self.ids, self.img = route, data, ids, img

    def regions(self) -> list:
        return _footprint(self.img, self.route.origins)

    def quants(self) -> list:
        return [self.img.quant_table_for(c)
                for c in range(len(self.route.origins))]

    def scatter(self, regions) -> None:
        _footprint(self.img, self.route.origins, regions)

    def encode(self) -> bytes:
        return self.route.encode(self.img)

    def decoded(self, stats: dict, cpu: float) -> None:
        """Count its decode (``cpu`` thread seconds) in the route's stats."""

    def encoded(self, stats: dict, cpu: float) -> None:
        """Count its encode (``cpu`` thread seconds) in the route's stats."""


class _BandFile(_FullFile):
    """A file on the band splice: the band's image and codec.decode_band's
    splice info.  The prefix is byte-copied and the suffix bit-shift-copied
    around the re-encoded band."""

    def __init__(self, route, data, ids, img, info):
        super().__init__(route, data, ids, img)
        self.info = info

    def encode(self) -> bytes:
        try:
            return codec.encode_splice_band(self.data, self.img,
                                            self.route.band[0],
                                            self.route.band[1], self.info)
        except codec.EncodeError as e:
            # the band splice keeps the original tables for bit-identity,
            # which may lack a code the composed band now needs: redo on the
            # full path; any other encode error is counted under its own
            # message
            self.route.fallback(
                "splice: original tables lack a needed symbol"
                if "has no Huffman code" in str(e) else f"splice: {e}")
            return self.route.graft(self.data, self.regions())

    def decoded(self, stats, cpu):
        stats["band_prefix_s"] += self.info[13] * 1e-9
        stats["band_decode_s"] += self.info[14] * 1e-9
        stats["band_after_s"] += self.info[15] * 1e-9


class _SurgicalFile:
    """A file on the surgical splice: its extract payload and window planes
    (only the restart segments the footprint touches), in place of a
    decoded image."""

    def __init__(self, route, data, ids, payload):
        self.route, self.data, self.ids = route, data, ids
        self.payload = payload
        self.planes = route.plan.decode_windows(payload)
        self.spliced = True

    def regions(self) -> list:
        return self.route.plan.gather(self.planes)

    def quants(self) -> list:
        return self.payload[4]

    def scatter(self, regions) -> None:
        self.route.plan.scatter(self.planes, regions)

    def encode(self) -> bytes:
        try:
            with tracing.span("mjt.stream.surgical_reencode", **self.ids):
                return self.route.plan.reencode(self.data, self.payload,
                                                self.planes)
        except codec.EncodeError:
            # the original (optimized) tables lack a code the composed
            # segment now needs: redo on the full path, which the surgical
            # counters then leave out
            self.spliced = False
            self.route.fallback(
                "surgical: original tables lack a needed symbol")
            return self.route.graft(self.data, self.regions())

    def decoded(self, stats, cpu):
        stats["surgical_window_cpu_s"] += cpu

    def encoded(self, stats, cpu):
        if self.spliced:
            stats["surgical_reencode_cpu_s"] += cpu
            stats["surgical_recoded_bytes"] += sum(
                e - s for s, e in self.payload[1])
            stats["surgical_entropy_bytes"] += self.payload[5]


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
        from ..composer import _place_dropon

        self.template = template
        self.mesh = mesh
        if mesh is not None:
            first = mesh.device_list[0]
            if device is not None and torch.device(device) != first:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {first}")
            device = first
        self.device = torch.device("cuda" if device is None else device)
        placed = _place_dropon(template, dropon, align, offset_x, offset_y,
                               self.device, compiled)
        self.noop = placed is None
        if self.noop:
            return
        p, self._dev, self._origins, _ = placed
        self.block_y = p.block_y
        self._dev_dropons = {self.device: self._dev}
        self._meta = self._dev.meta
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
        # the compose streams start behind the compile, which is queued on
        # the current stream
        for d, stream in self._streams.items():
            stream.wait_stream(torch.cuda.current_stream(d))
        self.last_dispatch_devices = 1

    def _dropon_on(self, device) -> DeviceDropon:
        """The compiled dropon on ``device``, moved there at first use; the
        device's compose stream then waits for the move."""
        dd = self._dev_dropons.get(device)
        if dd is None:
            src = self._dev
            drops, masks, weights = (tuple(t.to(device) for t in ts) for ts
                                     in (src.drops, src.masks, src.weights))
            dd = DeviceDropon(drops, masks, src.shapes, weights)
            if device in self._streams:
                self._streams[device].wait_stream(
                    torch.cuda.current_stream(device))
            self._dev_dropons[device] = dd
        return dd

    def compose_images(self, images: Sequence[CoefImage]) -> None:
        """In-place batched compose: only the overlay footprint travels to
        the device and back, all components in one device step.  Each image
        composes with its OWN quant tables."""
        if self.noop:
            return
        origins = self._origins
        pending = self._pack_regions(
            [_footprint(im, origins) for im in images],
            [[im.quant_table_for(c) for c in range(len(origins))]
             for im in images])
        for im, regions in zip(images, zip(*self._unpack_regions(pending))):
            _footprint(im, origins, regions)

    def _region_origins(self) -> list:
        """A copy of ``_origins``: per component (r0, c0, h, w), the
        footprint's block rectangle."""
        return list(self._origins)

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
        until the event has been waited on, the step's device span or
        None)."""
        dd = self._dropon_on(dev)
        stream = self._streams.get(dev)
        if stream is None:
            t = [torch.from_numpy(a).to(dev) for a in host]
            wire = tuple(t[:-1]) if packed else t[0]
            down, raw = packed_compose(self._meta, wire, t[-1], dd.drops,
                                       dd.masks, cap)
            return (dev, down.cpu(), raw, None, (), None)
        with torch.cuda.stream(stream):
            pinned = [torch.from_numpy(a).pin_memory() for a in host]
            with tracing.device_span("mjt.stream.device", stream) as step:
                t = [a.to(dev, non_blocking=True) for a in pinned]
                wire = tuple(t[:-1]) if packed else t[0]
                down_dev, raw = packed_compose(self._meta, wire, t[-1],
                                               dd.drops, dd.masks, cap)
                down = torch.empty(down_dev.shape, dtype=down_dev.dtype,
                                   pin_memory=True)
                down.copy_(down_dev, non_blocking=True)
            if step is None:
                event = torch.cuda.Event()
                event.record(stream)
            else:
                event = step.end_event
        return (dev, down, raw, event, (t, down_dev), step)

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
        for _dev, down, _raw, event, _keep, _step in parts:
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
            for k, (dev, _down, raw, _event, _keep, _step) in enumerate(
                    parts):
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
        for (h, w) in self._dev.shapes:
            sz = h * w * 64
            parts.append(flat[:, off:off + sz].reshape(n, h, w, 8, 8))
            off += sz
        return parts

    def _surgical_plan(self):
        """Lazily built surgical splice plan (libmodjpeg_tpu.surgical);
        plan.ok is False when the template is outside the surgical
        envelope."""
        if not hasattr(self, "_splan"):
            from ..surgical import SurgicalPlan

            self._splan = SurgicalPlan(self.template, self._origins,
                                       self.template.restart_interval)
        return self._splan

    def _stream_route(self, surgical, options: int, restart_interval,
                      max_pixel: int) -> _Route:
        """The route of a stream: its surgical plan or None, its band rows
        (row0, row1) or None; sets last_stream_path and clears
        last_fallback_reasons."""
        t = self.template
        plan = splice_band = None
        if surgical is not False and not self.noop and options == 0:
            if restart_interval in (None, t.restart_interval):
                plan = self._surgical_plan()
                if not plan.ok:
                    plan = None
            # Restart-free BAND splice (codec.decode_band /
            # encode_splice_band): when the surgical plan does not apply,
            # only the footprint's MCU rows are decoded and re-encoded; the
            # prefix is byte-copied and the suffix bit-shift-copied — output
            # bytes identical to the full path.
            if (plan is None and not t.progressive and not t.arithmetic
                    and t.restart_interval == 0
                    and restart_interval in (None, 0)):
                rows_total = -(-t.height // (8 * t.sampling.max_v_samp))
                mcu_rows = max(-(-h // t.components[c].v_samp)
                               for c, (h, _) in enumerate(self._dev.shapes))
                row1 = min(self.block_y + mcu_rows, rows_total)
                if self.block_y > 0 or row1 < rows_total:
                    splice_band = (self.block_y, row1)
        self.last_stream_path = ("surgical" if plan is not None else
                                 "splice" if splice_band is not None else
                                 "full")
        self.last_fallback_reasons = {}
        return _Route(self, plan, splice_band, options, restart_interval,
                      max_pixel)

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
        "surgical", "splice", "mixed" or "full".

        ``last_stream_stats`` holds the stream's cumulative counters, in
        seconds unless named otherwise.  Always on:

        - ``batches``: batches the consumer took;
        - ``start_s``: from entering the stream to three running threads
          (the pool, the queues, the route and the threads);
        - ``decode_s``: the producer's wall time in each batch's decode
          tasks (surgical extracts and windows, band or full decodes);
        - ``decode_cpu_s``: the thread CPU time of those tasks, summed over
          files;
        - ``surgical_extract_s``: the part of ``decode_s`` in the batch's
          surgical extracts (the whole-file parse and restart-marker scan,
          the crafted mini-JPEGs);
        - ``surgical_window_cpu_s``: the thread CPU time of the surgical
          window decodes (the mini-JPEGs), summed over files;
        - ``surgical_reencode_cpu_s``: the thread CPU time of the surgical
          re-encodes (mini encode, its re-scan, the splice join), summed over
          the files that took the surgical splice to the end;
        - ``surgical_recoded_bytes``, ``surgical_entropy_bytes``: over those
          files, the bytes of the touched segments' original entropy data,
          and of the whole entropy-coded data (SOS header to EOI, restart
          markers included);
        - ``band_prefix_s``, ``band_decode_s``, ``band_after_s``: the
          native band decode's phases (destuff + prefix skip walk, band
          decode, band-end re-walk + suffix walk), summed over band-splice
          files;
        - ``pack_dispatch_s``: the dispatcher's pack and device-step
          dispatch;
        - ``fetch_s``: the fetcher's wait for the device->host copy and
          its unpack;
        - ``scatter_s``: the consumer's scatter of composed regions;
        - ``encode_s``: the consumer's own time from taking up each output
          to yielding it (the encode tasks it waits for); the caller's time
          between outputs is left out;
        - ``encode_cpu_s``: the thread CPU time of the encode tasks, summed
          over files;
        - ``producer_blocked_s``: the producer waiting to hand a decoded
          batch on;
        - ``dispatcher_idle_s``, ``dispatcher_blocked_s``: the dispatcher
          waiting for a decoded batch, and to hand a dispatched one on;
        - ``fetcher_idle_s``, ``fetcher_blocked_s``: the same for the
          fetcher;
        - ``consumer_idle_s``: the consumer waiting for a fetched batch;
        - ``stop_s``: closing the stream (the threads' joins, the pool's
          shutdown).

        Only while tracing is on (``tracing``): ``device_step_s``, each
        batch's device step on its CUDA stream, from before its first
        host->device copy to the end of its device->host copy, summed over
        devices.  Each timed interval is also a span then
        (``mjt.stream.*``, with ``stream``, ``batch`` and ``file`` ids).
        """
        import os
        import queue
        from concurrent.futures import ThreadPoolExecutor

        seq = next(_STREAMS)
        stats = {"batches": 0, "start_s": 0.0, "decode_s": 0.0,
                 "decode_cpu_s": 0.0, "surgical_extract_s": 0.0,
                 "surgical_window_cpu_s": 0.0,
                 "surgical_reencode_cpu_s": 0.0, "surgical_recoded_bytes": 0,
                 "surgical_entropy_bytes": 0, "band_prefix_s": 0.0,
                 "band_decode_s": 0.0, "band_after_s": 0.0,
                 "pack_dispatch_s": 0.0, "fetch_s": 0.0, "scatter_s": 0.0,
                 "encode_s": 0.0, "encode_cpu_s": 0.0,
                 "producer_blocked_s": 0.0, "dispatcher_idle_s": 0.0,
                 "dispatcher_blocked_s": 0.0, "fetcher_idle_s": 0.0,
                 "fetcher_blocked_s": 0.0, "consumer_idle_s": 0.0,
                 "stop_s": 0.0}
        self.last_stream_stats = stats
        stop = object()
        closed = threading.Event()

        def get_from(src, key: str, ids: dict):
            """The next item of ``src``, or None once the stream is closed;
            the wait is stats[key] and the span mjt.stream.<key>."""
            with tracing.timed(stats, key, f"mjt.stream.{key[:-2]}", **ids):
                while not closed.is_set():
                    try:
                        return src.get(timeout=0.2)
                    except queue.Empty:
                        pass
            return None

        def put_to(dst, item, key: str, ids: dict) -> bool:
            """Hand ``item`` on to ``dst`` (False once the stream is
            closed); the wait is stats[key] and the span
            mjt.stream.<key>."""
            with tracing.timed(stats, key, f"mjt.stream.{key[:-2]}", **ids):
                while not closed.is_set():
                    try:
                        dst.put(item, timeout=0.2)
                        return True
                    except queue.Full:
                        pass
            return False

        def forward(dst, item, key: str, b: int) -> None:
            """Hand ``stop`` or an error on to ``dst`` after batch ``b``."""
            put_to(dst, item, key, {"stream": seq, "batch": b})

        def cpu_timed(fn):
            """``fn`` as a pool task that also returns its thread CPU
            seconds."""
            def task(*args):
                c0 = time.thread_time()
                out = fn(*args)
                return out, time.thread_time() - c0
            return task

        def decode_batch(chunk, ids) -> list:
            """Decode a batch on the pool: one file object per input, on the
            route it takes."""
            n = len(chunk)
            payloads = [None] * n
            extract_cpu = 0.0
            with tracing.timed(stats, "decode_s", "mjt.stream.decode", **ids):
                if route.plan is not None:
                    with tracing.timed(stats, "surgical_extract_s",
                                       "mjt.stream.surgical_extract", **ids):
                        extracted = list(pool.map(
                            cpu_timed(route.plan.extract), chunk))
                    for i, ((payload, reason), cpu) in enumerate(extracted):
                        extract_cpu += cpu
                        if payload is None:
                            route.fallback(reason)
                        payloads[i] = payload
                # the pool already decodes files concurrently; intra-file
                # thread parallelism on top would oversubscribe
                done = list(pool.map(
                    cpu_timed(route.decode), chunk, payloads,
                    [dict(ids, file=ids["file"] + i) for i in range(n)],
                    [1 if n > 1 else 0] * n))
            stats["decode_cpu_s"] += extract_cpu + sum(cpu for _, cpu in done)
            for f, cpu in done:
                f.decoded(stats, cpu)
            return [f for f, _ in done]

        def dispatch(ids, files, _):
            """Gather footprint regions and dispatch the packed device step
            (one host->device transfer) — every route shares it."""
            if self.noop:
                return None
            regions = [f.regions() for f in files]
            quants = [f.quants() for f in files]
            with tracing.timed(stats, "pack_dispatch_s",
                               "mjt.stream.dispatch", **ids):
                return self._pack_regions(regions, quants)

        def fetch(ids, files, pending):
            """Wait for the device->host transfer off the consumer thread, so
            batch i's wait overlaps batch i-1's (CPU-bound) encode."""
            if pending is None:
                return None
            with tracing.timed(stats, "fetch_s", "mjt.stream.fetch", **ids):
                parts = self._unpack_regions(pending)
            # the device spans' end events have been waited on
            steps = [p[5].device_ms for p in pending[0] if p[5] is not None]
            if steps:
                stats["device_step_s"] = (stats.get("device_step_s", 0.0)
                                          + sum(steps) * 1e-3)
            return parts

        def producer():
            b = first = 0
            try:
                it = iter(datas)
                while not closed.is_set():
                    chunk = list(itertools.islice(it, batch))
                    if not chunk:
                        break
                    ids = {"stream": seq, "batch": b, "file": first}
                    if not put_to(q0, (ids, decode_batch(chunk, ids), None),
                                  "producer_blocked_s", ids):
                        return
                    b += 1
                    first += len(chunk)
                item = stop
            except BaseException as e:  # surface decode errors to the consumer
                item = e
            forward(q0, item, "producer_blocked_s", b)

        def relay(src, dst, work, idle_key: str, blocked_key: str):
            """A stage thread: each batch of ``src`` with its handle
            replaced by work(ids, files, handle), handed on to ``dst``;
            ``stop`` and errors are handed on, and the thread ends with them
            or once the stream is closed."""
            b = 0
            try:
                while True:
                    item = get_from(src, idle_key, {"stream": seq, "batch": b})
                    if item is None:
                        return
                    if item is stop or isinstance(item, BaseException):
                        break
                    ids, files, handle = item
                    if not put_to(dst, (ids, files, work(ids, files, handle)),
                                  blocked_key, ids):
                        return
                    b += 1
            except BaseException as e:
                item = e
            forward(dst, item, blocked_key, b)

        with tracing.timed(stats, "start_s", "mjt.stream.start", stream=seq):
            own_pool = pool is None
            if own_pool:
                pool = ThreadPoolExecutor(
                    max_workers=max(2, os.cpu_count() or 2))
            # three hand-off queues: producer (decode) -> dispatcher (pack +
            # host->device) -> fetcher (device->host) -> consumer (scatter +
            # encode)
            q0: queue.Queue = queue.Queue(maxsize=1)
            q: queue.Queue = queue.Queue(
                maxsize=max(1, lookahead - lookahead // 2))
            q2: queue.Queue = queue.Queue(maxsize=max(1, lookahead // 2))
            route = self._stream_route(surgical, options, restart_interval,
                                       max_pixel)
            threads = [
                threading.Thread(target=producer, daemon=True),
                # pack + host->device dispatch off the decode thread, so
                # batch i's upload overlaps batch i+1's decode
                threading.Thread(target=relay, daemon=True, args=(
                    q0, q, dispatch, "dispatcher_idle_s",
                    "dispatcher_blocked_s")),
                threading.Thread(target=relay, daemon=True, args=(
                    q, q2, fetch, "fetcher_idle_s", "fetcher_blocked_s"))]
            for th in threads:
                th.start()
        try:
            while True:
                with tracing.timed(stats, "consumer_idle_s",
                                   "mjt.stream.consumer_idle", stream=seq,
                                   batch=stats["batches"]):
                    item = q2.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                ids, files, parts = item
                stats["batches"] += 1
                if parts is not None:
                    with tracing.timed(stats, "scatter_s",
                                       "mjt.stream.scatter", **ids):
                        for i, f in enumerate(files):
                            f.scatter([p[i] for p in parts])
                outs = None
                for f in files:
                    # timed up to each output, so the caller's time at the
                    # yield is not counted
                    with tracing.timed(stats, "encode_s",
                                       "mjt.stream.encode", **f.ids):
                        if outs is None:
                            outs = pool.map(cpu_timed(lambda g: g.encode()),
                                            files)
                        out, cpu = next(outs)
                    stats["encode_cpu_s"] += cpu
                    f.encoded(stats, cpu)
                    yield out
        finally:
            with tracing.timed(stats, "stop_s", "mjt.stream.stop",
                               stream=seq):
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
        for c, (r0, c0, h, w) in enumerate(self._origins):
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
