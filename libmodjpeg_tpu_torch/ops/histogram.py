"""Device-side Huffman symbol histograms (PyTorch port of
libmodjpeg_tpu.ops.histogram).

Every sequential-scan Huffman symbol follows from the coefficient grid with
vectorized ops: AC (run, size) symbols, ZRL and EOB are block-local, and a
DC difference category needs only the block's predecessor in scan order, a
static gather (``seq_pred_indices``) with -1 where a restart resets the
predictor.  So the statistics pass runs where the grids live, and only the
257-entry totals come back to the host, where the native encoder's own
table build (``codec.build_optimal_table``) makes the tables: the file is
byte-identical to the host ``OPTION_OPTIMIZE`` pass.

Counting is a ``scatter_add_`` into a fixed-size int64 tensor, with the
table slot folded into the high digit so one pass serves every slot, and
the invalid symbols (the zero coefficients, most of them) sent to a dump
region that is cut off: no data-dependent output size, so nothing
synchronises the card, and the dump is spread over _DUMP bins so its
atomic adds do not all queue on one address.  The blocks are counted in
chunks, which bounds the int32/int64 intermediates of a 100 MP frame.
For a grid split into row slabs (parallel.mesh.ShardedRows), the AC symbols
are counted per slab on that slab's device; the DC plane (1/64 of the grid)
is gathered to the first device for the predecessor gather, because
predecessors cross slab borders; the zero padding rows are left out; and
the per-slab partial histograms are summed on the first device (the
all-reduce of the JAX version).

Scope: sequential Huffman scans.  Progressive per-scan statistics depend on
EOB-run chunking and stay in the native encoder's host pass.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch

from .. import constants as C
from .. import tracing

from ..parallel.mesh import ShardedRows

_ZIGZAG = np.asarray(C.ZIGZAG, dtype=np.int64)
# magnitudes are exact up to 2**17 - 1 (a 12-bit DC difference is < 2**16)
_POW2 = np.asarray([1 << k for k in range(17)], dtype=np.int32)
_CHUNK = 1 << 18          # blocks per counting pass
_DC_BINS, _AC_BINS = 32, 256
_DUMP = 1024              # dump bins after the real ones (a power of two)


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> tuple:
    """(zigzag, powers of two, AC positions 1..63) on ``device``."""
    return (torch.from_numpy(_ZIGZAG).to(device),
            torch.from_numpy(_POW2).to(device),
            torch.arange(1, 64, dtype=torch.int32, device=device))


def _bit_width(av: torch.Tensor) -> torch.Tensor:
    """Magnitude category of int32 ``av`` >= 0: 0 for 0, floor(log2(av)) + 1
    otherwise, i.e. the count of powers of two <= av (integer compares)."""
    pow2 = _consts(av.device)[1]
    return torch.bucketize(av, pow2, right=True, out_int32=True)


def _ac_symbols(blocks: torch.Tensor) -> tuple:
    """Per-coefficient AC (run, size) symbols for [N, 64] blocks in natural
    order.  Returns (sym int32 [N, 63] with -1 at zeros, zrl_count,
    eob_count), the counts as 0-d int64 tensors: the symbol stream
    walk_seq_segment emits (encoder.inc)."""
    zigzag, _, idx = _consts(blocks.device)
    ac = blocks.to(torch.int32).index_select(1, zigzag)[:, 1:]   # [N, 63]
    nz = ac != 0
    marked = torch.where(nz, idx, 0)
    incl = torch.cummax(marked, dim=1).values
    prev = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)
    run = idx - prev - 1                             # zeros since last nonzero
    size = _bit_width(ac.abs())
    sym = torch.where(nz, ((run & 15) << 4) | size, -1)
    zrl = torch.where(nz, run >> 4, 0).sum(dtype=torch.int64)
    eob = (incl[:, -1] < 63).sum(dtype=torch.int64)
    return sym, zrl, eob


def _dc_categories(dc: torch.Tensor, pred_idx: torch.Tensor) -> torch.Tensor:
    """DC difference categories from the [N] DC plane (any integer type)
    and the [N] int64 predecessor map; the difference is taken in int32."""
    dc = dc.to(torch.int32)
    pred = torch.where(pred_idx >= 0, dc[pred_idx.clamp(min=0)], 0)
    return _bit_width((dc - pred).abs())


def _new_hist(nbins: int, device) -> torch.Tensor:
    """Zeroed int64 counts: ``nbins`` real bins, then the dump region."""
    return torch.zeros(nbins + _DUMP, dtype=torch.int64, device=device)


def _count(hist: torch.Tensor, sym: torch.Tensor, valid: torch.Tensor,
           offset: int) -> None:
    """hist[offset + sym] += 1 where ``valid``; the others land in the dump
    region hist[-_DUMP:], spread by their position."""
    dump0 = hist.shape[0] - _DUMP
    sym = sym.reshape(-1).to(torch.int64)
    spread = torch.arange(sym.shape[0], device=sym.device) & (_DUMP - 1)
    idx = torch.where(valid.reshape(-1), sym + offset, spread + dump0)
    hist.scatter_add_(0, idx, torch.ones_like(idx))


def _ac_hist_into(hist: torch.Tensor, blocks: torch.Tensor,
                  slot: int) -> None:
    """Add the AC symbols of [N, 64] ``blocks`` (slot ``slot``) to the
    _new_hist(nslots * 256) counts on the blocks' device."""
    base = slot * _AC_BINS
    for start in range(0, blocks.shape[0], _CHUNK):
        sym, zrl, eob = _ac_symbols(blocks[start:start + _CHUNK])
        _count(hist, sym, sym >= 0, base)
        hist[base + 0xF0] += zrl
        hist[base + 0x00] += eob


def _dc_hist_into(hist: torch.Tensor, dc: torch.Tensor,
                  pred_idx: torch.Tensor, slot: int) -> None:
    cat = _dc_categories(dc, pred_idx)
    _count(hist, cat, torch.ones_like(cat, dtype=torch.bool),
           slot * _DC_BINS)


def ac_symbol_hist(blocks: torch.Tensor) -> torch.Tensor:
    """AC symbol counts for a sequential full scan, [256] int64.

    ``blocks``: [..., 8, 8] integer coefficients (natural order).  Counts
    exactly the symbols walk_seq_segment emits (encoder.inc): (run, size)
    per nonzero with ZRL (0xF0) for runs > 15, EOB (0x00) when the last
    nonzero is before position 63.
    """
    hist = _new_hist(_AC_BINS, blocks.device)
    _ac_hist_into(hist, blocks.reshape(-1, 64), 0)
    return hist[:_AC_BINS]


def dc_category_hist(blocks: torch.Tensor,
                     pred_idx: torch.Tensor) -> torch.Tensor:
    """DC difference-category counts, [256] int64.

    ``pred_idx``: [N] index of each block's predecessor in scan order (into
    the same flattened plane), or -1 where the predictor resets
    (scan/restart-segment starts) — see seq_pred_indices.
    """
    hist = _new_hist(_AC_BINS, blocks.device)
    _dc_hist_into(hist, blocks.reshape(-1, 64)[:, 0],
                  pred_idx.to(device=blocks.device, dtype=torch.int64), 0)
    return hist[:_AC_BINS]


def seq_pred_indices(components, mcus_wide: int,
                     restart_interval: int = 0) -> list[np.ndarray]:
    """Static DC-predecessor maps for a sequential full scan.

    For each component (with its padded [ph, pw] block plane) returns the
    flattened row-major index of the block encoded immediately before it in
    the interleaved MCU walk, or -1 at scan/segment starts.  Single-component
    frames degenerate to raster order.  Purely geometric — computed once per
    (geometry, restart interval) on host.
    """
    interleaved = len(components) > 1
    out = []
    for ci in components:
        h, v = (ci.h_samp, ci.v_samp) if interleaved else (1, 1)
        pw = ci.padded_width_in_blocks
        ph = ci.padded_height_in_blocks
        mw = mcus_wide if interleaved else pw
        row, col = np.mgrid[0:ph, 0:pw]
        m = (row // v) * mw + (col // h)             # MCU index in the walk
        j = (row % v) * h + (col % h)                # block slot within MCU
        s = m * (h * v) + j                          # component walk index
        mp, jp = (s - 1) // (h * v), (s - 1) % (h * v)
        prow = (mp // mw) * v + jp // h
        pcol = (mp % mw) * h + jp % h
        pidx = prow * pw + pcol
        reset = (s == 0) | ((j == 0) & (restart_interval > 0)
                            & (m % max(restart_interval, 1) == 0))
        out.append(np.where(reset, -1, pidx).astype(np.int32).ravel())
    return out


@functools.lru_cache(maxsize=64)
def _device_pred_indices(key, device: torch.device) -> tuple:
    """Predecessor maps as int64 tensors on ``device``, cached per
    geometry and device (they are purely geometric, and an upload per call
    would cost a host-to-device copy)."""
    geo, mcus_wide, restart_interval = key
    comps = [types.SimpleNamespace(h_samp=h, v_samp=v,
                                   padded_width_in_blocks=pw,
                                   padded_height_in_blocks=ph)
             for h, v, pw, ph in geo]
    return tuple(torch.from_numpy(p.astype(np.int64)).to(device) for p in
                 seq_pred_indices(comps, mcus_wide, restart_interval))


def _as_sharded(plane, device) -> ShardedRows:
    """A numpy plane goes to ``device``; a tensor or ShardedRows stays
    where it is."""
    if isinstance(plane, ShardedRows):
        return plane
    if isinstance(plane, np.ndarray):
        plane = torch.from_numpy(np.ascontiguousarray(plane)).to(device)
    return ShardedRows([plane], plane.shape[0])


def symbol_freqs(coefs, components, mcus_wide: int,
                 restart_interval: int = 0, *, device="cuda") -> dict:
    """Per-table-slot symbol frequencies for a sequential full scan.

    ``coefs``: per component, an [H, W, 8, 8] numpy array (placed on
    ``device``), a tensor, or a ShardedRows of one (counted where its slabs
    live) — H being the real padded plane height (a ShardedRows' padding
    rows are left out).  Slot assignment mirrors the encoder: component 0
    -> slot 0, all others -> slot 1.  Returns {("dc"|"ac", slot):
    int64[257]} matching the native FreqSink counts exactly.
    """
    planes = [_as_sharded(c, device) for c in coefs]
    first = planes[0].slabs[0].device
    key = (tuple((c.h_samp, c.v_samp, c.padded_width_in_blocks,
                  c.padded_height_in_blocks) for c in components),
           mcus_wide, restart_interval)
    preds = _device_pred_indices(key, first)
    slots = [0 if c == 0 else 1 for c in range(len(planes))]
    ns = max(slots) + 1
    dc = _new_hist(ns * _DC_BINS, first)
    ac = _new_hist(ns * _AC_BINS, first)
    partial = {}                                   # device -> AC hist there
    # the counting, up to the totals' copy to the host (a device span on
    # the first device while tracing is on)
    with tracing.device_span("mjt.grid.histogram", first):
        for plane, pred, slot in zip(planes, preds, slots):
            dc_parts = []
            for slab in plane.real_slabs():
                blocks = slab.reshape(-1, 64)
                dev = blocks.device
                if dev not in partial:
                    partial[dev] = (ac if dev == first else
                                    torch.zeros_like(ac, device=dev))
                _ac_hist_into(partial[dev], blocks, slot)
                dc_parts.append(blocks[:, 0].to(first))
            _dc_hist_into(dc, torch.cat(dc_parts), pred, slot)
        for dev, h in partial.items():
            if dev != first:
                ac += h.to(first)
    dc_h = dc[:-_DUMP].reshape(ns, _DC_BINS).cpu().numpy()
    ac_h = ac[:-_DUMP].reshape(ns, _AC_BINS).cpu().numpy()
    freqs: dict = {}
    for slot in range(ns):
        d = np.zeros(257, np.int64)
        a = np.zeros(257, np.int64)
        d[:_DC_BINS] = dc_h[slot]
        a[:_AC_BINS] = ac_h[slot]
        freqs[("dc", slot)] = d
        freqs[("ac", slot)] = a
    return freqs


def optimal_tables(coefs, components, mcus_wide: int,
                   restart_interval: int = 0, *, device="cuda") -> list:
    """Device histogram -> native table build.  Returns the preset-table
    list codec.encode(preset_tables=...) accepts; the resulting file is
    byte-identical to the host OPTION_OPTIMIZE pass."""
    from .. import codec

    freqs = symbol_freqs(coefs, components, mcus_wide, restart_interval,
                         device=device)
    tables = []
    for (kind, slot), f in sorted(freqs.items()):
        counts, syms = codec.build_optimal_table(f)
        tables.append((0 if kind == "dc" else 1, slot, counts, syms))
    return tables
