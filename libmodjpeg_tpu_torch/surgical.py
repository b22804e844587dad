"""The port's copy of libmodjpeg_tpu.surgical (the surgical splice planner).

Surgical watermarking: entropy-code only the restart segments the overlay
footprint touches, byte-splice everything else.

The reference re-entropy-codes the whole image on every compose (decode at
image.c:94, encode at image.c:191-194) even though untouched blocks are
bit-exact by construction.  With restart markers in the source bitstream the
entropy stream is a sequence of independently decodable segments (T.81 E.1.4:
DC predictors and EOB runs reset, segments are byte-aligned), so a compose
that touches a small footprint only needs to:

  1. scan the entropy data for RSTn positions (a vectorized byte scan),
  2. entropy-decode ONLY the segments containing touched MCUs -- done by
     splicing those segments into a crafted mini-JPEG (original headers with
     the SOF dims patched to one MCU row) and running the ordinary decoder,
  3. compose the footprint blocks on device (same packed kernel as the full
     path),
  4. re-encode the mini-JPEG with the ORIGINAL file's Huffman tables
     (preset-table encode) and the same restart interval,
  5. splice the new segment bytes back between the original restart markers.

Untouched segments are copied verbatim -- the output decodes to exactly the
same coefficients as the full decode->compose->encode pipeline (asserted in
tests/test_surgical.py) while host entropy work drops to the footprint share
(~3% for a 256x64 logo on 1080p at restart interval 32).

Applies to baseline/extended sequential Huffman, 8-bit, single interleaved
scan, restart interval > 0; anything else falls back to the full pipeline.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from .constants import ZIGZAG
from .model import CoefImage, ComponentInfo, Sampling

# markers
_SOI, _EOI, _SOS, _DRI, _DHT = 0xD8, 0xD9, 0xDA, 0xDD, 0xC4
_SOF_SEQ = (0xC0, 0xC1)  # baseline / extended sequential Huffman
_SOF_OTHER = (0xC2, 0xC3, 0xC5, 0xC6, 0xC7,
              0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)
_RST0, _RST7 = 0xD0, 0xD7


@dataclasses.dataclass
class Structure:
    """Parsed skeleton of a sequential single-scan JPEG."""

    sof_payload_off: int          # offset of the SOF payload (precision byte)
    precision: int
    height: int
    width: int
    comps: list                   # (id, h, v, tq) in frame order
    dri: int
    htables: dict                 # (tc, th) -> (counts16 bytes, symbols bytes)
    scan_td: list                 # per frame component: DC table selector
    scan_ta: list                 # per frame component: AC table selector
    entropy_start: int            # first entropy byte (after SOS payload)
    qtables: dict                 # th -> uint16[8, 8] natural order

    def geometry_key(self) -> tuple:
        """Bucketing key compatible with corpus._geometry_key on a decoded
        image: same dims + sampling + quant content compose identically."""
        return (self.width, self.height,
                tuple((h, v) for _id, h, v, _tq in self.comps),
                tuple(sorted((t, tuple(tbl.reshape(-1)))
                             for t, tbl in self.qtables.items())))


def parse_structure(data: bytes) -> Optional[Structure]:
    """Marker walk up to the first SOS.  Returns None for anything outside
    the surgical envelope (progressive, arithmetic, 12-bit, multi-scan is
    caught later when the entropy scan hits a non-EOI marker)."""
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != _SOI:
        return None
    pos = 2
    sof_off = -1
    precision = height = width = 0
    comps: list = []
    dri = 0
    htables: dict = {}
    qtables: dict = {}
    while True:
        # skip fill bytes
        while pos < n and data[pos] == 0xFF and pos + 1 < n and \
                data[pos + 1] == 0xFF:
            pos += 1
        if pos + 4 > n or data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        if _RST0 <= marker <= _RST7 or marker in (_SOI, 0x01):
            pos += 2
            continue
        seglen = (data[pos + 2] << 8) | data[pos + 3]
        if seglen < 2 or pos + 2 + seglen > n:
            return None
        payload = pos + 4
        if marker in _SOF_SEQ:
            sof_off = payload
            precision = data[payload]
            height = (data[payload + 1] << 8) | data[payload + 2]
            width = (data[payload + 3] << 8) | data[payload + 4]
            nc = data[payload + 5]
            if payload + 6 + 3 * nc > n:
                return None
            comps = []
            for c in range(nc):
                o = payload + 6 + 3 * c
                comps.append((data[o], data[o + 1] >> 4, data[o + 1] & 15,
                              data[o + 2]))
        elif marker in _SOF_OTHER:
            return None  # progressive / arithmetic / lossless
        elif marker == _DHT:
            o, end = payload, pos + 2 + seglen
            while o < end:
                tc, th = data[o] >> 4, data[o] & 15
                if o + 17 > end or tc > 1 or th > 3:
                    return None
                counts = data[o + 1:o + 17]
                nsyms = sum(counts)
                if o + 17 + nsyms > end:
                    return None
                htables[(tc, th)] = (bytes(counts),
                                     bytes(data[o + 17:o + 17 + nsyms]))
                o += 17 + nsyms
        elif marker == _DRI:
            dri = (data[payload] << 8) | data[payload + 1]
        elif marker == 0xDB:  # DQT
            o, end = payload, pos + 2 + seglen
            while o < end:
                pq, tq = data[o] >> 4, data[o] & 15
                nb = 2 if pq else 1
                if tq > 3 or o + 1 + 64 * nb > end:
                    return None
                vals = np.frombuffer(data, np.uint8, 64 * nb, o + 1)
                if pq:
                    vals = vals.reshape(64, 2).astype(np.uint16)
                    vals = (vals[:, 0] << 8) | vals[:, 1]
                nat = np.zeros(64, np.uint16)
                nat[list(ZIGZAG)] = vals
                qtables[tq] = nat.reshape(8, 8)
                o += 1 + 64 * nb
        elif marker == 0xCC:  # DAC: arithmetic conditioning
            return None
        elif marker == _SOS:
            if sof_off < 0 or precision != 8:
                return None
            ns = data[payload]
            if ns != len(comps):
                return None  # non-interleaved scan
            td, ta = [], []
            for i in range(ns):
                cs = data[payload + 1 + 2 * i]
                if cs != comps[i][0]:
                    return None  # scan order differs from frame order
                sel = data[payload + 2 + 2 * i]
                td.append(sel >> 4)
                ta.append(sel & 15)
            return Structure(sof_off, precision, height, width, comps, dri,
                             htables, td, ta, pos + 2 + seglen, qtables)
        pos += 2 + seglen


def scan_entropy(data: bytes, start: int):
    """Find restart-marker positions and the end of the entropy data.

    Returns (rst_positions, end) where ``end`` points at the 0xFF of the EOI,
    or None if the scan leaves the surgical envelope (fill bytes, DNL,
    another SOS, truncation).
    """
    buf = np.frombuffer(data, np.uint8)
    ffs = np.flatnonzero(buf[start:len(data) - 1] == 0xFF) + start
    if ffs.size == 0:
        return None
    nxt = buf[ffs + 1]
    is_rst = (nxt >= _RST0) & (nxt <= _RST7)
    significant = nxt != 0x00  # skip stuffing
    markers = ffs[significant]
    mnext = nxt[significant]
    mrst = is_rst[significant]
    # first non-RST marker terminates the scan
    stop = np.flatnonzero(~mrst)
    if stop.size == 0:
        return None
    k = stop[0]
    if mnext[k] != _EOI:
        return None  # DNL, another SOS, fill bytes -> full path
    return markers[:k].tolist(), int(markers[k])


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# crafted mini-JPEGs are one MCU row; the 16-bit SOF width field caps the MCUs
# per crafted file (tests shrink this to exercise chunking)
_MAX_WIDTH = 65535


class SurgicalPlan:
    """Precomputed geometry for surgically watermarking a fleet of
    same-geometry JPEGs with one compiled dropon.

    Built from a BatchComposer's template + compiled-dropon placement; all
    per-file work is byte scans and mini codec calls.
    """

    def __init__(self, template: CoefImage, origins, restart_interval: int):
        """origins: per component (r0, c0, h, w) block-region rectangles
        (the compose footprint, already MCU-aligned per component)."""
        self.ok = False
        if (restart_interval <= 0 or template.progressive
                or template.arithmetic or template.precision != 8):
            return
        self.template = template
        self.R = int(restart_interval)
        self.origins = list(origins)
        smp = template.sampling
        self.h_max, self.v_max = smp.max_h_samp, smp.max_v_samp
        c0i = template.components[0]
        self.mcus_w = c0i.padded_width_in_blocks // c0i.h_samp
        self.mcus_h = c0i.padded_height_in_blocks // c0i.v_samp
        total = self.mcus_w * self.mcus_h
        self.total_mcus = total
        self.nsegs_file = _ceil_div(total, self.R)

        # touched MCU set from the per-component footprints
        rows: set = set()
        cols: set = set()
        for c, (r0, co, h, w) in enumerate(self.origins):
            ci = template.components[c]
            rows.update(range(r0 // ci.v_samp,
                              _ceil_div(r0 + h, ci.v_samp)))
            cols.update(range(co // ci.h_samp,
                              _ceil_div(co + w, ci.h_samp)))
        touched = sorted({r * self.mcus_w + c for r in rows for c in cols})
        if not touched or touched[-1] >= total:
            return
        segs = sorted({m // self.R for m in touched})
        self.segs = segs

        # window = all MCUs of the touched segments, in order; chunked so one
        # crafted file's 16-bit width field holds (one MCU row per chunk)
        max_mcus = _MAX_WIDTH // (8 * self.h_max)
        seg_sizes = [min((s + 1) * self.R, total) - s * self.R for s in segs]
        chunks: list = []  # list of lists of seg indices (into self.segs)
        cur: list = []
        cur_mcus = 0
        for i, sz in enumerate(seg_sizes):
            if sz > max_mcus:
                return  # absurd restart interval; full path
            if cur and cur_mcus + sz > max_mcus:
                chunks.append(cur)
                cur, cur_mcus = [], 0
            cur.append(i)
            cur_mcus += sz
        chunks.append(cur)
        self.chunks = chunks
        self.chunk_mcus = [sum(seg_sizes[i] for i in ch) for ch in chunks]
        self.window_mcus = sum(self.chunk_mcus)

        # original MCU index -> window position
        winpos = np.full(total, -1, np.int64)
        q = 0
        for s, sz in zip(segs, seg_sizes):
            winpos[s * self.R:s * self.R + sz] = np.arange(q, q + sz)
            q += sz

        # per-component fancy indices into the concatenated window plane
        # [v_c, window_mcus * h_c, 8, 8]
        self.gather_idx = []
        for c, (r0, co, h, w) in enumerate(self.origins):
            ci = template.components[c]
            i = np.arange(r0, r0 + h)[:, None]
            j = np.arange(co, co + w)[None, :]
            mcu = (i // ci.v_samp) * self.mcus_w + (j // ci.h_samp)
            qpos = winpos[mcu]
            if (qpos < 0).any():
                return
            self.gather_idx.append(
                (np.broadcast_to(i % ci.v_samp, (h, w)),
                 qpos * ci.h_samp + (j % ci.h_samp)))

        # crafted-encode component layouts + table-slot requirements
        self.ncomps = template.num_components
        self.ok = True

    # -- per-file -----------------------------------------------------------

    def extract(self, data: bytes):
        """Parse + scan one file; build the crafted mini-JPEG(s).

        Returns ``(payload, reason)``: payload is (crafted_jpegs,
        seg_byte_ranges, structure, preset_tables, file_quants,
        entropy_bytes) when the file is inside the surgical envelope, else
        None with a short reason string (the caller falls back to the full
        pipeline for that file and can count reasons for observability).
        ``entropy_bytes`` is the length of the file's entropy-coded data,
        from the end of the SOS header to the EOI, restart markers included;
        the touched segments' ``seg_byte_ranges`` are the part of it that
        is re-coded.

        The file's OWN quant tables ride along in the payload: the device
        compose dequantizes each file with its own tables, so quant content
        differing from the template's is not an envelope exit.  A scan whose
        component order differs from the frame header is rejected as
        "scan-order" — T.81 B.2.3 requires scan components to follow frame
        order, so this only excludes non-conformant streams (the crafted
        re-encode emits frame-order MCUs, which must match the original SOS
        for the splice to be valid)."""
        st = parse_structure(data)
        if st is None:
            return None, "structure"
        if st.dri != self.R:
            return None, "restart-interval"
        if (st.width != self.template.width
                or st.height != self.template.height
                or len(st.comps) != self.ncomps):
            return None, "geometry"
        fquants = []
        for c, (cid, h, v, tq) in enumerate(st.comps):
            ci = self.template.components[c]
            if h != ci.h_samp or v != ci.v_samp:
                return None, "sampling"
            stbl = st.qtables.get(tq)
            if stbl is None:
                return None, "missing-qtable"
            fquants.append(np.asarray(stbl, np.int32))
        # table selectors must be mappable onto the encoder's fixed
        # comp0 -> slot0, comps 1.. -> slot1 convention
        if self.ncomps > 1:
            if any(st.scan_td[i] != st.scan_td[1]
                   or st.scan_ta[i] != st.scan_ta[1]
                   for i in range(2, self.ncomps)):
                return None, "table-slots"
        preset = []
        try:
            for slot, comp in ((0, 0), (1, 1))[:min(self.ncomps, 2)]:
                cdc, sdc = st.htables[(0, st.scan_td[comp])]
                cac, sac = st.htables[(1, st.scan_ta[comp])]
                preset.append((0, slot, cdc, sdc))
                preset.append((1, slot, cac, sac))
        except KeyError:
            return None, "missing-htable"

        scan = scan_entropy(data, st.entropy_start)
        if scan is None:
            return None, "entropy-scan"
        rsts, end = scan
        if len(rsts) + 1 != self.nsegs_file:
            return None, "segment-count"
        starts = [st.entropy_start] + [p + 2 for p in rsts]
        ends = rsts + [end]

        seg_ranges = [(starts[s], ends[s]) for s in self.segs]
        header = bytearray(data[:st.entropy_start])
        crafted = []
        for ch, n_mcus in zip(self.chunks, self.chunk_mcus):
            h = 8 * self.v_max
            w = n_mcus * 8 * self.h_max
            header[st.sof_payload_off + 1] = h >> 8
            header[st.sof_payload_off + 2] = h & 0xFF
            header[st.sof_payload_off + 3] = w >> 8
            header[st.sof_payload_off + 4] = w & 0xFF
            parts = [bytes(header)]
            for k, i in enumerate(ch):
                if k:
                    parts.append(bytes((0xFF, _RST0 + ((k - 1) & 7))))
                s, e = seg_ranges[i]
                parts.append(data[s:e])
            parts.append(b"\xff\xd9")
            crafted.append(b"".join(parts))
        return (crafted, seg_ranges, st, preset, fquants,
                end - st.entropy_start), None

    def decode_windows(self, extract) -> list:
        """Decode the crafted mini-JPEGs into concatenated window planes
        (one [v_c, window_mcus*h_c, 8, 8] array per component)."""
        from . import codec

        crafted = extract[0]
        imgs = [codec.decode(cj, nthreads=1) for cj in crafted]
        planes = []
        for c in range(self.ncomps):
            if len(imgs) == 1:
                planes.append(imgs[0].coefs[c])
            else:
                planes.append(np.concatenate([im.coefs[c] for im in imgs],
                                             axis=1))
        return planes

    def gather(self, planes) -> list:
        """Footprint block-regions out of the window planes (one
        [h, w, 8, 8] per component) -- same shapes as the full path's."""
        return [planes[c][ri, cj]
                for c, (ri, cj) in enumerate(self.gather_idx)]

    def scatter(self, planes, regions) -> None:
        for c, (ri, cj) in enumerate(self.gather_idx):
            planes[c][ri, cj] = regions[c]

    def reencode(self, data: bytes, extract, planes) -> bytes:
        """Re-encode the window with the file's own Huffman tables and splice
        the new segment bytes back between the original restart markers."""
        from . import codec

        seg_ranges, preset = extract[1], extract[3]
        tpl = self.template
        new_segs: list = []
        col = 0
        for n_mcus in self.chunk_mcus:
            comps = []
            coefs = []
            for c in range(self.ncomps):
                ci = tpl.components[c]
                pw = n_mcus * ci.h_samp
                comps.append(ComponentInfo(
                    component_id=ci.component_id, h_samp=ci.h_samp,
                    v_samp=ci.v_samp, quant_tbl_no=ci.quant_tbl_no,
                    width_in_blocks=pw, height_in_blocks=ci.v_samp,
                    padded_width_in_blocks=pw,
                    padded_height_in_blocks=ci.v_samp))
                a = col * ci.h_samp
                coefs.append(planes[c][:, a:a + pw])
            col += n_mcus
            mini = CoefImage(
                width=n_mcus * 8 * self.h_max, height=8 * self.v_max,
                jpeg_color_space=tpl.jpeg_color_space, components=comps,
                coefs=coefs, quant_tables=tpl.quant_tables,
                sampling=Sampling(self.h_max, self.v_max),
                restart_interval=self.R, precision=8)
            out = codec.encode(mini, restart_interval=self.R, nthreads=1,
                               preset_tables=preset)
            ost = parse_structure(out)
            rsts, end = scan_entropy(out, ost.entropy_start)
            starts = [ost.entropy_start] + [p + 2 for p in rsts]
            ends = rsts + [end]
            new_segs.extend(out[s:e] for s, e in zip(starts, ends))

        parts = []
        pos = 0
        for (s, e), seg in zip(seg_ranges, new_segs):
            parts.append(data[pos:s])
            parts.append(seg)
            pos = e
        parts.append(data[pos:])
        return b"".join(parts)
