"""The port's surgical splice through ``BatchComposer.watermark_stream`` on
restart-coded input, on the CPU, against the benchmark's plain reference
(``benchmark/references/dct_compose.py``) and its frozen coder: the inputs
come from ``benchmark/inputs.py``, each answer is judged by
``benchmark/check.py`` as a run of ``wm1080rst.stream-restart`` is, and
the splice's byte counters are checked against the touched segments found
by a plain walk over each file's restart markers."""

import json
import os
import time

import pytest

import libmodjpeg_tpu_torch as mt
from benchmark import check, coder, inputs
from benchmark.references import dct_compose as ref
from libmodjpeg_tpu_torch import codec
from libmodjpeg_tpu_torch.parallel import BatchComposer
from libmodjpeg_tpu_torch.surgical import SurgicalPlan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 256, 144                   # 16 x 9 MCUs of 4:2:0
SEED = 2**33 + 13
# name -> (logo width, height, align, offset x, offset y)
PLACEMENTS = {
    # the bottom-right corner: the last MCU, so the last (partial) segment
    "last-segment": (64, 32, ["BOTTOM", "RIGHT"], 0, 0),
    # mid-picture, off the MCU grid: its MCU rows cross segment boundaries
    "straddle": (72, 40, ["CENTER"], 5, 3),
    # the picture's width: whole MCU rows
    "whole-row": (256, 20, ["TOP", "LEFT"], 0, 40),
}
RESTARTS = (1, 5, 7, 16, 32)      # 16 is one MCU row


def _config(lw, lh, align, ox, oy, ri):
    with open(os.path.join(REPO, "benchmark", "configs",
                           "wm1080rst.json")) as f:
        cfg = json.load(f)
    cfg.update(width=W, height=H, logo={"width": lw, "height": lh},
               placement={"align": align, "offset_x": ox, "offset_y": oy})
    cfg["output"] = dict(cfg["output"], restart_interval=ri)
    return cfg


def _limit() -> float:
    with open(os.path.join(REPO, "benchmark", "limits",
                           "wm1080rst.stream-restart.json")) as f:
        return json.load(f)["foot_diff_share"]


def _composer(files, logo, cfg):
    p = cfg["placement"]
    h, w = logo.shape[:2]
    dropon = mt.read_dropon_from_raw(logo, mt.COLORSPACE_RGBA, w, h)
    return BatchComposer(codec.decode(files[0]), dropon,
                         ref.align_bits(p["align"]), p["offset_x"],
                         p["offset_y"], device="cpu")


def _segments(data: bytes):
    """(entropy start, [(start, end)] of each restart segment's bytes,
    EOI position), by a plain walk over the bytes after the SOS header."""
    pos = 2
    while data[pos + 1] != 0xDA:                     # up to the SOS
        pos += 2 + (data[pos + 2] << 8 | data[pos + 3])
    start = pos + 2 + (data[pos + 2] << 8 | data[pos + 3])
    segs, s, i = [], start, start
    while True:
        if data[i] == 0xFF and data[i + 1] != 0x00:
            if 0xD0 <= data[i + 1] <= 0xD7:
                segs.append((s, i))
                s = i + 2
                i += 2
                continue
            assert data[i + 1] == 0xD9
            segs.append((s, i))
            return start, segs, i
        i += 1


def _touched_mcus(img: dict, fps) -> set:
    """Every MCU that holds a block of the footprints."""
    mcus_w = -(-img["width"] // 16)
    rows, cols = set(), set()
    for (_cid, hs, vs, _tq), (r0, c0, drop, _m) in zip(img["comps"], fps):
        h, w = drop.shape[:2]
        rows.update(range(r0 // vs, -(-(r0 + h) // vs)))
        cols.update(range(c0 // hs, -(-(c0 + w) // hs)))
    return {r * mcus_w + c for r in rows for c in cols}


def _byte_counts(data: bytes, touched: set, ri: int) -> tuple:
    """(re-coded bytes, entropy-coded bytes) of one file: the touched
    segments' data, and everything from the SOS header to the EOI."""
    start, segs, eoi = _segments(data)
    hit = {m // ri for m in touched}
    return sum(e - s for k, (s, e) in enumerate(segs) if k in hit), \
        eoi - start


def _judge(cfg, files, logo, outs):
    judge = check.Judge(cfg, files, logo, workers=2)
    return judge.judge(list(enumerate(outs)),
                       [(j, len(o)) for j, o in enumerate(outs)],
                       len(files), len(outs))


def _surgical_counts_of(bc, files, logo, cfg, ri):
    """The splice's byte counters are the sums of a plain walk's counts
    over ``files``."""
    img = coder.decode(files[0], nthreads=0)
    p = cfg["placement"]
    touched = _touched_mcus(img, ref.footprints(
        img, logo, ref.align_bits(p["align"]), p["offset_x"],
        p["offset_y"]))
    counts = [_byte_counts(f, touched, ri) for f in files]
    st = bc.last_stream_stats
    assert st["surgical_recoded_bytes"] == sum(r for r, _ in counts)
    assert st["surgical_entropy_bytes"] == sum(e for _, e in counts)


@pytest.mark.parametrize("ri", RESTARTS)
@pytest.mark.parametrize("where", sorted(PLACEMENTS))
def test_surgical_stream_equals_the_reference(where, ri):
    """The surgical splice and the full path (``surgical=False``) each
    judged as the cell judges a run; both give the same bytes."""
    lw, lh, align, ox, oy = PLACEMENTS[where]
    cfg = _config(lw, lh, align, ox, oy, ri)
    files = inputs.jpeg_files(SEED + ri, 3, W, H, 85, 8, 0, ri, "cpu",
                              workers=2)
    logo = inputs.logo_pixels(SEED, lw, lh)
    bc = _composer(files, logo, cfg)
    full = list(bc.watermark_stream(iter(files), batch=2, surgical=False))
    assert bc.last_stream_path == "full"
    outs = list(bc.watermark_stream(iter(files), batch=2))
    assert bc.last_stream_path == "surgical"
    assert bc.last_fallback_reasons == {}
    for answers in (outs, full):
        got = _judge(cfg, files, logo, answers)
        for name in ("missing", "unreadable", "outside_diff",
                     "foot_beyond_1", "bytes_diff", "lengths_diff"):
            assert got[name] == 0, (name, got)
        assert got["foot_diff_share"] <= _limit()
    assert outs == full
    _surgical_counts_of(bc, files, logo, cfg, ri)
    st = bc.last_stream_stats
    assert 0 < st["surgical_recoded_bytes"] < st["surgical_entropy_bytes"]


def _stream_with(odd: bytes, ri: int = 16):
    """A stream of two restart-coded files and ``odd`` last, batches of
    two: (composer, the good files, logo, config, outputs, the error the
    stream raised or None)."""
    lw, lh, align, ox, oy = PLACEMENTS["straddle"]
    cfg = _config(lw, lh, align, ox, oy, ri)
    files = inputs.jpeg_files(SEED, 2, W, H, 85, 8, 0, ri, "cpu", workers=2)
    logo = inputs.logo_pixels(SEED, lw, lh)
    bc = _composer(files, logo, cfg)
    outs, err = [], None
    try:
        for out in bc.watermark_stream(iter(files + [odd]), batch=2):
            outs.append(out)
    except codec.DecodeError as e:
        err = e
    return bc, files, logo, cfg, outs, err


def test_another_restart_interval_takes_the_full_path():
    """A file whose DRI is not the template's falls back whole, keeps its
    own interval and equals the reference; the splice's counters hold only
    the other files."""
    odd = inputs.jpeg_files(SEED + 1, 1, W, H, 85, 8, 0, 8, "cpu")[0]
    bc, files, logo, cfg, outs, err = _stream_with(odd)
    assert err is None and len(outs) == 3
    assert bc.last_stream_path == "mixed"
    assert bc.last_fallback_reasons == {"restart-interval": 1}
    got = _judge(cfg, files, logo, outs[:2])
    odd_cfg = dict(cfg, output=dict(cfg["output"], restart_interval=8))
    got_odd = _judge(odd_cfg, [odd], logo, outs[2:])
    for g in (got, got_odd):
        for name in ("outside_diff", "foot_beyond_1", "bytes_diff"):
            assert g[name] == 0, (name, g)
        assert g["foot_diff_share"] <= _limit()
    assert coder.decode(outs[2], nthreads=0)["restart_interval"] == 8
    _surgical_counts_of(bc, files, logo, cfg, 16)
    st = bc.last_stream_stats
    assert st["surgical_reencode_cpu_s"] > 0


def test_a_missing_restart_marker_takes_the_full_path():
    """A file with one restart marker cut out is outside the splice
    ("segment-count"); the full path then rejects it as the frozen coder
    does, after every earlier answer, each equal to the reference; the
    splice's counters hold only the earlier files."""
    good = inputs.jpeg_files(SEED + 2, 1, W, H, 85, 8, 0, 16, "cpu")[0]
    _start, segs, _eoi = _segments(good)
    cut = segs[3][1]                                 # the fourth RST
    odd = good[:cut] + good[cut + 2:]
    with pytest.raises(coder.CoderError, match="restart marker count"):
        coder.decode(odd, nthreads=0)
    bc, files, logo, cfg, outs, err = _stream_with(odd)
    assert "restart marker count" in str(err)
    assert bc.last_fallback_reasons == {"segment-count": 1}
    assert len(outs) == 2
    got = _judge(cfg, files, logo, outs)
    for name in ("outside_diff", "foot_beyond_1", "bytes_diff"):
        assert got[name] == 0, (name, got)
    _surgical_counts_of(bc, files, logo, cfg, 16)


def test_decode_counts_the_surgical_extract(monkeypatch):
    """decode_s is the producer's whole decode wall: the extract inside
    it, the extract's CPU inside decode_cpu_s.  Each extract is made to
    burn 20 ms of thread CPU, more than a window decode takes here."""
    burn = 0.02
    extract = SurgicalPlan.extract

    def slow_extract(self, data):
        t0 = time.thread_time()
        while time.thread_time() - t0 < burn:
            pass
        return extract(self, data)

    monkeypatch.setattr(SurgicalPlan, "extract", slow_extract)
    lw, lh, align, ox, oy = PLACEMENTS["straddle"]
    cfg = _config(lw, lh, align, ox, oy, 7)
    files = inputs.jpeg_files(SEED, 4, W, H, 85, 8, 0, 7, "cpu", workers=2)
    logo = inputs.logo_pixels(SEED, lw, lh)
    bc = _composer(files, logo, cfg)
    outs = list(bc.watermark_stream(iter(files * 3), batch=4))
    assert len(outs) == 12 and bc.last_stream_path == "surgical"
    st = bc.last_stream_stats
    assert st["batches"] == 3
    assert 3 * burn <= st["surgical_extract_s"] <= st["decode_s"]
    assert st["decode_cpu_s"] >= 12 * burn + st["surgical_window_cpu_s"]
    assert 0 < st["surgical_window_cpu_s"]
    assert 0 < st["surgical_reencode_cpu_s"] <= st["encode_cpu_s"]


def test_a_failed_reencode_is_left_out_of_the_counters():
    """Optimized-table inputs lack codes the composed segments need: every
    file is redone on the full path (standard tables), equal to the
    reference, and the re-encode and byte counters count none of them."""
    lw, lh, align, ox, oy = PLACEMENTS["straddle"]
    cfg = _config(lw, lh, align, ox, oy, 16)
    files = inputs.jpeg_files(SEED, 3, W, H, 85, 8, coder.OPTION_OPTIMIZE,
                              16, "cpu", workers=2)
    logo = inputs.logo_pixels(SEED, lw, lh)
    bc = _composer(files, logo, cfg)
    outs = list(bc.watermark_stream(iter(files), batch=2))
    assert bc.last_fallback_reasons == {
        "surgical: original tables lack a needed symbol": 3}
    got = _judge(cfg, files, logo, outs)
    for name in ("outside_diff", "foot_beyond_1", "bytes_diff"):
        assert got[name] == 0, (name, got)
    st = bc.last_stream_stats
    assert st["surgical_extract_s"] > 0 and st["surgical_window_cpu_s"] > 0
    assert st["surgical_reencode_cpu_s"] == 0
    assert st["surgical_recoded_bytes"] == st["surgical_entropy_bytes"] == 0
