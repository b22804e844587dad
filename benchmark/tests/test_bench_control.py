"""The output check fails what it must: the TF32 control (the reference in
the precision below the configuration's) and the timed path broken
underneath, each planted in a CPU run of the whole harness."""

import json
import time

import pytest

from benchmark import control, harness

SEEDS = "11,12,13"


def _override(bench, config, **kw):
    path = bench.path("configs", f"{config}.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(kw)
    with open(path, "w") as f:
        json.dump(cfg, f)


def test_control_fails_the_stream_limit(tiny):
    # the wm1080 geometry, logo and placement, on two files
    _override(tiny, "wm", width=1920, height=1080, corpus_files=2,
              logo={"width": 256, "height": 64},
              placement={"align": ["BOTTOM", "RIGHT"], "offset_x": -32,
                         "offset_y": -32})
    for line in control.main(["--workload", "wm.stream-baseline",
                              "--seeds", SEEDS, "--device", "cpu"],
                             bench=tiny):
        t = line["tf32"]
        assert t["outside_diff"] == 0
        assert t["foot_diff_share"] > line["limits"]["foot_diff_share"]


def test_control_fails_the_grid_limit(tiny):
    # fx100mp's logo, placement, effects and output on a 2048x1024 frame
    _override(tiny, "fx", width=2048, height=1024, corpus_files=1,
              logo={"width": 1024, "height": 256},
              output={"optimize": True, "restart_interval": 64})
    for line in control.main(["--workload", "fx.grid-chain", "--seeds",
                              SEEDS, "--device", "cpu"], bench=tiny):
        assert line["tf32"]["foot_diff_share"] > \
            line["limits"]["foot_diff_share"]


# -- faults planted under the timed path --------------------------------

def _unchanged(monkeypatch):
    """A compose step that returns its state unchanged."""
    from libmodjpeg_tpu_torch.parallel import batch, session

    monkeypatch.setattr(batch, "_compose_body",
                        lambda meta, flat, *a: flat.clone())
    monkeypatch.setattr(session, "_compose_rows", lambda *a, **k: None)


def _half_batch(monkeypatch):
    """Half of each batch (of a frame's footprint rows) left out."""
    from libmodjpeg_tpu_torch.parallel import batch, session

    body = batch._compose_body

    def half(meta, flat, *a):
        out = body(meta, flat, *a)
        k = flat.shape[0] // 2
        out[k:] = flat[k:]
        return out

    rows = session._compose_rows

    def half_rows(grid, drop, mask, quant, row0, col0):
        h = drop.shape[0] // 2
        rows(grid, drop[:h], mask[:h], quant, row0, col0)

    monkeypatch.setattr(batch, "_compose_body", half)
    monkeypatch.setattr(session, "_compose_rows", half_rows)


def _altered(monkeypatch):
    """One coefficient of every answer altered where it is produced."""
    from libmodjpeg_tpu_torch import codec
    from libmodjpeg_tpu_torch.parallel import session

    def bump(img, row=0):
        img = img.copy()
        img.coefs[0][row, 0, 0, 1] += 3
        return img

    enc, band = codec.encode, codec.encode_splice_band
    monkeypatch.setattr(codec, "encode",
                        lambda img, *a, **k: enc(bump(img), *a, **k))
    # the band splice re-encodes only MCU rows row0..row1: alter the band
    monkeypatch.setattr(
        codec, "encode_splice_band",
        lambda data, img, r0, r1, sp: band(data, bump(img, 2 * r0), r0, r1,
                                           sp))
    to_image = session.GridSession.to_image
    monkeypatch.setattr(session.GridSession, "to_image",
                        lambda self: bump(to_image(self)))


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered}
CELLS = ("wm.stream-baseline", "wm.stream-progressive", "wm.single-call",
         "fx.grid-chain")


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    import libmodjpeg_tpu_torch as mt

    mt._WATERMARK_CACHE.clear()
    FAULTS[fault](monkeypatch)
    try:
        res, _, code = harness.run_cell(tiny, cell, 21, 0.4, False, "cpu",
                                        time.perf_counter())
    finally:
        mt._WATERMARK_CACHE.clear()
    assert code == 0
    assert res["correct"] is False
    failing = [n for n, c in res["checks"].items()
               if c["value"] > c["limit"]]
    assert failing, res["checks"]


def test_sound_runs_are_correct(tiny):
    for cell in CELLS:
        res, _, _ = harness.run_cell(tiny, cell, 22, 0.4, False, "cpu",
                                     time.perf_counter())
        assert res["correct"] is True, (cell, res["checks"])
