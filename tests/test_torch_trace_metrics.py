"""The benchmark's readers of the program's own counters and spans
(benchmark/metrics/<name>.py over benchmark/program_trace.py), loaded as the
harness loads them, on synthetic records: the expected value, and None when
what they read is missing."""

import sys

import pytest

import libmodjpeg_tpu_torch
from benchmark import harness
from libmodjpeg_tpu_torch import tracing

STREAM = {"batches": 4, "device_step_s": 0.004, "decode_cpu_s": 2.0,
          "encode_cpu_s": 1.6, "producer_blocked_s": 0.2,
          "consumer_idle_s": 0.6, "surgical_extract_s": 0.08,
          "surgical_window_cpu_s": 0.16, "surgical_reencode_cpu_s": 0.24,
          "surgical_recoded_bytes": 31, "surgical_entropy_bytes": 1000}
CALLS = [{"start_s": 0.002, "stop_s": 0.001, "encode_s": 0.003,
          "band_prefix_s": 0.011, "band_decode_s": 0.002,
          "band_after_s": 0.001},
         {"start_s": 0.004, "stop_s": 0.001, "encode_s": 0.001,
          "band_prefix_s": 0.013, "band_decode_s": 0.004,
          "band_after_s": 0.003}]
# (name, start, end, device ms); the window runs from 10.0 to 13.0
SPANS = [("mjt.grid.compile", 9.0, 9.5, None),       # before the window
         ("mjt.grid.compile", 10.1, 10.19, None),
         ("mjt.grid.compile", 11.1, 11.17, None),
         ("mjt.grid.effect", 10.2, 10.21, 2.0),
         ("mjt.grid.compose", 10.22, 10.23, 1.0),
         ("mjt.grid.effect", 11.2, 11.21, 3.0),
         ("mjt.grid.histogram", 10.3, 10.31, 20.0),
         ("mjt.grid.histogram", 11.3, 11.31, 24.0),
         ("mjt.grid.to_image", 10.4, 10.55, None),
         ("mjt.grid.to_image", 11.4, 11.53, None),
         ("mjt.grid.encode", 10.6, 10.9, None),
         ("mjt.grid.encode", 11.6, 11.92, None)]

# metric -> (record kind, the counter it reads or None, expected value)
EXPECTED = {
    "device_step_ms.stream": ("stream", "device_step_s", 1.0),
    "decode_cpu_ms.stream": ("stream", "decode_cpu_s", 500.0),
    "encode_cpu_ms.stream": ("stream", "encode_cpu_s", 400.0),
    "producer_blocked_ms.stream": ("stream", "producer_blocked_s", 50.0),
    "consumer_starved_ms.stream": ("stream", "consumer_idle_s", 150.0),
    "surgical_extract_ms.stream": ("surgical", "surgical_extract_s", 20.0),
    "surgical_window_cpu_ms.stream": ("surgical", "surgical_window_cpu_s",
                                      40.0),
    "surgical_reencode_cpu_ms.stream": ("surgical",
                                        "surgical_reencode_cpu_s", 60.0),
    "recoded_share.stream": ("surgical", "surgical_recoded_bytes", 3.1),
    "stream_setup_ms.single": ("calls", "stop_s", 4.0),
    "encode_counted_ms.single": ("calls", "encode_s", 2.0),
    "band_prefix_ms.single": ("calls", "band_prefix_s", 12.0),
    "band_decode_ms.single": ("calls", "band_decode_s", 3.0),
    "band_after_ms.single": ("calls", "band_after_s", 2.0),
    "dropon_compile_ms.grid": ("grid", None, 80.0),
    "effects_device_ms.grid": ("grid", None, 3.0),
    "histogram_ms.grid": ("grid", None, 22.0),
    "to_image_ms.grid": ("grid", None, 140.0),
    "grid_encode_ms.grid": ("grid", None, 310.0),
}
DEVICE = {"effects_device_ms.grid", "histogram_ms.grid"}
UNITS = {"recoded_share.stream": "%"}
# the cells whose runs each kind of metric reads
CELLS = {"stream": ["wm1080.stream-progressive", "wm1080rst.stream-restart"],
         "surgical": ["wm1080rst.stream-restart"],
         "calls": ["wm1080.single-call"],
         "grid": ["fx100mp.grid-chain"]}


@pytest.fixture(scope="module")
def bench():
    return harness.Bench()


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _push_spans(device: bool = True) -> None:
    for name, start, end, ms in SPANS:
        sp = tracing.Span(name, {"session": 0})
        sp.start, sp.end = start, end
        sp._ms = ms if device else None
        tracing._push(sp)


def _rec(kind: str) -> dict:
    rec = {"counters": {}, "starts": [10.0, 11.0], "ends": [11.0, 12.0],
           "window_end": 13.0, "spans": []}
    if kind in ("stream", "surgical"):
        rec["counters"]["stream"] = dict(STREAM)
    elif kind == "calls":
        rec["counters"]["calls"] = [dict(c) for c in CALLS]
    else:
        _push_spans()
    return rec


def test_every_new_metric_is_declared(bench):
    declared = {m["name"]: m for m in bench.spec["per_layer"]}
    for name, (kind, _, _) in EXPECTED.items():
        m = declared[name]
        assert m["source"] == "program_counter"
        assert m["unit"] == UNITS.get(name, "ms")
        assert m["workloads"] == CELLS[kind]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_value(bench, name):
    kind, _, want = EXPECTED[name]
    got = bench.module("metrics", name).read(_rec(kind))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_none_without_its_input(bench, monkeypatch, name):
    """No counter, no span, a dropped span in the window, or a program
    without the tracing module: None, and no exception."""
    kind, key, _ = EXPECTED[name]
    read = bench.module("metrics", name).read
    rec = _rec(kind)
    if kind in ("stream", "surgical"):
        del rec["counters"]["stream"][key]
        assert read(rec) is None
        assert read({"counters": {"stream": {"batches": 0}}}) is None
    elif kind == "calls":
        del rec["counters"]["calls"][1][key]
        assert read(rec) is None
        assert read({"counters": {"calls": []}}) is None
    else:
        empty = dict(rec, starts=[20.0], ends=[21.0], window_end=22.0)
        assert read(empty) is None
        monkeypatch.setattr(tracing, "spans", lambda since, until: (
            [], 1))
        assert read(rec) is None
        monkeypatch.undo()
        # the parent program, which has no tracing module
        monkeypatch.delattr(libmodjpeg_tpu_torch, "tracing")
        monkeypatch.setitem(sys.modules, "libmodjpeg_tpu_torch.tracing",
                            None)
        assert read(rec) is None
        monkeypatch.undo()
        assert read(rec) is not None
        if name in DEVICE:
            tracing.clear()
            _push_spans(device=False)     # host spans only: off the card
            assert read(rec) is None
