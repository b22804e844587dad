"""The port's bench (libmodjpeg_tpu_torch/scripts/bench.py) and scaling
bench on the CPU: the same generators as the JAX package's bench.py, a
corpus that decodes to the JAX package's, every key of the JSON line at a
small size with every stream lane's path asserted, and a host-sharded
corpus run byte-identical to one host."""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from libmodjpeg_tpu import codec as jcodec
from libmodjpeg_tpu.encode_pixels import from_pixels as jfrom_pixels
from libmodjpeg_tpu_torch import codec as tcodec
from libmodjpeg_tpu_torch.scripts import bench, scaling_bench

from conftest import FIXTURE_IMAGES, REPO

SMALL = ["--batch", "2", "--iters", "1", "--windows", "3",
         "--grid-size", "256x128"]
STREAM_KEYS = ("value", "full_path_mp_s", "surgical_mp_s",
               "full_path_topleft_mp_s", "topleft_default_mp_s")


def _reference_bench():
    """The JAX package's bench.py, loaded from the repository root (its
    generators need numpy only)."""
    spec = importlib.util.spec_from_file_location(
        "reference_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_generators_equal_reference_bench():
    ref = _reference_bench()
    for fn, size in (("make_test_image", (1920, 1088)),
                     ("make_logo", (256, 64))):
        got = getattr(bench, fn)(np.random.RandomState(42), *size)
        want = getattr(ref, fn)(np.random.RandomState(42), *size)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_corpus_decodes_like_the_reference_corpus():
    """The first three frames made by the port's from_pixels decode within
    +-1 of the JAX package's, on at most 1e-5 of the coefficients; their
    restart copies carry the same coefficients."""
    free, rst = bench.make_corpus(np.random.RandomState(42), 3)
    rng = np.random.RandomState(42)
    differ = total = 0
    for data, data_rst in zip(free, rst):
        want = jcodec.decode(jcodec.encode(jfrom_pixels(
            bench.make_test_image(rng, bench.W, bench.H), quality=85,
            subsampling="420")))
        got = tcodec.decode(data)
        assert (got.width, got.height) == (bench.W, bench.H)
        assert tcodec.decode(data_rst).restart_interval == bench.RESTART
        for a, b, r in zip(got.coefs, want.coefs,
                           tcodec.decode(data_rst).coefs):
            d = np.abs(a.astype(np.int32) - b)
            assert d.max() <= 1
            differ += int((d != 0).sum())
            total += d.size
            np.testing.assert_array_equal(a, r)
    assert differ <= 1e-5 * total, (differ, total)


@pytest.fixture(scope="module")
def bench_run():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = bench.main(SMALL, device="cpu")
    return result, buf.getvalue()


def test_bench_prints_one_json_line(bench_run):
    result, out = bench_run
    lines = out.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == result


def test_bench_has_every_key(bench_run):
    result, _ = bench_run
    assert result["metric"] == "composited_megapixels_per_s_per_chip"
    assert result["unit"] == "MP/s/chip"
    assert result["vs_baseline"] == pytest.approx(result["value"] / 50.0)
    assert result["batch"] == 2 and result["windows"] == 3
    for key in ("corpus", "codec_lanes", "stages", "stream_stats",
                "single_file_decode", "surgical_stages", "grid_effects"):
        assert result[key], key
    assert set(result["codec_lanes"]) == {"progressive_mp_s",
                                          "arith_decode_mp_s"}
    assert set(result["stages"]) == {
        f"{s}_{u}" for s in ("decode", "compose", "encode")
        for u in ("s_per_batch", "mp_s")}
    assert set(result["single_file_decode"]) == {"serial_mp_s",
                                                 "parallel_mp_s"}
    assert set(result["surgical_stages"]) == {
        "scan_decode_mp_s", "device_round_trip_mp_s",
        "reencode_splice_mp_s", "touched_segments"}
    assert result["stream_stats"]["batches"] == 1
    g = result["grid_effects"]
    assert g["rounds"] == 6 and g["frame_mp"] == 256 * 128 / 1e6
    # card-only entries are null on the CPU
    assert result["blend_kernel"] == "plain"
    assert result["kernel_roofline"] is None
    assert result["device"] == {"name": "cpu", "power_limit": None}


def test_bench_spread_per_stream_lane(bench_run):
    """Each stream lane reports the median of its windows, and its spread
    over them."""
    result, _ = bench_run
    assert set(result["spread"]) == set(STREAM_KEYS)
    for key in STREAM_KEYS:
        s = result["spread"][key]
        assert len(s["windows"]) == 3
        assert all(r > 0 for r in s["windows"])
        assert s["min"] == min(s["windows"]) and s["max"] == max(s["windows"])
        assert result[key] == s["median"] == float(np.median(s["windows"]))
        assert s["rel"] == pytest.approx((s["max"] - s["min"]) / s["median"])


def test_stream_lanes_refuse_a_wrong_path():
    """A lane whose stream takes another path than it names raises, as
    bench.py's asserts do."""
    with open(os.path.join(FIXTURE_IMAGES, "image.jpg"), "rb") as f:
        data = tcodec.encode(tcodec.decode(f.read()))
    dropon = bench.read_dropon_from_raw(
        bench.make_logo(np.random.RandomState(0), 64, 32),
        bench.C.COLORSPACE_RGBA, 64, 32)
    bc = bench.BatchComposer(tcodec.decode(data), dropon, *bench.PLACE_BR,
                             device="cpu")
    lanes = {"value": (bc, [data], {"surgical": False}, "splice")}
    with pytest.raises(AssertionError, match="took 'full'"):
        bench.stream_lanes(lanes, None, 1, 1, 1)


def test_bench_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(SMALL)


def test_scaling_bench_on_cpu():
    """One host against two (one core each): the same output bytes, every
    file done once, the efficiencies from the runners' rates."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = scaling_bench.main(["--images", "4", "--mp-each", "0.1",
                                "--device", "cpu"])
    assert json.loads(buf.getvalue().splitlines()[-1]) == r
    assert r["output_mismatches"] == 0
    assert r["images"] == 4 and r["device"] == "cpu"
    assert r["workers_per_card"] is None
    hosts = r["per_host_summaries"]
    assert [h["host_id"] for h in hosts] == [0, 1]
    assert sum(h["files_done"] for h in hosts) == 4
    assert all(h["files_failed"] == 0 and h["compose_launches"] == 0
               for h in hosts)
    assert r["scaling_efficiency"] == pytest.approx(
        r["two_host_aggregate_mp_s"] / (2 * r["single_host_mp_s"]))
