"""End-to-end bench of the port: composited megapixels per second on one
card (the counterpart of the JAX package's bench.py, with its keys).

    python -m libmodjpeg_tpu_torch.scripts.bench [--batch 32] [--iters 5] \
        [--windows 5] [--grid-size 12288x8192]

Workload (not timed to build): ``--batch`` 1920x1088 4:2:0 q85 JPEGs from
bench.py's generator (seed 42), made by the port's ``from_pixels`` on the
CPU, and a copy of them with a restart marker every 32 MCUs; a 256x64 RGBA
logo at ALIGN_BOTTOM|ALIGN_RIGHT, -32, -32.

Stream lanes: ``BatchComposer.watermark_stream`` over ``--iters`` passes of
the corpus per timed window, after one warm-up pass per lane.  In order:
the band splice on the restart-free corpus (the headline ``value``), the
forced full path, the surgical splice on the restart copy, and the logo at
the top left through the forced full path and through the default.  The
windows are interleaved (one of each lane, in that order, ``--windows``
times).  Each lane's number is the median of its windows, and ``spread``
holds its windows with min, max and rel = (max - min) / median.  Every
window checks the path its lane took; the warm-up bytes of each default
lane must equal those of the forced full path.

Then, once each: the codec lanes (a progressive corpus through the stream,
arithmetic decode), the full pipeline's stages per batch, the headline's
stream stats, single-file decode of a 4K frame (serial and parallel), the
surgical splice's stages, grid effects on a ``--grid-size`` GridSession of
random coefficients (6 rounds of tint + luminance + pixelate), and on the
card ``kernel_roofline``: compose_rows_cuda at 131,072 blocks, its bytes
over CUDA-event time, against the card's own rate measured by 1 GiB
device-to-device copies.

Prints one JSON line and returns it as a dict.  ``device="cuda"`` needs a
card and raises without one; ``device="cpu"`` runs every lane on the plain
versions, and only there are ``kernel_roofline`` and the power limit null.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import codec
from .. import constants as C
from ..dropon import read_dropon_from_raw
from ..encode_pixels import from_pixels
from ..model import CoefImage, ComponentInfo, Sampling
from ..parallel import BatchComposer, GridSession

W, H = 1920, 1088
RESTART = 32            # MCUs per restart segment -> surgical splice
LANE_N = 16             # files of the codec lanes
TARGET_MP_S = 50.0      # vs_baseline: the north-star 50 MP/s/chip
PLACE_BR = (C.ALIGN_BOTTOM | C.ALIGN_RIGHT, -32, -32)
PLACE_TL = (C.ALIGN_TOP | C.ALIGN_LEFT, 0, 0)
EFFECT_ROUNDS = 6
ROOF_BLOCKS = 131072
COLD_BYTES = 150e6      # rotate input sets past 3x the 50 MB L2
COPY_BYTES = 1 << 30    # each device-to-device copy of the peak probe
PUBLISHED_PEAK_GBPS = 3350.0


def make_test_image(rng, w, h):
    """Photo-like synthetic pixels: smooth gradients + mild texture so the
    entropy codec sees realistic coefficient statistics."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (128 + 80 * np.sin(xx / 97.0) * np.cos(yy / 71.0)
            + 40 * np.sin((xx + yy) / 31.0))
    tex = rng.randn(h // 8 + 1, w // 8 + 1).astype(np.float32) * 14
    tex = np.kron(tex, np.ones((8, 8), np.float32))[:h, :w]
    img = np.stack([
        base + tex,
        base * 0.9 + tex + 10 * np.sin(yy / 53.0),
        base * 1.05 - tex * 0.5,
    ], axis=-1)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_logo(rng, w, h):
    logo = rng.randint(0, 255, (h, w, 4), dtype=np.uint8)
    # soft alpha: opaque core, transparent border
    yy, xx = np.mgrid[0:h, 0:w]
    d = np.minimum.reduce([xx, yy, w - 1 - xx, h - 1 - yy]).astype(np.float32)
    logo[..., 3] = np.clip(d * 24, 0, 255).astype(np.uint8)
    return logo


def make_corpus(rng, n: int):
    """n restart-free 1920x1088 4:2:0 q85 JPEGs and their restart copies,
    coded on the CPU."""
    free, rst = [], []
    for _ in range(n):
        img = from_pixels(make_test_image(rng, W, H), quality=85,
                          subsampling="420", device="cpu")
        free.append(codec.encode(img))
        rst.append(codec.encode(img, restart_interval=RESTART))
    return free, rst


def _spread(rates: list) -> dict:
    med = float(np.median(rates))
    return {"min": min(rates), "max": max(rates), "median": med,
            "rel": (max(rates) - min(rates)) / med, "windows": rates}


def _expect_path(bc: BatchComposer, want: str, lane: str) -> None:
    if bc.last_stream_path != want:
        raise AssertionError(f"{lane}: stream took {bc.last_stream_path!r}, "
                             f"expected {want!r}")


def _card() -> dict:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    name, _, limit = out.strip().splitlines()[0].rpartition(", ")
    return {"name": name, "power_limit": limit}


def stream_lanes(lanes: dict, pool, batch: int, iters: int,
                 windows: int) -> dict:
    """lanes: key -> (composer, corpus, watermark_stream kwargs, expected
    path).  One warm-up pass per lane, then ``windows`` rounds of one timed
    window per lane in turn; returns key -> MP/s per window."""
    warm = {}
    for key, (bc, datas, kw, path) in lanes.items():
        warm[key] = list(bc.watermark_stream(iter(datas), batch=batch,
                                             pool=pool, **kw))
        _expect_path(bc, path, key)
    for default, forced in (("value", "full_path_mp_s"),
                            ("topleft_default_mp_s",
                             "full_path_topleft_mp_s")):
        if warm[default] != warm[forced]:
            raise AssertionError(f"{default} bytes differ from {forced}")
    rates = {key: [] for key in lanes}
    for _ in range(windows):
        for key, (bc, datas, kw, path) in lanes.items():
            t0 = time.perf_counter()
            for _out in bc.watermark_stream(iter(datas * iters), batch=batch,
                                            pool=pool, **kw):
                pass
            dt = time.perf_counter() - t0
            _expect_path(bc, path, key)
            rates[key].append(W * H * len(datas) * iters / 1e6 / dt)
    return rates


def codec_lanes(free, dropon, pool, iters: int, device) -> dict:
    """A progressive corpus through the stream (re-encoded progressive) and
    arithmetic decode, on the first LANE_N files."""
    imgs = [codec.decode(d) for d in free[:LANE_N]]
    prog = [codec.encode(im, options=C.OPTION_PROGRESSIVE) for im in imgs]
    arith = [codec.encode(im, options=C.OPTION_ARITHMETIC) for im in imgs]
    mp = W * H / 1e6 * len(imgs)
    bc = BatchComposer(codec.decode(prog[0]), dropon, *PLACE_BR,
                       device=device)

    def progressive(n):
        for _out in bc.watermark_stream(iter(prog * n), batch=len(prog),
                                        pool=pool,
                                        options=C.OPTION_PROGRESSIVE):
            pass
        _expect_path(bc, "full", "progressive")

    def arith_decode():
        list(pool.map(lambda d: codec.decode(d, nthreads=1), arith))

    progressive(1)
    t0 = time.perf_counter()
    progressive(iters)
    t_prog = time.perf_counter() - t0
    arith_decode()
    t0 = time.perf_counter()
    for _ in range(iters):
        arith_decode()
    t_arith = time.perf_counter() - t0
    return {"progressive_mp_s": mp * iters / t_prog,
            "arith_decode_mp_s": mp * iters / t_arith}


def stages(bc: BatchComposer, free, pool, iters: int) -> dict:
    """The full pipeline one stage at a time (unpipelined), per batch."""
    mp_batch = W * H / 1e6 * len(free)
    t0 = time.perf_counter()
    for _ in range(iters):
        images = list(pool.map(lambda d: codec.decode(d, nthreads=1), free))
    t_dec = (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        bc.finish(bc.compose_images_async(images), images)
    t_comp = (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        list(pool.map(lambda im: len(codec.encode(im)), images))
    t_enc = (time.perf_counter() - t0) / iters
    return {"decode_s_per_batch": t_dec, "compose_s_per_batch": t_comp,
            "encode_s_per_batch": t_enc, "decode_mp_s": mp_batch / t_dec,
            "compose_mp_s": mp_batch / t_comp,
            "encode_mp_s": mp_batch / t_enc}


def single_file_decode(rng) -> dict:
    """Best of 3 decodes of one 3840x2160 q90 frame, serial and with the
    auto-threaded (self-sync split) decoder."""
    pix = make_test_image(rng, 3840, 2160)
    pix = np.clip(pix.astype(np.int32) + rng.randint(-20, 20, pix.shape),
                  0, 255).astype(np.uint8)
    one = codec.encode(from_pixels(pix, quality=90, subsampling="420",
                                   device="cpu"))
    mp = 3840 * 2160 / 1e6

    def best_of(f, n=3):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            f()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    codec.decode(one)  # warm
    return {"serial_mp_s": mp / best_of(lambda: codec.decode(one, nthreads=1)),
            "parallel_mp_s": mp / best_of(lambda: codec.decode(one))}


def surgical_stages(bc: BatchComposer, rst, pool, iters: int) -> dict:
    """The surgical splice one stage at a time (unpipelined), per batch:
    byte scan + window decode, the device round trip, window re-encode +
    splice."""
    plan = bc._surgical_plan()
    if not plan.ok:
        raise AssertionError("the restart corpus is outside the surgical "
                             "envelope")
    mp_batch = W * H / 1e6 * len(rst)
    t0 = time.perf_counter()
    for _ in range(iters):
        extracts = [p for p, _ in pool.map(plan.extract, rst)]
        planes_list = list(pool.map(plan.decode_windows, extracts))
    t_dec = (time.perf_counter() - t0) / iters
    quants_list = [ex[4] for ex in extracts]
    t0 = time.perf_counter()
    for _ in range(iters):
        bc._finish_surgical(
            plan, bc._compose_surgical_async(plan, planes_list, quants_list),
            planes_list)
    t_dev = (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        list(pool.map(lambda t3: len(plan.reencode(*t3)),
                      zip(rst, extracts, planes_list)))
    t_enc = (time.perf_counter() - t0) / iters
    return {"scan_decode_mp_s": mp_batch / t_dec,
            "device_round_trip_mp_s": mp_batch / t_dev,
            "reencode_splice_mp_s": mp_batch / t_enc,
            "touched_segments": f"{len(plan.segs)}/{plan.nsegs_file}"}


def grid_effects(rng, gw: int, gh: int, device) -> dict:
    """EFFECT_ROUNDS rounds of tint + luminance + pixelate on a gw x gh
    4:2:0 GridSession of random coefficients; the upload is not timed."""
    comps, coefs = [], []
    for c, (h, v) in enumerate([(2, 2), (1, 1), (1, 1)]):
        wb, hb = gw // 8 // (2 // h), gh // 8 // (2 // v)
        comps.append(ComponentInfo(
            component_id=c + 1, h_samp=h, v_samp=v,
            quant_tbl_no=0 if c == 0 else 1,
            width_in_blocks=wb, height_in_blocks=hb,
            padded_width_in_blocks=wb, padded_height_in_blocks=hb))
        coefs.append(rng.randint(-512, 512, (hb, wb, 8, 8), dtype=np.int16))
    img = CoefImage(width=gw, height=gh, jpeg_color_space=C.JCS_YCbCr,
                    components=comps, coefs=coefs,
                    quant_tables={0: np.full((8, 8), 8, np.uint16),
                                  1: np.full((8, 8), 12, np.uint16)},
                    sampling=Sampling(max_h_samp=2, max_v_samp=2))
    sess = GridSession(img, device=device)

    def rounds(k):
        for _ in range(k):
            sess.effect("tint", cb_value=3, cr_value=-2)
            sess.effect("luminance", value=1)
            sess.effect("pixelate")
        sess.block_until_ready()

    rounds(1)  # warm
    t0 = time.perf_counter()
    rounds(EFFECT_ROUNDS)
    dt = time.perf_counter() - t0
    mp = gw * gh / 1e6
    return {"mp_s": mp * EFFECT_ROUNDS / dt, "frame_mp": mp,
            "rounds": EFFECT_ROUNDS,
            "effects_per_round": "tint+luminance+pixelate", "chips": 1}


def _event_ms(fn, sets, reps: int) -> float:
    """Device milliseconds per call of ``fn`` cycling over ``sets``, behind
    a device-side sleep so the host enqueues the window before it runs."""
    for a in sets:
        fn(*a)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for k in range(reps):
        fn(*sets[k % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_roofline(rng, reps: int = 50) -> dict:
    """compose_rows_cuda on one row of ROOF_BLOCKS blocks with per-block
    dropon and mask, against the card's measured copy rate."""
    from ..ops.compose_kernel import compose_rows_cuda

    n = ROOF_BLOCKS
    # int16 region in and out, f32 dropon and mask per block, one quant
    # table: 768 B per block + 256
    nbytes = n * (2 + 2 + 4 + 4) * 64 + 64 * 4
    dev = torch.device("cuda")
    sets = [[torch.from_numpy(a).to(dev) for a in (
        rng.randint(-900, 900, (1, 1, n, 64)).astype(np.int16),
        rng.randint(1, 255, (1, 64)).astype(np.int32),
        (rng.randn(n, 64) * 300).astype(np.float32),
        (rng.rand(n, 64) * 0.9).astype(np.float32))]
        for _ in range(int(np.ceil(COLD_BYTES / nbytes)))]
    ms = _event_ms(compose_rows_cuda, sets, reps)
    del sets

    src = torch.ones(COPY_BYTES // 4, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    copy_ms = min(_event_ms(dst.copy_, [(src,)], 1) for _ in range(5))
    del src, dst
    gbps = nbytes / ms / 1e6
    peak = 2 * COPY_BYTES / copy_ms / 1e6
    return {"gbps": gbps, "peak_gbps": peak, "frac": gbps / peak,
            "published_peak_gbps": PUBLISHED_PEAK_GBPS, "n_blocks": n,
            "bytes": nbytes, "ms": ms, "copy_bytes": 2 * COPY_BYTES,
            "copy_ms": copy_ms}


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32,
                    help="files in the corpus and in a stream batch")
    ap.add_argument("--iters", type=int, default=5,
                    help="passes over the corpus per timed window")
    ap.add_argument("--windows", type=int, default=5,
                    help="timed windows per stream lane")
    ap.add_argument("--grid-size", default="12288x8192",
                    help="WxH of the grid-effects frame")
    args = ap.parse_args(argv)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: device 'cuda' asked for, but "
                           "torch.cuda.is_available() is False")
    gw, gh = (int(v) for v in args.grid_size.split("x"))
    batch, iters = args.batch, args.iters

    rng = np.random.RandomState(42)
    free, rst = make_corpus(rng, batch)
    dropon = read_dropon_from_raw(make_logo(rng, 256, 64),
                                  C.COLORSPACE_RGBA, 256, 64)

    def composer(datas, place):
        return BatchComposer(codec.decode(datas[0]), dropon, *place,
                             device=dev)

    # key -> (composer, corpus, watermark_stream kwargs, expected path), in
    # the order the windows take turns
    lanes = {
        "value": (composer(free, PLACE_BR), free, {}, "splice"),
        "full_path_mp_s": (composer(free, PLACE_BR), free,
                           {"surgical": False}, "full"),
        "surgical_mp_s": (composer(rst, PLACE_BR), rst,
                          {"restart_interval": RESTART}, "surgical"),
        "full_path_topleft_mp_s": (composer(free, PLACE_TL), free,
                                   {"surgical": False}, "full"),
        "topleft_default_mp_s": (composer(free, PLACE_TL), free, {},
                                 "splice"),
    }
    head, surg = lanes["value"][0], lanes["surgical_mp_s"][0]
    card = _card() if dev.type == "cuda" else {"name": "cpu",
                                               "power_limit": None}
    with ThreadPoolExecutor(max_workers=max(2, os.cpu_count() or 2)) as pool:
        rates = stream_lanes(lanes, pool, batch, iters, args.windows)
        stream_stats = dict(head.last_stream_stats)
        lanes_codec = codec_lanes(free, dropon, pool, iters, dev)
        stage = stages(head, free, pool, iters)
        single = single_file_decode(rng)
        surgical = surgical_stages(surg, rst, pool, iters)
    roofline = kernel_roofline(rng) if dev.type == "cuda" else None
    grid = grid_effects(rng, gw, gh, dev)

    spread = {key: _spread(r) for key, r in rates.items()}
    value = spread["value"]["median"]
    result = {
        "metric": "composited_megapixels_per_s_per_chip",
        "value": value,
        "unit": "MP/s/chip",
        "vs_baseline": value / TARGET_MP_S,
        "corpus": ("restart-free 1080p, shipped default (band splice, any "
                   "placement; output byte-identical to the full "
                   "pipeline)"),
        **{key: spread[key]["median"] for key in lanes if key != "value"},
        "spread": spread,
        "codec_lanes": lanes_codec,
        "stages": stage,
        "stream_stats": stream_stats,
        "single_file_decode": single,
        "blend_kernel": "cuda" if dev.type == "cuda" else "plain",
        "surgical_stages": surgical,
        "kernel_roofline": roofline,
        "grid_effects": grid,
        "batch": batch,
        "iters": iters,
        "windows": args.windows,
        "device": card,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
