#!/usr/bin/env python3
"""Smoke run of the PyTorch port (libmodjpeg_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. environment: a CUDA device is required (there is no CPU path); prints
   the torch/CUDA versions and the card's name and power limit;
2. build: compiles the hand-written kernel (compose and blend modes) from
   libmodjpeg_tpu_torch/csrc/ for sm_90a into build/torch_kernels/;
3. compose mode (compose_rows_cuda, compact operands: R rows of hw blocks
   read in place of a wider packed row, a random quant table per row, the
   dropon and mask shared with a third of the positions zero-mask)
   against its row-form plain version, on the card and on the CPU, with
   the +-1 / <0.5% bar, exact zero-mask blocks and the in-place call, at
   (R, hw) = (1, 1), (1, 7), (1, 4099), (32, 384), (32, 4096) with a
   third of the positions opaque too (mask exactly 1); a strided grid
   window with per-image dropons; 12-bit-range values; the test_pallas
   all-zero case (q up to 65,534).  Times kernel and plain version in
   turns at (32, 384), (32, 4096) and (1, 375000), and at (32, 4096) with
   a third of the blocks opaque, rotating input sets past the L2, and
   prints bytes, FLOPs (separable count), the bound on the published H100
   peaks and the share of it;
3b. blend mode against its plain-torch version, on the card and on the
   CPU, with the TPU blend kernel's bar (rtol 1e-5, atol 1e-3), zero-mask
   blocks exactly x1 and the opaque-mask case within 3e-2 of x0; times
   both at 12,288 and 131,072 blocks the same way;
4. main path: BatchComposer.watermark_stream on 32 1920x1088 4:2:0 q85
   JPEGs with a 256x64 RGBA logo, through the band splice, the forced full
   path and the surgical splice (restart_interval=32); checks the paths
   taken, splice bytes == full bytes, untouched coefficients identical to
   the input, the footprint within +-1 of a device="cpu" run, and that
   every batch launched the kernel once per component; then replays one
   batch's device step (packed_compose): the kernel at the batch's shapes
   against its plain version, and the device milliseconds (CUDA events)
   of the uplink restore, the compose launches and _pack_down;
5. the kernel bench (libmodjpeg_tpu_torch.scripts.kernel_bench) at its
   default sizes, the path that runs the blend mode; checks that it
   launched both modes;
6. the modjpeg CLI (libmodjpeg_tpu_torch.cli) on a 3840x2160 4:2:0 q85
   JPEG: effects, a JPEG dropon with its JPEG mask, a PNG dropon, two
   outputs; once as it is and once with -X, on the card and with
   device="cpu".  Checks exit codes, 3 compose launches per compose, the
   pixels and coefficients of the card run against the CPU run (identical
   outside the footprints, +-1 on under 0.5% inside), and byte-identical
   -X outputs;
7. the huge-image GridSession at full size: the JAX package's 100 MP
   4:2:0 frame (tests/test_bigimage.py synth_big(100.0), rebuilt here),
   encoded with restart_interval=64 and decoded, then on the card
   luminance(60) + tint(cb 25) + compose(dropon.png, centre) + an
   optimized to_jpeg whose Huffman statistics come from the device
   histogram.  Checks the bytes against the host OPTION_OPTIMIZE encode of
   the same coefficients, the coefficients against the same chain with
   device="cpu" (identical outside the footprint, +-1 on under 0.5%
   inside), and 3 compose launches; times the effects rounds of bench.py's
   grid_effects lane, the device tables against the host optimize walk
   and to_jpeg, and reports the peak device memory;
8. the corpus runner (libmodjpeg_tpu_torch.corpus.run_corpus) over the 32
   files of phase 4, on the card and with device="cpu": the stream route
   (dropon only), a resume run that skips all 32, and the effects route
   (luminance + dropon).  Checks 0 failures, card outputs against CPU
   outputs (identical outside the footprint, +-1 on under 0.5% inside,
   byte-identical wherever the coefficients are); then compose_batch on 8
   of the images against 8 single compose calls on the card (identical);
9. the betterjpeg script (libmodjpeg_tpu_torch.scripts.betterjpeg) on a
   6000x4000 4:2:0 q92 photo and an edited PNG of it (a noise patch, a
   flat redaction box, a thin white diagonal across the frame), so the
   compose is one packed row holding every block of the frame.  Checks
   to_pixels on the card == on the CPU, exit status 0 on the card and with
   device="cpu", 3 compose launches on the card, every block outside the
   edited MCUs identical to the input in both outputs, card vs CPU within
   +-1 on under 0.5% inside, and a no-change run that launches nothing and
   keeps every coefficient; then replays the compose step piece by piece
   (wire taken, downlink rows refetched, device time per step) and holds
   its Y launch (375,000 blocks) against its plain version on the card;
10. the port's bench (libmodjpeg_tpu_torch.scripts.bench) at its defaults:
   32 1080p files, 5 interleaved windows of 5 passes per stream lane, the
   codec lanes, stages, the surgical stages, grid effects on a 100.7 MP
   GridSession and kernel_roofline against the card's measured copy rate.
   Checks its asserted paths (it raises on a wrong one), 5 windows per
   stream lane, 0 < kernel_roofline.frac <= 1.05, grid_effects, the card's
   power limit and that it launched the kernel; then the scaling bench
   (scripts.scaling_bench, 8 images, two corpus processes sharing the
   card): byte-identical outputs across fan-out and kernel launches in the
   two-host run.  Both print their JSON lines.

Prints the card's name and power limit, then one JSON line describing the
kernels (times, bounds, launches per path), and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, without that line, when any phase fails.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1088
N_FILES = 32          # one batch: 384 footprint blocks per file x 32
BATCH = 32
ITERS = 10            # timed passes over the corpus per stream path
RESTART = 32          # MCUs per restart segment -> surgical path
PLACE_OFFSET = (-32, -32)
# compose mode: (rows R, blocks per row hw) checked, and timed (the stream's
# batch, a 32-row batch of 4,096-block footprints, the betterjpeg Y launch;
# then the 32 x 4,096 batch with a third of its blocks opaque)
KERNEL_ROWS = ((1, 1), (1, 7), (1, 4099), (32, 384), (32, 4096))
TIMED_ROWS = ((32, 384, False), (32, 4096, False), (1, 375000, False),
              (32, 4096, True))
BLEND_NS = (1, 7, 4099, 12288, 131072)
TIMED_NS = (12288, 131072)
TIMED_REPS = 50
COLD_BYTES = 150e6    # rotate input sets past 3x the 50 MB L2 when timing
HBM_BPS = 3.35e12     # H100 SXM: published memory rate and f32 peak
F32_FLOPS = 67e12
BLOCK_FLOPS = 4 * 8 * 8 * 8 * 2   # separable transforms, per 8x8 block
MAX_DIFF_SHARE = 0.005
BLEND_RTOL, BLEND_ATOL = 1e-5, 1e-3   # tests/test_pallas.py:30
CLI_W, CLI_H = 3840, 2160
BIG_MP = 100.0        # tests/test_bigimage.py with MJT_BIG=1
BIG_RESTART = 64
EFFECT_ROUNDS = 6     # bench.py grid_effects: KG
N_COMPOSE_BATCH = 8
SCALING_IMAGES = 8
BJ_W, BJ_H = 6000, 4000   # a 24 MP photo
BJ_QUALITY = 92
FIXTURES = os.path.join(REPO, "tests", "fixtures")
WORK = os.path.join(REPO, "build", "chip_smoke")


def log(msg):
    print(msg, flush=True)


# -- phase 1: environment -----------------------------------------------------

def phase_environment():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this run "
                 "needs one CUDA GPU")
    sys.path.insert(0, REPO)
    import libmodjpeg_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    log(f"card: {card}")
    return card


# -- phase 2: build -------------------------------------------------------------

def phase_build():
    from libmodjpeg_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    dt = time.perf_counter() - t0
    log(f"build: {_build.last_build['path']} in {dt:.2f} s "
        f"(nvcc {_build.last_build['seconds']:.2f} s)")
    for line in _build.last_build["output"].splitlines():
        log(f"  nvcc: {line}")
    return dt


# -- phase 3: kernel vs its plain version ---------------------------------------

def _rows_inputs(rng, n, hw, qmax=256, rmax=900, opaque=False):
    """Compose-mode operands as the stream batch gives them: an int16 [n, 1,
    hw, 64] region read in place of a wider packed row (a second component
    after it), one random quant table per row, the [hw, 64] dropon (whole
    numbers, as a compiled dropon's Q100 coefficients are) and mask shared
    by the rows with a third of the positions zero-mask; with ``opaque``,
    another third opaque (mask exactly 1, a logo's core), which the kernel
    recomputes in the plain version's order.  Returns the numpy arrays
    (region, quant, dropon, mask) and the zero positions."""
    packed = rng.randint(-rmax, rmax + 1, (n, hw + 2, 64)).astype(np.int16)
    q = rng.randint(1, qmax, (n, 64)).astype(np.int32)
    x0 = np.rint(rng.randn(hw, 64) * 300).astype(np.float32)
    m = (rng.rand(hw, 64) * 0.9).astype(np.float32)
    zero = np.arange(hw) % 3 == 0
    m[zero] = 0.0
    if opaque:
        m[np.arange(hw) % 3 == 1] = 1.0
    return (packed, q, x0, m), zero


def _rows_on(host, device, hw):
    """The operands on ``device``: the region a strided view of the packed
    rows."""
    packed, q, x0, m = [torch.from_numpy(a).to(device) for a in host]
    return (packed[:, :hw].view(-1, 1, hw, 64), q, x0, m)


def _rows_cost(n, hw):
    """(bytes, flops) a compose of n rows of hw blocks must move and do:
    the int16 region in and out, the shared dropon and mask and the rows'
    quant tables read once; the separable transforms."""
    return n * hw * 256 + hw * 512 + n * 256, n * hw * BLOCK_FLOPS


def _bound(nbytes, flops):
    """(bound ms, what sets it) on the published H100 peaks."""
    mem, ops = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def _time_ms(fn, args, reps):
    """Device milliseconds per call.  A device-side sleep queued ahead of
    the window lets the host enqueue every call before the first one runs,
    so host launch overhead does not leak into the device time."""
    return _time_sets_ms(fn, [args], reps)


def _time_sets_ms(fn, sets, reps):
    """_time_ms cycling over several argument sets, so that no call finds
    its inputs left in L2 by the one before when the sets together exceed
    the L2."""
    for a in sets[:3]:
        fn(*a)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # cycles: tens of ms at H100 clocks
    start.record()
    for k in range(reps):
        fn(*sets[k % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _check_rows(got, ref, label):
    """+-1 on under MAX_DIFF_SHARE of the coefficients; returns max |d| and
    the share that differs."""
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    share = float((d != 0).mean())
    if d.max() > 1 or share >= MAX_DIFF_SHARE:
        raise AssertionError(f"{label}: max|d|={d.max()} differing={share}")
    return int(d.max()), share


def phase_kernel():
    """The compose mode against its row-form plain version; returns the max
    error, per timed shape (kernel ms, plain ms), and the count of checked
    coefficients that differ from the plain version."""
    from libmodjpeg_tpu_torch.ops import compose_kernel as ck

    rng = np.random.RandomState(1234)
    max_err, differ, total = 0, 0, 0
    for n, hw in KERNEL_ROWS:
        host, zero = _rows_inputs(rng, n, hw, opaque=True)
        cpu, dev = _rows_on(host, "cpu", hw), _rows_on(host, "cuda", hw)
        got = ck.compose_rows_cuda(*dev)
        plain_dev = ck.compose_rows_ref(*dev)
        torch.cuda.synchronize()
        got = got.cpu().numpy()
        for name, ref in (("card", plain_dev.cpu().numpy()),
                          ("cpu", ck.compose_rows_ref(*cpu).numpy())):
            err, share = _check_rows(got, ref, f"kernel ({n}, {hw}) {name}")
            log(f"kernel (R, hw)=({n}, {hw}) vs plain on {name}: "
                f"max|d|={err} differing={share:.6f}")
            max_err = max(max_err, err)
            if name == "card":
                differ += int(round(share * got.size))
                total += got.size
        if not np.array_equal(got[:, 0, zero], host[0][:, :hw][:, zero]):
            raise AssertionError(f"zero-mask blocks not exact at ({n}, {hw})")
        # in place of the region, as the grid paths call it
        ck.compose_rows_cuda(dev[0], *dev[1:], out=dev[0])
        if not np.array_equal(dev[0].cpu().numpy(), got):
            raise AssertionError(f"in-place compose differs at ({n}, {hw})")

    # a footprint window of a [N, H, W, 8, 8] grid with per-image dropons,
    # and 12-bit-range values (the kernel's int32 requantization path)
    grids = rng.randint(-900, 901, (3, 9, 40, 64)).astype(np.int16)
    ops = [torch.from_numpy(grids)[:, 2:6, 5:38],
           torch.from_numpy(rng.randint(1, 256, (3, 64)).astype(np.int32)),
           torch.from_numpy((rng.randn(3, 132, 64) * 300).astype(np.float32)),
           torch.from_numpy((rng.rand(3, 132, 64) * 0.9).astype(np.float32))]
    win = [torch.from_numpy(grids).cuda()[:, 2:6, 5:38]] + [
        t.cuda() for t in ops[1:]]
    big, _ = _rows_inputs(rng, 4, 999, qmax=65535, rmax=32767, opaque=True)
    for label, cpu, dev in (
            ("window", ops, win),
            ("12-bit", _rows_on(big, "cpu", 999), _rows_on(big, "cuda", 999))):
        got = ck.compose_rows_cuda(*dev).cpu().numpy()
        err, share = _check_rows(got, ck.compose_rows_ref(*cpu).numpy(),
                                 label)
        log(f"kernel {label} {tuple(cpu[0].shape)} vs plain on cpu: "
            f"max|d|={err} differing={share:.6f}")

    # the test_pallas zero-mask case: region +-2047, q up to 65534
    n = 2053
    region = rng.randint(-2047, 2048, (1, 1, n, 64)).astype(np.int16)
    x0 = (rng.randn(n, 64) * 500).astype(np.float32)
    q = rng.randint(1, 65535, (1, 64)).astype(np.int32)
    out = ck.compose_rows_cuda(
        torch.from_numpy(region).cuda(), torch.from_numpy(q).cuda(),
        torch.from_numpy(x0).cuda(),
        torch.zeros((n, 64), dtype=torch.float32, device="cuda")).cpu()
    if not np.array_equal(out.numpy(), region):
        raise AssertionError("all-zero mask case is not an exact identity")
    log("kernel: all-zero-mask case (N=2053, q<=65534) exact")
    log(f"kernel: {differ} of {total} checked coefficients differ from the "
        f"plain version on the card (max 1)")

    times = {}
    for n, hw, opaque in TIMED_ROWS:
        nbytes, flops = _rows_cost(n, hw)
        sets = [_rows_on(_rows_inputs(rng, n, hw, opaque=opaque)[0], "cuda",
                         hw)
                for _ in range(max(1, int(np.ceil(COLD_BYTES / nbytes))))]
        plain_reps = max(3, min(TIMED_REPS, int(2e7 // (n * hw))))
        # in turns, plain / kernel / kernel / plain, on one card
        p1 = _time_sets_ms(ck.compose_rows_ref, sets, plain_reps)
        k1 = _time_sets_ms(ck.compose_rows_cuda, sets, TIMED_REPS)
        k2 = _time_sets_ms(ck.compose_rows_cuda, sets, TIMED_REPS)
        p2 = _time_sets_ms(ck.compose_rows_ref, sets, plain_reps)
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        bound, by = _bound(nbytes, flops)
        times[(n, hw, opaque)] = (k, p, bound, by)
        log(f"time (R, hw)=({n}, {hw}){' a third opaque' if opaque else ''}, "
            f"{len(sets)} input sets in turn: "
            f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms; "
            f"{nbytes} B, {flops} FLOP, bound {bound:.4f} ms ({by}), "
            f"{bound / k:.1%} of the bound")
    return max_err, times, (differ, total)


# -- phase 3b: blend mode vs its plain version ---------------------------------

def _blend_inputs(rng, n):
    x1 = (rng.randn(n, 64) * 300).astype(np.float32)
    x0 = (rng.randn(n, 64) * 300).astype(np.float32)
    m = (rng.rand(n, 64) * 0.9).astype(np.float32)
    zero = np.arange(n) % 3 == 0   # one third of the blocks: zero mask
    m[zero] = 0.0
    return (x1, x0, m), zero


def _blend_plain(x1, x0, m):
    """blend_blocks_m on the kernel's [N, 64] operands."""
    from libmodjpeg_tpu_torch.ops.compose import blend_blocks_m

    n = x1.shape[0]
    return blend_blocks_m(x1.view(n, 8, 8), x0.view(n, 8, 8),
                          m.view(n, 8, 8)).view(n, 64)


def _opaque_mask():
    """The pixel mask of a fully opaque 8x8 alpha block (the opaque case of
    tests/test_pallas.py), through the port's dropon-compile steps."""
    from libmodjpeg_tpu_torch import composer
    from libmodjpeg_tpu_torch.ops.compose import mask_pix_np

    w = composer._alpha_to_weights(torch.full((8, 8), 255.0), 1, 1)
    return mask_pix_np(w.numpy())[0, 0].reshape(64)


def phase_blend():
    from libmodjpeg_tpu_torch.ops import compose_kernel as ck

    rng = np.random.RandomState(4321)
    max_err = 0.0
    for n in BLEND_NS:
        host, zero = _blend_inputs(rng, n)
        cpu = [torch.from_numpy(a) for a in host]
        dev = [t.cuda() for t in cpu]
        got = ck.blend_blocks_cuda(*dev)
        plain_dev = _blend_plain(*dev)
        torch.cuda.synchronize()
        got = got.cpu().numpy()
        for name, ref in (("card", plain_dev.cpu().numpy()),
                          ("cpu", _blend_plain(*cpu).numpy())):
            err = float(np.abs(got - ref).max())
            ok = np.allclose(got, ref, rtol=BLEND_RTOL, atol=BLEND_ATOL)
            log(f"blend N={n} vs plain on {name}: max|d|={err:.6g} "
                f"allclose(rtol={BLEND_RTOL}, atol={BLEND_ATOL})={ok}")
            if not ok:
                raise AssertionError(f"blend kernel disagrees at N={n} "
                                     f"({name})")
            max_err = max(max_err, err)
        if not np.array_equal(got[zero], host[0][zero]):
            raise AssertionError(f"blend: zero-mask blocks not x1 at N={n}")

    n = 16
    x1 = (rng.randn(n, 64) * 300).astype(np.float32)
    x0 = (rng.randn(n, 64) * 300).astype(np.float32)
    m = np.ascontiguousarray(np.broadcast_to(_opaque_mask(), (n, 64)))
    out = ck.blend_blocks_cuda(*[torch.from_numpy(a).cuda()
                                 for a in (x1, x0, m)]).cpu().numpy()
    err = float(np.abs(out - x0).max())
    if err > 3e-2:
        raise AssertionError(f"blend: opaque mask off x0 by {err}")
    log(f"blend: zero-mask blocks exact; opaque mask within {err:.3g} of x0")

    times = {}
    for n in TIMED_NS:
        nbytes, flops = n * 4 * 4 * 64, n * BLOCK_FLOPS
        sets = [[torch.from_numpy(a).cuda() for a in _blend_inputs(rng, n)[0]]
                for _ in range(max(1, int(np.ceil(COLD_BYTES / nbytes))))]
        p1 = _time_sets_ms(_blend_plain, sets, TIMED_REPS)
        k1 = _time_sets_ms(ck.blend_blocks_cuda, sets, TIMED_REPS)
        k2 = _time_sets_ms(ck.blend_blocks_cuda, sets, TIMED_REPS)
        p2 = _time_sets_ms(_blend_plain, sets, TIMED_REPS)
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        bound, by = _bound(nbytes, flops)
        times[n] = (k, p, bound, by)
        log(f"blend time N={n}, {len(sets)} input sets in turn: kernel "
            f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms; {nbytes} B, "
            f"{flops} FLOP, bound {bound:.4f} ms ({by}), "
            f"{bound / k:.1%} of the bound")
    return max_err, times


# -- phase 4: the main path ----------------------------------------------------

def make_test_image(rng, w, h):
    """Photo-like synthetic pixels: smooth gradients + mild texture (the
    benchmark corpus generator of the JAX package's bench.py)."""
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


def _check_footprint(origins, inputs, outputs, cpu_outputs, label):
    """Untouched coefficients identical to the input; the footprint within
    +-1 of the CPU run on under 0.5% of its coefficients."""
    from libmodjpeg_tpu_torch import codec

    diffs = total = 0
    for src, out, ref in zip(inputs, outputs, cpu_outputs):
        x, y, r = codec.decode(src), codec.decode(out), codec.decode(ref)
        for c, (r0, c0, h, w) in enumerate(origins):
            outside = np.ones(x.coefs[c].shape[:2], bool)
            outside[r0:r0 + h, c0:c0 + w] = False
            if not np.array_equal(y.coefs[c][outside], x.coefs[c][outside]):
                raise AssertionError(f"{label}: untouched coefficients moved")
            d = np.abs(y.coefs[c][r0:r0 + h, c0:c0 + w].astype(np.int64)
                       - r.coefs[c][r0:r0 + h, c0:c0 + w])
            if d.max() > 1:
                raise AssertionError(f"{label}: footprint off by {d.max()}")
            diffs += int((d != 0).sum())
            total += d.size
    share = diffs / total
    if share >= MAX_DIFF_SHARE:
        raise AssertionError(f"{label}: {share:.6f} of footprint differs")
    log(f"{label}: untouched coefficients identical; footprint vs cpu run "
        f"{diffs}/{total} differ (max 1)")


def phase_main_path(pool):
    import libmodjpeg_tpu_torch as mt
    from libmodjpeg_tpu_torch import codec
    from libmodjpeg_tpu_torch.encode_pixels import from_pixels
    from libmodjpeg_tpu_torch.ops import compose_kernel as ck
    from libmodjpeg_tpu_torch.parallel import BatchComposer

    t0 = time.perf_counter()
    rng = np.random.RandomState(42)
    free, rst = [], []
    for _ in range(N_FILES):
        img = from_pixels(make_test_image(rng, W, H), quality=85,
                          subsampling="420", device="cuda")
        free.append(codec.encode(img))
        rst.append(codec.encode(img, restart_interval=RESTART))
    dropon = mt.read_dropon_from_raw(make_logo(rng, 256, 64),
                                     mt.COLORSPACE_RGBA, 256, 64)
    place = (mt.ALIGN_BOTTOM | mt.ALIGN_RIGHT, *PLACE_OFFSET)
    log(f"corpus: {N_FILES} x {W}x{H} 4:2:0 q85 ({len(free[0])} B, "
        f"{len(rst[0])} B with restarts) in {time.perf_counter() - t0:.1f} s")

    runs = {
        "splice": (free, {}),
        "full": (free, {"surgical": False}),
        "surgical": (rst, {"restart_interval": RESTART}),
    }
    composers = {}
    for name, (datas, kw) in runs.items():
        bc = BatchComposer(codec.decode(datas[0]), dropon, *place,
                           device="cuda")
        list(bc.watermark_stream(iter(datas), batch=BATCH, pool=pool, **kw))
        composers[name] = bc  # warmed: dropon compiled, kernel loaded

    mp = W * H * N_FILES * ITERS / 1e6
    results, launches = {}, {}
    torch.cuda.synchronize()
    ck.launches = 0
    for name, (datas, kw) in runs.items():
        bc = composers[name]
        before = ck.launches
        t0 = time.perf_counter()
        outs = list(bc.watermark_stream(iter(datas * ITERS), batch=BATCH,
                                        pool=pool, **kw))
        dt = time.perf_counter() - t0
        launches[name] = ck.launches - before
        results[name] = outs[:N_FILES]
        stats = {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in bc.last_stream_stats.items()}
        log(f"stream {name}: path={bc.last_stream_path} "
            f"fallbacks={bc.last_fallback_reasons} {mp / dt:.2f} MP/s "
            f"({N_FILES * ITERS} files in {dt:.3f} s) stats={stats}")
        if bc.last_stream_path != name:
            raise AssertionError(f"{name} run took {bc.last_stream_path}")
        expect = len(bc._meta) * stats["batches"]
        if launches[name] != expect:
            raise AssertionError(f"{name}: {launches[name]} kernel launches, "
                                 f"expected {expect}")
    total_launches = ck.launches
    log(f"kernel launches in the main-path runs: {launches} "
        f"(total {total_launches})")
    if total_launches == 0:
        raise AssertionError("the main path never launched the kernel")

    if results["splice"] != results["full"]:
        raise AssertionError("splice bytes differ from full-path bytes")
    log("splice bytes == full-path bytes for all files")

    for name in ("splice", "surgical"):
        datas, kw = runs[name]
        bc = composers[name]
        cpu_bc = BatchComposer(codec.decode(datas[0]), dropon, *place,
                               device="cpu", compiled=bc.cd)
        cpu_out = list(cpu_bc.watermark_stream(iter(datas), batch=BATCH,
                                               pool=pool, **kw))
        if cpu_bc.last_stream_path != name:
            raise AssertionError(f"cpu {name} run took "
                                 f"{cpu_bc.last_stream_path}")
        _check_footprint(bc._region_origins(), datas, results[name], cpu_out,
                         name)
    step = _stream_step(composers["splice"], free)
    return total_launches, free, step


def _stream_step(bc, datas):
    """One stream batch's device step (packed_compose) replayed piece by
    piece on the card: the kernel at the batch's own shapes held against
    its plain version, and the device milliseconds of the uplink restore,
    the compose (one launch per component) and _pack_down, timed with CUDA
    events.  Returns the compose's (kernel ms, plain ms, bytes, flops)."""
    from libmodjpeg_tpu_torch import codec
    from libmodjpeg_tpu_torch.ops import compose_kernel as ck
    from libmodjpeg_tpu_torch.parallel import batch as tbatch

    imgs = [codec.decode(d) for d in datas[:BATCH]]
    n, meta, dd = len(imgs), bc._meta, bc._dev
    flat = np.concatenate(
        [np.stack([im.coefs[c][r0:r0 + h, c0:c0 + w] for im in imgs])
         .reshape(n, -1)
         for c, (r0, c0, h, w) in enumerate(bc._region_origins())], axis=1)
    qstack = np.concatenate(
        [np.stack([np.asarray(im.quant_table_for(c), np.int32).reshape(64)
                   for im in imgs]) for c in range(len(meta))], axis=1)
    packed = tbatch._wirepack(flat)
    up = [torch.from_numpy(a).cuda() for a in (packed or (flat,))]
    q = torch.from_numpy(qstack).cuda()
    cap = bc._down_cap
    body_in = tbatch._restore_uplink(*up) if packed else up[0]

    def plain_body():
        out, off = [], 0
        for c, hw in enumerate(meta):
            out.append(ck.compose_rows_ref(
                body_in[:, off:off + hw * 64].view(n, 1, hw, 64),
                q[:, c * 64:(c + 1) * 64], dd.drops[c],
                dd.masks[c]).view(n, -1))
            off += hw * 64
        return torch.cat(out, dim=1)

    body_out = tbatch._compose_body(meta, body_in, q, dd.drops, dd.masks)
    err, share = _check_rows(body_out.cpu().numpy(),
                             plain_body().cpu().numpy(), "stream batch")
    zero = torch.cat([(m == 0).all(dim=1) for m in dd.masks])
    got = body_out.view(n, -1, 64)[:, zero]
    if not torch.equal(got, body_in.view(n, -1, 64)[:, zero]):
        raise AssertionError("stream batch: zero-mask blocks moved")
    log(f"stream batch (R, hw per component)=({n}, {meta}): kernel vs plain "
        f"on the card max|d|={err} differing={share:.6f}; "
        f"{int(zero.sum())} zero-mask block positions exact")
    steps = {
        "_restore_uplink": (lambda: tbatch._restore_uplink(*up)
                            if packed else None),
        f"compose ({len(meta)} launches)": lambda: tbatch._compose_body(
            meta, body_in, q, dd.drops, dd.masks),
        "_pack_down": lambda: tbatch._pack_down(body_out, cap),
        "packed_compose (all)": lambda: tbatch.packed_compose(
            meta, tuple(up) if packed else up[0], q, dd.drops, dd.masks, cap),
        "plain compose": plain_body,
    }
    ms = {k: _time_ms(f, (), TIMED_REPS) for k, f in steps.items()}
    log("stream batch device step: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ms.items()))
    costs = [_rows_cost(n, hw) for hw in meta]
    return (ms[f"compose ({len(meta)} launches)"], ms["plain compose"],
            sum(b for b, _ in costs), sum(f for _, f in costs))


# -- phase 5: the kernel bench -------------------------------------------------

def phase_kernel_bench():
    from libmodjpeg_tpu_torch.ops import compose_kernel as ck
    from libmodjpeg_tpu_torch.scripts import kernel_bench

    torch.cuda.synchronize()
    ck.launches = ck.blend_launches = 0
    kernel_bench.main([])
    launches = {"blend": ck.blend_launches, "compose": ck.launches}
    log(f"kernel bench launches: {launches}")
    if not all(launches.values()):
        raise AssertionError("the kernel bench did not launch both modes")
    return launches


# -- phase 6: the CLI path ---------------------------------------------------

def _cli_args(src, out_a, out_b, bitexact):
    return (["-X"] if bitexact else []) + [
        "-i", src, "-y", "12", "-b", "-6", "-p", "br", "-m", "-32,-32",
        "-d", f"{FIXTURES}/dropon.jpg,{FIXTURES}/mask.jpg", "-p", "tl",
        "-d", f"{FIXTURES}/dropon.png", "-x", "-o", out_a, "-g", "-o", out_b]


def _cli_footprints(src):
    """Per component, True on the blocks the two dropons of _cli_args
    cover."""
    import libmodjpeg_tpu_torch as mt
    from libmodjpeg_tpu_torch import codec
    from libmodjpeg_tpu_torch.parallel import BatchComposer

    img = codec.decode(open(src, "rb").read())
    masks = [np.zeros(c.shape[:2], bool) for c in img.coefs]
    for dropon, mask, align in (
            ("dropon.jpg", "mask.jpg", mt.ALIGN_BOTTOM | mt.ALIGN_RIGHT),
            ("dropon.png", None, mt.ALIGN_TOP | mt.ALIGN_LEFT)):
        d = mt.read_dropon(f"{FIXTURES}/{dropon}",
                           mask=mask and f"{FIXTURES}/{mask}", device="cpu")
        bc = BatchComposer(img, d, align, -32, -32, device="cpu")
        for c, (r0, c0, h, w) in enumerate(bc._region_origins()):
            masks[c][r0:r0 + h, c0:c0 + w] = True
    return masks


def _share_within_one(a, b, label):
    """Max |a - b| <= 1 on under MAX_DIFF_SHARE of the entries; returns the
    count that differ."""
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    n = int((d != 0).sum())
    if d.size and (d.max() > 1 or n / d.size >= MAX_DIFF_SHARE):
        raise AssertionError(f"{label}: max|d|={d.max()}, {n}/{d.size} "
                             f"differ")
    return n


def phase_cli():
    from libmodjpeg_tpu_torch import codec
    from libmodjpeg_tpu_torch import cli
    from libmodjpeg_tpu_torch.encode_pixels import from_pixels
    from libmodjpeg_tpu_torch.ops import compose_kernel as ck
    from libmodjpeg_tpu_torch.pixels import to_pixels

    os.makedirs(WORK, exist_ok=True)
    src = os.path.join(WORK, "in.jpg")
    img = from_pixels(make_test_image(np.random.RandomState(7), CLI_W, CLI_H),
                      quality=85, subsampling="420", device="cuda")
    with open(src, "wb") as f:
        f.write(codec.encode(img))
    ncomps = img.num_components
    log(f"cli input: {CLI_W}x{CLI_H} 4:2:0 q85, {os.path.getsize(src)} B")

    outs, walls, launches = {}, {}, {}
    for dev in ("cuda", "cpu"):
        for bitexact in (False, True):
            key = (dev, bitexact)
            tag = f"{dev}{'_X' if bitexact else ''}"
            out_a = os.path.join(WORK, f"a_{tag}.jpg")
            out_b = os.path.join(WORK, f"b_{tag}.jpg")
            torch.cuda.synchronize()
            before = ck.launches
            t0 = time.perf_counter()
            rc = cli.main(_cli_args(src, out_a, out_b, bitexact), device=dev)
            torch.cuda.synchronize()
            walls[key] = time.perf_counter() - t0
            launched = launches[key] = ck.launches - before
            log(f"cli {tag}: rc={rc} {walls[key]:.3f} s "
                f"({CLI_W * CLI_H / 1e6 / walls[key]:.2f} MP/s), "
                f"{launched} compose launches")
            if rc != 0:
                raise AssertionError(f"cli {tag} exited {rc}")
            want = 0 if (bitexact or dev == "cpu") else 2 * ncomps
            if launched != want:
                raise AssertionError(f"cli {tag}: {launched} compose "
                                     f"launches, expected {want}")
            outs[key] = [open(p, "rb").read() for p in (out_a, out_b)]

    for i, name in enumerate(("a.jpg", "b.jpg")):
        if outs[("cuda", True)][i] != outs[("cpu", True)][i]:
            raise AssertionError(f"-X {name}: card bytes != cpu bytes")
    log("cli -X: a.jpg and b.jpg byte-identical between card and cpu")

    card_a = codec.decode(outs[("cuda", False)][0])
    cpu_a = codec.decode(outs[("cpu", False)][0])
    n = _share_within_one(to_pixels(card_a, device="cuda"),
                          to_pixels(cpu_a, device="cpu"), "a.jpg pixels")
    log(f"cli a.jpg pixels, card run on card vs cpu run on cpu: {n} of "
        f"{CLI_W * CLI_H * 3} samples differ (max 1)")
    inside = _cli_footprints(src)
    for i, name in enumerate(("a.jpg", "b.jpg")):
        g = codec.decode(outs[("cuda", False)][i])
        c = codec.decode(outs[("cpu", False)][i])
        differing = total = 0
        for k, m in enumerate(inside):
            if not np.array_equal(g.coefs[k][~m], c.coefs[k][~m]):
                raise AssertionError(f"cli {name}: coefficients outside the "
                                     f"footprints differ")
            differing += _share_within_one(g.coefs[k][m], c.coefs[k][m],
                                           f"cli {name} footprint")
            total += int(m.sum()) * 64
        if differing / total >= MAX_DIFF_SHARE:
            raise AssertionError(f"cli {name}: {differing}/{total} differ")
        log(f"cli {name}: identical outside the footprints; {differing} of "
            f"{total} footprint coefficients differ from the cpu run (max 1)")
    return launches[("cuda", False)]


# -- phase 7: the huge-image GridSession --------------------------------------

def synth_big(mp_target):
    """A big 4:2:0 coefficient image with photo-like sparsity: random DC
    and two AC coefficients per block, and a block-row count that does not
    divide by 8 (tests/test_bigimage.py synth_big, rebuilt here because
    tests/ imports JAX)."""
    from libmodjpeg_tpu_torch import constants as C
    from libmodjpeg_tpu_torch.model import CoefImage, ComponentInfo, Sampling

    mcus_w = int(np.sqrt(mp_target * 1e6 * (3 / 2)) // 16)
    mcus_h = int(mp_target * 1e6 // (mcus_w * 16 * 16))
    if mcus_h % 8 == 0:
        mcus_h -= 1
    rng = np.random.RandomState(0)
    comps, coefs = [], []
    for c, (sh, sv) in enumerate([(2, 2), (1, 1), (1, 1)]):
        pw, ph = mcus_w * sh, mcus_h * sv
        a = np.zeros((ph, pw, 8, 8), np.int16)
        a[..., 0, 0] = rng.randint(-200, 200, (ph, pw))
        a[..., 0, 1] = rng.randint(-20, 20, (ph, pw))
        a[..., 1, 0] = rng.randint(-20, 20, (ph, pw))
        comps.append(ComponentInfo(c + 1, sh, sv, 0 if c == 0 else 1,
                                   pw, ph, pw, ph))
        coefs.append(a)
    return CoefImage(
        width=mcus_w * 16, height=mcus_h * 16, jpeg_color_space=C.JCS_YCbCr,
        components=comps, coefs=coefs,
        quant_tables={0: np.full((8, 8), 6, np.uint16),
                      1: np.full((8, 8), 11, np.uint16)},
        sampling=Sampling(2, 2))


def _grid_chain(img, logo, device, compiled=None):
    """The phase-7 chain on a new GridSession; returns the session."""
    import libmodjpeg_tpu_torch as mt
    from libmodjpeg_tpu_torch.parallel import GridSession

    sess = GridSession(img, device=device)
    sess.effect("luminance", value=60).effect("tint", cb_value=25)
    sess.compose(logo, mt.ALIGN_CENTER, compiled=compiled)
    return sess.block_until_ready()


def _compare_coefs(a, b, inside, label):
    """Per component: identical where ``inside`` is False, within +-1
    where it is True, on under MAX_DIFF_SHARE of the footprint's
    coefficients.  Returns (differing, total) inside."""
    differing = total = 0
    for c, m in enumerate(inside):
        if not np.array_equal(a.coefs[c][~m], b.coefs[c][~m]):
            raise AssertionError(f"{label}: coefficients outside the "
                                 f"footprint differ (component {c})")
        d = np.abs(a.coefs[c][m].astype(np.int64) - b.coefs[c][m])
        if d.size and d.max() > 1:
            raise AssertionError(f"{label}: footprint off by {d.max()}")
        differing += int((d != 0).sum())
        total += d.size
    if total and differing / total >= MAX_DIFF_SHARE:
        raise AssertionError(f"{label}: {differing}/{total} differ")
    return differing, total


def _footprint_masks(img, logo, align, ox, oy):
    """Per component, True on the blocks the dropon's footprint covers."""
    from libmodjpeg_tpu_torch.parallel import BatchComposer

    bc = BatchComposer(img, logo, align, ox, oy, device="cpu")
    masks = [np.zeros(c.shape[:2], bool) for c in img.coefs]
    for c, (r0, c0, h, w) in enumerate(bc._region_origins()):
        masks[c][r0:r0 + h, c0:c0 + w] = True
    return masks


def phase_grid_session():
    import libmodjpeg_tpu_torch as mt
    from libmodjpeg_tpu_torch import codec
    from libmodjpeg_tpu_torch import composer
    from libmodjpeg_tpu_torch.ops import compose_kernel as ck

    opt = mt.OPTION_OPTIMIZE
    img = synth_big(BIG_MP)
    mp = img.width * img.height / 1e6
    blocks = sum(a.shape[0] * a.shape[1] for a in img.coefs)
    t0 = time.perf_counter()
    data = codec.encode(img, restart_interval=BIG_RESTART)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = codec.decode(data)
    t_dec = time.perf_counter() - t0
    for a, b in zip(back.coefs, img.coefs):
        if not np.array_equal(a, b):
            raise AssertionError("grid: encode/decode round trip differs")
    log(f"grid: {img.width}x{img.height} 4:2:0 ({mp:.2f} MP, {blocks} "
        f"blocks, {len(data)} B); encode {t_enc:.3f} s, decode {t_dec:.3f} s")
    logo = mt.read_dropon(f"{FIXTURES}/dropon.png", device="cuda")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.launches = 0
    t0 = time.perf_counter()
    sess = _grid_chain(back, logo, "cuda")
    t_chain = time.perf_counter() - t0
    launches = ck.launches
    log(f"grid: GridSession upload + luminance + tint + compose on the card "
        f"{t_chain:.3f} s, {launches} compose launches")
    if launches != 3:
        raise AssertionError(f"grid: {launches} compose launches, "
                             f"expected 3")

    t0 = time.perf_counter()
    out_bytes = sess.to_jpeg(options=opt, restart_interval=BIG_RESTART)
    t_jpeg = time.perf_counter() - t0
    got = sess.to_image()
    t0 = time.perf_counter()
    host_bytes = codec.encode(got, options=opt,
                              restart_interval=BIG_RESTART)
    t_host_opt = time.perf_counter() - t0
    if out_bytes != host_bytes:
        raise AssertionError("grid: device-histogram tables give other "
                             "bytes than the host optimize pass")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables = sess.optimized_tables(BIG_RESTART)
    t_tables = time.perf_counter() - t0
    t0 = time.perf_counter()
    codec.encode(got, restart_interval=BIG_RESTART, preset_tables=tables)
    t_preset = time.perf_counter() - t0
    log(f"grid: to_jpeg(OPTIMIZE) {t_jpeg:.3f} s, {len(out_bytes)} B == "
        f"host OPTION_OPTIMIZE encode ({t_host_opt:.3f} s); device tables "
        f"{t_tables:.4f} s vs host optimize walk ~{t_host_opt - t_preset:.3f}"
        f" s (optimized encode {t_host_opt:.3f} s - preset-table encode "
        f"{t_preset:.3f} s)")

    p = composer.plan_placement(back, logo, mt.ALIGN_CENTER, 0, 0)
    cd = composer.compile_dropon(logo, back, p.blockoffset_x,
                                 p.blockoffset_y, p.crop_x, p.crop_y,
                                 p.crop_w, p.crop_h, device="cuda")
    t0 = time.perf_counter()
    ref = _grid_chain(back, logo, "cpu", compiled=cd).to_image()
    t_cpu = time.perf_counter() - t0
    inside = _footprint_masks(back, logo, mt.ALIGN_CENTER, 0, 0)
    differing, total = _compare_coefs(got, ref, inside, "grid")
    log(f"grid: card vs device=\"cpu\" chain ({t_cpu:.3f} s): identical "
        f"outside the footprint, {differing} of {total} footprint "
        f"coefficients differ (max 1)")

    def rounds(k):
        for _ in range(k):
            sess.effect("tint", cb_value=3, cr_value=-2)
            sess.effect("luminance", value=1)
            sess.effect("pixelate")
        sess.block_until_ready()

    rounds(1)
    t0 = time.perf_counter()
    rounds(EFFECT_ROUNDS)
    dt = time.perf_counter() - t0
    log(f"grid effects: {EFFECT_ROUNDS} rounds of tint+luminance+pixelate "
        f"on {mp:.2f} MP in {dt:.4f} s = {mp * EFFECT_ROUNDS / dt:.1f} MP/s")
    log(f"grid: peak device memory {torch.cuda.max_memory_allocated()} B")
    del sess
    return launches


# -- phase 8: the corpus runner and compose_batch ---------------------------

def _compare_outputs(card, cpu, inside, label):
    """Card vs CPU output files: coefficients within the bar, and bytes
    identical wherever the coefficients are."""
    from libmodjpeg_tpu_torch import codec

    differing = total = same = 0
    for name in sorted(card):
        a, b = codec.decode(card[name]), codec.decode(cpu[name])
        d, t = _compare_coefs(a, b, inside, f"{label} {name}")
        differing += d
        total += t
        if d == 0:
            if card[name] != cpu[name]:
                raise AssertionError(f"{label} {name}: same coefficients, "
                                     f"other bytes")
            same += 1
    if differing / total >= MAX_DIFF_SHARE:
        raise AssertionError(f"{label}: {differing}/{total} differ")
    log(f"{label}: card vs cpu identical outside the footprint; "
        f"{differing} of {total} footprint coefficients differ (max 1); "
        f"{same} of {len(card)} files byte-identical")


def phase_corpus(datas):
    import libmodjpeg_tpu_torch as mt
    from libmodjpeg_tpu_torch import codec
    from libmodjpeg_tpu_torch.corpus import CorpusConfig, run_corpus
    from libmodjpeg_tpu_torch.ops import compose_kernel as ck
    from libmodjpeg_tpu_torch.parallel import compose_batch

    src = os.path.join(WORK, "corpus_in")
    os.makedirs(src, exist_ok=True)
    for i, d in enumerate(datas):
        with open(os.path.join(src, f"f{i:03d}.jpg"), "wb") as f:
            f.write(d)
    png = f"{FIXTURES}/dropon.png"
    dropon = mt.read_dropon(png, device="cuda")
    place = (mt.ALIGN_BOTTOM | mt.ALIGN_RIGHT, *PLACE_OFFSET)
    align, ox, oy = place
    inside = _footprint_masks(codec.decode(datas[0]), dropon, *place)
    routes = {"stream": [], "effects": [("luminance", (12,))]}
    launches = 0
    for route, effects in routes.items():
        outs = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(WORK, f"corpus_{route}_{dev}")
            cfg = CorpusConfig(inputs=[src], output_dir=out,
                               dropon_path=png, align=align, offset_x=ox,
                               offset_y=oy, effects=effects, batch_size=BATCH)
            torch.cuda.synchronize()
            before = ck.launches
            s = run_corpus(cfg, device=dev)
            torch.cuda.synchronize()
            if dev == "cuda":
                launches += ck.launches - before
            log(f"corpus {route} {dev}: {s['files_done']} done, "
                f"{s['files_failed']} failed, {s['mp_per_s']} MP/s, "
                f"wall {s['wall_s']} s, stages {s['stage_s']}"
                + (f", paths {s['stream_paths']}" if "stream_paths" in s
                   else ""))
            if s["files_failed"] or s["files_done"] != len(datas):
                raise AssertionError(f"corpus {route} {dev}: {s}")
            outs[dev] = {n: open(os.path.join(out, n), "rb").read()
                         for n in sorted(os.listdir(out))
                         if n.endswith(".jpg")}
            if route == "stream" and dev == "cuda":
                cfg.resume = True
                r = run_corpus(cfg, device=dev)
                log(f"corpus resume: {r['files_done']} done, "
                    f"{r['skipped_resume']} skipped")
                if r["files_done"] or r["skipped_resume"] != len(datas):
                    raise AssertionError(f"corpus resume: {r}")
        _compare_outputs(outs["cuda"], outs["cpu"], inside,
                         f"corpus {route}")
        if route == "stream":
            for name, blob in outs["cuda"].items():
                x = codec.decode(datas[int(name[1:4])])
                y = codec.decode(blob)
                for c, m in enumerate(inside):
                    if not np.array_equal(x.coefs[c][~m], y.coefs[c][~m]):
                        raise AssertionError(f"corpus stream {name}: "
                                             f"untouched coefficients moved")
    log(f"corpus: {launches} compose launches on the card")
    if launches == 0:
        raise AssertionError("corpus never launched the kernel")

    images = [codec.decode(d) for d in datas[:N_COMPOSE_BATCH]]
    torch.cuda.synchronize()
    ck.launches = 0
    batched = compose_batch(images, dropon, *place, device="cuda")
    batch_launches = ck.launches
    singles = [mt.compose(im, dropon, *place, device="cuda")
               for im in images]
    for i, (a, b) in enumerate(zip(batched, singles)):
        for c in range(a.num_components):
            if not np.array_equal(a.coefs[c], b.coefs[c]):
                raise AssertionError(f"compose_batch image {i} component "
                                     f"{c} differs from a single compose")
    log(f"compose_batch: {N_COMPOSE_BATCH} images identical to single "
        f"compose calls on the card; {batch_launches} compose launches")
    if batch_launches != images[0].num_components:
        raise AssertionError("compose_batch: expected one launch per "
                             "component")
    return launches, batch_launches


# -- phase 9: betterjpeg on a whole 24 MP frame ----------------------------

def write_png(path, rgb):
    """RGB uint8 [H, W, 3] -> an 8-bit RGB PNG, filter type 0 on every row
    (the standard library only: the card's machine has no PIL)."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                + chunk(b"IEND", b""))


def _bj_edits(pix, rng):
    """Three retouching edits on a copy of ``pix``, placed in proportion to
    the frame; on 6000x4000: a 1200x800 patch of uniform noise at (2400,
    1600), a flat (16, 16, 16) redaction box of 320x240 at (240, 3600), and
    a 3-pixel-wide white diagonal stroke across the whole frame (many MCUs
    touched sparsely, partial chroma masks)."""
    h, w, _ = pix.shape
    e = pix.copy()
    e[2 * h // 5:3 * h // 5, 2 * w // 5:3 * w // 5] = rng.randint(
        0, 256, (3 * h // 5 - 2 * h // 5, 3 * w // 5 - 2 * w // 5, 3))
    y, x = 9 * h // 10, w // 25
    e[y:y + 6 * h // 100, x:x + 4 * w // 75] = 16
    rows = np.arange(h)
    for k in range(-1, 2):
        e[rows, np.clip(rows * w // h + k, 0, w - 1)] = 255
    return e


def _edited_mcus(img, changed):
    """Per component, True on the blocks of every MCU that holds a changed
    pixel."""
    s = img.sampling
    mh, mw = 8 * s.max_v_samp, 8 * s.max_h_samp
    h, w = changed.shape
    mcus = changed.reshape(h // mh, mh, w // mw, mw).any(axis=(1, 3))
    return [np.kron(mcus, np.ones((ci.v_samp, ci.h_samp), bool))
            for ci in img.components]


def _bj_compose_breakdown(img, dropon):
    """Replays the compose step of a betterjpeg run piece by piece on the
    card (the same BatchComposer calls mt.compose makes) to show where its
    time goes; then holds the Y launch, at its real operands, against its
    plain version."""
    import libmodjpeg_tpu_torch as mt
    from libmodjpeg_tpu_torch import composer
    from libmodjpeg_tpu_torch.ops import compose_kernel as ck
    from libmodjpeg_tpu_torch.ops.compose import mask_pix_np
    from libmodjpeg_tpu_torch.parallel import batch as tbatch

    tl = mt.ALIGN_TOP | mt.ALIGN_LEFT
    t0 = time.perf_counter()
    p = composer.plan_placement(img, dropon, tl, 0, 0)
    cd = composer.compile_dropon(dropon, img, p.blockoffset_x,
                                 p.blockoffset_y, p.crop_x, p.crop_y,
                                 p.crop_w, p.crop_h, device="cuda")
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    for w in cd.alpha_weights:
        mask_pix_np(w)
    t_mask = time.perf_counter() - t0
    t0 = time.perf_counter()
    bc = tbatch.BatchComposer(img, dropon, tl, 0, 0, device="cuda",
                              compiled=cd)
    t_setup = time.perf_counter() - t0
    origins = bc._region_origins()
    regions = [[img.coefs[c][r0:r0 + h, c0:c0 + w]
                for c, (r0, c0, h, w) in enumerate(origins)]]
    quants = [[img.quant_table_for(c) for c in range(len(origins))]]
    log(f"betterjpeg compose, replayed: footprint {bc._meta} blocks per "
        f"component; compile_dropon {t_compile:.3f} s (of which host "
        f"mask_pix_np {t_mask:.3f} s when run alone), BatchComposer setup "
        f"{t_setup:.3f} s")

    flat = np.concatenate([np.asarray(r, np.int16).reshape(1, -1)
                           for r in regions[0]], axis=1)
    exc_up = int((flat != np.clip(flat, -128, 127)).sum())
    t0 = time.perf_counter()
    packed = tbatch._wirepack(flat)
    t_wire = time.perf_counter() - t0
    wire = ("int16 (raw)" if packed is None else
            f"int8 + exceptions (cap {packed[1].shape[1]})")
    cap = bc._down_cap
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = bc._pack_regions(regions, quants)
    t_dispatch = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts = bc._unpack_regions(pending)
    t_unpack = time.perf_counter() - t0
    out = np.concatenate([a.reshape(1, -1) for a in parts], axis=1)
    exc_down = int((out != np.clip(out, -128, 127)).sum())
    refetched = int(exc_down > cap)
    dev, _down, raw, _event, _keep = pending[0][0]
    t0 = time.perf_counter()
    bc._fetch_rows(dev, raw, np.arange(1))
    t_refetch = time.perf_counter() - t0
    log(f"betterjpeg row: {flat.shape[1]} coefficients; uplink "
        f"{exc_up} exceptions ({exc_up / flat.shape[1]:.4%}), wire {wire}, "
        f"_wirepack {t_wire:.3f} s on the host; _pack_regions (pack + "
        f"pinned upload + dispatch) {t_dispatch:.3f} s; downlink "
        f"{exc_down} exceptions against capacity {cap}: {refetched} row "
        f"refetched ({raw.numel() * raw.element_size()} B); "
        f"_unpack_regions {t_unpack:.3f} s, of which a refetch alone "
        f"{t_refetch:.3f} s")

    # the device step piece by piece (CUDA events, 5 calls each)
    dd = bc._dev
    up = [torch.from_numpy(a).cuda() for a in (packed or (flat,))]
    qstack = torch.from_numpy(np.concatenate(
        [np.asarray(q, np.int32).reshape(1, 64) for q in quants[0]],
        axis=1)).cuda()
    body_in = tbatch._restore_uplink(*up) if packed else up[0]
    body_out = tbatch._compose_body(bc._meta, body_in, qstack, dd.drops,
                                    dd.masks)
    steps = {
        "_restore_uplink": (lambda: tbatch._restore_uplink(*up)
                            if packed else None),
        "_compose_body (3 launches)": lambda: tbatch._compose_body(
            bc._meta, body_in, qstack, dd.drops, dd.masks),
        "_pack_down": lambda: tbatch._pack_down(body_out, cap),
    }
    step_ms = {k: _time_ms(f, (), 5) for k, f in steps.items()}
    log("betterjpeg device step: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in step_ms.items()))

    # the Y launch at its real operands (one row of (1, hw) blocks, the
    # frame's quant table, the whole-frame dropon and mask) against its
    # plain version
    n = bc._meta[0]
    region = torch.from_numpy(np.array(regions[0][0], np.int16).reshape(
        1, 1, n, 64)).cuda()
    q = torch.from_numpy(np.asarray(quants[0][0], np.int32).reshape(
        1, 64)).cuda()
    ops = (region, q, dd.drops[0], dd.masks[0])
    got = ck.compose_rows_cuda(*ops)
    ref = ck.compose_rows_ref(*ops)
    zero = (dd.masks[0] == 0).all(dim=1)
    if not torch.equal(got[0, 0][zero], region[0, 0][zero]):
        raise AssertionError("betterjpeg Y launch: zero-mask blocks moved")
    err, share = _check_rows(got.cpu().numpy(), ref.cpu().numpy(),
                             "betterjpeg Y launch")
    p1 = _time_ms(ck.compose_rows_ref, ops, 10)
    k1 = _time_ms(ck.compose_rows_cuda, ops, 10)
    k2 = _time_ms(ck.compose_rows_cuda, ops, 10)
    p2 = _time_ms(ck.compose_rows_ref, ops, 10)
    nbytes, flops = _rows_cost(1, n)
    bound, by = _bound(nbytes, flops)
    log(f"betterjpeg Y launch (R, hw)=(1, {n}): {int(zero.sum())} zero-mask "
        f"blocks exact; vs plain on the card max|d|={err} "
        f"differing={share:.6f}; kernel {k1:.4f}/{k2:.4f} ms, plain "
        f"{p1:.4f}/{p2:.4f} ms; bound {bound:.4f} ms ({by}), "
        f"{bound / ((k1 + k2) / 2):.1%} of the bound")


def phase_betterjpeg():
    import contextlib
    import io

    from libmodjpeg_tpu_torch import codec
    from libmodjpeg_tpu_torch.encode_pixels import from_pixels
    from libmodjpeg_tpu_torch.ops import compose_kernel as ck
    from libmodjpeg_tpu_torch.pixels import to_pixels
    from libmodjpeg_tpu_torch.scripts import betterjpeg

    os.makedirs(WORK, exist_ok=True)
    rng = np.random.RandomState(BJ_QUALITY)
    t_phase = t0 = time.perf_counter()
    src = os.path.join(WORK, "bj_in.jpg")
    with open(src, "wb") as f:
        f.write(codec.encode(from_pixels(
            make_test_image(rng, BJ_W, BJ_H), quality=BJ_QUALITY,
            subsampling="420", device="cuda")))
    with open(src, "rb") as f:
        img = codec.decode(f.read())
    log(f"betterjpeg input: {BJ_W}x{BJ_H} 4:2:0 q{BJ_QUALITY}, "
        f"{os.path.getsize(src)} B, made in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    pix = to_pixels(img, device="cuda")
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    pix_cpu = to_pixels(img, device="cpu")
    t_cpu = time.perf_counter() - t0
    n = int((pix != pix_cpu).sum())
    if n:
        raise AssertionError(f"betterjpeg: to_pixels card vs cpu: {n} "
                             f"samples differ")
    log(f"betterjpeg: to_pixels on the card == on the cpu, all {pix.size} "
        f"samples (card {t_card:.3f} s, cpu {t_cpu:.3f} s)")

    edited = _bj_edits(pix, rng)
    paths = {"edited": os.path.join(WORK, "bj_edited.png"),
             "same": os.path.join(WORK, "bj_same.png")}
    write_png(paths["edited"], edited)
    write_png(paths["same"], pix)
    changed, dropon = betterjpeg.edit_dropon(pix, edited)
    inside = _edited_mcus(img, changed)
    y_blocks = int(changed.reshape(BJ_H // 8, 8, BJ_W // 8, 8).any(
        axis=(1, 3)).sum())
    mcus = int(inside[1].sum())
    log(f"betterjpeg edit: {changed.mean():.4%} of pixels changed; "
        f"{mcus} of {inside[1].size} MCUs touched; {y_blocks} Y blocks + "
        f"{2 * mcus} chroma blocks hold a changed pixel")

    outs, launches, peak = {}, 0, 0
    for dev in ("cuda", "cpu"):
        out = os.path.join(WORK, f"bj_out_{dev}.jpg")
        stages = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.launches = 0
        t0 = time.perf_counter()
        rc = betterjpeg.main([src, paths["edited"], out], device=dev,
                             timings=stages)
        wall = time.perf_counter() - t0
        launched = ck.launches
        if dev == "cuda":
            launches, peak = launched, torch.cuda.max_memory_allocated()
        log(f"betterjpeg {dev}: rc={rc} {wall:.3f} s, stages "
            + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
            + f"; {launched} compose launches")
        if rc != 0:
            raise AssertionError(f"betterjpeg {dev} returned {rc}")
        want = 3 if dev == "cuda" else 0
        if launched != want:
            raise AssertionError(f"betterjpeg {dev}: {launched} compose "
                                 f"launches, expected {want}")
        with open(out, "rb") as f:
            outs[dev] = codec.decode(f.read())
    log(f"betterjpeg: peak device memory of the card run {peak} B")

    for dev, out in outs.items():
        for c, m in enumerate(inside):
            if not np.array_equal(out.coefs[c][~m], img.coefs[c][~m]):
                raise AssertionError(f"betterjpeg {dev}: blocks outside the "
                                     f"edited MCUs moved (component {c})")
    differing, total = _compare_coefs(outs["cuda"], outs["cpu"], inside,
                                      "betterjpeg")
    log(f"betterjpeg: both outputs identical to the input outside the "
        f"edited MCUs; card vs cpu {differing} of {total} coefficients "
        f"inside differ (max 1)")

    same_out = os.path.join(WORK, "bj_same_out.jpg")
    buf = io.StringIO()
    ck.launches = 0
    with contextlib.redirect_stdout(buf):
        rc = betterjpeg.main([src, paths["same"], same_out], device="cuda")
    if rc != 0 or not buf.getvalue().startswith("no changes detected"):
        raise AssertionError(f"betterjpeg no-change run: rc={rc} "
                             f"{buf.getvalue()!r}")
    if ck.launches:
        raise AssertionError(f"betterjpeg no-change run launched "
                             f"{ck.launches} times")
    with open(same_out, "rb") as f:
        same = codec.decode(f.read())
    for a, b in zip(same.coefs, img.coefs):
        if not np.array_equal(a, b):
            raise AssertionError("betterjpeg no-change run moved "
                                 "coefficients")
    log(f"betterjpeg no-change run: {buf.getvalue().strip()!r}, 0 launches, "
        f"coefficients identical to the input")

    _bj_compose_breakdown(img, dropon)
    log(f"betterjpeg phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 10: the port's bench and scaling bench ----------------------------

def phase_bench():
    from libmodjpeg_tpu_torch.ops import compose_kernel as ck
    from libmodjpeg_tpu_torch.scripts import bench, scaling_bench

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    ck.launches = 0
    r = bench.main([])   # prints its JSON line; raises if a lane's path fails
    launches = ck.launches
    windows = {k: len(v["windows"]) for k, v in r["spread"].items()}
    log(f"bench: {time.perf_counter() - t0:.1f} s, {launches} compose "
        f"launches, windows per lane {windows}")
    roof = r["kernel_roofline"]
    if not 0 < roof["frac"] <= 1.05:
        raise AssertionError(f"bench kernel_roofline frac {roof['frac']}")
    if len(windows) != 5 or set(windows.values()) != {5}:
        raise AssertionError(f"bench stream lanes: {windows}")
    grid = r["grid_effects"]
    if grid["rounds"] != EFFECT_ROUNDS or not grid["mp_s"] > 0:
        raise AssertionError(f"bench grid_effects: {grid}")
    if r["device"]["power_limit"] is None or r["blend_kernel"] != "cuda":
        raise AssertionError(f"bench device: {r['device']}")
    if launches == 0:
        raise AssertionError("the bench never launched the kernel")

    t0 = time.perf_counter()
    s = scaling_bench.main(["--images", str(SCALING_IMAGES)])
    scaling = sum(h["compose_launches"] for h in s["per_host_summaries"])
    log(f"scaling bench: {time.perf_counter() - t0:.1f} s, "
        f"{s['output_mismatches']} mismatches, {scaling} compose launches "
        f"in the two-host run")
    if s["output_mismatches"] or scaling == 0:
        raise AssertionError(f"scaling bench: {s}")
    return launches, scaling


def main():
    from concurrent.futures import ThreadPoolExecutor

    card = phase_environment()
    from libmodjpeg_tpu_torch.ops import compose_kernel as ck

    phase_build()
    max_err, times, differ = phase_kernel()
    blend_err, blend_times = phase_blend()
    with ThreadPoolExecutor(max_workers=max(2, os.cpu_count() or 2)) as pool:
        launches, corpus, step = phase_main_path(pool)
    bench = phase_kernel_bench()
    torch.cuda.synchronize()
    ck.launches = 0
    cli_launches = phase_cli()
    grid_launches = phase_grid_session()
    corpus_launches, batch_launches = phase_corpus(corpus)
    bj_launches = phase_betterjpeg()
    bench_launches, scaling_launches = phase_bench()
    # compose: one stream batch's launches (phase 4); blend: the kernel
    # bench's largest default size, inputs cold (phase 3b)
    k_ms, p_ms, nbytes, flops = step
    bound, by = _bound(nbytes, flops)
    bk_ms, bp_ms, bbound, bby = blend_times[TIMED_NS[-1]]
    log(card)
    print(json.dumps({"kernels": [{
        "name": "compose_rows",
        "route": "cuda",
        "source": "libmodjpeg_tpu_torch/csrc/compose.cu",
        "replaces": "libmodjpeg_tpu/ops/pallas_compose.py:105",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "shape": "one stream batch: its compose launches, (R, hw) = "
                 f"({BATCH}, each component's footprint blocks)",
        "differing_coefficients": list(differ),
        "by_shape": {f"{n}x{hw}{' opaque third' if o else ''}": {
            "ms": t[0], "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3]}
            for (n, hw, o), t in times.items()},
        "launches_by_path": {"watermark_stream": launches,
                             "kernel_bench": bench["compose"],
                             "cli": cli_launches,
                             "grid_session": grid_launches,
                             "corpus": corpus_launches,
                             "compose_batch": batch_launches,
                             "betterjpeg": bj_launches,
                             "bench": bench_launches,
                             "scaling_bench": scaling_launches},
    }, {
        "name": "blend_blocks",
        "route": "cuda",
        "source": "libmodjpeg_tpu_torch/csrc/compose.cu",
        "replaces": "libmodjpeg_tpu/ops/pallas_compose.py:52",
        "launches": bench["blend"],
        "max_abs_err": blend_err,
        "ms": bk_ms,
        "plain_ms": bp_ms,
        "bound_ms": bbound,
        "bound_by": bby,
        "library_ms": None,
        "shape": f"{TIMED_NS[-1]} blocks",
        "launches_by_path": {"kernel_bench": bench["blend"]},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
