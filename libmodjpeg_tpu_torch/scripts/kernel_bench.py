"""On-card microbench: the hand-written blend kernel against its plain
PyTorch version, and the fused compose kernel.

    python -m libmodjpeg_tpu_torch.scripts.kernel_bench \
        [--sizes 16384 65536 131072] [--reps 5] [--chain 10]

Each timed call is a chain of ``--chain`` dependent blends (each blend's
output, scaled, is the next one's image operand), so the card runs them one
after another; ``--reps`` chains are timed together with CUDA events, behind
a device-side sleep that lets the host enqueue the whole window before it
starts, so host launch overhead stays out of the device time.  Per size it
prints one line:

    n=N: plain Tus/blend cuda Tus/blend fused Tus/compose [G GB/s = Rx
    the plain chain's P GB/s]  speedup xS

where G is the fused compose's traffic rate and P the plain chain's (three
f32 reads and one f32 write per coefficient per blend): the quantity that
the JAX package's scripts/kernel_bench.py calls its elementwise roofline.
The fused compose runs as the stream does: N blocks as 32 rows (one when
N is not a multiple of 32), one quant table per row, the dropon and mask
shared by the rows, so its traffic is the int16 region in and out.
It is a ratio of two measured rates, not a roofline share; a roofline
share needs the card's own measured peak, which this bench does not take.
It needs a CUDA GPU and raises without one; there is no CPU run.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.compose import blend_blocks_m
from ..ops.compose_kernel import blend_blocks_cuda, compose_rows_cuda

# bytes the fused compose moves per block: the int16 region in and out (the
# rows' quant tables and the shared dropon and mask are read once a launch)
BYTES_PER_BLOCK = (2 + 2) * 64


def chain(x1, x0, w, kind, r):
    """``r`` dependent blends of [N, 64] f32 operands; returns the sum of
    the last one (a 0-d tensor, not yet synchronised).  kind: "plain"
    (blend_blocks_m) or "cuda" (blend_blocks_cuda)."""
    n = x1.shape[0]
    acc = x1
    for i in range(r):
        xs = acc + i * 1e-6  # every blend depends on the one before
        if kind == "plain":
            y = blend_blocks_m(xs.reshape(n, 8, 8), x0.reshape(n, 8, 8),
                               w.reshape(n, 8, 8)).reshape(n, 64)
        elif kind == "cuda":
            y = blend_blocks_cuda(xs, x0, w)
        else:
            raise ValueError(f"unknown kind {kind!r}")
        acc = y * 0.999
    return acc.sum()


def chain_fused(region, q, x0, w, r):
    """``r`` dependent fused composes (int16 in/out incl. dequant and
    requant) of an int16 [rows, 1, hw, 64] region with one quant table per
    row and the [hw, 64] dropon and mask shared; returns the sum of the
    last one."""
    acc = region
    for i in range(r):
        xs = acc ^ (i % 2)  # every compose depends on the one before; int16
        acc = compose_rows_cuda(xs, q, x0, w)
    return acc.sum()


def _time_s(fn, reps):
    """Device seconds of ``reps`` calls of ``fn`` after one warm call."""
    float(fn())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # cycles: tens of ms at H100 clocks
    start.record()
    for _ in range(reps):
        v = fn()
    end.record()
    end.synchronize()
    float(v)
    return start.elapsed_time(end) / 1e3


def main(argv=None) -> dict:
    """Run the bench, print one line per size, and return
    {n: {"plain": s, "cuda": s, "fused": s}} in seconds per call."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[16384, 65536, 131072])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chain", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bench needs a CUDA GPU "
                           "(torch.cuda.is_available() is False)")

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    print("platform:", torch.cuda.get_device_name(dev), flush=True)
    results = {}
    for n in args.sizes:
        def put(a):
            return torch.from_numpy(a).to(dev)

        x1 = put((rng.randn(n, 64) * 300).astype(np.float32))
        x0 = put((rng.randn(n, 64) * 300).astype(np.float32))
        w = put((rng.rand(n, 64) * 0.9).astype(np.float32))
        times = {}
        line = f"n={n}:"
        for kind in ("plain", "cuda"):
            dt = _time_s(lambda: chain(x1, x0, w, kind, args.chain),
                         args.reps) / (args.reps * args.chain)
            times[kind] = dt
            line += f" {kind} {dt*1e6:.0f}us/blend"
        rows = 32 if n % 32 == 0 else 1
        hw = n // rows
        region = put(rng.randint(-900, 900, (rows, 1, hw, 64))
                     .astype(np.int16))
        q = put(rng.randint(1, 255, (rows, 64)).astype(np.int32))
        dt = _time_s(lambda: chain_fused(region, q, x0[:hw], w[:hw],
                                         args.chain),
                     args.reps) / (args.reps * args.chain)
        times["fused"] = dt
        gbps = BYTES_PER_BLOCK * n / dt / 1e9
        # plain chain traffic: 3 f32 reads + 1 f32 write per coefficient
        plain_gbps = 4 * 4 * n * 64 / times["plain"] / 1e9
        line += (f" fused {dt*1e6:.0f}us/compose [{gbps:.0f} GB/s"
                 f" = {gbps/plain_gbps:.2f}x the plain chain's"
                 f" {plain_gbps:.0f} GB/s]")
        line += f"  speedup x{times['plain']/times['cuda']:.2f}"
        print(line, flush=True)
        results[n] = times
    return results


if __name__ == "__main__":
    main()
