"""Host-scaling efficiency of the port's corpus runner (the counterpart of
the JAX package's scripts/scaling_bench.py, with its keys).

    python -m libmodjpeg_tpu_torch.scripts.scaling_bench [--images 24] \
        [--mp-each 2.0] [--device cuda|cpu]

The corpus path shards files over hosts with no traffic between them
(disjoint index shards, one manifest per host), so per-host throughput must
not fall when the fleet doubles.  Measured with OS processes, each pinned
to one core with ``os.sched_setaffinity``:

  run A: 1 corpus process                              -> MP/s baseline
  run B: 2 processes, --hosts 2 --host-id {0,1}, same corpus
                                                       -> aggregate MP/s
  run C: 2 independent single-host runs at once (the control: the same
         contention, no sharding)

  efficiency = aggregate_B / (2 * baseline_A)

A and B are the better of two runs each.  Every process runs the corpus
CLI (``corpus.main(argv, device=)``: dropon tests/fixtures/dropon.png at
the bottom right, luminance 35, batch 8) on ``--device``; on the card both
processes of B and C share the one GPU (``workers_per_card``).  The
outputs of A and B must be byte-identical.  Prints one JSON line and
returns it as a dict.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from .. import constants as C
from ..codec import encode
from ..model import CoefImage, ComponentInfo, Sampling

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DROPON = os.path.join(REPO, "tests", "fixtures", "dropon.png")

# a worker: pin to one core, run the corpus CLI, then print its compose
# launch count on a line of its own after the runner's summary line
_WORKER = """
import json, os, sys
os.sched_setaffinity(0, {int(sys.argv[1])})
from libmodjpeg_tpu_torch import corpus
from libmodjpeg_tpu_torch.ops import compose_kernel
rc = corpus.main(sys.argv[3:], device=sys.argv[2])
print(json.dumps({"compose_launches": compose_kernel.launches}))
sys.exit(rc)
"""


def synth_corpus(outdir: str, n: int, mp_each: float) -> None:
    """n 4:2:0 JPEGs of about ``mp_each`` MP each, random low-frequency
    coefficients (seed 7)."""
    rng = np.random.RandomState(7)
    mcus_w = int(np.sqrt(mp_each * 1e6 * 1.5) // 16)
    mcus_h = int(mp_each * 1e6 // (mcus_w * 256))
    w, h = mcus_w * 16, mcus_h * 16
    for i in range(n):
        comps, coefs = [], []
        for c, (sh, sv) in enumerate([(2, 2), (1, 1), (1, 1)]):
            pw, ph = mcus_w * sh, mcus_h * sv
            a = np.zeros((ph, pw, 8, 8), np.int16)
            a[..., 0, 0] = rng.randint(-300, 300, (ph, pw))
            a[..., 0, 1] = rng.randint(-25, 25, (ph, pw))
            a[..., 1, 0] = rng.randint(-25, 25, (ph, pw))
            a[..., 1, 1] = rng.randint(-10, 10, (ph, pw))
            comps.append(ComponentInfo(c + 1, sh, sv, 0 if c == 0 else 1,
                                       pw, ph, pw, ph))
            coefs.append(a)
        img = CoefImage(
            width=w, height=h, jpeg_color_space=C.JCS_YCbCr,
            components=comps, coefs=coefs,
            quant_tables={0: np.full((8, 8), 6, np.uint16),
                          1: np.full((8, 8), 11, np.uint16)},
            sampling=Sampling(2, 2))
        with open(os.path.join(outdir, f"img{i:04d}.jpg"), "wb") as f:
            f.write(encode(img))


def run_host(core: int, device: str, indir: str, outdir: str, hosts: int,
             host_id: int) -> subprocess.Popen:
    env = dict(os.environ)
    env.pop("MJT_COORDINATOR", None)   # independent hosts: no group
    return subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(core), device,
         "--inputs", indir, "--out", outdir, "--dropon", DROPON,
         "--position", "br", "--luminance", "35", "--batch", "8",
         "--io-workers", "2", "--hosts", str(hosts),
         "--host-id", str(host_id)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO)


def collect(p: subprocess.Popen) -> dict:
    """The runner's summary, with the worker's compose launches."""
    out, err = p.communicate()
    if p.returncode != 0:
        raise RuntimeError(f"corpus worker exited {p.returncode}: "
                           f"{err.decode()[-3000:]}")
    lines = out.decode().splitlines()
    summary = json.loads(lines[-2])
    summary.update(json.loads(lines[-1]))
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=24)
    ap.add_argument("--mp-each", type=float, default=2.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cores = sorted(os.sched_getaffinity(0))
    core = [cores[0], cores[1 % len(cores)]]

    with tempfile.TemporaryDirectory() as td:
        indir = os.path.join(td, "in")
        os.makedirs(indir)
        synth_corpus(indir, args.images, args.mp_each)

        sa = sb = None
        for rep in range(2):
            out = os.path.join(td, f"a{rep}")
            t0 = time.perf_counter()
            s = collect(run_host(core[0], args.device, indir, out, 1, 0))
            wall = time.perf_counter() - t0
            if sa is None or s["mp_per_s"] > sa["mp_per_s"]:
                sa, wall_a, out_a = s, wall, out

            out = os.path.join(td, f"b{rep}")
            t0 = time.perf_counter()
            procs = [run_host(core[i], args.device, indir, out, 2, i)
                     for i in range(2)]
            s2 = [collect(p) for p in procs]
            wall = time.perf_counter() - t0
            if sb is None or sum(x["mp_per_s"] for x in s2) > \
                    sum(x["mp_per_s"] for x in sb):
                sb, wall_b, out_b = s2, wall, out

        # control: two independent single-host runs at once on the same two
        # cores (the same contention, no sharding logic): the gap between B
        # and C is the framework's multi-host overhead, the gap between A
        # and C the hardware's
        procs = [run_host(core[i], args.device, indir,
                          os.path.join(td, f"c{i}"), 1, 0) for i in range(2)]
        sc = [collect(p) for p in procs]

        mismatches = 0
        for name in sorted(os.listdir(out_a)):
            if not name.endswith(".jpg"):
                continue
            with open(os.path.join(out_a, name), "rb") as f1, \
                    open(os.path.join(out_b, name), "rb") as f2:
                if f1.read() != f2.read():
                    mismatches += 1
        mp_total = sa["megapixels"]
        # steady-state efficiency from the runners' own wall clocks; the
        # external wall also counts each process's start-up
        rate_a = sa["mp_per_s"]
        rate_b = sum(s["mp_per_s"] for s in sb)
        rate_c = sum(s["mp_per_s"] for s in sc) / 2
        result = {
            "images": args.images, "mp_total": mp_total,
            "single_host_mp_s": rate_a,
            "two_host_aggregate_mp_s": rate_b,
            "scaling_efficiency": rate_b / (2 * rate_a),
            "scaling_efficiency_incl_startup":
                (mp_total / wall_b) / (2 * mp_total / wall_a),
            "contended_control_mp_s_per_host": rate_c,
            "framework_efficiency_vs_control": rate_b / (2 * rate_c),
            "single_host_wall_s": wall_a,
            "two_host_wall_s": wall_b,
            "per_host_summaries": sb,
            "output_mismatches": mismatches,
            "device": args.device,
            "cores": core,
            "workers_per_card": 2 if args.device == "cuda" else None,
        }
    print(json.dumps(result), flush=True)
    if mismatches:
        raise AssertionError(f"{mismatches} outputs differ between one host "
                             f"and two")
    return result


if __name__ == "__main__":
    main()
