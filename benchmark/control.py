"""The control of the output check: the plain reference put in the
program's place and computed in TF32 (the nearest precision below the
configuration's float32, the step a tensor-core blend would take), judged
by the same numbers as the program, on every distinct input of a cell at
the cell's own size:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--device cuda]

Prints one JSON line per seed with the control's numbers, ``tf32`` (the
operands rounded to TF32 by the reference itself) and ``tf32_hw`` (the
float32 reference on the card with PyTorch's TF32 matmuls allowed), and
the cell's limits.  A limit sound for the program has to be failed here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check, harness  # noqa: E402


def readings(ctx, precision: str, device, allow_tf32: bool = False) -> dict:
    """The check's numbers for the reference at ``precision`` on ``device``
    against the float32 reference on the host."""
    import torch

    ref = check.Judge(ctx.config, ctx.files, ctx.logo)
    ctl = check.Judge(ctx.config, ctx.files, ctx.logo, precision, device)
    tot = {"outside_diff": 0, "foot_beyond_1": 0, "foot_diff": 0,
           "foot_total": 0}
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        for j in range(len(ctx.files)):
            img, want = ref.expected(j)
            _, got = ctl.expected(j)
            for k, v in check.compare_planes(got, want,
                                             ref.footprints(img)).items():
                tot[k] += v
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return {"outside_diff": tot["outside_diff"],
            "foot_beyond_1": tot["foot_beyond_1"],
            "foot_diff_share": tot["foot_diff"] / tot["foot_total"],
            "foot_total": tot["foot_total"]}


def main(argv=None, bench=None) -> list:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = bench or harness.Bench()
    cell = bench.cell(args.workload)
    out = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = harness.Ctx(cell, seed, False, args.device)
        ctx.make_inputs()
        line = {"workload": args.workload, "seed": seed,
                "files": len(ctx.files),
                "tf32": readings(ctx, "tf32", ctx.device)}
        if ctx.device.type == "cuda":
            line["tf32_hw"] = readings(ctx, "f32", ctx.device, True)
        line["limits"] = cell["limits"]
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == "__main__":
    main()
