"""The benchmark's harness: finds a cell's pieces by name, runs it once and
prints its result.

Everything a cell is made of is a file found by name, so a later change
adds files and edits none:

- ``BENCHMARK.json`` (the checkout's root): cells, metrics, bounds;
- ``benchmark/configs/<config>.json``: the deployment (geometry, quality,
  logo, placement, effects, output coding, corpus size);
- ``benchmark/traffic/<traffic>.json``: the traffic mix (its ``driver``,
  the input coding, the caller model);
- ``benchmark/drivers/<driver>.py``: one way of driving the program, with
  ``setup(ctx)``, ``window(ctx, state, rec)``, ``release(state)``;
- ``benchmark/metrics/<metric>.py``: one reader per metric, ``read(rec)``
  returning a number or None (nothing to read: the metric is left out);
- ``benchmark/limits/<workload>.json``: the limit of each number that
  decides ``correct`` (check.py).

A run: check the card, make the inputs from ``--seed``, let the driver set
the program up and warm it, measure for ``--seconds``, free the program's
state, judge the answers against the plain reference, read the metrics,
refuse if JAX or the JAX package was loaded by then, print the info line,
the numbers compared (the last lines of standard error) and the result (the
last line of standard output).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
BANNED = ("jax", "jaxlib", "flax", "libmodjpeg_tpu")


def banned_loaded() -> list:
    """Top-level names in sys.modules that the benchmark may not load,
    compared whole (libmodjpeg_tpu_torch is not libmodjpeg_tpu)."""
    return sorted({k.split(".")[0] for k, v in list(sys.modules.items())
                   if v is not None and k.split(".")[0] in BANNED})


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """BENCHMARK.json and the files it names, under ``root``."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.spec = _load_json(os.path.join(root, "BENCHMARK.json"))
        self._modules: dict = {}

    def path(self, *parts) -> str:
        return os.path.join(self.root, "benchmark", *parts)

    def module(self, kind: str, name: str):
        """benchmark/<kind>/<name>.py, loaded once."""
        key = (kind, name)
        if key not in self._modules:
            path = self.path(kind, f"{name}.py")
            modname = f"_bench_{kind}_{name}".replace(".", "_").replace(
                "-", "_")
            spec = importlib.util.spec_from_file_location(modname, path)
            if spec is None or not os.path.exists(path):
                raise FileNotFoundError(f"no {kind} file for {name!r}: "
                                        f"{path}")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def cell(self, workload: str) -> dict:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        w = cells[workload]
        config = _load_json(self.path("configs", f"{w['config']}.json"))
        traffic = _load_json(self.path("traffic", f"{w['traffic']}.json"))

        def mine(m):
            return "workloads" not in m or workload in m["workloads"]

        return {
            "name": workload, "chips": w["chips"],
            "config": dict(config, name=w["config"]),
            "traffic": dict(traffic, name=w["traffic"]),
            "end_to_end": [m for m in self.spec["end_to_end"] if mine(m)],
            "per_layer": [m for m in self.spec["per_layer"] if mine(m)],
            "limits": _load_json(self.path("limits", f"{workload}.json")),
        }


class Ctx:
    """What a driver gets: the cell, the seed, the device, the inputs
    made from the seed, spans, the deadline and a log on stderr."""

    def __init__(self, cell: dict, seed: int, trace: bool, device):
        import torch

        from .trace import Tracer

        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.seed = seed
        self.trace = trace
        self.device = torch.device(device)
        self.tracer = Tracer(trace, self.device)
        self.deadline = None
        self.files: list = []
        self.logo = None

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def span(self, name: str):
        return self.tracer.span(name)

    def make_inputs(self) -> None:
        """The cell's distinct input files and logo pixels, from the seed,
        by the benchmark's own generator and coder (nothing of the
        program); then the device's peak-memory count starts afresh."""
        import torch

        from . import coder, inputs

        cfg, mix = self.config, self.traffic
        coding = mix["input"]
        w, h = cfg["width"], cfg["height"]
        chunk = max(1, int(64e6 // (w * h)))
        self.files = inputs.jpeg_files(
            self.seed, cfg["corpus_files"], w, h, cfg["quality"],
            cfg["texture"],
            coder.OPTION_PROGRESSIVE if coding["progressive"] else 0,
            coding["restart_interval"], self.device, chunk=chunk)
        lw, lh = cfg["logo"]["width"], cfg["logo"]["height"]
        self.logo = inputs.logo_pixels(self.seed, lw, lh)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def occurrence(self, j: int, spread: int = 3) -> int:
        """Which answer to input ``j`` (0 = the first in the window) is
        checked in full, drawn from the seed."""
        from .inputs import substream

        return int(np.random.default_rng(substream(self.seed, 100 + j))
                   .integers(0, spread))

    def dropon(self):
        """The logo as the program's Dropon (RGBA, per-pixel alpha)."""
        import libmodjpeg_tpu_torch as mt

        h, w = self.logo.shape[:2]
        return mt.read_dropon_from_raw(self.logo, mt.COLORSPACE_RGBA, w, h)

    def placement(self) -> tuple:
        from .references.dct_compose import align_bits

        p = self.config["placement"]
        return align_bits(p["align"]), p["offset_x"], p["offset_y"]


def smi() -> dict:
    """The card's name, clocks, power and temperature from nvidia-smi."""
    fields = ("name", "clocks.sm", "clocks.mem", "power.draw", "power.limit",
              "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return {"error": str(e)}
    return dict(zip(fields, [v.strip() for v in out.split(",")]))


def cpu_seconds() -> float:
    """This process's CPU seconds (user + system)."""
    t = os.times()
    return t.user + t.system


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> tuple:
    """Run one cell once.  Returns (result dict, info dict, exit code);
    a result of None means print none."""
    import torch

    from . import check, coder

    cell = bench.cell(workload)
    ctx = Ctx(cell, seed, trace, device)
    driver = bench.module("drivers", cell["traffic"]["driver"])
    rec = {"cell": cell, "counters": {}, "starts": [], "ends": [],
           "pixels": [], "samples": [], "lengths": [], "attempted": 0}
    state = driver.setup(ctx)
    cuda = ctx.device.type == "cuda"
    info = {"workload": workload, "seed": seed, "seconds": seconds,
            "trace": int(trace), "cores": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)),
            "torch": torch.__version__, "smi_before": smi() if cuda else None}
    if cuda:
        torch.cuda.synchronize()
    error = None
    cpu0 = cpu_seconds()
    t0 = time.perf_counter()
    try:
        with ctx.tracer.window():  # a traced run starts the profiler first
            t0 = time.perf_counter()
            rec["setup_s"] = t0 - t_start
            ctx.deadline = t0 + seconds
            driver.window(ctx, state, rec)
    except Exception:  # the program failed: report it as not correct
        error = traceback.format_exc()
        ctx.log(error)
    rec["window_end"] = time.perf_counter()
    # cores' worth of CPU time the process used in the window (the
    # sandbox's /proc/stat reads zeros, so the machine's share is unknown)
    info["process_cores"] = (cpu_seconds() - cpu0) / (rec["window_end"] - t0)
    info["smi_after"] = smi() if cuda else None
    peak = torch.cuda.max_memory_allocated() if cuda else None
    driver.release(state)
    state = None
    if cuda:
        torch.cuda.empty_cache()

    from libmodjpeg_tpu_torch import _build

    info["nvcc_build_s"] = _build.last_build.get("seconds")
    info["coder_build_s"] = coder.last_build.get("seconds")
    info.update(rec["counters"].get("info", {}))
    rec["spans"] = ctx.tracer.spans
    rec["trace"] = None
    if trace and ctx.tracer.events is not None:
        from .trace import summarize

        rec["trace"] = summarize(ctx.tracer.events)
    completed = len(rec["ends"])
    judge = check.Judge(ctx.config, ctx.files, ctx.logo)
    values = judge.judge(rec["samples"], rec["lengths"], rec["attempted"],
                         completed)
    correct, checks = check.verdict(values, cell["limits"])
    correct = correct and error is None
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"] if cuda else 0,
           "memory_peak_bytes": peak}
    rec["device"] = dev
    specs = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in specs:
        try:
            v = bench.module("metrics", m["name"]).read(rec)
        except Exception:  # a reader that cannot read leaves its metric out
            ctx.log(f"metric {m['name']}: {traceback.format_exc()}")
            v = None
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": rec["attempted"],
              "failed": rec["attempted"] - completed, "metrics": metrics,
              "device": dev}
    if trace:
        t = rec["trace"] or {}
        dev["busy_s"] = t.get("busy_s")
        dev["window_s"] = t.get("window_s")
        if t.get("busy_s") is not None:
            result["breakdown"] = {"device_ops": t["device_ops"],
                                   "idle_gaps": t["idle_gaps"]}
    result["checks"] = checks
    # last, once the judge, the trace's summary and every metric's reader
    # have run: whatever any of them loaded is caught too
    found = banned_loaded()
    if found:
        ctx.log(f"refused: modules {found} were loaded")
        return None, info, 3
    return result, info, 0


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    import libmodjpeg_tpu_torch  # noqa: F401  (fails where the port is absent)

    result, info, code = run_cell(bench, args.workload, args.seed,
                                  args.seconds, bool(args.trace), "cuda",
                                  t_start)
    emit(result, info)
    return code


def emit(result, info) -> None:
    """The info line, the numbers compared (last lines of stderr), the
    result (last line of stdout).  A refused run (no result) prints its
    info line on stderr and nothing on stdout."""
    if result is None:
        print(json.dumps({"info": info}), file=sys.stderr, flush=True)
        return
    print(json.dumps({"info": info}), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
