"""A small copy of the benchmark in a temporary directory, for CPU runs:
the real harness, drivers, metrics and references, with tiny
configurations and the real traffic mixes and limits."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY = {
    "wm": {"width": 256, "height": 120, "quality": 85, "texture": 8,
           "precision": "float32",
           "logo": {"width": 64, "height": 32},
           "placement": {"align": ["BOTTOM", "RIGHT"], "offset_x": -8,
                         "offset_y": -8},
           "effects": [], "output": {"optimize": False,
                                     "restart_interval": 0},
           "corpus_files": 6},
    "fx": {"width": 512, "height": 256, "quality": 90, "texture": 8,
           "precision": "float32",
           "logo": {"width": 96, "height": 32},
           "placement": {"align": ["CENTER"], "offset_x": 0, "offset_y": 0},
           "effects": [["grayscale"], ["luminance", 60], ["tint", 25, 0],
                       ["pixelate"]],
           "output": {"optimize": True, "restart_interval": 4},
           "corpus_files": 2},
}
CELLS = {"wm.stream-baseline": ("wm", "stream-baseline"),
         "wm.stream-progressive": ("wm", "stream-progressive"),
         "wm.single-call": ("wm", "single-call"),
         "fx.grid-chain": ("fx", "grid-chain")}
# the real cells each tiny cell stands for (their limits are used)
REAL = {"wm.stream-baseline": "wm1080.stream-baseline",
        "wm.stream-progressive": "wm1080.stream-progressive",
        "wm.single-call": "wm1080.single-call",
        "fx.grid-chain": "fx100mp.grid-chain"}
# the real cell whose metrics each tiny cell reports: the band-splice
# stream (whose traffic and limits stay in benchmark/ while the cell is out
# of BENCHMARK.json) reports what the other stream cell does
METRICS_OF = dict(REAL, **{"wm.stream-baseline":
                           "wm1080.stream-progressive"})


def tiny_bench(tmp: str) -> str:
    """A checkout-like root under ``tmp`` holding BENCHMARK.json and a copy
    of benchmark/ with the tiny configurations; returns the root."""
    root = os.path.join(tmp, "root")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__",
                                                  "native"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for name, cfg in TINY.items():
        with open(os.path.join(root, "benchmark", "configs",
                               f"{name}.json"), "w") as f:
            json.dump(cfg, f)
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                          "why": "tiny"} for n, (c, t) in CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [n for n in CELLS
                              if METRICS_OF[n] in m["workloads"]]
    for n in CELLS:
        shutil.copy(os.path.join(BENCH, "limits", f"{REAL[n]}.json"),
                    os.path.join(root, "benchmark", "limits", f"{n}.json"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root
