"""The benchmark's own host spans, and the reduction of a torch.profiler
trace of the measured window to device busy time, kernel time, the
heaviest device operations and the longest idle gaps.

Spans are recorded around the calls the benchmark makes into the program
(never inside it), always on the host clock and, in a traced run, also as
profiler annotations so that an idle gap on the device can be labelled by
the span open on the host at the time.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 160  # kernel names carry whole template signatures


class Tracer:
    """Spans on the host clock; with ``enabled``, a torch.profiler trace
    (CPU and, on a card, CUDA activity) over ``window()``."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.cuda = device.type == "cuda"
        self.spans: list = []          # (name, start, end), perf_counter s
        self._prof = None
        self.events: list | None = None

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self._prof is not None:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.spans.append((name, t0, time.perf_counter()))

    @contextlib.contextmanager
    def window(self):
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        try:
            with self.span("window"):
                yield
                if self.cuda:
                    torch.cuda.synchronize()
        finally:
            if self._prof is not None:
                prof, self._prof = self._prof, None
                prof.__exit__(None, None, None)
                with tempfile.TemporaryDirectory() as d:
                    path = os.path.join(d, "trace.json")
                    prof.export_chrome_trace(path)
                    with open(path) as f:
                        data = json.load(f)
                events = (data.get("traceEvents", [])
                          if isinstance(data, dict) else data)
                self.events = [e for e in events if e.get("ph") == "X"]


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> dict | None:
    """Reduce the window's trace events: {"window_s", "busy_s", "kernel_s",
    "device_ops", "idle_gaps"}, or None when the trace holds no
    window annotation.  busy_s is None when no device activity was
    recorded (a CPU run, or a profiler that saw no card)."""
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    wins = [e for e in ann if e.get("name") == "window"]
    if not wins:
        return None
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    dev, kernel_s, by_name = [], 0.0, {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(w0, float(e["ts"]))
        b = min(w1, float(e["ts"]) + float(e.get("dur", 0.0)))
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
        if e["cat"] == "kernel":
            kernel_s += (b - a) * 1e-6
    out = {"window_s": (w1 - w0) * 1e-6, "busy_s": None, "kernel_s": None,
           "device_ops": [], "idle_gaps": []}
    if not dev:
        return out
    busy = _union(dev)
    out["busy_s"] = sum(b - a for a, b in busy) * 1e-6
    out["kernel_s"] = kernel_s
    out["device_ops"] = [[n[:NAME_CHARS], s] for n, s in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    labels = [e for e in ann if e is not wins[0]]
    out["idle_gaps"] = [[_label(labels, (a + b) / 2), (b - a) * 1e-6]
                        for a, b in gaps[:TOP]]
    return out


def _label(annotations, t: float) -> str:
    """The innermost benchmark span open at trace time ``t``."""
    best = None
    for e in annotations:
        a = float(e["ts"])
        if a <= t <= a + float(e["dur"]) and (
                best is None or float(e["dur"]) < float(best["dur"])):
            best = e
    return best["name"] if best is not None else "window"
