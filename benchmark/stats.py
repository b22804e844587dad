"""Arithmetic shared by the metric readers (metrics/<name>.py): window
rates and tails over every request, stage means, device idle share and
the compose's least bytes.  Every rate and tail is taken over all the
requests of the window, never from medians of chunks."""

from __future__ import annotations

import json
import os

import numpy as np

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


def latencies_ms(rec) -> np.ndarray:
    n = len(rec["ends"])
    return (np.asarray(rec["ends"]) - np.asarray(rec["starts"][:n])) * 1e3


def p95_ms(rec):
    lat = latencies_ms(rec)
    return float(np.percentile(lat, 95)) if lat.size else None


def span_s(rec) -> float | None:
    """From the first request taken to the last answer given."""
    if not rec["ends"]:
        return None
    return max(rec["ends"]) - min(rec["starts"])


def stream_stage_ms(rec, key: str):
    st = rec["counters"].get("stream")
    if not st or not st.get("batches"):
        return None
    return st[key] / st["batches"] * 1e3


def span_mean_ms(rec, name: str):
    d = [t1 - t0 for n, t0, t1 in rec["spans"] if n == name]
    return float(np.mean(d)) * 1e3 if d else None


def device_idle_pct(rec):
    t = rec.get("trace")
    if not t or t.get("busy_s") is None or not t["window_s"]:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0


def peak(kind: str, key: str):
    """The published peak ``key`` of the card named ``kind``, or None."""
    with open(PEAKS) as f:
        return json.load(f).get(kind, {}).get(key)
