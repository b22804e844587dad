"""Corpus runner: batch/multi-host watermarking with resume and metrics
(PyTorch port of libmodjpeg_tpu.corpus; BASELINE.json config-5).

* manifest journal (JSONL) with atomic append -> crash-safe resume
* per-file failure isolation + error journal
* host sharding by file index, MJT_NUM_HOSTS / MJT_HOST_ID or flags; works
  standalone or under torch.distributed (``init_distributed``)
* ragged-corpus bucketing: images group by geometry and quant tables so
  each bucket reuses one compiled dropon
* throughput metrics (MP/s, per-stage wall clock) + an optional
  torch.profiler Chrome trace (``trace_dir``)

The journal, metrics, input expansion and geometry key are copies of the
JAX package's.  The JAX runner's MJT_PLATFORM switch
and persistent XLA compile cache have no counterpart here: the device is
the ``device=`` keyword, and the compose kernel's build is cached in
``build/torch_kernels/`` by its source hash.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from . import constants as C
from .errors import ModJpegError
from .jpegio import read_jpeg, write_jpeg


@dataclasses.dataclass
class CorpusConfig:
    inputs: list
    output_dir: str
    dropon_path: Optional[str] = None
    mask_path: Optional[str] = None
    align: int = C.ALIGN_TOP | C.ALIGN_LEFT
    offset_x: int = 0
    offset_y: int = 0
    effects: list = dataclasses.field(default_factory=list)  # [(name, args)]
    encode_options: int = 0
    restart_interval: Optional[int] = None
    batch_size: int = 16
    io_workers: int = 4
    num_hosts: int = 1
    host_id: int = 0
    resume: bool = False
    max_pixel: int = 0
    trace_dir: Optional[str] = None
    max_failures: int = -1  # -1 = unlimited


class ManifestJournal:
    """Append-only JSONL journal; the durable artifact for resume."""

    def __init__(self, path: str, resume: bool):
        self.path = path
        self.done = {}
        if resume and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail write from a crash
                    if rec.get("status") == "done":
                        self.done[rec["input"]] = rec
        mode = "a" if resume else "w"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, mode)

    def record(self, rec: dict) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self):
        self._f.close()


class Metrics:
    def __init__(self):
        self.stages = {}
        self.megapixels = 0.0
        self.files_done = 0
        self.files_failed = 0
        self.t0 = time.perf_counter()

    def add(self, stage: str, dt: float):
        self.stages[stage] = self.stages.get(stage, 0.0) + dt

    def summary(self) -> dict:
        wall = time.perf_counter() - self.t0
        return {
            "files_done": self.files_done,
            "files_failed": self.files_failed,
            "megapixels": round(self.megapixels, 2),
            "wall_s": round(wall, 3),
            "mp_per_s": round(self.megapixels / wall, 2) if wall > 0 else 0.0,
            "stage_s": {k: round(v, 3) for k, v in self.stages.items()},
        }


def _expand_inputs(patterns) -> list:
    files = []
    for p in patterns:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, "*.jpg"))))
            files.extend(sorted(glob.glob(os.path.join(p, "*.jpeg"))))
        else:
            matched = sorted(glob.glob(p))
            files.extend(matched if matched else [p])
    return files


def _geometry_key(img) -> tuple:
    return (img.width, img.height,
            tuple((c.h_samp, c.v_samp) for c in img.components),
            tuple(sorted((t, tuple(tbl.reshape(-1)))
                         for t, tbl in img.quant_tables.items())))


def _out_path(cfg: CorpusConfig, inp: str) -> str:
    return os.path.join(cfg.output_dir, os.path.basename(inp))


def _failed(journal, metrics, path: str, stage: str, err: str) -> None:
    """Journal a file's failure at ``stage`` and count it."""
    journal.record({"input": path, "status": "error", "stage": stage,
                    "error": err})
    metrics.files_failed += 1


def _done(cfg, journal, metrics, path: str, mp: float) -> None:
    """Journal a file's written output of ``mp`` megapixels and count it."""
    journal.record({"input": path, "status": "done",
                    "output": _out_path(cfg, path), "mp": round(mp, 3)})
    metrics.files_done += 1
    metrics.megapixels += mp


@contextlib.contextmanager
def _trace(trace_dir, device, host_id: int):
    """torch.profiler over the run, written as a Chrome trace
    ``trace_h<host_id>.json`` into ``trace_dir``; nothing without one."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir,
                                          f"trace_h{host_id}.json"))


def run_corpus(cfg: CorpusConfig, device="cuda") -> dict:
    """Watermark and/or apply effects to a corpus on ``device``; returns
    the metrics summary.  Pure watermarking runs the streaming pipeline
    (_run_corpus_stream); effects need whole-coefficient access and run
    the batch loop."""
    from .dropon import read_dropon

    files = _expand_inputs(cfg.inputs)
    files = [f for i, f in enumerate(files)
             if i % cfg.num_hosts == cfg.host_id]
    os.makedirs(cfg.output_dir, exist_ok=True)
    journal = ManifestJournal(
        os.path.join(cfg.output_dir, f"manifest_h{cfg.host_id}.jsonl"),
        cfg.resume)
    metrics = Metrics()

    todo = [f for f in files if f not in journal.done]
    skipped = len(files) - len(todo)

    dropon = None
    if cfg.dropon_path:
        dropon = read_dropon(cfg.dropon_path, mask=cfg.mask_path,
                             blend=C.BLEND_FULL, device=device)
    with _trace(cfg.trace_dir, device, cfg.host_id):
        try:
            if dropon is not None and not cfg.effects:
                return _run_corpus_stream(cfg, todo, skipped, dropon,
                                          journal, metrics, device)
            _run_corpus_batches(cfg, todo, dropon, journal, metrics, device)
        finally:
            journal.close()
    s = metrics.summary()
    s["skipped_resume"] = skipped
    s["host_id"] = cfg.host_id
    s["num_hosts"] = cfg.num_hosts
    return s


def _run_corpus_batches(cfg: CorpusConfig, todo, dropon, journal, metrics,
                        device) -> None:
    """Decode -> compose (bucketed by geometry) -> effects -> encode, one
    batch of files at a time, each file's failure journaled on its own."""
    from . import effects as fx
    from .parallel.batch import BatchComposer

    composers = {}  # geometry key -> BatchComposer

    def decode_one(path):
        t0 = time.perf_counter()
        try:
            img = read_jpeg(path, max_pixel=cfg.max_pixel)
            return path, img, time.perf_counter() - t0, None
        except (ModJpegError, OSError) as e:
            return path, None, time.perf_counter() - t0, str(e)

    def encode_one(args):
        path, img = args
        t0 = time.perf_counter()
        try:
            write_jpeg(img, _out_path(cfg, path), options=cfg.encode_options,
                       restart_interval=cfg.restart_interval)
            return path, img.width * img.height / 1e6, \
                time.perf_counter() - t0, None
        except (ModJpegError, OSError) as e:
            return path, 0.0, time.perf_counter() - t0, str(e)

    with ThreadPoolExecutor(max_workers=cfg.io_workers) as pool:
        for i in range(0, len(todo), cfg.batch_size):
            chunk = todo[i:i + cfg.batch_size]
            t0 = time.perf_counter()
            decoded = list(pool.map(decode_one, chunk))
            metrics.add("decode", time.perf_counter() - t0)

            ok = []
            for path, img, dt, err in decoded:
                if err is not None:
                    _failed(journal, metrics, path, "decode", err)
                else:
                    ok.append((path, img))

            # bucket by geometry so each bucket shares one compiled dropon
            t0 = time.perf_counter()
            if dropon is not None and ok:
                buckets = {}
                for path, img in ok:
                    buckets.setdefault(_geometry_key(img), []).append(
                        (path, img))
                for key, members in buckets.items():
                    if key not in composers:
                        composers[key] = BatchComposer(
                            members[0][1], dropon, cfg.align, cfg.offset_x,
                            cfg.offset_y, device=device)
                    composers[key].compose_images([im for _, im in members])
            metrics.add("compose", time.perf_counter() - t0)

            t0 = time.perf_counter()
            if cfg.effects:
                processed = []
                for path, img in ok:
                    for name, args in cfg.effects:
                        img = getattr(fx, name)(img, *args, device=device)
                    processed.append((path, img))
                ok = processed
            metrics.add("effects", time.perf_counter() - t0)

            t0 = time.perf_counter()
            encoded = list(pool.map(encode_one, ok))
            metrics.add("encode", time.perf_counter() - t0)
            for path, mp, dt, err in encoded:
                if err is not None:
                    _failed(journal, metrics, path, "encode", err)
                else:
                    _done(cfg, journal, metrics, path, mp)
            if 0 <= cfg.max_failures < metrics.files_failed:
                raise RuntimeError(f"aborting: {metrics.files_failed} "
                                   f"failures exceeds limit")


def _run_corpus_stream(cfg: CorpusConfig, todo, skipped, dropon, journal,
                       metrics, device) -> dict:
    """Watermark-only corpus path on the streaming pipeline.

    Files are probed (header-only for sequential JPEGs, so surgical-eligible
    files are never fully decoded), bucketed by geometry, and each bucket
    streams through its BatchComposer's watermark_stream.  A failing bucket
    batch degrades to per-file processing so one bad file cannot take down
    its batch.
    """
    from . import codec
    from .surgical import parse_structure

    from .parallel.batch import BatchComposer

    stream_paths = {}       # "surgical"/"splice"/"mixed"/"full" -> files
    fallback_reasons = {}   # per-file fallback reason -> count
    composers = {}

    def load(path):
        """Read bytes + geometry probe (header-only when possible)."""
        try:
            with open(path, "rb") as f:
                data = f.read()
            st = parse_structure(data)
            if st is not None:
                if cfg.max_pixel and st.width * st.height > cfg.max_pixel:
                    return path, None, None, "image exceeds max_pixel limit"
                return path, data, st.geometry_key(), None
            img = codec.decode(data, max_pixel=cfg.max_pixel, nthreads=1)
            return path, data, _geometry_key(img), None
        except (ModJpegError, OSError, ValueError) as e:
            return path, None, None, str(e)

    def write_out(args):
        path, blob = args
        try:
            with open(_out_path(cfg, path), "wb") as f:
                f.write(blob)
            return path, None
        except OSError as e:
            return path, str(e)

    def stream(bc, datas, batch):
        return list(bc.watermark_stream(
            iter(datas), batch=batch, pool=pool, options=cfg.encode_options,
            restart_interval=cfg.restart_interval, max_pixel=cfg.max_pixel))

    with ThreadPoolExecutor(max_workers=cfg.io_workers) as pool:
        for i in range(0, len(todo), cfg.batch_size):
            chunk = todo[i:i + cfg.batch_size]
            t0 = time.perf_counter()
            loaded = list(pool.map(load, chunk))
            metrics.add("probe", time.perf_counter() - t0)

            buckets = {}
            for path, data, key, err in loaded:
                if err is not None:
                    _failed(journal, metrics, path, "probe", err)
                else:
                    buckets.setdefault(key, []).append((path, data))

            for key, members in buckets.items():
                mp_file = key[0] * key[1] / 1e6
                bc = composers.get(key)
                if bc is None:
                    bc = BatchComposer(codec.decode(members[0][1]), dropon,
                                       cfg.align, cfg.offset_x, cfg.offset_y,
                                       device=device)
                    composers[key] = bc
                t0 = time.perf_counter()
                try:
                    outs = stream(bc, [d for _, d in members],
                                  cfg.batch_size)
                except (ModJpegError, ValueError, OSError):
                    # a bad file poisoned the batch: isolate per file
                    metrics.add("stream", time.perf_counter() - t0)
                    for path, data in members:
                        t1 = time.perf_counter()
                        try:
                            blob = stream(bc, [data], 1)[0]
                            with open(_out_path(cfg, path), "wb") as f:
                                f.write(blob)
                            _done(cfg, journal, metrics, path, mp_file)
                        except (ModJpegError, ValueError, OSError) as e:
                            _failed(journal, metrics, path, "stream", str(e))
                        metrics.add("stream", time.perf_counter() - t1)
                    continue
                metrics.add("stream", time.perf_counter() - t0)
                t0 = time.perf_counter()
                written = list(pool.map(write_out,
                                        zip((p for p, _ in members), outs)))
                metrics.add("write", time.perf_counter() - t0)
                for path, err in written:
                    if err is not None:
                        _failed(journal, metrics, path, "write", err)
                    else:
                        _done(cfg, journal, metrics, path, mp_file)
                sp = getattr(bc, "last_stream_path", "full")
                stream_paths[sp] = stream_paths.get(sp, 0) + len(members)
                for r, n in getattr(bc, "last_fallback_reasons",
                                    {}).items():
                    fallback_reasons[r] = fallback_reasons.get(r, 0) + n
            if 0 <= cfg.max_failures < metrics.files_failed:
                raise RuntimeError(f"aborting: {metrics.files_failed} "
                                   f"failures exceeds limit")

    s = metrics.summary()
    s["skipped_resume"] = skipped
    s["host_id"] = cfg.host_id
    s["num_hosts"] = cfg.num_hosts
    s["pipeline"] = "stream"
    s["stream_paths"] = stream_paths
    s["surgical_fallbacks"] = fallback_reasons
    return s


def main(argv=None, device="cuda") -> int:
    """The corpus CLI (the flags of ``libmodjpeg_tpu.corpus``); runs on
    ``device``.  Joins a torch.distributed group first when MJT_COORDINATOR
    is set (init_distributed)."""
    from .parallel.session import init_distributed

    init_distributed()  # no-op unless MJT_COORDINATOR is configured

    ap = argparse.ArgumentParser(
        description="libmodjpeg_tpu_torch corpus runner (multi-host "
                    "watermarking)")
    ap.add_argument("--inputs", nargs="+", required=True,
                    help="input files, globs or directories")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--dropon", help="dropon image (PNG or JPEG)")
    ap.add_argument("--mask", help="JPEG mask for the dropon")
    ap.add_argument("--position", default="tl",
                    help="[t|b|c][l|r|c], like modjpeg -p")
    ap.add_argument("--offset", default="0,0")
    ap.add_argument("--luminance", type=int)
    ap.add_argument("--tint", help="cb,cr")
    ap.add_argument("--pixelate", action="store_true")
    ap.add_argument("--grayscale", action="store_true")
    ap.add_argument("--optimize", action="store_true")
    ap.add_argument("--progressive", action="store_true")
    ap.add_argument("--arithmetic", action="store_true")
    ap.add_argument("--restart-interval", type=int)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--io-workers", type=int, default=4)
    ap.add_argument("--hosts", type=int,
                    default=int(os.environ.get("MJT_NUM_HOSTS", "1")))
    ap.add_argument("--host-id", type=int,
                    default=int(os.environ.get("MJT_HOST_ID", "0")))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-pixel", type=int, default=0)
    ap.add_argument("--trace-dir")
    ap.add_argument("--max-failures", type=int, default=-1)
    args = ap.parse_args(argv)

    align = 0
    p = args.position
    if len(p) == 2:
        align |= {"t": C.ALIGN_TOP, "b": C.ALIGN_BOTTOM,
                  "c": C.ALIGN_CENTER}.get(p[0], 0)
        align |= {"l": C.ALIGN_LEFT, "r": C.ALIGN_RIGHT,
                  "c": C.ALIGN_CENTER}.get(p[1], 0)
    ox, _, oy = args.offset.partition(",")

    effects = []
    if args.luminance is not None:
        effects.append(("luminance", (args.luminance,)))
    if args.tint:
        cb, _, cr = args.tint.partition(",")
        effects.append(("tint", (int(cb or 0), int(cr or 0))))
    if args.pixelate:
        effects.append(("pixelate", ()))
    if args.grayscale:
        effects.append(("grayscale", ()))

    options = 0
    if args.optimize:
        options |= C.OPTION_OPTIMIZE
    if args.progressive:
        options |= C.OPTION_PROGRESSIVE
    if args.arithmetic:
        options |= C.OPTION_ARITHMETRIC

    cfg = CorpusConfig(
        inputs=args.inputs, output_dir=args.out, dropon_path=args.dropon,
        mask_path=args.mask, align=align, offset_x=int(ox or 0),
        offset_y=int(oy or 0), effects=effects, encode_options=options,
        restart_interval=args.restart_interval, batch_size=args.batch,
        io_workers=args.io_workers, num_hosts=args.hosts,
        host_id=args.host_id, resume=args.resume, max_pixel=args.max_pixel,
        trace_dir=args.trace_dir, max_failures=args.max_failures)
    summary = run_corpus(cfg, device=device)
    print(json.dumps(summary))
    return 0 if summary["files_failed"] == 0 else 2


if __name__ == "__main__":
    sys.exit(main())
