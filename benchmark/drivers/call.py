"""Driver ``call``: the one-image API, ``libmodjpeg_tpu_torch.watermark``,
called by one caller in a closed loop, one file at a time, over the
distinct files in order.

Set-up makes a few calls (the first builds and caches the composer, so
later calls reuse it, as a long-lived caller's would; every call has the
same shapes).  Each call is timed on the host clock from the call to its return.
The composer's ``last_stream_stats`` after each call are the program's
stage seconds for that call (read in the traced run only).  The stream
adds a batch's encode seconds only once the batch's outputs have all been
yielded, which a one-file call never reaches, so a traced run also times
the call's encode itself: a benchmark span around each call of the
program's ``codec.encode`` and ``codec.encode_splice_band``, put in place
for the window and taken away after it.
"""

from __future__ import annotations

import threading
import time

WARM_CALLS = 4
ENCODERS = ("encode", "encode_splice_band")


def _time_encodes(state) -> None:
    """Wrap the program's encoders so that their seconds add up in
    ``state["encode_spent"][0]``."""
    from libmodjpeg_tpu_torch import codec

    spent, lock = [0.0], threading.Lock()
    saved = {name: getattr(codec, name) for name in ENCODERS}

    def timed(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with lock:
                    spent[0] += time.perf_counter() - t0
        return call

    for name, fn in saved.items():
        setattr(codec, name, timed(fn))
    state["encode_saved"], state["encode_spent"] = saved, spent


def setup(ctx):
    import libmodjpeg_tpu_torch as mt

    ctx.make_inputs()
    align, ox, oy = ctx.placement()
    dropon = ctx.dropon()
    for data in ctx.files[:WARM_CALLS]:
        mt.watermark(data, dropon, align, ox, oy, device=ctx.device)
    composers = list(mt._WATERMARK_CACHE.values())
    state = {"mt": mt, "dropon": dropon, "place": (align, ox, oy),
             "bc": composers[-1] if len(composers) == 1 else None}
    if ctx.trace:
        _time_encodes(state)
    return state


def window(ctx, state, rec) -> None:
    mt, dropon, (align, ox, oy) = state["mt"], state["dropon"], state["place"]
    bc = state["bc"]
    files = ctx.files
    n = len(files)
    dev = ctx.device
    want = {j: ctx.occurrence(j) for j in range(n)}
    seen, last = [0] * n, [None] * n
    starts, ends = rec["starts"], rec["ends"]
    lengths, samples = rec["lengths"], rec["samples"]
    stages = []
    spent = state.get("encode_spent")
    i = 0
    while time.perf_counter() < ctx.deadline:
        j = i % n
        rec["attempted"] = i + 1
        enc0 = spent[0] if spent else 0.0
        with ctx.span("call"):
            t0 = time.perf_counter()
            out = mt.watermark(files[j], dropon, align, ox, oy, device=dev)
            t1 = time.perf_counter()
        starts.append(t0)
        ends.append(t1)
        if ctx.trace and bc is not None:
            stages.append(dict(bc.last_stream_stats,
                               encode_span_s=spent[0] - enc0))
        lengths.append((j, len(out)))
        if seen[j] == want[j]:
            samples.append((j, out))
        seen[j] += 1
        last[j] = out
        i += 1
    samples.extend((j, last[j]) for j in range(n) if 0 < seen[j] <= want[j])
    pixels = ctx.config["width"] * ctx.config["height"]
    rec["pixels"] = [pixels] * len(ends)
    rec["counters"]["calls"] = stages
    if bc is not None:
        rec["counters"]["info"] = {"stream_path": bc.last_stream_path,
                                   "fallback_reasons":
                                   dict(bc.last_fallback_reasons)}


def release(state) -> None:
    if "encode_saved" in state:
        from libmodjpeg_tpu_torch import codec

        for name, fn in state["encode_saved"].items():
            setattr(codec, name, fn)
    state["mt"]._WATERMARK_CACHE.clear()
    state.clear()
