"""Driver ``stream``: the batch watermark pipeline,
``BatchComposer.watermark_stream``, over a closed loop whose input
iterator is always ready.

Set-up decodes the first file as the composer's template (the compiled
logo), builds the composer and warms it with one pass over the distinct
files.  The window feeds the files over and over, in order, and stops
taking new ones at the first batch boundary past the deadline; the stream
then drains.  Each file's latency runs from when the stream's producer
takes it from the iterator to when its output is yielded.  The traffic's
``expect_path`` is the path every file must take; another path fails the
run, since the cell would then measure other traffic.
"""

from __future__ import annotations

import time


def setup(ctx):
    from libmodjpeg_tpu_torch import codec
    from libmodjpeg_tpu_torch.parallel import BatchComposer

    ctx.make_inputs()
    align, ox, oy = ctx.placement()
    bc = BatchComposer(codec.decode(ctx.files[0]), ctx.dropon(), align, ox,
                       oy, device=ctx.device)
    kwargs = ctx.traffic.get("stream_kwargs", {})
    for _ in bc.watermark_stream(iter(ctx.files), **kwargs):
        pass
    _expect_path(ctx, bc)
    return {"bc": bc, "kwargs": kwargs}


def _expect_path(ctx, bc) -> None:
    want = ctx.traffic["expect_path"]
    ctx.log(f"stream path {bc.last_stream_path!r}, fallback reasons "
            f"{bc.last_fallback_reasons!r}")
    if bc.last_stream_path != want:
        raise AssertionError(f"stream took {bc.last_stream_path!r}, the "
                             f"cell measures {want!r}")


def window(ctx, state, rec) -> None:
    bc = state["bc"]
    files = ctx.files
    n = len(files)
    batch = ctx.traffic["batch"]
    pixels = ctx.config["width"] * ctx.config["height"]
    deadline = ctx.deadline
    takes = rec["starts"]
    want = {j: ctx.occurrence(j) for j in range(n)}

    def source():
        i = 0
        while i % batch or time.perf_counter() < deadline:
            takes.append(time.perf_counter())
            yield files[i % n]
            i += 1

    ends, lengths, samples = rec["ends"], rec["lengths"], rec["samples"]
    seen, last = [0] * n, [None] * n
    for k, out in enumerate(bc.watermark_stream(source(), **state["kwargs"])):
        ends.append(time.perf_counter())
        j = k % n
        lengths.append((j, len(out)))
        if seen[j] == want[j]:
            samples.append((j, out))
        seen[j] += 1
        last[j] = out
    rec["attempted"] = len(takes)
    rec["pixels"] = [pixels] * len(ends)
    # a window too short for the drawn answer checks the last one it gave
    samples.extend((j, last[j]) for j in range(n)
                   if 0 < seen[j] <= want[j])
    stats = dict(bc.last_stream_stats)
    rec["counters"]["stream"] = stats
    rec["counters"]["info"] = {
        "stream_path": bc.last_stream_path,
        "fallback_reasons": dict(bc.last_fallback_reasons),
        "stream_stats": stats}
    _expect_path(ctx, bc)


def release(state) -> None:
    state.clear()
