"""Driver ``grid_chain``: the huge-frame chain, one frame after another:
``codec.decode`` -> ``GridSession(img, device)`` -> the configuration's
effects -> ``compose(logo)`` -> ``to_jpeg(OPTION_OPTIMIZE?,
restart_interval)``, with the distinct frames in turn.

Set-up runs the whole chain once on the first frame.  A new frame starts
only before the deadline.  The benchmark's spans (``decode``, ``upload``
ended by a synchronise, ``effects_compose`` ended by one, ``to_jpeg``)
are the per-layer times.
"""

from __future__ import annotations

import time


def _chain(ctx, state, data: bytes) -> bytes:
    import libmodjpeg_tpu_torch as mt
    from libmodjpeg_tpu_torch import codec
    from libmodjpeg_tpu_torch.parallel import GridSession

    align, ox, oy = state["place"]
    out_cfg = ctx.config["output"]
    with ctx.span("decode"):
        img = codec.decode(data)
    with ctx.span("upload"):
        sess = GridSession(img, device=ctx.device)
        sess.block_until_ready()
    with ctx.span("effects_compose"):
        for name, *args in ctx.config["effects"]:
            if name == "luminance":
                sess.effect("luminance", value=args[0])
            elif name == "tint":
                sess.effect("tint", cb_value=args[0],
                            cr_value=args[1] if len(args) > 1 else 0)
            else:                               # grayscale, pixelate
                sess.effect(name)
        sess.compose(state["dropon"], align, ox, oy)
        sess.block_until_ready()
    with ctx.span("to_jpeg"):
        out = sess.to_jpeg(
            options=mt.OPTION_OPTIMIZE if out_cfg["optimize"] else 0,
            restart_interval=out_cfg["restart_interval"])
    return out


def setup(ctx):
    ctx.make_inputs()
    state = {"dropon": ctx.dropon(), "place": ctx.placement()}
    _chain(ctx, state, ctx.files[0])
    ctx.tracer.spans.clear()
    return state


def window(ctx, state, rec) -> None:
    files = ctx.files
    n = len(files)
    want = {j: ctx.occurrence(j) for j in range(n)}
    seen, last = [0] * n, [None] * n
    pixels = ctx.config["width"] * ctx.config["height"]
    k = 0
    while time.perf_counter() < ctx.deadline:
        j = k % n
        rec["attempted"] = k + 1
        t0 = time.perf_counter()
        out = _chain(ctx, state, files[j])
        rec["starts"].append(t0)
        rec["ends"].append(time.perf_counter())
        rec["pixels"].append(pixels)
        rec["lengths"].append((j, len(out)))
        if seen[j] == want[j]:
            rec["samples"].append((j, out))
        seen[j] += 1
        last[j] = out
        k += 1
    rec["samples"].extend((j, last[j]) for j in range(n)
                          if 0 < seen[j] <= want[j])


def release(state) -> None:
    state.clear()
