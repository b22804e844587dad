"""outside_stages_ms.single: the mean watermark() call time less the
stage seconds the stream counted for that call (decode, pack + dispatch,
fetch, scatter) and less the call's encode, timed by the benchmark's span
around the program's encoders (drivers/call.py): what is left is the entry
API's own work, the probe, the composer cache, the per-call pool and
threads."""

STAGES = ("decode_s", "pack_dispatch_s", "fetch_s", "scatter_s",
          "encode_span_s")


def read(rec):
    calls = rec["counters"].get("calls")
    if not calls or len(calls) != len(rec["ends"]):
        return None
    total = sum(e - s for s, e in zip(rec["starts"], rec["ends"]))
    staged = sum(c[k] for c in calls for k in STAGES)
    return (total - staged) / len(calls) * 1e3
