"""step_roofline.stream: the least time the window's composes need
(roofline.py: bytes over the card's 3.35 TB/s, or float32 operations over
67 TFLOP/s, whichever is larger) over the summed time of every kernel the
card ran in the traced window (copies and memsets excluded), in %."""

from benchmark import roofline


def read(rec):
    t = rec.get("trace")
    st = rec["counters"].get("stream")
    if not t or not t.get("kernel_s") or not st or not st.get("batches"):
        return None
    nbytes, flops = roofline.compose_least(rec["cell"]["config"],
                                           len(rec["ends"]), st["batches"])
    least = roofline.least_seconds(rec["device"]["kind"], nbytes, flops)
    if least is None:
        return None
    return least / t["kernel_s"] * 100.0
