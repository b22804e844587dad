"""The compose's least work, reckoned from a cell's shapes alone, so that
it does not depend on which kernels implement the step.

Per file, every footprint coefficient is read once and written once as
int16 and each component's 8x8 quantization table is read once (64
uint16 values); per batch, the compiled logo's dropon blocks and pixel
mask are read once each as float32 (the batch shares them).  The
operations are a separable forward and inverse 8x8 DCT per footprint block
(4 passes of 8 x 8 x 8 multiply-adds: 4,096 operations); the blend's
elementwise work is left out.
"""

from __future__ import annotations

from .references.dct_compose import align_bits, placement

FLOPS_PER_BLOCK = 4096


def footprint_blocks(config: dict) -> list:
    """Blocks of the logo's footprint per component (4:2:0: Y at 2x2)."""
    comps = [(2, 2), (1, 1), (1, 1)]
    mcu_w, mcu_h = 16, 16
    p = config["placement"]
    place = placement(config["width"], config["height"], mcu_w, mcu_h,
                      config["logo"]["width"], config["logo"]["height"],
                      align_bits(p["align"]), p["offset_x"], p["offset_y"])
    if place is None:
        return [0, 0, 0]
    crop_w, crop_h, box, boy = place[2], place[3], place[4], place[5]
    width = -(-(crop_w + box) // mcu_w) * mcu_w
    height = -(-(crop_h + boy) // mcu_h) * mcu_h
    return [(height // (8 * (2 // v))) * (width // (8 * (2 // h)))
            for h, v in comps]


def compose_least(config: dict, files: int, batches: int) -> tuple:
    """(bytes, operations) the compose of ``files`` files in ``batches``
    batches needs at least."""
    blocks = footprint_blocks(config)
    per_file = sum(blocks) * 64 * 2 * 2 + len(blocks) * 64 * 2
    per_batch = sum(blocks) * 64 * 4 * 2
    return (files * per_file + batches * per_batch,
            files * sum(blocks) * FLOPS_PER_BLOCK)


def least_seconds(kind: str, nbytes: float, flops: float):
    """The larger of bytes over the card's HBM peak and operations over
    its float32 peak, or None for a card the peaks table lacks."""
    from .stats import peak

    bw, fl = peak(kind, "hbm_bytes_s"), peak(kind, "fp32_flop_s")
    if bw is None or fl is None:
        return None
    return max(nbytes / bw, flops / fl)
