"""The compose's least bytes and operations, worked by hand."""

from benchmark import roofline


def test_least_bytes_by_hand():
    # 64x32 logo at the bottom right of 256x128, offset (-16, -16), 4:2:0:
    # x = 256 - 64 - 16 = 176, y = 128 - 32 - 16 = 80, both on the 16-px
    # MCU grid, so the footprint is 64x32 px: Y 8x4 = 32 blocks, Cb and Cr
    # 4x2 = 8 blocks each, 48 in all
    cfg = {"width": 256, "height": 128, "logo": {"width": 64, "height": 32},
           "placement": {"align": ["BOTTOM", "RIGHT"], "offset_x": -16,
                         "offset_y": -16}}
    assert roofline.footprint_blocks(cfg) == [32, 8, 8]
    nbytes, flops = roofline.compose_least(cfg, files=2, batches=1)
    per_file = 48 * 64 * 2 * 2 + 3 * 64 * 2      # int16 in + out, 3 tables
    per_batch = 48 * 64 * 4 * 2                  # f32 dropon + mask, shared
    assert nbytes == 2 * per_file + per_batch == 25344 + 24576
    assert flops == 2 * 48 * 4096


def test_off_grid_placement_pads_to_the_mcu():
    # centred 24x8 logo on 64x32: x = 20, y = 12; block offsets 4 and 12
    # pad the canvas to 32x32 px: Y 4x4, chroma 2x2
    cfg = {"width": 64, "height": 32, "logo": {"width": 24, "height": 8},
           "placement": {"align": ["CENTER"], "offset_x": 0, "offset_y": 0}}
    assert roofline.footprint_blocks(cfg) == [16, 4, 4]


def test_least_seconds_uses_the_published_peaks():
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.least_seconds(kind, 3.35e12, 0) == 1.0
    assert roofline.least_seconds(kind, 0, 6.7e13) == 1.0
    assert roofline.least_seconds("unknown card", 1, 1) is None
