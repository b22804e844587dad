"""The port's placement, dropon compilation, DCT primitives and pixel
encoder against the JAX package's, on the CPU."""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import libmodjpeg_tpu as mj
from libmodjpeg_tpu import codec
from libmodjpeg_tpu import composer as jcomp
from libmodjpeg_tpu import encode_pixels as jenc
from libmodjpeg_tpu.ops import dct as jdct
from libmodjpeg_tpu_torch import composer as tcomp
from libmodjpeg_tpu_torch import encode_pixels as tenc
from libmodjpeg_tpu_torch.ops import dct as tdct

from conftest import FIXTURE_IMAGES

_ALIGNS = [mj.ALIGN_TOP | mj.ALIGN_LEFT, mj.ALIGN_TOP | mj.ALIGN_RIGHT,
           mj.ALIGN_BOTTOM | mj.ALIGN_LEFT, mj.ALIGN_BOTTOM | mj.ALIGN_RIGHT,
           mj.ALIGN_CENTER]
# includes crops past every edge and placements entirely off the image
_OFFSETS = [(0, 0), (-7, 3), (13, -5), (-100, -40), (200, 180), (-300, 0),
            (0, 300), (5, 11)]


@pytest.fixture(scope="module")
def fixture_pair():
    with open(os.path.join(FIXTURE_IMAGES, "image.jpg"), "rb") as f:
        img = codec.decode(f.read())
    d = mj.read_dropon(os.path.join(FIXTURE_IMAGES, "dropon.png"))
    return img, d


def test_plan_placement_identical(fixture_pair):
    img, d = fixture_pair
    for align in _ALIGNS:
        for ox, oy in _OFFSETS:
            want = jcomp.plan_placement(img, d, align, ox, oy)
            got = tcomp.plan_placement(img, d, align, ox, oy)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (align, ox, oy)


def _rel_close(got, want, rel=1e-4):
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rel * scale


def test_dct_primitives_match_jax():
    rng = np.random.RandomState(1)
    blocks = (rng.rand(6, 5, 8, 8) * 255).astype(np.float32)
    _rel_close(tdct.fdct_blocks(torch.from_numpy(blocks)).numpy(),
               np.asarray(jdct.fdct_blocks(jnp.asarray(blocks))))
    rgb = (rng.rand(16, 24, 3) * 255).astype(np.float32)
    _rel_close(tdct.rgb_to_ycc(torch.from_numpy(rgb)).numpy(),
               np.asarray(jdct.rgb_to_ycc(jnp.asarray(rgb))))
    _rel_close(tdct.ycc_to_rgb(torch.from_numpy(rgb)).numpy(),
               np.asarray(jdct.ycc_to_rgb(jnp.asarray(rgb))))
    plane = rgb[..., 0]
    for fh, fv in ((1, 1), (2, 1), (2, 2)):
        _rel_close(tdct.subsample_plane(torch.from_numpy(plane), fh,
                                        fv).numpy(),
                   np.asarray(jdct.subsample_plane(jnp.asarray(plane), fh,
                                                   fv)))
    np.testing.assert_array_equal(
        tdct.tile_blocks(torch.from_numpy(plane)).numpy(),
        np.asarray(jdct.tile_blocks(jnp.asarray(plane))))


def _at_most_one_step(got, want, step, max_share):
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max() <= step * (1 + 1e-6) + 1e-12
    assert (diff > 0).mean() <= max_share


@pytest.mark.parametrize("align,ox,oy", [
    (mj.ALIGN_BOTTOM | mj.ALIGN_RIGHT, -10, -10),
    (mj.ALIGN_TOP | mj.ALIGN_LEFT, 3, 5),
    (mj.ALIGN_CENTER, 0, 0),
    (mj.ALIGN_TOP | mj.ALIGN_RIGHT, 20, -9),   # cropped on two edges
])
def test_compile_dropon_within_one_rounding_step(fixture_pair, align, ox, oy):
    """Compiled image blocks differ by at most one rint step on <= 0.1% of
    coefficients; alpha weights by one step x _ALPHA_FACTORS on < 0.5%
    (the alpha planes carry exact .5 ties that f32 summation order tips)."""
    img, d = fixture_pair
    p = jcomp.plan_placement(img, d, align, ox, oy)
    args = (d, img, p.blockoffset_x, p.blockoffset_y, p.crop_x, p.crop_y,
            p.crop_w, p.crop_h)
    want = jcomp.compile_dropon(*args)
    got = tcomp.compile_dropon(*args, device="cpu")
    assert got.samp_factors == want.samp_factors
    assert got.image_colorspace == want.image_colorspace
    for c in range(len(want.image_blocks)):
        assert got.image_blocks[c].shape == want.image_blocks[c].shape
        assert got.image_blocks[c].dtype == np.float32
        _at_most_one_step(got.image_blocks[c], want.image_blocks[c], 1.0,
                          0.001)
        step = np.broadcast_to(tcomp._ALPHA_FACTORS,
                               want.alpha_weights[c].shape)
        diff = np.abs(got.alpha_weights[c] - want.alpha_weights[c])
        # one step, plus the f32 rounding of the two scaled products
        eps = 4 * np.finfo(np.float32).eps * np.abs(want.alpha_weights[c])
        assert np.all(diff <= step + eps)
        assert (diff > 0).mean() < 0.005
        assert got.mask_pixels[c].shape == want.mask_pixels[c].shape


def test_from_pixels_within_one_step():
    rng = np.random.RandomState(2)
    yy, xx = np.mgrid[0:120, 0:136].astype(np.float32)
    base = 128 + 80 * np.sin(xx / 17.0) * np.cos(yy / 13.0)
    pix = np.clip(base[..., None] + rng.randn(120, 136, 3) * 12, 0,
                  255).astype(np.uint8)
    for sub in ("420", "444", "gray"):
        want = jenc.from_pixels(pix, quality=85, subsampling=sub)
        got = tenc.from_pixels(pix, quality=85, subsampling=sub,
                               device="cpu")
        assert [dataclasses.asdict(c) for c in got.components] == \
            [dataclasses.asdict(c) for c in want.components]
        for t in want.quant_tables:
            np.testing.assert_array_equal(got.quant_tables[t],
                                          want.quant_tables[t])
        for a, b in zip(got.coefs, want.coefs):
            assert a.dtype == np.int16 and a.shape == b.shape
            _at_most_one_step(a, b, 1, 0.001)


def _make_logo(w, h, seed):
    """The benchmark's logo (noise colours, opaque core, a transparent
    border ramping in over 11 pixels) as an RGBA dropon of the port."""
    import libmodjpeg_tpu_torch as mt

    px = np.random.default_rng(seed).integers(0, 255, (h, w, 4),
                                              dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    edge = np.minimum.reduce([xx, yy, w - 1 - xx, h - 1 - yy])
    px[..., 3] = np.clip(edge.astype(np.float32) * 24, 0, 255)
    return mt.read_dropon_from_raw(px, mt.COLORSPACE_RGBA, w, h)


def _header_420(width, height):
    """A 4:2:0 YCbCr CoefImage's header with no coefficient planes: all a
    compile reads of the frame."""
    from libmodjpeg_tpu_torch.model import (CoefImage, ComponentInfo,
                                            Sampling)

    comps = [ComponentInfo(c + 1, hs, vs, int(c > 0),
                           -(-width * hs // 16), -(-height * vs // 16),
                           -(-width // 16) * hs, -(-height // 16) * vs)
             for c, (hs, vs) in enumerate([(2, 2), (1, 1), (1, 1)])]
    return CoefImage(width=width, height=height, jpeg_color_space=3,
                     components=comps, coefs=[], quant_tables={},
                     sampling=Sampling(2, 2))


def _compile_before(d, img, bx, by, crop_x, crop_y, crop_w, crop_h):
    """The port's compile_dropon as it was while the masks were made on the
    host: float32 host canvases, each component's blocks and weights
    copied down as it was made, the masks from mask_pix_np.  Returns
    (image_blocks, alpha_weights, mask_pixels)."""
    from libmodjpeg_tpu_torch.ops.compose import mask_pix_np

    hf, vf = img.sampling.h_factor, img.sampling.v_factor
    width, height = -(-(crop_w + bx) // hf) * hf, -(-(crop_h + by) // vf) * vf
    canvases = []
    for src in (d.image, d.alpha):
        canvas = np.zeros((height, width, 3), np.float32)
        canvas[by:by + crop_h, bx:bx + crop_w] = \
            src[crop_y:crop_y + crop_h, crop_x:crop_x + crop_w]
        canvases.append(torch.from_numpy(canvas))
    planes = tcomp._convert_canvas(canvases[0], d.colorspace,
                                   img.jpeg_color_space)
    scale = float(1 << (getattr(img, "precision", 8) - 8))
    blocks, weights = [], []
    for c in range(len(planes)):
        ci = img.components[c]
        fh = img.sampling.max_h_samp // ci.h_samp
        fv = img.sampling.max_v_samp // ci.v_samp
        b = np.ascontiguousarray(tcomp._plane_to_dct_blocks(planes[c], fh,
                                                            fv))
        blocks.append(b * scale if scale != 1.0 else b)
        weights.append(np.ascontiguousarray(tcomp._alpha_to_weights(
            canvases[1][..., min(c, 2)], fh, fv)))
    return blocks, weights, [mask_pix_np(w) for w in weights]


def _compile_case(name):
    """(frame, dropon, align, offset_x, offset_y) of a named case."""
    import libmodjpeg_tpu_torch as mt
    from libmodjpeg_tpu_torch.state import from_reference

    from test_fuzz_roundtrip import random_image
    from test_precision12_dnl import _coef_image_12

    rng = np.random.RandomState(sum(map(ord, name)))
    tl = mj.ALIGN_TOP | mj.ALIGN_LEFT
    logo = _make_logo(61, 37, 3)
    if name == "fx100mp-logo":
        return (_header_420(12240, 8160), _make_logo(1024, 256, 5),
                mj.ALIGN_CENTER, 0, 0)
    if name == "12bit":
        return from_reference(_coef_image_12(rng)), logo, tl, 5, 3
    samp, align, ox, oy = {
        "420-sub-mcu": ("420", tl, 3, 5),
        "420-edge-crop": ("420", tl, -7, -3),
        "420-crop-bottom-right": ("420", mj.ALIGN_BOTTOM | mj.ALIGN_RIGHT,
                                  20, -9),
        "444-ycc-dropon": ("444", mj.ALIGN_CENTER, 1, -2),
        "gray": ("gray", mj.ALIGN_TOP | mj.ALIGN_RIGHT, -5, 7),
        "cmyk": ("cmyk", mj.ALIGN_CENTER, 1, 1),
        "cmyk420-uniform-blend": ("cmyk420", tl, 2, 9),
    }[name]
    img = from_reference(random_image(rng, samp, 12, 9))
    if name == "444-ycc-dropon":
        px = rng.randint(0, 256, (29, 43, 4)).astype(np.uint8)
        logo = mt.read_dropon_from_raw(px, mt.COLORSPACE_YCCA, 43, 29)
    elif name == "cmyk420-uniform-blend":
        px = rng.randint(0, 256, (29, 43, 3)).astype(np.uint8)
        logo = mt.read_dropon_from_raw(px, mt.COLORSPACE_RGB, 43, 29, 160)
    return img, logo, align, ox, oy


_COMPILE_CASES = ["420-sub-mcu", "420-edge-crop", "420-crop-bottom-right",
                  "444-ycc-dropon", "gray", "cmyk", "cmyk420-uniform-blend",
                  "12bit", "fx100mp-logo"]


@pytest.mark.parametrize("case", _COMPILE_CASES)
def test_device_compile_equals_host_compile(case):
    """The compile left on the device, and compile_dropon's host model made
    from it, equal the host compile it replaced: the same drops and alpha
    weights, and masks equal to mask_pix_np of the same weights."""
    from libmodjpeg_tpu_torch.ops.compose import mask_pix_np

    img, d, align, ox, oy = _compile_case(case)
    p = tcomp.plan_placement(img, d, align, ox, oy)
    assert not p.noop
    if case.startswith("420-sub") or case == "12bit":
        assert p.blockoffset_x or p.blockoffset_y
    if "crop" in case:
        assert p.crop_x or p.crop_y or p.crop_w < d.width
    args = (d, img, p.blockoffset_x, p.blockoffset_y, p.crop_x, p.crop_y,
            p.crop_w, p.crop_h)
    blocks, weights, masks = _compile_before(*args)
    dd = tcomp.compile_dropon_device(*args, device="cpu")
    host = tcomp.compile_dropon(*args, device="cpu")
    assert dd.shapes == tuple(b.shape[:2] for b in blocks)
    assert len(dd.drops) == len(dd.weights) == len(dd.masks) == \
        img.num_components
    if case == "fx100mp-logo":
        assert sum(h * w for h, w in dd.shapes) == 6240
    for c in range(len(blocks)):
        for t in (dd.drops[c], dd.weights[c], dd.masks[c]):
            assert t.dtype == torch.float32 and t.is_contiguous()
            assert t.shape == (blocks[c].shape[0] * blocks[c].shape[1], 64)
        np.testing.assert_array_equal(dd.drops[c].numpy().reshape(
            blocks[c].shape), blocks[c])
        np.testing.assert_array_equal(dd.weights[c].numpy().reshape(
            weights[c].shape), weights[c])
        np.testing.assert_array_equal(dd.masks[c].numpy().reshape(
            masks[c].shape), masks[c])
        np.testing.assert_array_equal(dd.masks[c].numpy(), mask_pix_np(
            dd.weights[c].numpy().reshape(-1, 8, 8)).reshape(-1, 64))
        for got, want in ((host.image_blocks, blocks),
                          (host.alpha_weights, weights),
                          (host.mask_pixels, masks)):
            assert got[c].dtype == np.float32
            np.testing.assert_array_equal(got[c], want[c])
    assert host.samp_factors == [(ci.h_samp, ci.v_samp)
                                 for ci in img.components]
    assert host.image_colorspace == img.jpeg_color_space


def test_device_compile_reads_nothing_back(monkeypatch):
    """compile_dropon_device takes none of its results to the host: no
    .cpu(), .item() or .tolist() on a tensor and no host mask_pix_np."""
    from libmodjpeg_tpu_torch.ops import compose as tops

    def refuse(*a, **k):
        raise AssertionError("host step in the device compile")

    img, d, align, ox, oy = _compile_case("420-sub-mcu")
    p = tcomp.plan_placement(img, d, align, ox, oy)
    args = (d, img, p.blockoffset_x, p.blockoffset_y, p.crop_x, p.crop_y,
            p.crop_w, p.crop_h)
    for name in ("cpu", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(tops, "mask_pix_np", refuse)
    dd = tcomp.compile_dropon_device(*args, device="cpu")
    monkeypatch.undo()
    want = tcomp.compile_dropon(*args, device="cpu")
    for c, m in enumerate(want.mask_pixels):
        np.testing.assert_array_equal(dd.masks[c].numpy(), m.reshape(-1, 64))
