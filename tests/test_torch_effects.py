"""The port's effects against the JAX package's, on the CPU: integer
arithmetic, so the coefficients must be identical, quirks included."""

import os

import numpy as np
import pytest

import libmodjpeg_tpu as mj
import libmodjpeg_tpu_torch as mt
from libmodjpeg_tpu import codec

from conftest import FIXTURE_IMAGES
from test_cmyk import _make_cmyk
from test_precision12_dnl import _coef_image_12


def _fixture():
    with open(os.path.join(FIXTURE_IMAGES, "image.jpg"), "rb") as f:
        return codec.decode(f.read())


_IMAGES = {
    "image.jpg": _fixture,
    "12bit": lambda: _coef_image_12(np.random.RandomState(1)),
    "cmyk": lambda: _make_cmyk(np.random.RandomState(2))[0],
}

# (name, JAX call, port call); the values reach the DC clamp at both
# precisions (+-2047 for 8-bit, +-32767 for 12-bit) in both directions
_EFFECTS = [
    ("grayscale", lambda im: mj.effect_grayscale(im),
     lambda im: mt.effect_grayscale(im, device="cpu")),
    ("pixelate", lambda im: mj.effect_pixelate(im),
     lambda im: mt.effect_pixelate(im, device="cpu")),
    ("luminance", lambda im: mj.effect_luminance(im, 300),
     lambda im: mt.effect_luminance(im, 300, device="cpu")),
    ("luminance_clamp_hi", lambda im: mj.effect_luminance(im, 40000),
     lambda im: mt.effect_luminance(im, 40000, device="cpu")),
    ("luminance_clamp_lo", lambda im: mj.effect_luminance(im, -40000),
     lambda im: mt.effect_luminance(im, -40000, device="cpu")),
    ("tint", lambda im: mj.effect_tint(im, 120, -90),
     lambda im: mt.effect_tint(im, 120, -90, device="cpu")),
    ("tint_cb_clamp", lambda im: mj.effect_tint(im, 5000, 0),
     lambda im: mt.effect_tint(im, 5000, 0, device="cpu")),
    ("tint_zero", lambda im: mj.effect_tint(im, 0, 0),
     lambda im: mt.effect_tint(im, 0, 0, device="cpu")),
]


@pytest.mark.parametrize("effect", _EFFECTS, ids=[e[0] for e in _EFFECTS])
@pytest.mark.parametrize("image", sorted(_IMAGES))
def test_effect_exact(image, effect):
    _, jax_fx, port_fx = effect
    img = _IMAGES[image]()
    before = [c.copy() for c in img.coefs]
    want, got = jax_fx(img), port_fx(img)
    assert got is not img
    for c, (a, b) in enumerate(zip(got.coefs, want.coefs)):
        assert a.dtype == b.dtype == np.int16
        np.testing.assert_array_equal(a, b, err_msg=f"component {c}")
    for a, b in zip(img.coefs, before):  # the input is left as it was
        np.testing.assert_array_equal(a, b)


def test_quirks():
    """Non-YCbCr images pass grayscale/tint/luminance unchanged (pixelate
    still applies); tint(0, 0) is a copy; the DC clamp is
    (1 << (precision + 3)) - 1."""
    cmyk = _make_cmyk(np.random.RandomState(3))[0]
    for out in (mt.effect_grayscale(cmyk, device="cpu"),
                mt.effect_tint(cmyk, 50, 50, device="cpu"),
                mt.effect_luminance(cmyk, 50, device="cpu")):
        for a, b in zip(out.coefs, cmyk.coefs):
            np.testing.assert_array_equal(a, b)
    assert any((a != b).any() for a, b in zip(
        mt.effect_pixelate(cmyk, device="cpu").coefs, cmyk.coefs))
    img = _fixture()
    same = mt.effect_tint(img, 0, 0, device="cpu")
    assert same is not img and same.coefs[1] is not img.coefs[1]
    for prec, img in ((8, _fixture()),
                      (12, _coef_image_12(np.random.RandomState(4)))):
        q0 = int(img.quant_table_for(0)[0, 0])
        out = mt.effect_luminance(img, 1 << 20, device="cpu")
        clamp = (1 << (prec + 3)) - 1
        assert int(out.coefs[0][..., 0, 0].max()) == clamp // q0
