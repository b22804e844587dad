"""The port's read_dropon against the JAX package's, on the CPU: JPEG
dropons (with a JPEG mask) go through the port's to_pixels, PNG and raw
input through the shared host readers."""

import os

import numpy as np
import pytest

import libmodjpeg_tpu as mj
import libmodjpeg_tpu_torch as mt

from conftest import FIXTURE_IMAGES

_JPG = os.path.join(FIXTURE_IMAGES, "dropon.jpg")
_MASK = os.path.join(FIXTURE_IMAGES, "mask.jpg")
_PNG = os.path.join(FIXTURE_IMAGES, "dropon.png")
_IMAGE = os.path.join(FIXTURE_IMAGES, "image.jpg")


def _assert_same_header(got, want):
    assert (got.width, got.height) == (want.width, want.height)
    assert got.colorspace == want.colorspace
    assert got.blend == want.blend
    assert got.image.shape == want.image.shape
    assert got.alpha.shape == want.alpha.shape
    assert got.image.dtype == want.image.dtype == np.uint8


def _assert_within_one(got, want):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1
    assert (d != 0).mean() < 0.005


@pytest.mark.parametrize("blend", [mj.BLEND_FULL, 100])
def test_jpeg_dropon_with_mask(blend):
    want = mj.read_dropon(_JPG, mask=_MASK, blend=blend)
    got = mt.read_dropon(_JPG, mask=_MASK, blend=blend, device="cpu")
    _assert_same_header(got, want)
    _assert_within_one(got.image, want.image)
    _assert_within_one(got.alpha, want.alpha)


@pytest.mark.parametrize("blend", [mj.BLEND_FULL, 100, mj.BLEND_NONE])
def test_jpeg_dropon_without_mask(blend):
    with open(_JPG, "rb") as f:
        data = f.read()
    want = mj.read_dropon(data, blend=blend)
    got = mt.read_dropon(data, blend=blend, device="cpu")
    _assert_same_header(got, want)
    _assert_within_one(got.image, want.image)
    np.testing.assert_array_equal(got.alpha, want.alpha)


@pytest.mark.parametrize("mask", [None, _MASK])
def test_png_dropon_equals_jax_exactly(mask):
    """A PNG carries its own alpha: the JAX package ignores a mask given
    with it, and so does the port (it used to raise NotImplementedError)."""
    want = mj.read_dropon(_PNG, mask=mask)
    got = mt.read_dropon(_PNG, mask=mask, device="cpu")
    _assert_same_header(got, want)
    np.testing.assert_array_equal(got.image, want.image)
    np.testing.assert_array_equal(got.alpha, want.alpha)


def test_error_parity(tmp_path):
    bogus = tmp_path / "bogus.gif"
    bogus.write_bytes(b"GIF89a" + bytes(64))
    small = tmp_path / "small.jpg"
    small.write_bytes(b"\xff\xd8\xff")
    cases = [
        (b"", {}, "NullDataError"),
        (str(small), {}, "NullDataError"),
        (str(bogus), {}, "UnsupportedFiletypeError"),
        # a mask of another size than the dropon
        (_JPG, {"mask": _IMAGE}, "DroponDimensionsError"),
    ]
    # each package raises its own class of the same name and code
    for source, kw, err in cases:
        with pytest.raises(getattr(mj, err)):
            mj.read_dropon(source, **kw)
        with pytest.raises(getattr(mt, err)) as e:
            mt.read_dropon(source, device="cpu", **kw)
        assert e.value.code == getattr(mj, err).code
