"""The port's coefficient-to-pixel decode (libmodjpeg_tpu_torch.pixels and
its ops.dct primitives) against the JAX package's, on the CPU.

Bar for to_pixels: samples within +-1 on under 0.5% of them.  The IDCT sums
in another order than XLA's, so a sample whose exact value is a .5 tie may
round the other way; everything after the IDCT is the same elementwise f32.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import libmodjpeg_tpu as mj
from libmodjpeg_tpu import codec
from libmodjpeg_tpu import constants as C
from libmodjpeg_tpu.encode_pixels import from_pixels
from libmodjpeg_tpu.errors import UnsupportedColorspaceError
from libmodjpeg_tpu.ops import dct as jdct
from libmodjpeg_tpu.pixels import to_pixels as jax_to_pixels
from libmodjpeg_tpu_torch.errors import UnsupportedColorspaceError as \
    TUnsupportedColorspaceError
from libmodjpeg_tpu_torch.ops import dct as tdct
from libmodjpeg_tpu_torch.pixels import to_pixels

from conftest import FIXTURE_IMAGES
from test_cmyk import _make_cmyk
from test_precision12_dnl import _coef_image_12
from util import make_gradient_pixels

_SPACES = {"rgb": C.COLORSPACE_RGB, "ycc": C.COLORSPACE_YCC,
           "gray": C.COLORSPACE_GRAYSCALE}


def _rel_close(got, want, rel=1e-4):
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rel * scale


def test_idct_and_untile_match_jax():
    rng = np.random.RandomState(1)
    coefs = (rng.randn(6, 5, 8, 8) * 200).astype(np.float32)
    for center in (128.0, 2048.0):
        _rel_close(tdct.idct_blocks(torch.from_numpy(coefs), center).numpy(),
                   np.asarray(jdct.idct_blocks(jnp.asarray(coefs), center)))
    np.testing.assert_array_equal(
        tdct.untile_blocks(torch.from_numpy(coefs)).numpy(),
        np.asarray(jdct.untile_blocks(jnp.asarray(coefs))))


def test_idct_inverts_fdct():
    rng = np.random.RandomState(2)
    pix = (rng.rand(40, 8, 8) * 255).astype(np.float32)
    back = tdct.idct_blocks(tdct.fdct_blocks(torch.from_numpy(pix)))
    np.testing.assert_allclose(back.numpy(), pix, atol=1e-3)


@pytest.mark.parametrize("fh,fv", [(1, 1), (2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("shape", [(16, 24), (7, 5), (1, 1)])
def test_upsample_plane_fancy_matches_jax(fh, fv, shape):
    """Edge rows and columns replicate as the JAX version's concatenate."""
    rng = np.random.RandomState(3)
    plane = (rng.rand(*shape) * 255).astype(np.float32)
    got = tdct.upsample_plane_fancy(torch.from_numpy(plane), fh, fv).numpy()
    want = np.asarray(jdct.upsample_plane_fancy(jnp.asarray(plane), fh, fv))
    assert got.shape == want.shape == (shape[0] * fv, shape[1] * fh)
    _rel_close(got, want)


def _assert_pixels_close(img, colorspace):
    want = jax_to_pixels(img, colorspace)
    got = to_pixels(img, colorspace, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1
    assert (d != 0).mean() < 0.005
    return got


@pytest.mark.parametrize("space", sorted(_SPACES))
@pytest.mark.parametrize("name", ["image.jpg", "dropon.jpg", "mask.jpg"])
def test_to_pixels_fixtures(name, space):
    with open(os.path.join(FIXTURE_IMAGES, name), "rb") as f:
        img = codec.decode(f.read())
    _assert_pixels_close(img, _SPACES[space])


@pytest.mark.parametrize("sub,w,h", [("422", 77, 45), ("444", 50, 38),
                                     ("420", 61, 35), ("gray", 30, 21)])
@pytest.mark.parametrize("space", sorted(_SPACES))
def test_to_pixels_sampling_and_odd_sizes(sub, w, h, space):
    """Odd sizes: each plane is cropped before its upsample, and after."""
    rng = np.random.RandomState(4)
    img = from_pixels(make_gradient_pixels(rng, w, h), quality=90,
                      subsampling=sub)
    img = codec.decode(codec.encode(img))
    got = _assert_pixels_close(img, _SPACES[space])
    assert got.shape[:2] == (h, w)


@pytest.mark.parametrize("space", sorted(_SPACES))
@pytest.mark.parametrize("ycck", [False, True], ids=["cmyk", "ycck"])
def test_to_pixels_cmyk_ycck(ycck, space):
    """Adobe inverted ink, built as tests/test_cmyk.py builds it."""
    img, _ = _make_cmyk(np.random.RandomState(5), ycck=ycck)
    _assert_pixels_close(img, _SPACES[space])


@pytest.mark.parametrize("space", sorted(_SPACES))
def test_to_pixels_12bit(space):
    """12-bit frames (tests/test_precision12_dnl.py's image) give uint16 in
    [0, 4095]."""
    img = _coef_image_12(np.random.RandomState(6))
    got = _assert_pixels_close(img, _SPACES[space])
    assert got.dtype == np.uint16 and int(got.max()) <= 4095


def test_to_pixels_rgb_frame():
    """A JCS_RGB frame (no colour transform at encode) in all three
    output spaces."""
    img, _ = _make_cmyk(np.random.RandomState(7))
    img.components = img.components[:3]
    img.coefs = img.coefs[:3]
    img.jpeg_color_space = C.JCS_RGB
    for space in _SPACES.values():
        _assert_pixels_close(img, space)


def test_unsupported_colorspace_parity():
    with open(os.path.join(FIXTURE_IMAGES, "image.jpg"), "rb") as f:
        img = codec.decode(f.read())
    for bad in (mj.COLORSPACE_RGBA, 99):
        with pytest.raises(UnsupportedColorspaceError):
            jax_to_pixels(img, bad)
        with pytest.raises(TUnsupportedColorspaceError):
            to_pixels(img, bad, device="cpu")
    img.jpeg_color_space = 77
    with pytest.raises(UnsupportedColorspaceError):
        jax_to_pixels(img, C.COLORSPACE_RGB)
    with pytest.raises(TUnsupportedColorspaceError):
        to_pixels(img, C.COLORSPACE_RGB, device="cpu")
