"""The port's band splice against the JAX package's full path, on frames
whose suffix is one MCU row or a few: the port's splice takes the band-end
bit position from a skip walk over the band, where the JAX codec
back-computes it from its bit reader and counts the zero refill past the
scan end near it (10 coefficients wrong on seed 28, H=64, rows (0, 3)).
A suffix that fails its index walk is a splice failure, so the stream's
default path reaches the verdict of the full path (surgical=False)."""

import os

import numpy as np
import pytest

import libmodjpeg_tpu_torch as mt
from libmodjpeg_tpu import codec as jcodec
from libmodjpeg_tpu_torch import codec as tcodec
from libmodjpeg_tpu_torch.encode_pixels import from_pixels
from libmodjpeg_tpu_torch.parallel import BatchComposer

from conftest import FIXTURE_IMAGES

SEEDS = range(30)
HEIGHTS = (32, 64, 144)   # 2, 4 and 9 MCU rows of one MCU each


def tiny_frame(seed: int, h: int) -> bytes:
    """A 16 px wide 4:2:0 q60 frame of ``h`` rows: a vertical sine with
    seeded noise, coded by the port."""
    yy = np.mgrid[0:h, 0:16][0].astype(np.float32)
    base = (128 + 60 * np.sin(yy / (5 + seed))
            + np.random.RandomState(seed).randn(h, 16) * (seed % 4))
    pix = np.clip(np.stack([base, base * 0.9 + 10, 255 - base], -1), 0, 255)
    return tcodec.encode(from_pixels(pix.astype(np.uint8), quality=60,
                                     subsampling="420", device="cpu"))


def _edit(img, row0):
    """+3 on the DC of the band's first row of Y blocks."""
    img.coefs[0][2 * row0, :, 0, 0] += 3


def _coef_diffs(a, b) -> int:
    return sum(int((x != y).sum()) for x, y in zip(a.coefs, b.coefs))


@pytest.mark.parametrize("h", HEIGHTS)
@pytest.mark.parametrize("seed", SEEDS)
def test_band_splice_equals_jax_full_path(seed, h):
    """Every band with a suffix: the port's spliced bytes equal the JAX
    package's full decode / re-encode after the same edit, and decode to
    its coefficients."""
    data = tiny_frame(seed, h)
    rows = h // 16
    for row0 in range(rows):
        for row1 in range(row0 + 1, rows):
            img, sp = tcodec.decode_band(data, row0, row1)
            _edit(img, row0)
            out = tcodec.encode_splice_band(data, img, row0, row1, sp)
            full = jcodec.decode(data)
            _edit(full, row0)
            assert out == jcodec.encode(full), (row0, row1)
            assert _coef_diffs(tcodec.decode(out), full) == 0, (row0, row1)


def test_reference_band_splice_fault_is_not_ported():
    """Pins the JAX codec's own fault: its splice of seed 28, H=64, rows
    (0, 3) decodes 10 coefficients away from its full path, without an
    error.  The port's splice gives the full path's bytes."""
    data = tiny_frame(28, 64)
    full = jcodec.decode(data)
    jimg, jsp = jcodec.decode_band(data, 0, 3)
    jout = jcodec.encode_splice_band(data, jimg, 0, 3, jsp)
    assert _coef_diffs(jcodec.decode(jout), full) == 10
    timg, tsp = tcodec.decode_band(data, 0, 3)
    tout = tcodec.encode_splice_band(data, timg, 0, 3, tsp)
    assert tout == jcodec.encode(full) == data
    assert tsp[7] > jsp[7]   # the reference stops short of the band end


def _stream(template, dropon, datas, **kw):
    """(outcome, path, fallback reasons) of one watermark_stream run:
    outcome is ("ok", bytes...) or (exception class name, message)."""
    bc = BatchComposer(template, dropon, mt.ALIGN_TOP | mt.ALIGN_LEFT, 0, 0,
                       device="cpu")
    try:
        out = ("ok",) + tuple(bc.watermark_stream(iter(datas), batch=3, **kw))
    except mt.ModJpegError as e:
        out = (type(e).__name__, str(e))
    return out, bc.last_stream_path, dict(bc.last_fallback_reasons)


@pytest.fixture(scope="module")
def fixture_stream():
    """image.jpg re-coded with the standard tables (256x256, 4:2:0), and
    dropon.png at the top left: a band of rows 0-2 and a 13-row suffix."""
    with open(os.path.join(FIXTURE_IMAGES, "image.jpg"), "rb") as f:
        data = tcodec.encode(tcodec.decode(f.read()))
    return data, mt.read_dropon(os.path.join(FIXTURE_IMAGES, "dropon.png"),
                                device="cpu")


# (byte offset into the file, XOR mask; 0 writes a zero byte): corruptions
# of the suffix's entropy data that decode, and ones that fail its walk
_FINE = ((3000, 0x5A), (6000, 0x01), (11000, 0xFE))
_FAILING = ((5623, 0), (7314, 0), (9467, 0x5A), (12697, 0))


@pytest.mark.parametrize("pos,mask", _FINE + _FAILING)
def test_stream_corrupted_suffix_matches_full_path(fixture_stream, pos, mask):
    """Three files, the middle one corrupted in its suffix: the default
    path gives the outcome of surgical=False, bytes or the same error; a
    suffix that fails its walk is counted as a splice fallback."""
    data, dropon = fixture_stream
    bad = bytearray(data)
    bad[pos] = bad[pos] ^ mask if mask else 0
    datas = [data, bytes(bad), data]
    template = tcodec.decode(data)
    got, path, reasons = _stream(template, dropon, datas)
    want, full_path, _ = _stream(template, dropon, datas, surgical=False)
    assert got == want
    assert full_path == "full"
    if (pos, mask) in _FAILING:
        assert want[0] == "DecodeError"
        assert reasons == {f"splice: suffix index failed: {want[1]}": 1}
        assert path == "mixed"
    else:
        assert want[0] == "ok" and reasons == {} and path == "splice"


def test_stream_tiny_suffix_frames_match_full_path():
    """The frames that the reference's band-end count got wrong, in one
    stream: the default path splices all of them to the full path's bytes,
    with no fallback; a corruption of the first entropy byte of seed 26
    (the old count spliced it to other bytes) gives the full path's bytes,
    through a counted fallback."""
    logo = np.zeros((48, 16, 4), np.uint8)
    logo[..., :3] = 200
    logo[..., 3] = 128
    dropon = mt.read_dropon_from_raw(logo, mt.COLORSPACE_RGBA, 16, 48)
    datas = [tiny_frame(s, 64) for s in (26, 28, 29)]
    template = tcodec.decode(datas[0])
    got, path, reasons = _stream(template, dropon, datas)
    want, _, _ = _stream(template, dropon, datas, surgical=False)
    assert got == want and got[0] == "ok"
    assert path == "splice" and reasons == {}

    bad = bytearray(datas[0])
    scan = bad.rfind(b"\xff\xda") + 14   # SOS of three components
    bad[scan] ^= 0x01
    datas[1] = bytes(bad)
    got, path, reasons = _stream(template, dropon, datas)
    want, _, _ = _stream(template, dropon, datas, surgical=False)
    assert got == want and got[0] == "ok"
    assert path == "mixed"
    assert reasons == {"splice: bad splice suffix coordinates": 1}
