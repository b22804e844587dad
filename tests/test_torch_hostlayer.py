"""The port's own host layer against the JAX package's, on the CPU: its
copy of the entropy codec (built by g++ from its own sources) decodes to
the same coefficients and encodes to the same bytes on every coding path,
also into planes that hold stale data, and gives page-locked planes only to
large frames in a process with a CUDA context; state.from_reference carries
every model type across; the port raises its own error classes."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import libmodjpeg_tpu as mj
import libmodjpeg_tpu_torch as mt
from libmodjpeg_tpu import codec as jcodec
from libmodjpeg_tpu import composer as jcomposer
from libmodjpeg_tpu_torch import codec as tcodec
from libmodjpeg_tpu_torch import model as tmodel
from libmodjpeg_tpu_torch.state import from_reference

from conftest import FIXTURE_IMAGES, REPO

# (encode options, restart interval) per coding path
_PATHS = {"baseline": (0, 0), "optimize": (mt.OPTION_OPTIMIZE, 0),
          "progressive": (mt.OPTION_PROGRESSIVE, 0),
          "arithmetic": (mt.OPTION_ARITHMETRIC, 0), "restart": (0, 3)}


def _synthetic_frame() -> bytes:
    """A seeded 4:2:0 frame of odd size (not a whole number of MCUs), coded
    by the JAX package's encoder."""
    rng = np.random.RandomState(11)
    h, w = 200, 328
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 128 + 70 * np.sin(xx / 23.0) * np.cos(yy / 17.0)
    pix = np.clip(base[..., None] + rng.randn(h, w, 3) * 20, 0, 255)
    from libmodjpeg_tpu.encode_pixels import from_pixels

    return jcodec.encode(from_pixels(pix.astype(np.uint8), quality=80,
                                     subsampling="420"))


@pytest.fixture(scope="module")
def sources():
    out = {}
    for name in ("image.jpg", "dropon.jpg", "mask.jpg"):
        with open(os.path.join(FIXTURE_IMAGES, name), "rb") as f:
            out[name] = f.read()
    out["synthetic"] = _synthetic_frame()
    return out


def _same_coefs(a, b):
    assert (a.width, a.height, a.jpeg_color_space) == \
        (b.width, b.height, b.jpeg_color_space)
    assert len(a.coefs) == len(b.coefs)
    for x, y in zip(a.coefs, b.coefs):
        np.testing.assert_array_equal(x, y)
    assert sorted(a.quant_tables) == sorted(b.quant_tables)
    for k in a.quant_tables:
        np.testing.assert_array_equal(a.quant_tables[k], b.quant_tables[k])


def test_codec_is_the_ports_own_build():
    """The port's codec library is built from its own sources into
    build/torch_codec/, never the JAX package's libmjtcodec.so."""
    path = tcodec.library_path()
    assert path.startswith(tcodec.BUILD_DIR)
    assert os.path.basename(os.path.dirname(path)) == "torch_codec"
    assert os.path.dirname(tcodec._NATIVE_DIR) == os.path.dirname(
        tcodec.__file__)
    tcodec._load()
    with open("/proc/self/maps") as f:
        maps = f.read()
    assert path in maps


@pytest.mark.parametrize("path", sorted(_PATHS))
@pytest.mark.parametrize("source", ["image.jpg", "dropon.jpg", "mask.jpg",
                                    "synthetic"])
def test_codec_equals_jax_codec(sources, source, path):
    """Same coefficients from both decoders; byte-identical encodes of them
    on the path; both decoders agree on the encoded file."""
    data = sources[source]
    timg, jimg = tcodec.decode(data), jcodec.decode(data)
    assert isinstance(timg, tmodel.CoefImage)
    _same_coefs(timg, jimg)
    options, ri = _PATHS[path]
    tbytes = tcodec.encode(timg, options=options, restart_interval=ri)
    jbytes = jcodec.encode(jimg, options=options, restart_interval=ri)
    assert tbytes == jbytes
    _same_coefs(tcodec.decode(tbytes), jcodec.decode(jbytes))
    # the JAX encoder takes the port's image and the port's encoder the
    # JAX package's (the two models have the same fields)
    assert jcodec.encode(timg, options=options, restart_interval=ri) == tbytes
    assert tcodec.encode(jimg, options=options, restart_interval=ri) == jbytes


@pytest.mark.parametrize("source", ["image.jpg", "synthetic"])
def test_band_splice_equals_jax(sources, source):
    """decode_band / encode_splice_band: the same band and splice record
    (slots 0-12; the port's slots 13-15 are its decode's phase times, which
    the JAX package leaves at zero), and byte-identical spliced output
    after an edit inside the band."""
    data = sources[source]
    if source == "image.jpg":
        # optimized tables: re-encode with standard ones first
        data = jcodec.encode(jcodec.decode(data))
    row0, row1 = 2, 5
    timg, tsp = tcodec.decode_band(data, row0, row1)
    jimg, jsp = jcodec.decode_band(data, row0, row1)
    _same_coefs(timg, jimg)
    assert tuple(tsp[:13]) == tuple(jsp[:13])
    assert tuple(jsp[13:]) == (0, 0, 0) and all(t > 0 for t in tsp[13:])
    for img in (timg, jimg):
        c0 = img.components[0]
        r = row0 * c0.v_samp
        img.coefs[0][r:r + 2, 1:4, 0, 0] += 3
    tout = tcodec.encode_splice_band(data, timg, row0, row1, tsp)
    jout = jcodec.encode_splice_band(data, jimg, row0, row1, jsp)
    assert tout == jout
    full = jcodec.decode(data)
    full.coefs[0][row0 * full.components[0].v_samp:][:2, 1:4, 0, 0] += 3
    _same_coefs(tcodec.decode(tout), full)


def _noise_frame(h, w, subsampling, seed, **encode_kw) -> bytes:
    """Noise pixels coded by the JAX package's encoder."""
    from libmodjpeg_tpu.encode_pixels import from_pixels

    rng = np.random.RandomState(seed)
    shape = (h, w) if subsampling == "gray" else (h, w, 3)
    return jcodec.encode(from_pixels(
        rng.randint(0, 256, shape).astype(np.uint8), quality=90,
        subsampling=subsampling), **encode_kw)


_SEQ = [((c,), 0, 63, 0, 0) for c in range(3)]
# (height, width, subsampling, encode keywords, nthreads) per first scan:
# those that visit every padded block clear block by block, the rest keep
# one memset before the scan
_STALE = {
    "restart64-420": (512, 512, "420", {"restart_interval": 64}, 0),
    "baseline-420": (768, 1024, "420", {}, 0),        # the self-sync split
    "baseline-420-serial": (768, 1024, "420", {}, 1),
    "progressive": (120, 200, "420", {"options": mt.OPTION_PROGRESSIVE}, 0),
    "arithmetic": (120, 200, "420", {"options": mt.OPTION_ARITHMETRIC}, 0),
    "non-interleaved": (120, 200, "420", {"scan_script": _SEQ}, 0),
    "two-of-three": (120, 200, "420",
                     {"scan_script": [((0, 1), 0, 63, 0, 0), _SEQ[2]]}, 0),
    "444": (120, 200, "444", {}, 0),
    "gray": (120, 200, "gray", {}, 0),
    "odd-size": (203, 331, "420", {"restart_interval": 7}, 0),
}


def _stale_planes(prezeroed):
    """A stand-in for codec._planes: planes filled with 0x5A5A, as a reused
    page-locked block holds an earlier frame, said to be zero or not."""
    def planes(components, data_len, may_pin):
        return [np.full((c.padded_height_in_blocks,
                         c.padded_width_in_blocks, 8, 8), 0x5A5A, np.int16)
                for c in components], prezeroed
    return planes


@pytest.mark.parametrize("case", sorted(_STALE))
def test_stale_planes_decode_equals_jax(monkeypatch, case):
    """Planes that hold stale data, handed over with prezeroed=0, decode to
    the JAX codec's coefficients on every kind of first scan: cleared block
    by block where it is sequential and interleaved over every component,
    by one memset before it otherwise.  Said to be zeroed, the same planes
    keep the fill, so the test's planes do reach the decoder."""
    h, w, sub, kw, nthreads = _STALE[case]
    data = _noise_frame(h, w, sub, len(case), **kw)
    want = jcodec.decode(data)
    monkeypatch.setattr(tcodec, "_planes", _stale_planes(False))
    _same_coefs(tcodec.decode(data, nthreads=nthreads), want)
    monkeypatch.setattr(tcodec, "_planes", _stale_planes(True))
    kept = tcodec.decode(data, nthreads=nthreads)
    assert any((a == 0x5A5A).any() for a in kept.coefs)


def test_stale_planes_of_a_frame_without_a_scan(monkeypatch):
    """A frame with no scan decodes to zero planes, also from stale ones."""
    sof = bytes([0xFF, 0xC0, 0, 17, 8, 0, 40, 0, 56, 3,
                 1, 0x22, 0, 2, 0x11, 0, 3, 0x11, 0])
    dqt = bytes([0xFF, 0xDB, 0, 67, 0]) + bytes(range(1, 65))
    data = b"\xff\xd8" + dqt + sof + b"\xff\xd9"
    want = jcodec.decode(data)
    assert not any(a.any() for a in want.coefs)
    monkeypatch.setattr(tcodec, "_planes", _stale_planes(False))
    _same_coefs(tcodec.decode(data), want)
    monkeypatch.setattr(tcodec, "_planes", _stale_planes(True))
    assert all((a == 0x5A5A).all() for a in tcodec.decode(data).coefs)


def _frame_420(width, height, seed, restart_interval=64) -> bytes:
    """A 4:2:0 frame with random DC and one random AC per block, coded by
    the port's encoder (at the grid chain's restart interval by default):
    3 bytes of planes per pixel from a file a few percent of their size."""
    rng = np.random.RandomState(seed)
    mw, mh = -(-width // 16), -(-height // 16)
    comps, coefs = [], []
    for c, (sh, sv) in enumerate([(2, 2), (1, 1), (1, 1)]):
        pw, ph = mw * sh, mh * sv
        a = np.zeros((ph, pw, 8, 8), np.int16)
        a[..., 0, 0] = rng.randint(-500, 500, (ph, pw))
        a[..., 0, 1] = rng.randint(-3, 4, (ph, pw))
        comps.append(tmodel.ComponentInfo(
            c + 1, sh, sv, int(c > 0), -(-width * sh // 16),
            -(-height * sv // 16), pw, ph))
        coefs.append(a)
    q = np.full((8, 8), 4, np.uint16)
    return tcodec.encode(tmodel.CoefImage(
        width=width, height=height, jpeg_color_space=3, components=comps,
        coefs=coefs, quant_tables={0: q, 1: q},
        sampling=tmodel.Sampling(2, 2)), restart_interval=restart_interval)


def _watch_planes(monkeypatch):
    """Fake a CUDA context, make a page-locked allocation a pageable one
    filled with 0x5A5A (a reused block), and record what codec._planes
    returns: [(bytes, prezeroed, tensor-backed)]."""
    seen, planes, empty = [], tcodec._planes, torch.empty
    asked = []

    def fake_empty(*shape, pin_memory=False, **kw):
        asked.append(pin_memory)
        return torch.full(*shape, 0x5A5A, **kw)

    def spy(components, data_len, may_pin):
        out, prezeroed = planes(components, data_len, may_pin)
        seen.append((sum(a.nbytes for a in out), prezeroed,
                     all(isinstance(a.base, torch.Tensor) for a in out)))
        return out, prezeroed

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch, "empty", fake_empty)
    monkeypatch.setattr(tcodec, "_planes", spy)
    return seen, asked


def test_large_frame_decodes_into_torch_planes(monkeypatch):
    """Over 32 MiB of planes, from a file long enough to fill them, in a
    process that holds a CUDA context (faked), decode() asks torch for
    page-locked planes (here pageable, holding a stale fill), says they are
    not zeroed, and gives the np.zeros decode's coefficients; decode_band
    keeps np.zeros."""
    data = _frame_420(4096, 2752, 1)
    band = _frame_420(4096, 2752, 1, restart_interval=0)
    want = tcodec.decode(data)
    seen, asked = _watch_planes(monkeypatch)
    got = tcodec.decode(data)
    assert seen == [(33816576, False, True)] and asked == [True] * 3
    _same_coefs(got, want)
    tcodec.decode_band(band, 0, 1)
    assert seen[1:] == [(33816576, True, False)] and asked == [True] * 3


def test_small_frame_keeps_zeroed_planes(monkeypatch):
    """1080p planes (6.3 MB) stay np.zeros, said to be zeroed, with a CUDA
    context up."""
    data = _frame_420(1920, 1080, 2)
    want = jcodec.decode(data)
    seen, asked = _watch_planes(monkeypatch)
    _same_coefs(tcodec.decode(data), want)
    assert seen == [(6266880, True, False)] and asked == []


def _huge_header() -> bytes:
    """A few hundred bytes that claim a 65535x65535 4:2:0 frame (12.9 GB of
    planes) and hold a scan but no Huffman table."""
    sof = bytes([0xFF, 0xC0, 0, 17, 8, 0xFF, 0xFF, 0xFF, 0xFF, 3,
                 1, 0x22, 0, 2, 0x11, 0, 3, 0x11, 0])
    dqt = bytes([0xFF, 0xDB, 0, 67, 0]) + bytes(range(1, 65))
    sos = bytes([0xFF, 0xDA, 0, 12, 3, 1, 0, 2, 0, 3, 0, 0, 63, 0])
    return (b"\xff\xd8" + dqt + sof + sos + bytes(range(1, 200))
            + b"\xff\xd9")


def test_crafted_huge_header_keeps_zeroed_planes(monkeypatch):
    """A tiny file that claims a huge frame gets np.zeros planes (calloc:
    nothing is touched), not page-locked ones, with a CUDA context up, and
    raises what the JAX codec raises (the host-RAM guard is off in both, so
    that the frame reaches the allocation)."""
    data = _huge_header()
    assert len(data) < 400
    monkeypatch.setattr(jcodec, "_available_ram_bytes", lambda: None)
    monkeypatch.setattr(tcodec, "_available_ram_bytes", lambda: None)
    with pytest.raises(mj.DecodeError) as want:
        jcodec.decode(data)
    seen, asked = _watch_planes(monkeypatch)
    with pytest.raises(mt.DecodeError) as got:
        tcodec.decode(data)
    assert str(got.value) == str(want.value)
    assert seen == [(8192 * 8192 * 128 + 2 * 4096 * 4096 * 128, True,
                     False)] and asked == []


_NO_CUDA_START = """
import sys, torch
from libmodjpeg_tpu_torch import codec
with open(sys.argv[1], "rb") as f:
    img = codec.decode(f.read())
print(sum(a.nbytes for a in img.coefs), torch.cuda.is_initialized(),
      all(a.base is None for a in img.coefs))
"""


def test_decode_never_starts_cuda(tmp_path):
    """In a fresh process, decode() of a frame with 40 MB of planes leaves
    CUDA uninitialised and its planes np.zeros."""
    path = tmp_path / "frame.jpg"
    path.write_bytes(_frame_420(4096, 3264, 3))
    r = subprocess.run([sys.executable, "-c", _NO_CUDA_START, str(path)],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["40108032", "False", "True"]


def test_optimal_table_builder_equals_jax():
    rng = np.random.RandomState(3)
    freq = rng.randint(0, 5000, 257).astype(np.int64)
    freq[256] = 0
    freq[rng.rand(257) < 0.3] = 0
    assert tcodec.build_optimal_table(freq) == \
        jcodec.build_optimal_table(freq)


def _fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        elif isinstance(x, dict):
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        elif dataclasses.is_dataclass(x):
            _fields_equal(x, y)
        elif isinstance(x, list) and x and dataclasses.is_dataclass(x[0]):
            for u, v in zip(x, y):
                _fields_equal(u, v)
        else:
            assert x == y, f.name


def _reference_objects():
    img = mj.read_jpeg(os.path.join(FIXTURE_IMAGES, "image.jpg"))
    d = mj.read_dropon(os.path.join(FIXTURE_IMAGES, "dropon.png"))
    p = jcomposer.plan_placement(img, d, mj.ALIGN_CENTER, 3, -5)
    cd = jcomposer.compile_dropon(d, img, p.blockoffset_x, p.blockoffset_y,
                                  p.crop_x, p.crop_y, p.crop_w, p.crop_h)
    return {"CoefImage": img, "ComponentInfo": img.components[1],
            "Sampling": img.sampling, "Dropon": d, "CompiledDropon": cd}


@pytest.mark.parametrize("kind", ["CoefImage", "ComponentInfo", "Sampling",
                                  "Dropon", "CompiledDropon"])
def test_from_reference_round_trips(kind):
    """Every model type comes over as the port's own class, field for field
    equal, with its arrays copied into numpy; a port object comes back as
    it is."""
    ref = _reference_objects()[kind]
    got = from_reference(ref)
    assert type(got) is getattr(tmodel, kind)
    assert type(ref) is not type(got)
    _fields_equal(got, ref)
    assert from_reference(got) is got
    for f in dataclasses.fields(got):
        v = getattr(got, f.name)
        if isinstance(v, list):
            assert all(not hasattr(x, "__array__") or isinstance(x, np.ndarray)
                       for x in v)
    if kind == "CoefImage":
        assert all(type(c) is tmodel.ComponentInfo for c in got.components)
        assert type(got.sampling) is tmodel.Sampling
        got.coefs[0][0, 0, 0, 0] += 1   # a copy: the reference is untouched
        assert got.coefs[0][0, 0, 0, 0] != ref.coefs[0][0, 0, 0, 0]


def test_from_reference_refuses_other_objects():
    with pytest.raises(TypeError):
        from_reference(np.zeros(3))
    with pytest.raises(TypeError):
        from_reference(tmodel.CoefImage)


def test_port_raises_its_own_errors(tmp_path):
    """Decode, file and colorspace errors are the port's classes, carrying
    the reference's codes, and not the JAX package's."""
    cases = [
        (lambda: mt.read_jpeg(b"\xff\xd8\xff\xe0 not a jpeg"), "DecodeError"),
        (lambda: mt.read_jpeg(str(tmp_path / "missing.jpg")), "FileIOError"),
        (lambda: mt.read_jpeg(b""), "NullDataError"),
        (lambda: mt.read_dropon_from_raw(np.zeros(12, np.uint8), 99, 2, 2),
         "UnsupportedColorspaceError"),
        (lambda: mt.read_dropon(b"GIF89a......", device="cpu"),
         "UnsupportedFiletypeError"),
    ]
    for fn, name in cases:
        with pytest.raises(getattr(mt, name)) as e:
            fn()
        assert isinstance(e.value, mt.ModJpegError)
        assert not isinstance(e.value, mj.ModJpegError)
        assert e.value.code == getattr(mj, name).code
