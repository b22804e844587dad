"""The port's own host layer against the JAX package's, on the CPU: its
copy of the entropy codec (built by g++ from its own sources) decodes to
the same coefficients and encodes to the same bytes on every coding path;
state.from_reference carries every model type across; the port raises its
own error classes."""

import dataclasses
import os

import numpy as np
import pytest

import libmodjpeg_tpu as mj
import libmodjpeg_tpu_torch as mt
from libmodjpeg_tpu import codec as jcodec
from libmodjpeg_tpu import composer as jcomposer
from libmodjpeg_tpu_torch import codec as tcodec
from libmodjpeg_tpu_torch import model as tmodel
from libmodjpeg_tpu_torch.state import from_reference

from conftest import FIXTURE_IMAGES

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
    """decode_band / encode_splice_band: the same band and splice record,
    and byte-identical spliced output after an edit inside the band."""
    data = sources[source]
    if source == "image.jpg":
        # optimized tables: re-encode with standard ones first
        data = jcodec.encode(jcodec.decode(data))
    row0, row1 = 2, 5
    timg, tsp = tcodec.decode_band(data, row0, row1)
    jimg, jsp = jcodec.decode_band(data, row0, row1)
    _same_coefs(timg, jimg)
    assert tuple(tsp) == tuple(jsp)
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
