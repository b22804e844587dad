"""The port's mesh helpers, grid-sharded effects and compose, and
GridSession against the JAX package's, on the CPU.

The port's meshes list the CPU device eight times, so the row split, the
zero padding and the merge run for real; the JAX package runs on the
8-device virtual CPU mesh of conftest.py.  Effects are integer math and the
compose is exact on the CPU, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import libmodjpeg_tpu as mj
import libmodjpeg_tpu_torch as mt
from libmodjpeg_tpu import codec
from libmodjpeg_tpu import constants as C
from libmodjpeg_tpu import parallel as jpar
from libmodjpeg_tpu.parallel import batch as jbatch
from libmodjpeg_tpu_torch.parallel import (GridSession, batch_sharding,
                                           compose_sharded, effects_sharded,
                                           grid_sharding, make_mesh)
from libmodjpeg_tpu_torch.parallel import mesh as tmesh
from libmodjpeg_tpu_torch.parallel.batch import BatchComposer
from libmodjpeg_tpu_torch.state import from_reference

from conftest import FIXTURE_IMAGES as IMAGES
from test_fuzz_roundtrip import random_image
from test_precision12_dnl import _coef_image_12

_CPU = torch.device("cpu")


def _mesh(batch, grid):
    return make_mesh([_CPU] * (batch * grid), batch=batch, grid=grid)


@pytest.fixture(scope="module")
def base():
    return mj.read_jpeg(f"{IMAGES}/image.jpg")


@pytest.fixture(scope="module")
def logo():
    return mj.read_dropon(f"{IMAGES}/dropon.png")


def _assert_same(a, b, what=""):
    assert a.num_components == b.num_components
    for c in range(a.num_components):
        np.testing.assert_array_equal(a.coefs[c], b.coefs[c],
                                      err_msg=f"{what} component {c}")


def test_mesh_shapes():
    m = _mesh(8, 1)
    assert m.shape == {"batch": 8, "grid": 1} and m.size == 8
    m2 = make_mesh([_CPU] * 8, batch=4, grid=2)
    assert m2.shape == {"batch": 4, "grid": 2}
    assert m2.devices.shape == (4, 2) and len(m2.device_list) == 8
    assert make_mesh([_CPU] * 8, grid=4).shape == {"batch": 2, "grid": 4}
    with pytest.raises(ValueError):
        make_mesh([_CPU] * 8, batch=3, grid=3)
    assert len(batch_sharding(m2)) == 4 and len(grid_sharding(m2)) == 2
    if torch.cuda.is_available():
        assert make_mesh().size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError):
            make_mesh()          # no CUDA device: no silent CPU mesh


def test_stream_mesh_local_cards(monkeypatch):
    """stream_mesh spans the local CUDA devices, capped by
    MJT_STREAM_CHIPS, and is None below two."""
    monkeypatch.delenv("MJT_STREAM_CHIPS", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = tmesh.stream_mesh()
    assert m.shape == {"batch": 4}
    assert m.device_list == [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setenv("MJT_STREAM_CHIPS", "2")
    assert tmesh.stream_mesh().size == 2
    monkeypatch.setenv("MJT_STREAM_CHIPS", "1")
    assert tmesh.stream_mesh() is None
    monkeypatch.delenv("MJT_STREAM_CHIPS")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.stream_mesh() is None


def test_shard_rows_pad_split_merge():
    """13 rows over 8 slabs: 2 rows each, zero padding at the end, the
    merge trims it, and no slab aliases the input."""
    arr = np.arange(13 * 3 * 4, dtype=np.int16).reshape(13, 3, 2, 2)
    g = tmesh.shard_rows(arr, _mesh(2, 4).device_list)
    assert len(g.slabs) == 8 and g.slab_rows == 2 and g.rows == 13
    assert not g.slabs[-1].any() and not g.slabs[-2][1:].any()
    assert [s.shape[0] for s in g.real_slabs()] == [2] * 6 + [1, 0]
    np.testing.assert_array_equal(g.numpy(), arr)
    g.slabs[0][0] = 0
    assert arr[0].any()


_EFFECTS = [("grayscale", {}, lambda im: mt.effect_grayscale(im,
                                                            device="cpu")),
            ("pixelate", {}, lambda im: mt.effect_pixelate(im, device="cpu")),
            ("tint", {"cb_value": 80, "cr_value": -40},
             lambda im: mt.effect_tint(im, 80, -40, device="cpu")),
            ("luminance", {"value": 150},
             lambda im: mt.effect_luminance(im, 150, device="cpu"))]


@pytest.mark.parametrize("name,kwargs,api", _EFFECTS,
                         ids=[e[0] for e in _EFFECTS])
def test_effects_sharded_equal_jax(base, name, kwargs, api):
    """Each effect on a 2x4 mesh == JAX's effects_sharded == the port's
    API-level effect (8-bit: both clamps are +-2047)."""
    got = effects_sharded(base, name, _mesh(2, 4), **kwargs)
    _assert_same(got, jpar.effects_sharded(base, name,
                                           jpar.make_mesh(batch=2, grid=4),
                                           **kwargs), name)
    _assert_same(got, api(base), name)


def test_grid_path_clamps_12bit_dc_at_2047():
    """The JAX grid path clamps the dequantized DC to +-2047 on a 12-bit
    frame (fx.add_to_dc's default), where the API-level effect clamps to
    +-32767: the port reproduces the grid path's value, in effects_sharded
    and in GridSession."""
    img = _coef_image_12(np.random.RandomState(4))
    mesh = _mesh(1, 8)
    got = effects_sharded(img, "luminance", mesh, value=40000)
    _assert_same(got, jpar.effects_sharded(img, "luminance",
                                           jpar.make_mesh(batch=1, grid=8),
                                           value=40000))
    q0 = int(img.quant_table_for(0)[0, 0])
    assert int(got.coefs[0][..., 0, 0].max()) == 2047 // q0
    api = mt.effect_luminance(img, 40000, device="cpu")
    assert int(api.coefs[0][..., 0, 0].max()) == 32767 // q0
    sess = GridSession(img, device="cpu").effect("luminance", value=40000)
    _assert_same(sess.to_image(), got)


def test_compose_sharded_straddling_slabs(base, logo):
    """A centre overlay whose rows cross slab borders == the port's single
    compose, and == JAX's compose_sharded with its compiled dropon carried
    across."""
    place = (mj.ALIGN_CENTER, 3, -7)
    mesh = _mesh(1, 8)
    bc = BatchComposer(base, logo, *place, device="cpu")
    per = -(-base.coefs[0].shape[0] // 8)
    r0, _, h, _ = bc._region_origins()[0]
    assert r0 // per != (r0 + h - 1) // per      # the overlay straddles
    got = compose_sharded(base, logo, *place, mesh)
    _assert_same(got, mt.compose(base, logo, *place, device="cpu"))
    jbc = jbatch.BatchComposer(base, logo, *place)
    carried = compose_sharded(from_reference(base), from_reference(logo),
                              *place, mesh, compiled=from_reference(jbc.cd))
    _assert_same(carried, jpar.compose_sharded(
        base, logo, *place, jpar.make_mesh(batch=1, grid=8)))


def test_compose_sharded_noop_placement(base, logo):
    """An overlay placed outside the image leaves it unchanged."""
    got = compose_sharded(base, logo, mj.ALIGN_TOP | mj.ALIGN_LEFT, 4000, 0,
                          _mesh(1, 8))
    _assert_same(got, base)


def _chain(sess, logo, **compose_kw):
    sess.effect("luminance", value=77).effect("tint", cb_value=30,
                                              cr_value=-10)
    sess.compose(logo, mj.ALIGN_CENTER, -9, 4, **compose_kw)
    sess.effect("pixelate")
    return sess.to_image()


@pytest.mark.parametrize("mesh", [None, (2, 4), (1, 8)],
                         ids=["one-device", "mesh2x4", "mesh1x8"])
def test_grid_session_chain(base, logo, mesh):
    """The device-resident chain == the port's sequential API calls, on one
    device and on a mesh (test_parallel.py's chain)."""
    m = None if mesh is None else _mesh(*mesh)
    got = _chain(GridSession(base, m, device="cpu"), logo)
    want = mt.effect_luminance(base, 77, device="cpu")
    want = mt.effect_tint(want, 30, -10, device="cpu")
    want = mt.compose(want, logo, mj.ALIGN_CENTER, -9, 4, device="cpu")
    want = mt.effect_pixelate(want, device="cpu")
    _assert_same(got, want)


def test_grid_session_chain_equal_jax(base, logo):
    """With the JAX compiled dropon carried across, the port's session
    chain equals JAX's GridSession chain exactly."""
    cd = jbatch.BatchComposer(base, logo, mj.ALIGN_CENTER, -9, 4).cd
    got = _chain(GridSession(from_reference(base), _mesh(2, 4)),
                 from_reference(logo), compiled=from_reference(cd))
    want = _chain(jpar.GridSession(base, jpar.make_mesh(batch=2, grid=4)),
                  logo)
    _assert_same(got, want)


@pytest.mark.parametrize("mesh", [None, (1, 8)], ids=["one-device",
                                                     "mesh1x8"])
def test_grid_session_optimized_encode(mesh):
    """to_jpeg(OPTIMIZE): statistics from the resident grids (padding rows
    left out on a 13-row frame), bytes == the host optimize pass."""
    img = random_image(np.random.RandomState(3), "420", 8, 13)
    m = None if mesh is None else _mesh(*mesh)
    sess = GridSession(img, m, device="cpu")
    data = sess.to_jpeg(options=C.OPTION_OPTIMIZE, restart_interval=4)
    assert data == codec.encode(img, options=C.OPTION_OPTIMIZE,
                                restart_interval=4)
    _assert_same(codec.decode(data), img)
    assert sess.block_until_ready() is sess


def test_grid_session_leaves_input_alone(base, logo):
    before = [a.copy() for a in base.coefs]
    _chain(GridSession(base, device="cpu"), logo)
    for a, b in zip(base.coefs, before):
        np.testing.assert_array_equal(a, b)


def test_grid_session_cuda_without_card_raises(base):
    """No fallback: asking for the card where there is none raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        GridSession(base, device="cuda")
