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
from libmodjpeg_tpu_torch import tracing
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


@pytest.mark.parametrize("padded", [False, True], ids=["whole", "padded"])
@pytest.mark.parametrize("slabs", [1, 2, 3])
def test_downlink_owns_its_rows(slabs, padded):
    """ShardedRows.numpy is the row concatenation of the real slabs in one
    new array; GridSession.to_image equals the grids, its planes are the
    caller's to write, and last_to_image and the span count their bytes."""
    rng = np.random.RandomState(slabs)
    rows = 6                       # splits evenly over 1, 2 or 3 slabs
    per = -(-(rows + padded) // slabs)
    arr = rng.randint(-999, 999, (rows, 5, 8, 8)).astype(np.int16)
    full = np.concatenate([arr, np.full((per * slabs - rows, 5, 8, 8), -1,
                                        np.int16)])
    g = tmesh.ShardedRows([torch.from_numpy(full[k * per:(k + 1) * per])
                           for k in range(slabs)], rows)
    got = g.numpy()
    np.testing.assert_array_equal(got, np.concatenate(
        [s.numpy() for s in g.real_slabs()]))
    np.testing.assert_array_equal(got, arr)
    got += 1
    np.testing.assert_array_equal(full[:rows], arr)

    # 7 MCU rows leave padding rows in some plane over 2 or 3 slabs
    img = from_reference(random_image(rng, "420", 4, 6 + padded))
    before = [a.copy() for a in img.coefs]
    sess = GridSession(img, None if slabs == 1 else _mesh(1, slabs),
                       device="cpu")
    with tracing.recording():
        out = sess.to_image()
    nbytes = sum(a.nbytes for a in before)
    assert sess.last_to_image == {"bytes": nbytes, "pinned_bytes": 0,
                                  "host_copy_bytes": nbytes}
    sp = [s for s in tracing.spans()[0] if s.name == "mjt.grid.to_image"
          and s.ids["session"] == sess._ids["session"]]
    assert len(sp) == 1 and sp[0].ids == {**sess._ids, **sess.last_to_image}
    for c, p in enumerate(out.coefs):
        grid = sess.grids[c].numpy()
        np.testing.assert_array_equal(p, grid)
        np.testing.assert_array_equal(p, before[c])
        p += 1
        np.testing.assert_array_equal(sess.grids[c].numpy(), grid)
        np.testing.assert_array_equal(img.coefs[c], before[c])
    assert out.quant_tables[0] is not img.quant_tables[0]
    assert out.components[0] is not img.components[0]


@pytest.mark.parametrize("mesh", [None, (1, 2), (1, 3)],
                         ids=["one-device", "mesh1x2", "mesh1x3"])
def test_upload_counts_its_bytes(base, mesh):
    """last_upload and the upload span count the planes' bytes; on the CPU
    none are copied up from page-locked memory (asking would start a CUDA
    context), whether or not the rows split evenly over the mesh."""
    img = from_reference(base)
    with tracing.recording():
        sess = GridSession(img, None if mesh is None else _mesh(*mesh),
                           device="cpu")
    nbytes = sum(a.nbytes for a in img.coefs)
    assert sess.last_upload == {"bytes": nbytes, "pinned_bytes": 0}
    sp = [s for s in tracing.spans()[0] if s.name == "mjt.grid.upload"
          and s.ids["session"] == sess._ids["session"]]
    assert len(sp) == 1 and sp[0].ids == {**sess._ids, **sess.last_upload}
    assert not torch.cuda.is_initialized()
    _assert_same(sess.to_image(), base)


def test_grid_session_cuda_without_card_raises(base):
    """No fallback: asking for the card where there is none raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        GridSession(base, device="cuda")


def _host_model(img, logo, align, ox, oy):
    """compile_dropon's host CompiledDropon for a placement."""
    from libmodjpeg_tpu_torch import composer

    p = composer.plan_placement(img, logo, align, ox, oy)
    return composer.compile_dropon(logo, img, p.blockoffset_x,
                                   p.blockoffset_y, p.crop_x, p.crop_y,
                                   p.crop_w, p.crop_h, device="cpu")


@pytest.mark.parametrize("mesh", [None, (2, 4), (1, 8)],
                         ids=["one-device", "mesh2x4", "mesh1x8"])
def test_grid_compose_device_compile_equals_host_model(base, logo, mesh):
    """GridSession.compose compiles the logo where it composes: the planes
    equal those of the same chain given compile_dropon's host model, and
    last_compile and the compile span count the blocks and the bytes that
    passed through the host (none without ``compiled``)."""
    img, d = from_reference(base), from_reference(logo)
    cd = _host_model(img, d, mj.ALIGN_CENTER, -9, 4)
    blocks = sum(b.shape[0] * b.shape[1] for b in cd.image_blocks)
    nbytes = sum(a.size * 4 for a in cd.image_blocks + cd.mask_pixels)
    got = {}
    for kw, host in (({}, 0), ({"compiled": cd}, nbytes)):
        sess = GridSession(img, None if mesh is None else _mesh(*mesh),
                           device="cpu")
        with tracing.recording():
            got[host] = _chain(sess, d, **kw)
        assert sess.last_compile == {"blocks": blocks, "host_bytes": host}
        sp = [s for s in tracing.spans()[0] if s.name == "mjt.grid.compile"
              and s.ids["session"] == sess._ids["session"]]
        assert len(sp) == 1
        assert sp[0].ids == {**sess._ids, **sess.last_compile}
    _assert_same(got[0], got[nbytes])


def test_grid_compose_noop_placement_compiles_nothing(base, logo):
    """An overlay placed outside the frame compiles nothing and leaves the
    grids as they were."""
    sess = GridSession(from_reference(base), device="cpu")
    sess.compose(from_reference(logo), mj.ALIGN_TOP | mj.ALIGN_LEFT, 4000, 0)
    assert sess.last_compile == {"blocks": 0, "host_bytes": 0}
    _assert_same(sess.to_image(), base)


@pytest.mark.parametrize("mesh", [(1, 8), (2, 4)], ids=["mesh1x8",
                                                       "mesh2x4"])
def test_compose_sharded_device_compile_equals_host_model(base, logo, mesh):
    """compose_sharded compiles on the mesh's first device: equal to the
    same compose given compile_dropon's host model, on a placement whose
    rows cross slab borders."""
    img, d = from_reference(base), from_reference(logo)
    place = (mj.ALIGN_CENTER, 3, -7)
    m = _mesh(*mesh)
    _assert_same(compose_sharded(img, d, *place, m),
                 compose_sharded(img, d, *place, m,
                                 compiled=_host_model(img, d, *place)))
