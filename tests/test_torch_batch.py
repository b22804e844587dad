"""The port's packed device step and streaming pipeline against the JAX
package's, on the CPU.

With the compiled dropon carried across (state.compiled_dropon_to_torch),
the two packages compose on identical state, so their JPEG bytes must be
identical on every stream path; with the port's own compile, the dropon's
one-step rounding differences may move footprint coefficients by +-1.
"""

import os

import numpy as np
import pytest
import torch

import libmodjpeg_tpu as mj
from libmodjpeg_tpu import codec
from libmodjpeg_tpu.encode_pixels import from_pixels
from libmodjpeg_tpu.parallel import batch as jbatch
from libmodjpeg_tpu_torch.parallel import batch as tbatch
from libmodjpeg_tpu_torch.state import from_reference

from conftest import FIXTURE_IMAGES

_PLACE = (mj.ALIGN_BOTTOM | mj.ALIGN_RIGHT, -32, -32)


def _coef_rows(rng, n, sz, n_exc):
    """[n, sz] int16 rows of small values with n_exc[i] out-of-int8 values
    in row i."""
    flat = rng.randint(-60, 60, (n, sz)).astype(np.int16)
    for i, k in enumerate(n_exc):
        cols = rng.choice(sz, k, replace=False)
        flat[i, cols] = rng.choice([-1, 1], k) * rng.randint(129, 2000, k)
    return flat


def test_wirepack_and_downunpack_identical():
    rng = np.random.RandomState(0)
    flat = _coef_rows(rng, 5, 640, [0, 3, 9, 40, 1])
    want, got = jbatch._wirepack(flat), tbatch._wirepack(flat)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tbatch._wirepack(_coef_rows(rng, 2, 64, [0, 30])) is None
    assert jbatch._wirepack(_coef_rows(rng, 2, 64, [0, 30])) is None
    wire = rng.randint(-128, 128, (4, 640 + 8 * 6 + 4)).astype(np.int8)
    sz = 640
    eidx = rng.randint(0, sz, (4, 8)).astype(np.int32)
    wire[:, sz:sz + 32] = eidx.view(np.int8)
    for a, b in zip(tbatch._downunpack(wire, 8), jbatch._downunpack(wire, 8)):
        np.testing.assert_array_equal(a, b)


def _step_inputs(seed, meta, n, n_exc):
    rng = np.random.RandomState(seed)
    sz = sum(meta) * 64
    flat = _coef_rows(rng, n, sz, n_exc)
    qstack = rng.randint(1, 120, (n, 64 * len(meta))).astype(np.int32)
    drops = [(rng.randn(hw, 64) * 200).astype(np.float32) for hw in meta]
    masks = []
    for hw in meta:
        m = (rng.rand(hw, 64) * 0.9).astype(np.float32)
        m[rng.rand(hw) < 0.3] = 0.0
        masks.append(m)
    return flat, qstack, drops, masks


@pytest.mark.parametrize("packed", [True, False])
def test_packed_step_wire_bytes_identical(packed):
    """The port's device step vs _packed_compose_fn(meta, None, packed,
    down_cap): identical downlink wire bytes and raw output, including a
    row whose composed exceptions overflow down_cap."""
    meta, n, down_cap = (6, 2, 2), 4, 8
    flat, qstack, drops, masks = _step_inputs(1, meta, n, [0, 2, 60, 5])
    jfn = jbatch._packed_compose_fn(meta, None, packed, down_cap)
    up = jbatch._wirepack(flat) if packed else (flat,)
    assert up is not None
    jw, jraw = jfn(*up, qstack, tuple(drops), tuple(masks))
    twire = (tuple(torch.from_numpy(a) for a in up) if packed
             else torch.from_numpy(flat))
    tw, traw = tbatch.packed_compose(
        meta, twire, torch.from_numpy(qstack),
        tuple(torch.from_numpy(d) for d in drops),
        tuple(torch.from_numpy(m) for m in masks), down_cap)
    np.testing.assert_array_equal(traw.numpy(), np.asarray(jraw))
    assert tw.dtype == torch.int8
    assert tw.numpy().tobytes() == np.asarray(jw).tobytes()
    _, counts = tbatch._downunpack(tw.numpy(), down_cap)
    assert counts.max() > down_cap  # the overflow row is exercised


def _synthetic_corpus(n, seed, w=512, h=512):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(n):
        base = (128 + 80 * np.sin(xx / rng.uniform(40, 90))
                * np.cos(yy / rng.uniform(40, 90)))
        pix = np.clip(base[..., None] + rng.randn(h, w, 3) * 14, 0,
                      255).astype(np.uint8)
        out.append(codec.encode(from_pixels(pix, quality=85,
                                            subsampling="420")))
    return out


@pytest.fixture(scope="module")
def corpora():
    with open(os.path.join(FIXTURE_IMAGES, "image.jpg"), "rb") as f:
        fixture = f.read()
    synth = _synthetic_corpus(3, 5)
    return {"fixture": [fixture] * 3, "synthetic512": synth}


@pytest.fixture(scope="module")
def dropon():
    return mj.read_dropon(os.path.join(FIXTURE_IMAGES, "dropon.png"))


_RESTART = 4


def _path_setup(datas, path):
    """(inputs, stream kwargs) that send a corpus down ``path``."""
    if path == "surgical":
        rst = [codec.encode(codec.decode(d), restart_interval=_RESTART)
               for d in datas]
        return rst, {"restart_interval": _RESTART}
    if path == "full":
        return datas, {"surgical": False}
    return datas, {}


def _run_both(datas, dropon, kwargs, carry):
    tmpl = codec.decode(datas[0])
    jbc = jbatch.BatchComposer(tmpl, dropon, *_PLACE)
    tbc = tbatch.BatchComposer(
        from_reference(tmpl), from_reference(dropon), *_PLACE, device="cpu",
        compiled=from_reference(jbc.cd) if carry else None)
    jout = list(jbc.watermark_stream(iter(datas), batch=2, **kwargs))
    tout = list(tbc.watermark_stream(iter(datas), batch=2, **kwargs))
    return jbc, tbc, jout, tout


@pytest.mark.parametrize("path", ["splice", "surgical", "full"])
@pytest.mark.parametrize("corpus", ["fixture", "synthetic512"])
def test_stream_bytes_identical_with_carried_compile(corpora, dropon, corpus,
                                                     path):
    datas, kwargs = _path_setup(corpora[corpus], path)
    jbc, tbc, jout, tout = _run_both(datas, dropon, kwargs, carry=True)
    assert tbc.last_stream_path == jbc.last_stream_path
    assert tbc.last_fallback_reasons == jbc.last_fallback_reasons
    if path == "full":
        assert tbc.last_stream_path == "full"
    elif corpus == "synthetic512":  # standard tables: no per-file fallback
        assert tbc.last_stream_path == path
    assert tbc.last_dispatch_devices == 1
    assert tbc.last_stream_stats["batches"] == 2
    assert len(tout) == len(datas)
    for a, b in zip(tout, jout):
        assert a == b


@pytest.mark.parametrize("path", ["splice", "surgical", "full"])
@pytest.mark.parametrize("corpus", ["fixture", "synthetic512"])
def test_stream_own_compile_footprint_within_one(corpora, dropon, corpus,
                                                 path):
    """Coefficients outside the footprint identical to the input; inside,
    within +-1 of the JAX package on under 0.5% of them."""
    datas, kwargs = _path_setup(corpora[corpus], path)
    jbc, tbc, jout, tout = _run_both(datas, dropon, kwargs, carry=False)
    assert tbc.last_stream_path == jbc.last_stream_path
    origins = tbc._region_origins()
    diffs, total = 0, 0
    for src, a, b in zip(datas, tout, jout):
        x, t, j = codec.decode(src), codec.decode(a), codec.decode(b)
        for c, (r0, c0, h, w) in enumerate(origins):
            outside = np.ones(x.coefs[c].shape[:2], bool)
            outside[r0:r0 + h, c0:c0 + w] = False
            np.testing.assert_array_equal(t.coefs[c][outside],
                                          x.coefs[c][outside])
            d = (t.coefs[c][r0:r0 + h, c0:c0 + w].astype(int)
                 - j.coefs[c][r0:r0 + h, c0:c0 + w].astype(int))
            assert np.abs(d).max() <= 1
            diffs += int((d != 0).sum())
            total += d.size
    assert diffs < 0.005 * total


def _heavy_images(n):
    """Synthetic 128x128 images whose footprint carries many coefficients
    outside int8, so the packed downlink overflows a small capacity."""
    rng = np.random.RandomState(9)
    imgs = []
    for _ in range(n):
        pix = rng.randint(0, 256, (128, 128, 3)).astype(np.uint8)
        img = codec.decode(codec.encode(from_pixels(pix, quality=100,
                                                    subsampling="444")))
        imgs.append(img)
    return imgs


def test_compose_images_downlink_overflow_refetch(dropon):
    """A batch whose composed rows overflow the downlink capacity restores
    them from the raw output and widens the capacity; the result equals the
    JAX package's on the same compiled dropon."""
    imgs = _heavy_images(3)
    place = (mj.ALIGN_TOP | mj.ALIGN_LEFT, 0, 0)
    jbc = jbatch.BatchComposer(imgs[0], dropon, *place)
    tbc = tbatch.BatchComposer(from_reference(imgs[0]),
                               from_reference(dropon), *place, device="cpu",
                               compiled=from_reference(jbc.cd))
    tbc._down_cap = 8
    jout = [im.copy() for im in imgs]
    tout = [from_reference(im) for im in imgs]
    jbc.compose_images(jout)
    tbc.compose_images(tout)
    assert tbc._down_cap > 8
    for a, b in zip(tout, jout):
        for ca, cb in zip(a.coefs, b.coefs):
            np.testing.assert_array_equal(ca, cb)


# -- whole-image batches and the mesh split (mesh.py, compose_batch) ---------

_CPU = torch.device("cpu")


def _mesh8():
    from libmodjpeg_tpu_torch.parallel import make_mesh

    return make_mesh([_CPU] * 8)


@pytest.fixture(scope="module")
def perturbed():
    """8 perturbed copies of the fixture image (test_parallel.py's batch)."""
    base = mj.read_jpeg(os.path.join(FIXTURE_IMAGES, "image.jpg"))
    rng = np.random.RandomState(0)
    images = []
    for _ in range(8):
        im = base.copy()
        for c in range(3):
            m = rng.randint(0, 2, im.coefs[c].shape[:2])[..., None, None]
            im.coefs[c] = (im.coefs[c] + m.astype(np.int16)).astype(np.int16)
        images.append(im)
    return images


_BATCH_PLACE = (mj.ALIGN_BOTTOM | mj.ALIGN_RIGHT, -5, -3)


@pytest.mark.parametrize("mesh", [False, True], ids=["one-device", "mesh8"])
def test_compose_batch_matches_single(perturbed, dropon, mesh):
    """compose_batch == one single compose per image, exactly."""
    from libmodjpeg_tpu_torch import compose
    from libmodjpeg_tpu_torch.parallel import compose_batch

    kw = {"mesh": _mesh8()} if mesh else {"device": "cpu"}
    batched = compose_batch(perturbed, dropon, *_BATCH_PLACE, **kw)
    for im, b in zip(perturbed, batched):
        s = compose(im, dropon, *_BATCH_PLACE, device="cpu")
        for c in range(3):
            np.testing.assert_array_equal(b.coefs[c], s.coefs[c])


def test_compose_batch_equal_jax_with_carried_compile(perturbed, dropon):
    from libmodjpeg_tpu.parallel import compose_batch as jcompose_batch
    from libmodjpeg_tpu.parallel import make_mesh as jmake_mesh
    from libmodjpeg_tpu_torch.parallel import compose_batch

    cd = jbatch.BatchComposer(perturbed[0], dropon, *_BATCH_PLACE).cd
    got = compose_batch([from_reference(im) for im in perturbed],
                        from_reference(dropon), *_BATCH_PLACE, _mesh8(),
                        compiled=from_reference(cd))
    want = jcompose_batch(perturbed, dropon, *_BATCH_PLACE,
                          mesh=jmake_mesh())
    for a, b in zip(got, want):
        for c in range(3):
            np.testing.assert_array_equal(a.coefs[c], b.coefs[c])


def test_put_batch_compose_arrays_reuse(perturbed, dropon):
    """A composer applies to successive batches; put_batch splits 5 images
    over the 8-slab mesh with zero padding; compose_arrays equals JAX's on
    the carried compiled dropon."""
    from libmodjpeg_tpu.parallel import make_mesh as jmake_mesh
    from libmodjpeg_tpu_torch.parallel.mesh import ShardedRows

    place = (mj.ALIGN_TOP | mj.ALIGN_LEFT, 7, 9)
    base = perturbed[0]
    jbc = jbatch.BatchComposer(base, dropon, *place, mesh=jmake_mesh())
    cd = from_reference(jbc.cd)
    base, dropon = from_reference(base), from_reference(dropon)
    tbc = tbatch.BatchComposer(base, dropon, *place, _mesh8(), compiled=cd)
    single = base.copy()       # a single compose on the same compiled dropon
    tbatch.BatchComposer(base, dropon, *place, device="cpu",
                         compiled=cd).compose_images([single])
    for n in (8, 5):
        batches = tbc.put_batch([base] * n)
        assert all(isinstance(b, ShardedRows) and len(b.slabs) == 8
                   and b.rows == n for b in batches)
        out = [b.numpy() for b in tbc.compose_arrays(batches)]
        for c in range(3):
            assert out[c].shape[0] == n
            for i in range(n):
                np.testing.assert_array_equal(out[c][i], single.coefs[c])
    jout = jbc.compose_arrays(jbc.put_batch(perturbed))
    tout = tbc.compose_arrays(tbc.put_batch(perturbed))
    for c in range(3):
        np.testing.assert_array_equal(tout[c].numpy(), np.asarray(jout[c]))


def test_compose_arrays_one_device_tensors(perturbed, dropon):
    """Without a mesh, put_batch gives one [N, H, W, 8, 8] tensor per
    component and compose_arrays updates it in place."""
    bc = tbatch.BatchComposer(perturbed[0], dropon, *_BATCH_PLACE,
                              device="cpu")
    batches = bc.put_batch(perturbed)
    assert batches[0].shape == (8,) + perturbed[0].coefs[0].shape
    out = bc.compose_arrays(batches)
    assert out[0] is batches[0]
    ref = [im.copy() for im in perturbed]
    bc.compose_images(ref)
    for c in range(3):
        for i in range(8):
            np.testing.assert_array_equal(out[c][i].numpy(), ref[i].coefs[c])


def test_mesh_and_device_must_agree(perturbed, dropon):
    with pytest.raises(ValueError):
        tbatch.BatchComposer(perturbed[0], dropon, *_BATCH_PLACE, _mesh8(),
                             device="cuda")


@pytest.mark.parametrize("corpus", ["fixture", "heavy"])
def test_stream_split_over_mesh_bytes_identical(corpora, dropon, corpus):
    """BatchComposer(mesh=[cpu] * 8) on 13 files splits each batch's rows
    into 8 slabs (3 zero rows with q = 1 of padding) and merges them: the
    stream bytes equal the one-device path's.  The heavy corpus with a
    small downlink capacity makes rows overflow in several slabs, so the
    refetch from each slab's raw output runs too."""
    if corpus == "fixture":
        datas = corpora["fixture"][:1] * 13
        place, cap = _PLACE, 32
    else:
        datas = [codec.encode(im) for im in _heavy_images(13)]
        place, cap = (mj.ALIGN_TOP | mj.ALIGN_LEFT, 0, 0), 8
    tmpl = codec.decode(datas[0])
    one = tbatch.BatchComposer(tmpl, dropon, *place, device="cpu")
    split = tbatch.BatchComposer(tmpl, dropon, *place, _mesh8(),
                                 compiled=one.cd)
    one._down_cap = split._down_cap = cap
    want = list(one.watermark_stream(iter(datas), batch=13,
                                     surgical=False))
    got = list(split.watermark_stream(iter(datas), batch=13,
                                      surgical=False))
    assert split.last_dispatch_devices == 8
    assert one.last_dispatch_devices == 1
    assert got == want
    if corpus == "heavy":
        assert split._down_cap > 8
