"""The port's compose step (libmodjpeg_tpu_torch.ops.compose) against the
JAX package's, on the CPU: the same numpy-seeded inputs through both."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from libmodjpeg_tpu.ops import compose as jc
from libmodjpeg_tpu.ops.pallas_compose import compose_blocks_pallas
from libmodjpeg_tpu_torch import _build
from libmodjpeg_tpu_torch.ops import compose as tc
from libmodjpeg_tpu_torch.ops import compose_kernel


def _inputs(n, seed, zero_frac=1 / 3):
    """region in [-900, 900], x0 ~ 300 randn, m in [0, 0.9), q in [1, 255];
    a share of the blocks gets an all-zero mask."""
    rng = np.random.RandomState(seed)
    region = rng.randint(-900, 900, (n, 64)).astype(np.int16)
    x0 = (rng.randn(n, 64) * 300).astype(np.float32)
    m = (rng.rand(n, 64) * 0.9).astype(np.float32)
    q = rng.randint(1, 255, (n, 64)).astype(np.int32)
    zero = rng.rand(n) < zero_frac
    m[zero] = 0.0
    return region, x0, m, q, zero


def _ref(region, x0, m, q):
    return tc.compose_blocks_ref(torch.from_numpy(region),
                                 torch.from_numpy(x0), torch.from_numpy(m),
                                 torch.from_numpy(q)).numpy()


@pytest.mark.parametrize("n", [1, 7, 2048, 2051])
def test_ref_equals_jax_compose_region_auto(n):
    """Plain torch vs the JAX package's XLA compose path: exactly equal."""
    region, x0, m, q, _ = _inputs(n, 10 + n)
    want = np.asarray(jc.compose_region_auto(
        jnp.asarray(region.reshape(n, 8, 8)), jnp.asarray(x0.reshape(n, 8, 8)),
        jnp.asarray(m.reshape(n, 8, 8)), jnp.asarray(q.reshape(n, 8, 8))))
    got = _ref(region, x0, m, q)
    np.testing.assert_array_equal(got, want.reshape(n, 64))


@pytest.mark.parametrize("n", [7, 2051])
def test_ref_against_pallas_kernel_interpret(n):
    """Plain torch vs the TPU kernel in interpret mode: the TPU kernel's own
    bar (+-1 on under 0.5% of coefficients), zero-mask blocks exact."""
    region, x0, m, q, zero = _inputs(n, 20 + n)
    want = np.asarray(compose_blocks_pallas(
        jnp.asarray(region), jnp.asarray(x0), jnp.asarray(m), jnp.asarray(q),
        interpret=True))
    got = _ref(region, x0, m, q)
    diff = got.astype(int) - want.astype(int)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() < 0.005
    np.testing.assert_array_equal(got[zero], region[zero])


def test_ref_zero_mask_is_exact_identity():
    """The test_pallas zero-mask case: region in +-2047, q up to 65534, an
    all-zero mask, a ragged count — the output is the input, bit for bit."""
    rng = np.random.RandomState(7)
    n = 2053
    region = rng.randint(-2047, 2048, (n, 64)).astype(np.int16)
    x0 = (rng.randn(n, 64) * 500).astype(np.float32)
    w = np.zeros((n, 64), np.float32)
    q = rng.randint(1, 65535, (n, 64)).astype(np.int32)
    np.testing.assert_array_equal(_ref(region, x0, w, q), region)


def test_numpy_builders_equal_jax_copies():
    np.testing.assert_array_equal(tc._dct_kron(), jc._dct_kron())
    rng = np.random.RandomState(3)
    w = (rng.randn(5, 8, 8) * 0.02).astype(np.float32)
    w[:, 0, 0] = 0.25
    np.testing.assert_array_equal(tc.mask_pix_np(w), jc.mask_pix_np(w))


def test_blend_blocks_m_matches_jax():
    rng = np.random.RandomState(4)
    n = 300
    x1 = (rng.randn(n, 8, 8) * 300).astype(np.float32)
    x0 = (rng.randn(n, 8, 8) * 300).astype(np.float32)
    m = (rng.rand(n, 8, 8)).astype(np.float32)
    want = np.asarray(jc.blend_blocks_m(jnp.asarray(x1), jnp.asarray(x0),
                                        jnp.asarray(m)))
    got = tc.blend_blocks_m(torch.from_numpy(x1), torch.from_numpy(x0),
                            torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_requant_trunc_matches_jax():
    rng = np.random.RandomState(5)
    v = rng.randint(-2 ** 30, 2 ** 30, (64, 64)).astype(np.int32)
    q = rng.randint(1, 65535, (64, 64)).astype(np.int32)
    want = np.asarray(jc.requant_trunc(jnp.asarray(v), jnp.asarray(q)))
    got = tc.requant_trunc(torch.from_numpy(v), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)


def _rows_inputs(seed, n, h, w, quant_shared, drop_shared, pad=(0, 0)):
    """Compact row-form operands: an int16 [n, h, w, 64] region cut out of
    a larger tensor (pad images and pad block rows beyond it, and a pad of
    three blocks before each block row, so its strides are not the dense
    ones), the quant per image or shared, the dropon and mask shared
    ([h * w, 64]) or per image ([n, h * w, 64]) with a third of the
    positions zero-mask.  Returns the torch operands and their broadcast
    [N, 64] numpy forms."""
    rng = np.random.RandomState(seed)
    big = rng.randint(-900, 901, (n + pad[0], h + pad[1], w + 3, 64))
    region = torch.from_numpy(big.astype(np.int16))[:n, :h, 3:]
    nq, nd = (1 if quant_shared else n), (1 if drop_shared else n)
    q = rng.randint(1, 256, (nq, 64)).astype(np.int32)
    x0 = (rng.randn(nd, h * w, 64) * 300).astype(np.float32)
    m = (rng.rand(nd, h * w, 64) * 0.9).astype(np.float32)
    m[:, rng.rand(h * w) < 1 / 3] = 0.0
    drop = torch.from_numpy(x0[0] if drop_shared else x0)
    mask = torch.from_numpy(m[0] if drop_shared else m)
    nb = n * h * w
    wide = (region.numpy().reshape(nb, 64),
            np.broadcast_to(x0, (n, h * w, 64)).reshape(nb, 64),
            np.broadcast_to(m, (n, h * w, 64)).reshape(nb, 64),
            np.broadcast_to(q[:, None], (n, h * w, 64)).reshape(nb, 64))
    return (region, torch.from_numpy(q), drop, mask), wide


_ROW_CASES = [(1, 1, 1), (1, 1, 7), (3, 1, 40), (2, 3, 5), (4, 2, 33)]


@pytest.mark.parametrize("quant_shared", [True, False])
@pytest.mark.parametrize("drop_shared", [True, False])
@pytest.mark.parametrize("n,h,w", _ROW_CASES)
def test_rows_ref_equals_blocks_ref_on_broadcast_operands(n, h, w,
                                                          quant_shared,
                                                          drop_shared):
    """The row-form plain version on a strided region, with shared and
    per-image quant, dropon and mask, equals compose_blocks_ref on the
    broadcast [N, 64] operands bit for bit, and the router writes the same
    into a strided output in place of the region."""
    ops, wide = _rows_inputs(n * 100 + h * 10 + w, n, h, w, quant_shared,
                             drop_shared, pad=(1, 2))
    want = _ref(*[np.array(a) for a in wide])
    got = tc.compose_rows_ref(*ops)
    assert got.shape == (n, h, w, 64) and got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().reshape(-1, 64), want)
    region = ops[0]
    before = region.clone()
    out = tc.compose_rows(region, *ops[1:], out=region)
    assert out is region
    np.testing.assert_array_equal(region.numpy().reshape(-1, 64), want)
    fresh = tc.compose_rows(before, *ops[1:])
    np.testing.assert_array_equal(fresh.numpy().reshape(-1, 64), want)


@pytest.mark.parametrize("n,h,w", [(3, 1, 40), (2, 3, 5)])
def test_rows_ref_against_pallas_kernel_interpret(n, h, w):
    """The row form against the JAX package's TPU kernel in interpret mode
    on the broadcast operands: the TPU kernel's bar (+-1 on under 0.5% of
    coefficients), zero-mask blocks exact."""
    ops, wide = _rows_inputs(70 + n, n, h, w, False, True)
    region, x0, m, q = (np.array(a) for a in wide)
    want = np.asarray(compose_blocks_pallas(
        jnp.asarray(region), jnp.asarray(x0), jnp.asarray(m), jnp.asarray(q),
        interpret=True))
    got = tc.compose_rows_ref(*ops).numpy().reshape(-1, 64)
    diff = got.astype(int) - want.astype(int)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() < 0.005
    zero = (m == 0).all(axis=1)
    assert zero.any()
    np.testing.assert_array_equal(got[zero], region[zero])


def test_router_sends_cpu_tensors_to_plain_version(monkeypatch):
    """A CPU tensor never reaches the kernel wrapper, and the router
    broadcasts a shared quant table like compose_region_auto does."""
    def boom(*a, **k):
        raise AssertionError("kernel wrapper reached for a CPU tensor")

    monkeypatch.setattr(compose_kernel, "compose_rows_cuda", boom)
    n = 9
    region, x0, m, q, _ = _inputs(n, 6)
    qt = q[0].reshape(1, 64)
    before = compose_kernel.launches
    out = tc.compose_rows(torch.from_numpy(region.reshape(1, 1, n, 64)),
                          torch.from_numpy(qt), torch.from_numpy(x0),
                          torch.from_numpy(m))
    assert compose_kernel.launches == before
    assert out.shape == (1, 1, n, 64) and out.dtype == torch.int16
    want = _ref(region, x0, m, np.broadcast_to(qt, (n, 64)).copy())
    np.testing.assert_array_equal(out.numpy().reshape(n, 64), want)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper raises for CPU tensors instead of falling back."""
    region, x0, m, q, _ = _inputs(3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        compose_kernel.compose_rows_cuda(
            torch.from_numpy(region.reshape(1, 1, 3, 64)),
            torch.from_numpy(q[:1]), torch.from_numpy(x0),
            torch.from_numpy(m))


def test_kernel_wrapper_refuses_bad_layouts():
    """Layouts the kernel cannot address raise before any device work: a
    block row whose blocks are not adjacent, an outer stride that is not a
    multiple of 64, quant or dropon of the wrong count, and a dropon shared
    while its mask is per image."""
    ops, _ = _rows_inputs(5, 2, 2, 4, False, True)
    region, q, d, m = ops
    wrap = compose_kernel.compose_rows_cuda
    with pytest.raises(ValueError, match="contiguous blocks"):
        wrap(region[:, :, ::2], q, d[:8], m[:8])
    odd = torch.zeros((2 * 2 * 4 * 64 + 2,), dtype=torch.int16)
    with pytest.raises(ValueError, match="multiples of 64"):
        wrap(odd[2:].as_strided((2, 2, 4, 64), (4 * 64 + 1, 4 * 64, 64, 1)),
             q, d, m)
    with pytest.raises(ValueError, match="quant"):
        wrap(region, q[:, :32], d, m)
    with pytest.raises(ValueError, match="dropon"):
        wrap(region, q, d[:5], m)
    with pytest.raises(ValueError, match="both be shared"):
        wrap(region, q, d, m.expand(2, 8, 64).contiguous())


def test_nvcc_command_targets_sm90a():
    """The build line names sm_90a (string check only; nothing is run)."""
    cmd = _build.nvcc_command("nvcc", "/tmp/out.so")
    line = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in line
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert cmd[-1].endswith("compose.cu")
    path = _build.library_path()
    assert path.startswith(_build.BUILD_DIR)
    assert "build" + "/torch_kernels" in path.replace("\\", "/")
