"""The port's f32 blend (blend_blocks_m, the plain version of the CUDA
kernel's blend mode) against the JAX package's blend kernel in interpret
mode, on the CPU; the blend router; the blend entry point of the CUDA
source (read as text: nothing is built here); the kernel bench's refusal to
run without a card."""

import ctypes
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from libmodjpeg_tpu.ops.compose import blend_blocks
from libmodjpeg_tpu.ops.compose import mask_pix_np as jmask_pix_np
from libmodjpeg_tpu.ops.dct import fdct_blocks
from libmodjpeg_tpu.ops.pallas_compose import blend_blocks_pallas
from libmodjpeg_tpu_torch import _build
from libmodjpeg_tpu_torch.ops import compose as tc
from libmodjpeg_tpu_torch.ops import compose_kernel


def _blend_m(x1, x0, m):
    n = x1.shape[0]
    return tc.blend_blocks_m(
        torch.from_numpy(x1.reshape(n, 8, 8)),
        torch.from_numpy(x0.reshape(n, 8, 8)),
        torch.from_numpy(m.reshape(n, 8, 8))).numpy().reshape(n, 64)


@pytest.mark.parametrize("n", [1, 7, 2048, 2051])
def test_blend_matches_pallas_kernel_interpret(n):
    """The TPU kernel's bar (tests/test_pallas.py): rtol 1e-5 / atol 1e-3
    against the kernel in interpret mode; rtol 1e-4 / atol 5e-3 against the
    S-basis spec blend_blocks on the alpha weights the mask came from."""
    rng = np.random.RandomState(n)
    x1 = (rng.randn(n, 64) * 300).astype(np.float32)
    x0 = (rng.randn(n, 64) * 300).astype(np.float32)
    w = (rng.randn(n, 8, 8) * 0.02).astype(np.float32)
    w[:, 0, 0] = 0.25
    m = tc.mask_pix_np(w).reshape(n, 64)
    np.testing.assert_array_equal(m, jmask_pix_np(w).reshape(n, 64))
    got = _blend_m(x1, x0, m)
    kernel = np.asarray(blend_blocks_pallas(
        jnp.asarray(x1), jnp.asarray(x0), jnp.asarray(m), interpret=True))
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-3)
    spec = np.asarray(blend_blocks(
        jnp.asarray(x1.reshape(n, 8, 8)), jnp.asarray(x0.reshape(n, 8, 8)),
        jnp.asarray(w))).reshape(n, 64)
    np.testing.assert_allclose(got, spec, rtol=1e-4, atol=5e-3)


def test_blend_opaque_identity():
    """An opaque mask blends to the dropon (tests/test_pallas.py's case)."""
    adct = np.rint(np.asarray(fdct_blocks(
        jnp.full((1, 8, 8), 255.0, jnp.float32))))[0]
    adct[0, 0] += 1024
    f = np.full((8, 8), 0.25)
    f[0, :] = 0.3535534 * 0.5
    f[:, 0] = 0.3535534 * 0.5
    f[0, 0] = 0.3535534 ** 2
    w = (adct * f / 1020.0).astype(np.float32)
    m = tc.mask_pix_np(w)
    rng = np.random.RandomState(0)
    n = 16
    x1 = (rng.randn(n, 64) * 300).astype(np.float32)
    x0 = (rng.randn(n, 64) * 300).astype(np.float32)
    mb = np.broadcast_to(m.reshape(64), (n, 64)).astype(np.float32)
    np.testing.assert_allclose(_blend_m(x1, x0, mb), x0, atol=3e-2)


def test_blend_zero_mask_blocks_exact():
    rng = np.random.RandomState(5)
    n = 2051
    x1 = (rng.randn(n, 64) * 300).astype(np.float32)
    x0 = (rng.randn(n, 64) * 300).astype(np.float32)
    m = (rng.rand(n, 64) * 0.9).astype(np.float32)
    zero = np.arange(n) % 3 == 0
    m[zero] = 0.0
    np.testing.assert_array_equal(_blend_m(x1, x0, m)[zero], x1[zero])


def test_blend_router_sends_cpu_tensors_to_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel wrapper reached for a CPU tensor")

    monkeypatch.setattr(compose_kernel, "blend_blocks_cuda", boom)
    rng = np.random.RandomState(6)
    n = 9
    x1, x0 = ((rng.randn(n, 8, 8) * 300).astype(np.float32) for _ in "ab")
    m = rng.rand(n, 8, 8).astype(np.float32)
    before = compose_kernel.blend_launches
    got = tc.blend_blocks_auto(torch.from_numpy(x1), torch.from_numpy(x0),
                               torch.from_numpy(m))
    assert compose_kernel.blend_launches == before
    assert got.shape == (n, 8, 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), _blend_m(x1, x0, m).reshape(n, 8, 8))


def test_blend_wrapper_refuses_cpu_tensors():
    t = torch.zeros((3, 64), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        compose_kernel.blend_blocks_cuda(t, t, t)


def _c_params(src: str, name: str) -> list:
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, f"{name} is not exported"
    return [p.strip() for p in m.group(1).split(",")]


def test_cuda_source_exports_blend_entry_with_argtypes():
    """compose.cu exports mjt_blend_blocks next to mjt_compose_rows, and
    _build gives each the argtypes of its C parameter list (pointers and
    the stream as c_void_p, counts and strides as c_longlong)."""
    with open(os.path.join(_build.CSRC, "compose.cu")) as f:
        src = f.read()
    assert "template <bool kBlend>" in src
    assert set(_build.SIGNATURES) == {"mjt_compose_rows", "mjt_blend_blocks"}
    for name in ("mjt_compose_rows", "mjt_blend_blocks"):
        params = _c_params(src, name)
        argtypes = _build.SIGNATURES[name]
        assert len(argtypes) == len(params)
        for p, a in zip(params, argtypes):
            want = ctypes.c_longlong if p.startswith("long long") \
                else ctypes.c_void_p
            assert a is want, (name, p, a)


def test_kernel_bench_raises_without_cuda(monkeypatch):
    """The bench needs a card: it raises before any work, never running a
    CPU substitute."""
    from libmodjpeg_tpu_torch.scripts import kernel_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_bench.main(["--sizes", "16", "--reps", "1", "--chain", "1"])
    assert kernel_bench.BYTES_PER_BLOCK == (2 + 2) * 64
