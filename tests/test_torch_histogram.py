"""The port's device histograms (libmodjpeg_tpu_torch.ops.histogram)
against the JAX package's, on the CPU.

Counting is integer work, so the frequencies must equal the JAX package's
exactly, and the tables built from them must give files byte-identical to
the host OPTION_OPTIMIZE pass.
"""

import zlib

import numpy as np
import pytest
import torch

from libmodjpeg_tpu import codec
from libmodjpeg_tpu import constants as C
from libmodjpeg_tpu.ops import histogram as jh
from libmodjpeg_tpu_torch.ops import histogram as th
from libmodjpeg_tpu_torch.parallel.grid import _shard_grid
from libmodjpeg_tpu_torch.parallel.mesh import make_mesh

from test_fuzz_roundtrip import random_image

_CPU = torch.device("cpu")
# the samplings x restart intervals of tests/test_histogram.py, and 12-bit
_CASES = [("420", 0, 8), ("420", 5, 8), ("444", 0, 8), ("gray", 0, 8),
          ("gray", 3, 8), ("cmyk420", 0, 8), ("422", 7, 8), ("420", 0, 12)]
_IDS = [f"{s}-ri{ri}-{p}bit" for s, ri, p in _CASES]


def _mcus_wide(img):
    c0 = img.components[0]
    return c0.padded_width_in_blocks // c0.h_samp


def _image(sampling, ri, precision):
    rng = np.random.RandomState(zlib.crc32(f"{sampling}/{ri}/{precision}"
                                           .encode()))
    if precision == 12:
        return random_image(rng, sampling, 6, 5, precision=12)
    return random_image(rng, sampling, 9, 7, trim_x=3, trim_y=5)


@pytest.mark.parametrize("sampling,ri,precision", _CASES, ids=_IDS)
def test_symbol_freqs_equal_jax(sampling, ri, precision):
    img = _image(sampling, ri, precision)
    want = jh.symbol_freqs(img.coefs, img.components, _mcus_wide(img), ri)
    got = th.symbol_freqs(img.coefs, img.components, _mcus_wide(img), ri,
                          device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.int64
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("sampling,ri,precision", _CASES, ids=_IDS)
def test_tables_byte_identical_to_host_optimize(sampling, ri, precision):
    img = _image(sampling, ri, precision)
    tables = th.optimal_tables(img.coefs, img.components, _mcus_wide(img),
                               ri, device="cpu")
    host = codec.encode(img, options=C.OPTION_OPTIMIZE, restart_interval=ri)
    assert codec.encode(img, restart_interval=ri,
                        preset_tables=tables) == host


def test_bit_width_exact_to_2_pow_17():
    """The magnitude category by integer compares equals the bit length
    for every magnitude a 12-bit DC difference (< 2**16) can reach."""
    av = np.arange(0, 1 << 17, dtype=np.int32)
    want = np.array([int(v).bit_length() for v in av], np.int32)
    got = th._bit_width(torch.from_numpy(av)).numpy()
    np.testing.assert_array_equal(got, want)


def test_dc_difference_widened_before_subtracting():
    """DC values at the int16 extremes: the difference overflows int16 but
    not int32, and the category matches JAX's."""
    blocks = np.zeros((4, 8, 8), np.int16)
    blocks[:, 0, 0] = [32767, -32768, 32767, -1]
    pred = np.array([-1, 0, 1, 2], np.int32)
    want = np.asarray(jh.dc_category_hist(blocks, pred))
    got = th.dc_category_hist(torch.from_numpy(blocks),
                              torch.from_numpy(pred)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[15] == 1 and got[16] == 3     # 32767; 65535, 65535, 32768


@pytest.mark.parametrize("seed", [0, 1])
def test_single_plane_hists_equal_jax(seed):
    """ac_symbol_hist / dc_category_hist on one plane, including ZRL runs
    (a lone nonzero at the last zigzag position) and blocks without EOB."""
    rng = np.random.RandomState(seed)
    blocks = np.zeros((300, 8, 8), np.int16)
    nz = rng.rand(300, 8, 8) < 0.1
    blocks[nz] = rng.randint(-2000, 2001, nz.sum())
    blocks[::7, 7, 7] = 5            # zigzag 63: a run of up to 62 zeros
    blocks[::11] = rng.randint(1, 9, (28, 8, 8))     # full blocks, no EOB
    pred = np.arange(-1, 299, dtype=np.int32)
    np.testing.assert_array_equal(
        th.ac_symbol_hist(torch.from_numpy(blocks)).numpy(),
        np.asarray(jh.ac_symbol_hist(blocks)))
    np.testing.assert_array_equal(
        th.dc_category_hist(torch.from_numpy(blocks),
                            torch.from_numpy(pred)).numpy(),
        np.asarray(jh.dc_category_hist(blocks, pred)))


def test_counting_chunks_add_up(monkeypatch):
    """Counting in chunks smaller than the plane gives the same totals."""
    img = _image("420", 5, 8)
    want = th.symbol_freqs(img.coefs, img.components, _mcus_wide(img), 5,
                           device="cpu")
    monkeypatch.setattr(th, "_CHUNK", 7)
    got = th.symbol_freqs(img.coefs, img.components, _mcus_wide(img), 5,
                          device="cpu")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("ri", [0, 4])
def test_sharded_histogram_equals_unsharded(ri):
    """Row slabs over a [cpu] * 8 mesh on a frame whose 13 MCU rows do not
    divide by 8: per-slab AC counts, the DC plane gathered across slab
    borders, the padding rows left out; equal to the unsharded counts and
    to JAX's."""
    img = random_image(np.random.RandomState(3), "420", 8, 13)
    mesh = make_mesh([_CPU] * 8, batch=1, grid=8)
    sharded = [_shard_grid(mesh, a) for a in img.coefs]
    assert all(len(g.slabs) == 8 and g.slabs[0].shape[0] * 8 > g.rows
               for g in sharded)
    mw = _mcus_wide(img)
    got = th.symbol_freqs(sharded, img.components, mw, ri)
    flat = th.symbol_freqs([torch.from_numpy(a) for a in img.coefs],
                           img.components, mw, ri)
    want = jh.symbol_freqs(img.coefs, img.components, mw, ri)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(flat[k], want[k])
