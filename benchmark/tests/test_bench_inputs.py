"""The inputs are the benchmark's own and follow the seed alone."""

import numpy as np
import pytest
import torch

from benchmark import coder, inputs

SEEDS = (0, 7, 2**31 + 5, 2**40 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_files_repeat_for_a_seed(seed):
    a = inputs.jpeg_files(seed, 2, 64, 32, 85, 8, 0, 0, "cpu")
    b = inputs.jpeg_files(seed, 2, 64, 32, 85, 8, 0, 0, "cpu")
    assert a == b
    assert a[0] != a[1]                  # distinct files in the pool


def test_seeds_give_other_files_and_logos():
    files = {inputs.jpeg_files(s, 1, 64, 32, 85, 8, 0, 0, "cpu")[0]
             for s in SEEDS}
    assert len(files) == len(SEEDS)
    logos = {inputs.logo_pixels(s, 16, 8).tobytes() for s in SEEDS}
    assert len(logos) == len(SEEDS)
    np.testing.assert_array_equal(inputs.logo_pixels(3, 16, 8),
                                  inputs.logo_pixels(3, 16, 8))


def test_substream_takes_any_whole_number():
    vals = {inputs.substream(s, 1) for s in (-1, 0, 1, 2**31, 2**64 + 1)}
    assert len(vals) == 5
    assert all(0 <= v < 2**63 for v in vals)


@pytest.mark.parametrize("progressive,ri", [(False, 0), (True, 0),
                                            (False, 4)])
def test_files_decode_to_the_generated_coefficients(progressive, ri):
    gen = torch.Generator().manual_seed(inputs.substream(5, 1))
    planes = inputs.to_coefficients(
        inputs.photo_pixels(gen, 1, 64, 32, 8, "cpu"), 85)
    opts = coder.OPTION_PROGRESSIVE if progressive else 0
    data = inputs.jpeg_files(5, 1, 64, 32, 85, 8, opts, ri, "cpu")[0]
    img = coder.decode(data)
    assert img["progressive"] == progressive
    assert img["restart_interval"] == ri
    for got, want in zip(img["coefs"], planes):
        np.testing.assert_array_equal(got, want[0])


def test_quant_table_is_libjpegs():
    assert inputs.quant_table(inputs.STD_LUMA, 50)[0, 0] == 16
    assert inputs.quant_table(inputs.STD_LUMA, 85)[0, 0] == 5
    assert inputs.quant_table(inputs.STD_CHROMA, 90)[0, 0] == 3
