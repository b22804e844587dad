"""The port's CLI (libmodjpeg_tpu_torch.cli, device="cpu") against the JAX
package's CLI on the same arguments.

Bars: effect-only, encode-option and bit-exact (-X) outputs are
byte-identical; compose outputs are identical outside the dropon footprints
and within +-1 on under 0.5% of the coefficients inside them.
"""

import os

import numpy as np
import pytest

import libmodjpeg_tpu as mj
from libmodjpeg_tpu import codec
from libmodjpeg_tpu.cli import main as jax_main
from libmodjpeg_tpu_torch import cli as tcli
from libmodjpeg_tpu_torch.parallel import BatchComposer

from conftest import FIXTURE_IMAGES as IMAGES
from test_cmyk import _make_cmyk

_IMG = f"{IMAGES}/image.jpg"
_PNG = f"{IMAGES}/dropon.png"
_JPG_MASK = f"{IMAGES}/dropon.jpg,{IMAGES}/mask.jpg"
_BR = mj.ALIGN_BOTTOM | mj.ALIGN_RIGHT
_TL = mj.ALIGN_TOP | mj.ALIGN_LEFT

# id -> (arguments with {IN}/{A}/{B} placeholders, outputs, footprints as
# (dropon, mask, align, offset_x, offset_y); none = byte-identical bar)
_CASES = {
    # tests/test_cli.py's invocations
    "readme_p_after_d": (["-i", "{IN}", "-d", _PNG, "-p", "br", "-o", "{A}"],
                         "A", [(_PNG, None, _TL, 0, 0)]),
    "readme_p_before_d": (["-i", "{IN}", "-p", "br", "-d", _PNG, "-o", "{A}"],
                          "A", [(_PNG, None, _BR, 0, 0)]),
    "outputs_and_effects": (["-i", "{IN}", "-x", "-o", "{A}", "-g", "-o",
                             "{B}"], "AB", []),
    "progressive_arithmetic": (["-i", "{IN}", "-P", "-A", "-o", "{A}"], "A",
                               []),
    # a JPEG dropon with its JPEG mask, then a PNG, at a kept offset
    "jpeg_dropon_mask": (["-i", "{IN}", "-p", "br", "-m", "-32,-32", "-d",
                          _JPG_MASK, "-p", "tl", "-d", _PNG, "-o", "{A}"],
                         "A", [(f"{IMAGES}/dropon.jpg", f"{IMAGES}/mask.jpg",
                                _BR, -32, -32),
                               (_PNG, None, _TL, -32, -32)]),
    "luminance_tints": (["-i", "{IN}", "-y", "40", "-b", "-30", "-r", "25",
                         "-o", "{A}", "--luminance=-3000", "-o", "{B}"],
                        "AB", []),
    "restart_interval": (["-i", "{IN}", "-R", "4", "-x", "-o", "{A}", "-O",
                          "-o", "{B}"], "AB", []),
    "cmyk_allowed": (["-C", "-i", "{CMYK}", "-y", "30", "-x", "-o", "{A}"],
                     "A", []),
    "cmyk_compose": (["-C", "-i", "{CMYK}", "-p", "cc", "-d", _PNG, "-o",
                      "{A}"], "A", [(_PNG, None, mj.ALIGN_CENTER, 0, 0)]),
    "bitexact_optimize": (["-X", "-i", "{IN}", "-O", "-p", "br", "-m",
                           "-5,-9", "-d", _JPG_MASK, "-o", "{A}"], "A", []),
    "bitexact_png_effect": (["-i", "{IN}", "-X", "-b", "20", "-p", "tr",
                             "-d", _PNG, "-o", "{A}"], "A", []),
}


@pytest.fixture(scope="module")
def cmyk_path(tmp_path_factory):
    img, _ = _make_cmyk(np.random.RandomState(11), w=96, h=64)
    path = tmp_path_factory.mktemp("cmyk") / "cmyk.jpg"
    path.write_bytes(codec.encode(img))
    return str(path)


def _run(main, args, tmp_path, tag, cmyk_path):
    outs = {k: str(tmp_path / f"{tag}_{k}.jpg") for k in "AB"}
    subst = {"{IN}": _IMG, "{CMYK}": cmyk_path,
             "{A}": outs["A"], "{B}": outs["B"]}
    return main([subst.get(a, a) for a in args]), outs


def _footprint_masks(image_path, footprints):
    """Per component, True on every block some dropon's footprint covers."""
    img = codec.decode(open(image_path, "rb").read())
    masks = [np.zeros(c.shape[:2], bool) for c in img.coefs]
    for dropon, mask, align, ox, oy in footprints:
        d = mj.read_dropon(dropon, mask=mask)
        bc = BatchComposer(img, d, align, ox, oy, device="cpu")
        for c, (r0, c0, h, w) in enumerate(bc._region_origins()):
            masks[c][r0:r0 + h, c0:c0 + w] = True
    return masks


@pytest.mark.parametrize("case", sorted(_CASES))
def test_cli_matches_jax(case, tmp_path, cmyk_path):
    args, outputs, footprints = _CASES[case]
    rc_j, jout = _run(jax_main, args, tmp_path, "jax", cmyk_path)
    rc_t, tout = _run(lambda a: tcli.main(a, device="cpu"), args, tmp_path,
                      "torch", cmyk_path)
    assert rc_j == rc_t == 0
    src = cmyk_path if "{CMYK}" in args else _IMG
    for k in outputs:
        want = open(jout[k], "rb").read()
        got = open(tout[k], "rb").read()
        if not footprints:
            assert got == want, f"output {k} differs"
            continue
        inside = _footprint_masks(src, footprints)
        a, b = codec.decode(got), codec.decode(want)
        differing = total = 0
        for c, m in enumerate(inside):
            np.testing.assert_array_equal(a.coefs[c][~m], b.coefs[c][~m])
            d = np.abs(a.coefs[c][m].astype(np.int64) - b.coefs[c][m])
            assert d.max() <= 1
            differing += int((d != 0).sum())
            total += d.size
        assert differing / total < 0.005


def test_cli_order_dependence(tmp_path):
    """-p after -d must not affect the already-applied compose."""
    o1, o2 = str(tmp_path / "o1.jpg"), str(tmp_path / "o2.jpg")
    assert tcli.main(["-i", _IMG, "-d", _PNG, "-p", "br", "-o", o1],
                     device="cpu") == 0
    assert tcli.main(["-i", _IMG, "-d", _PNG, "-o", o2], device="cpu") == 0
    assert open(o1, "rb").read() == open(o2, "rb").read()


@pytest.mark.parametrize("args,rc,message", [
    (["-i", "/nonexistent.jpg"], 1, "Can't read image"),
    (["-d", _PNG], 1, "Failed to apply the dropon"),
    (["-i", _IMG, "-d", "/nonexistent.png"], 1, "Can't read dropon"),
    (["-o", "/tmp/never.jpg"], 1, "Can't write image"),
    (["-i", _IMG, "-y"], 0, "Argument missing"),
    (["-i", _IMG, "-Z"], 0, "Unknown option"),
    (["-R", "x"], 0, "Invalid restart interval"),
    (["-h"], 0, "modjpeg (libmodjpeg_tpu)"),
], ids=["no_image", "dropon_first", "no_dropon", "no_output_image",
        "missing_arg", "unknown", "bad_restart", "help"])
def test_cli_errors_match_jax(args, rc, message, capsys):
    assert jax_main(list(args)) == rc
    want = capsys.readouterr()
    assert tcli.main(list(args), device="cpu") == rc
    got = capsys.readouterr()
    assert message in got.err
    assert (got.out, got.err) == (want.out, want.err)
