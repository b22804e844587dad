"""The CUDA kernel's compose (row form) and blend modes, the pixel decode,
the device histogram, the grid paths and the betterjpeg script on the card
(marked ``cuda``; skips without a GPU).  This file imports only the port,
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from libmodjpeg_tpu_torch.ops import compose_kernel as ck
from libmodjpeg_tpu_torch.parallel import batch as tbatch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, h, w, seed, per_image=False):
    """Row-form operands: an int16 [n, h, w, 64] region cut out of a wider
    tensor (strided images and block rows), one quant table per image, the
    dropon and mask shared (or per image) with a third of the positions
    zero-mask."""
    rng = np.random.RandomState(seed)
    big = rng.randint(-900, 901, (n + 1, h + 1, w + 3, 64)).astype(np.int16)
    region = torch.from_numpy(big)[:n, :h, 3:]
    q = torch.from_numpy(rng.randint(1, 256, (n, 64)).astype(np.int32))
    k = n if per_image else 1
    x0 = (rng.randn(k, h * w, 64) * 300).astype(np.float32)
    m = (rng.rand(k, h * w, 64) * 0.9).astype(np.float32)
    zero = rng.rand(h * w) < 1 / 3
    m[:, zero] = 0.0
    d, mm = torch.from_numpy(x0), torch.from_numpy(m)
    if not per_image:
        d, mm = d[0], mm[0]
    return [region, q, d, mm], zero


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 1, 15), (2, 1, 17),
                                   (3, 2, 7), (1, 1, 4099)])
@pytest.mark.parametrize("per_image", [False, True])
def test_kernel_matches_plain_version(cuda, shape, per_image):
    """+-1 on under 0.5% of coefficients against the row-form plain version
    on the card and on the CPU, zero-mask blocks exact, the same result in
    place of the region, and one launch counted per call."""
    n, h, w = shape
    cpu, zero = _inputs(n, h, w, n * 100 + w, per_image)
    dev = [t.to(cuda) for t in cpu]
    dev[0] = torch.from_numpy(np.zeros((n + 1, h + 1, w + 3, 64),
                                       np.int16)).to(cuda)[:n, :h, 3:]
    dev[0].copy_(cpu[0])              # strided on the card as on the CPU
    before = ck.launches
    got = ck.compose_rows_cuda(*dev)
    torch.cuda.synchronize()
    assert ck.launches == before + 1
    got = got.cpu().numpy().astype(int)
    for ref in (ck.compose_rows_ref(*dev).cpu(), ck.compose_rows_ref(*cpu)):
        d = np.abs(got - ref.numpy().astype(int))
        assert d.max() <= 1 and (d != 0).mean() < 0.005
    blocks = zero.reshape(h, w)
    np.testing.assert_array_equal(got[:, blocks], cpu[0].numpy()[:, blocks])
    ck.compose_rows_cuda(dev[0], *dev[1:], out=dev[0])
    np.testing.assert_array_equal(dev[0].cpu().numpy(), got)


@pytest.mark.parametrize("shape", [(1, 1, 33), (4, 3, 40)])
def test_kernel_opaque_blocks_equal_plain_version(cuda, shape):
    """Opaque blocks (mask exactly 1, whole-number dropon: a logo's core)
    are recomputed in the plain version's order, so they equal it bit for
    bit; the other blocks keep the +-1 bar."""
    n, h, w = shape
    cpu, _ = _inputs(n, h, w, 7 + w)
    cpu[2] = torch.round(cpu[2])
    opaque = np.arange(h * w) % 2 == 1
    cpu[3][opaque] = 1.0
    dev = [t.to(cuda) for t in cpu]
    got = ck.compose_rows_cuda(*dev).cpu().numpy()
    want = ck.compose_rows_ref(*cpu).numpy()
    blocks = opaque.reshape(h, w)
    np.testing.assert_array_equal(got[:, blocks], want[:, blocks])
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d != 0).mean() < 0.005


@pytest.mark.parametrize("n", [1, 15, 17, 4099])
def test_blend_kernel_matches_plain_version(cuda, n):
    """Blend mode: the TPU blend kernel's relative bar (rtol 1e-5, atol
    1e-3) against the plain version on the card and on the CPU, zero-mask
    blocks exactly x1, and one blend launch counted per call."""
    rng = np.random.RandomState(100 + n)
    x1 = (rng.randn(n, 64) * 300).astype(np.float32)
    x0 = (rng.randn(n, 64) * 300).astype(np.float32)
    m = (rng.rand(n, 64) * 0.9).astype(np.float32)
    zero = np.arange(n) % 3 == 0
    m[zero] = 0.0
    cpu = [torch.from_numpy(a) for a in (x1, x0, m)]
    dev = [t.to(cuda) for t in cpu]
    before = ck.blend_launches
    got = ck.blend_blocks_cuda(*dev)
    torch.cuda.synchronize()
    assert ck.blend_launches == before + 1
    got = got.cpu().numpy()
    for ts in (dev, cpu):
        ref = ck.blend_blocks_m(*[t.reshape(n, 8, 8) for t in ts])
        np.testing.assert_allclose(got, ref.cpu().numpy().reshape(n, 64),
                                   rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got[zero], x1[zero])


def test_to_pixels_on_card_equals_cpu(cuda):
    """The fixed-order IDCT gives the card and the CPU the same pixels, so
    a JPEG dropon compiles to the same bits on both."""
    import os

    import libmodjpeg_tpu_torch as mt
    from libmodjpeg_tpu_torch import codec
    from libmodjpeg_tpu_torch.pixels import to_pixels

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures")
    for name in ("image.jpg", "dropon.jpg", "mask.jpg"):
        with open(os.path.join(fixtures, name), "rb") as f:
            img = codec.decode(f.read())
        for cs in (mt.COLORSPACE_RGB, mt.COLORSPACE_GRAYSCALE,
                   mt.COLORSPACE_YCC):
            np.testing.assert_array_equal(to_pixels(img, cs, device=cuda),
                                          to_pixels(img, cs, device="cpu"))


def test_kernel_rejects_bad_inputs(cuda):
    cpu, _ = _inputs(2, 1, 4, 0)
    dev = [t.to(cuda) for t in cpu]
    with pytest.raises(TypeError):
        ck.compose_rows_cuda(dev[0].to(torch.int32), *dev[1:])
    with pytest.raises(ValueError):
        ck.compose_rows_cuda(dev[0], dev[1], dev[2][:3], dev[3])
    with pytest.raises(ValueError):
        ck.compose_rows_cuda(dev[0], dev[1].cpu(), *dev[2:])
    with pytest.raises(ValueError):  # a data pointer off 16-byte alignment
        odd = torch.zeros(2 * 4 * 64 + 1, dtype=torch.int16, device=cuda)
        ck.compose_rows_cuda(odd[1:].view(2, 1, 4, 64), *dev[1:])


def test_packed_step_on_card_matches_cpu(cuda):
    """The whole device step on the card vs on the CPU: raw outputs within
    +-1, and the downlink wire restores to the card's raw output."""
    rng = np.random.RandomState(3)
    meta, n, cap = (8, 2, 2), 5, 32
    sz = sum(meta) * 64
    flat = rng.randint(-60, 60, (n, sz)).astype(np.int16)
    flat[1, :40] = 900
    qstack = rng.randint(1, 120, (n, 64 * len(meta))).astype(np.int32)
    drops = [(rng.randn(hw, 64) * 200).astype(np.float32) for hw in meta]
    masks = [(rng.rand(hw, 64) * 0.9).astype(np.float32) for hw in meta]
    up = tbatch._wirepack(flat)

    def run(device):
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        return tbatch.packed_compose(meta, tuple(t(a) for a in up), t(qstack),
                                     tuple(t(d) for d in drops),
                                     tuple(t(m) for m in masks), cap)

    wire_g, raw_g = run(cuda)
    _, raw_c = run("cpu")
    raw_g = raw_g.cpu().numpy()
    d = np.abs(raw_g.astype(int) - raw_c.numpy().astype(int))
    assert d.max() <= 1 and (d != 0).mean() < 0.005
    restored, counts = tbatch._downunpack(wire_g.cpu().numpy(), cap)
    ok = counts <= cap
    np.testing.assert_array_equal(restored[ok], raw_g[ok])


def test_batch_composer_on_card_matches_cpu(cuda):
    """compose_images through the card's stream (pinned buffers, side
    stream, event) vs the CPU path on the same compiled dropon, with a
    downlink capacity small enough that rows overflow and are refetched."""
    import libmodjpeg_tpu_torch as mt
    from libmodjpeg_tpu_torch import codec
    from libmodjpeg_tpu_torch.encode_pixels import from_pixels

    rng = np.random.RandomState(9)
    imgs = [codec.decode(codec.encode(from_pixels(
        rng.randint(0, 256, (128, 128, 3)).astype(np.uint8), quality=100,
        subsampling="444", device="cpu"))) for _ in range(3)]
    logo = rng.randint(0, 256, (40, 72, 4)).astype(np.uint8)
    d = mt.read_dropon_from_raw(logo, mt.COLORSPACE_RGBA, 72, 40)
    place = (mt.ALIGN_TOP | mt.ALIGN_LEFT, 4, 4)
    gbc = tbatch.BatchComposer(imgs[0], d, *place, device=cuda)
    cbc = tbatch.BatchComposer(imgs[0], d, *place, device="cpu",
                               compiled=gbc.cd)
    gbc._down_cap = 8
    gout = [im.copy() for im in imgs]
    cout = [im.copy() for im in imgs]
    before = ck.launches
    gbc.compose_images(gout)
    assert ck.launches == before + len(gbc._meta)
    assert gbc._down_cap > 8
    cbc.compose_images(cout)
    for a, b in zip(gout, cout):
        for ca, cb in zip(a.coefs, b.coefs):
            dd = np.abs(ca.astype(int) - cb.astype(int))
            assert dd.max() <= 1 and (dd != 0).mean() < 0.005


def _random_420(seed, mcus_w, mcus_h):
    """A 4:2:0 CoefImage with sparse AC and dense DC (the shape of
    tests/test_fuzz_roundtrip.py random_image, built here without JAX)."""
    from libmodjpeg_tpu_torch import constants as C
    from libmodjpeg_tpu_torch.model import CoefImage, ComponentInfo, Sampling

    rng = np.random.RandomState(seed)
    comps, coefs = [], []
    for c, (sh, sv) in enumerate([(2, 2), (1, 1), (1, 1)]):
        pw, ph = mcus_w * sh, mcus_h * sv
        a = np.zeros((ph, pw, 8, 8), np.int16)
        nz = rng.rand(ph, pw, 8, 8) < 0.15
        a[nz] = rng.randint(-1023, 1024, nz.sum())
        a[..., 0, 0] = rng.randint(-1024, 1024, (ph, pw))
        comps.append(ComponentInfo(c + 1, sh, sv, 0 if c == 0 else 1,
                                   pw, ph, pw, ph))
        coefs.append(a)
    return CoefImage(
        width=mcus_w * 16, height=mcus_h * 16, jpeg_color_space=C.JCS_YCbCr,
        components=comps, coefs=coefs,
        # q >= 8 keeps a composed DC inside the encoder's range
        quant_tables={0: rng.randint(8, 64, (8, 8)).astype(np.uint16),
                      1: rng.randint(8, 64, (8, 8)).astype(np.uint16)},
        sampling=Sampling(2, 2))


@pytest.mark.parametrize("ri", [0, 5])
def test_symbol_freqs_on_card_equals_cpu(cuda, ri):
    """The device histogram counts exactly (integer ops), on a frame large
    enough for several counting chunks."""
    from libmodjpeg_tpu_torch.ops import histogram as th

    img = _random_420(ri, 96, 90)
    c0 = img.components[0]
    mw = c0.padded_width_in_blocks // c0.h_samp
    got = th.symbol_freqs(img.coefs, img.components, mw, ri, device=cuda)
    want = th.symbol_freqs(img.coefs, img.components, mw, ri, device="cpu")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _fixture_logo():
    import os

    import libmodjpeg_tpu_torch as mt

    return mt.read_dropon(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "fixtures",
        "dropon.png"), device="cpu")


def _check_grid(got, want, inside):
    for c, m in enumerate(inside):
        np.testing.assert_array_equal(got.coefs[c][~m], want.coefs[c][~m])
        d = np.abs(got.coefs[c][m].astype(int) - want.coefs[c][m])
        assert d.max() <= 1 and (d != 0).mean() < 0.005


def test_grid_session_on_card_matches_cpu(cuda):
    """Effects + compose + optimized encode on the card: identical to the
    CPU chain outside the footprint (the compiled dropon carried across),
    +-1 on under 0.5% inside, bytes equal to the host optimize pass."""
    import libmodjpeg_tpu_torch as mt
    from libmodjpeg_tpu_torch import codec
    from libmodjpeg_tpu_torch import composer
    from libmodjpeg_tpu_torch.parallel import BatchComposer, GridSession

    img = _random_420(7, 40, 27)
    logo = _fixture_logo()
    p = composer.plan_placement(img, logo, mt.ALIGN_CENTER, 5, -3)
    cd = composer.compile_dropon(logo, img, p.blockoffset_x, p.blockoffset_y,
                                 p.crop_x, p.crop_y, p.crop_w, p.crop_h,
                                 device=cuda)
    sessions = {}
    for dev in (cuda, "cpu"):
        s = GridSession(img, device=dev)
        s.effect("luminance", value=60).effect("tint", cb_value=25,
                                               cr_value=-9)
        before = ck.launches
        s.compose(logo, mt.ALIGN_CENTER, 5, -3, compiled=cd)
        s.effect("pixelate").block_until_ready()
        assert ck.launches == before + (3 if dev is cuda else 0)
        sessions[str(dev)] = s
    got = sessions[str(cuda)].to_image()
    bc = BatchComposer(img, logo, mt.ALIGN_CENTER, 5, -3, device="cpu",
                       compiled=cd)
    inside = [np.zeros(a.shape[:2], bool) for a in img.coefs]
    for c, (r0, c0, h, w) in enumerate(bc._region_origins()):
        inside[c][r0:r0 + h, c0:c0 + w] = True
    _check_grid(got, sessions["cpu"].to_image(), inside)
    data = sessions[str(cuda)].to_jpeg(options=mt.OPTION_OPTIMIZE,
                                       restart_interval=4)
    assert data == codec.encode(got, options=mt.OPTION_OPTIMIZE,
                                restart_interval=4)


def write_png(path, rgb):
    """RGB uint8 [H, W, 3] -> an 8-bit RGB PNG, filter type 0 on every row
    (the standard library only: the card's machine has no PIL)."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                + chunk(b"IEND", b""))


def test_betterjpeg_on_card_matches_cpu(cuda, tmp_path):
    """The betterjpeg script on the fixture with a red box, on the card and
    with device="cpu": 3 compose launches on the card, coefficients
    identical outside the edited MCUs in both outputs, +-1 on under 0.5%
    inside."""
    import os

    from libmodjpeg_tpu_torch import codec
    from libmodjpeg_tpu_torch.pixels import to_pixels
    from libmodjpeg_tpu_torch.scripts import betterjpeg

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "image.jpg")
    with open(src, "rb") as f:
        img = codec.decode(f.read())
    pix = to_pixels(img, device=cuda).copy()
    pix[40:70, 60:140] = [255, 0, 0]
    edited = str(tmp_path / "edited.png")
    write_png(edited, pix)
    outs = {}
    for dev in (cuda, "cpu"):
        out = str(tmp_path / f"out_{dev}.jpg")
        before = ck.launches
        assert betterjpeg.main([src, edited, out], device=dev) == 0
        assert ck.launches == before + (3 if dev is cuda else 0)
        with open(out, "rb") as f:
            outs[str(dev)] = codec.decode(f.read())
    # the box covers MCU rows 2-4 and MCU columns 3-8 (16x16 MCUs)
    mcus = np.zeros((16, 16), bool)
    mcus[2:5, 3:9] = True
    for c, ci in enumerate(img.components):
        m = np.kron(mcus, np.ones((ci.v_samp, ci.h_samp), bool))
        for out in outs.values():
            np.testing.assert_array_equal(out.coefs[c][~m], img.coefs[c][~m])
        d = np.abs(outs[str(cuda)].coefs[c][m].astype(int)
                   - outs["cpu"].coefs[c][m])
        assert d.max() <= 1 and (d != 0).mean() < 0.005


def test_compose_sharded_one_card_mesh(cuda):
    """compose_sharded over a one-card mesh == the single compose on the
    card (the same kernel on the same footprint)."""
    import libmodjpeg_tpu_torch as mt
    from libmodjpeg_tpu_torch.parallel import compose_sharded, make_mesh

    img = _random_420(11, 24, 19)
    logo = _fixture_logo()
    mesh = make_mesh([torch.device("cuda", 0)])
    before = ck.launches
    got = compose_sharded(img, logo, mt.ALIGN_CENTER, 3, -7, mesh)
    assert ck.launches == before + 3
    want = mt.compose(img, logo, mt.ALIGN_CENTER, 3, -7, device=cuda)
    for a, b in zip(got.coefs, want.coefs):
        np.testing.assert_array_equal(a, b)


def test_bench_kernel_roofline_on_card(cuda):
    """The bench's kernel_roofline: the compose's bytes (768 B per block +
    256) over its CUDA-event time, as a share of the card's own measured
    copy rate, which it may not exceed by more than 5%."""
    from libmodjpeg_tpu_torch.scripts import bench

    r = bench.kernel_roofline(np.random.RandomState(0), reps=5)
    assert r["bytes"] == 100_663_552 == bench.ROOF_BLOCKS * 768 + 256
    assert 0 < r["frac"] <= 1.05
    assert r["peak_gbps"] > 0 and r["published_peak_gbps"] == 3350.0
