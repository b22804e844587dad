"""The port's copy of libmodjpeg_tpu.bitexact's arithmetic (host numpy).

Bit-exact reference-parity compose.

The default compose pipeline is float32 matmuls on device; its untouched
blocks are bit-exact by construction and its touched blocks match the
reference to within one quantization step.  This module instead reproduces
libmodjpeg's EXACT arithmetic so whole output files can be byte-identical
to the reference binary's:

* dropon compilation == libjpeg's quality-100 re-encode (dropon.c:325-428 ->
  image.c:257-347): jccolor fixed-point RGB->YCC, jcsample biased box
  downsampling, jfdctint islow integer FDCT, half-away-from-zero
  quantization at quantval=1, alpha DC+1024 and double->float weight factors
  (dropon.c:544-566).
* masked blend == compose.c:237-342 + convolve.c semantics: in-place int16
  dequantize (with wraparound), C float32 accumulation with the exact
  per-case double/float expression mixing of mj_convolve (M_SQRT2 terms
  evaluate in double, plain terms in float), `(int)Y` truncation, and
  truncating requantization.

Enabled via ``compose(..., bitexact=True)`` (or the CLI's ``-X``), whose
wrapper is composer.compose_bitexact.  Runs on the host — this is a
compatibility mode, not the performance path.
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .model import Dropon

SQRT2 = np.float64(np.sqrt(2.0))  # C's M_SQRT2 (same double)


# ---------------------------------------------------------------- libjpeg
# fixed-point colorspace conversion (jccolor.c rgb_ycc_start tables)

_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)
_CBCR_OFFSET = 128 << _SCALEBITS


def _FIX(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def _rgb_ycc_fixed(rgb: np.ndarray) -> np.ndarray:
    """[h, w, 3] uint8 RGB -> [h, w, 3] uint8 YCbCr, libjpeg rgb_ycc_convert."""
    r = rgb[..., 0].astype(np.int64)
    g = rgb[..., 1].astype(np.int64)
    b = rgb[..., 2].astype(np.int64)
    y = (_FIX(0.29900) * r + _FIX(0.58700) * g + _FIX(0.11400) * b
         + _ONE_HALF) >> _SCALEBITS
    cb = (-_FIX(0.16874) * r - _FIX(0.33126) * g + _FIX(0.50000) * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> _SCALEBITS
    cr = (_FIX(0.50000) * r - _FIX(0.41869) * g - _FIX(0.08131) * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> _SCALEBITS
    return np.stack([y, cb, cr], axis=-1).astype(np.uint8)


def _rgb_gray_fixed(rgb: np.ndarray) -> np.ndarray:
    r = rgb[..., 0].astype(np.int64)
    g = rgb[..., 1].astype(np.int64)
    b = rgb[..., 2].astype(np.int64)
    y = (_FIX(0.29900) * r + _FIX(0.58700) * g + _FIX(0.11400) * b
         + _ONE_HALF) >> _SCALEBITS
    return y.astype(np.uint8)


# ------------------------------------------------------------- jcsample.c

def _downsample(plane: np.ndarray, h_expand: int, v_expand: int) -> np.ndarray:
    """libjpeg box downsample with its exact rounding biases.

    plane: [H, W] uint8, H % (8*v_expand) == W % (8*h_expand) == 0 (the
    compile canvas is MCU-aligned, so no edge expansion is ever needed).
    """
    p = plane.astype(np.int64)
    h, w = p.shape
    if h_expand == 1 and v_expand == 1:
        return plane.copy()
    if h_expand == 2 and v_expand == 1:
        # h2v1_downsample: bias alternates 0,1 per output column
        s = p[:, 0::2] + p[:, 1::2]
        bias = np.arange(w // 2, dtype=np.int64) & 1
        return ((s + bias[None, :]) >> 1).astype(np.uint8)
    if h_expand == 2 and v_expand == 2:
        # h2v2_downsample: bias alternates 1,2 per output column
        s = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2])
        bias = 1 + ((np.arange(w // 2, dtype=np.int64) & 1))
        return ((s + bias[None, :]) >> 2).astype(np.uint8)
    # int_downsample (generic): (sum + numpix/2) / numpix
    numpix = h_expand * v_expand
    s = p.reshape(h // v_expand, v_expand, w // h_expand, h_expand) \
        .sum(axis=(1, 3))
    return ((s + numpix // 2) // numpix).astype(np.uint8)


# ------------------------------------------------------------- jfdctint.c

_CONST_BITS = 13
_PASS1_BITS = 2
_F_0_298631336 = 2446
_F_0_390180644 = 3196
_F_0_541196100 = 4433
_F_0_765366865 = 6270
_F_0_899976223 = 7373
_F_1_175875602 = 9633
_F_1_501321110 = 12299
_F_1_847759065 = 15137
_F_1_961570560 = 16069
_F_2_053119869 = 16819
_F_2_562915447 = 20995
_F_3_072711026 = 25172


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, shift_bits, descale_bits):
    """One jpeg_fdct_islow butterfly pass over axis -1 ([..., 8] int64)."""
    tmp0 = d[..., 0] + d[..., 7]
    tmp7 = d[..., 0] - d[..., 7]
    tmp1 = d[..., 1] + d[..., 6]
    tmp6 = d[..., 1] - d[..., 6]
    tmp2 = d[..., 2] + d[..., 5]
    tmp5 = d[..., 2] - d[..., 5]
    tmp3 = d[..., 3] + d[..., 4]
    tmp4 = d[..., 3] - d[..., 4]

    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    out = np.empty_like(d)
    if shift_bits is not None:
        out[..., 0] = (tmp10 + tmp11) << shift_bits
        out[..., 4] = (tmp10 - tmp11) << shift_bits
    else:
        out[..., 0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[..., 4] = _descale(tmp10 - tmp11, _PASS1_BITS)

    z1 = (tmp12 + tmp13) * _F_0_541196100
    out[..., 2] = _descale(z1 + tmp13 * _F_0_765366865, descale_bits)
    out[..., 6] = _descale(z1 - tmp12 * _F_1_847759065, descale_bits)

    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * _F_1_175875602

    tmp4 = tmp4 * _F_0_298631336
    tmp5 = tmp5 * _F_2_053119869
    tmp6 = tmp6 * _F_3_072711026
    tmp7 = tmp7 * _F_1_501321110
    z1 = z1 * -_F_0_899976223
    z2 = z2 * -_F_2_562915447
    z3 = z3 * -_F_1_961570560
    z4 = z4 * -_F_0_390180644
    z3 = z3 + z5
    z4 = z4 + z5

    out[..., 7] = _descale(tmp4 + z1 + z3, descale_bits)
    out[..., 5] = _descale(tmp5 + z2 + z4, descale_bits)
    out[..., 3] = _descale(tmp6 + z2 + z3, descale_bits)
    out[..., 1] = _descale(tmp7 + z1 + z4, descale_bits)
    return out


def fdct_islow(samples: np.ndarray) -> np.ndarray:
    """jpeg_fdct_islow over batched blocks: [..., 8, 8] uint8 samples ->
    [..., 8, 8] int64 coefficients scaled by 8 (libjpeg workspace values)."""
    d = samples.astype(np.int64) - 128  # CENTERJSAMPLE
    # pass 1: rows (gains PASS1_BITS)
    d = _fdct_1d(d, _PASS1_BITS, _CONST_BITS - _PASS1_BITS)
    # pass 2: columns (drops PASS1_BITS)
    d = d.swapaxes(-1, -2)
    d = _fdct_1d(d, None, _CONST_BITS + _PASS1_BITS)
    return d.swapaxes(-1, -2)


def _quantize_q1(workspace: np.ndarray) -> np.ndarray:
    """jcdctmgr quantization at quantval=1 (divisor 8, half away from zero)."""
    a = np.abs(workspace)
    q = (a + 4) >> 3
    return (np.sign(workspace) * q).astype(np.int16)


def _tile(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


# ----------------------------------------------------- dropon compilation

_ALPHA_FACTORS = np.full((8, 8), 0.5 * 0.5 / 1020.0, dtype=np.float64)
_ALPHA_FACTORS[0, 1:] = 0.3535534 * 0.5 / 1020.0
_ALPHA_FACTORS[1:, 0] = 0.5 * 0.3535534 / 1020.0
_ALPHA_FACTORS[0, 0] = 0.3535534 * 0.3535534 / 1020.0


def compile_dropon_bitexact(d: Dropon, jpeg_color_space: int, max_h: int,
                            max_v: int, samp: list, blockoffset_x: int,
                            blockoffset_y: int, crop_x: int, crop_y: int,
                            crop_w: int, crop_h: int):
    """mj_compile_dropon with libjpeg-identical arithmetic.

    samp: [(h_samp, v_samp)] per component.  Returns (image_blocks,
    alpha_weights): lists of [hib, wib, 8, 8] float32.
    """
    h_factor = max_h * 8
    v_factor = max_v * 8
    width = crop_w + blockoffset_x
    if width % h_factor:
        width += h_factor - (width % h_factor)
    height = crop_h + blockoffset_y
    if height % v_factor:
        height += v_factor - (height % v_factor)

    def make_canvas(src: np.ndarray) -> np.ndarray:
        canvas = np.zeros((height, width, 3), dtype=np.uint8)
        canvas[blockoffset_y:blockoffset_y + crop_h,
               blockoffset_x:blockoffset_x + crop_w] = np.asarray(
            src[crop_y:crop_y + crop_h, crop_x:crop_x + crop_w],
            dtype=np.uint8)
        return canvas

    img_canvas = make_canvas(d.image)
    alpha_canvas = make_canvas(d.alpha)

    # image: in_color_space = dropon colorspace, out = image's jpeg space
    if jpeg_color_space == C.JCS_YCbCr:
        if d.colorspace == C.COLORSPACE_RGB:
            img_full = _rgb_ycc_fixed(img_canvas)
        elif d.colorspace == C.COLORSPACE_YCC:
            img_full = img_canvas
        else:
            raise ValueError("bitexact compile: unsupported dropon "
                             f"colorspace {d.colorspace}")
        img_planes = [img_full[..., i] for i in range(3)]
        # alpha claims YCC -> YCbCr: null conversion (dropon.c:402-415)
        alpha_planes = [alpha_canvas[..., i] for i in range(3)]
    elif jpeg_color_space == C.JCS_GRAYSCALE:
        if d.colorspace == C.COLORSPACE_RGB:
            img_planes = [_rgb_gray_fixed(img_canvas)]
        else:
            img_planes = [img_canvas[..., 0]]
        alpha_planes = [alpha_canvas[..., 0]]
    elif jpeg_color_space == C.JCS_RGB:
        img_planes = [img_canvas[..., i] for i in range(3)]
        alpha_planes = [alpha_canvas[..., i] for i in range(3)]
    else:
        raise ValueError("bitexact compile: unsupported jpeg colorspace "
                         f"{jpeg_color_space}")

    image_blocks, alpha_weights = [], []
    for c, (sh, sv) in enumerate(samp):
        he, ve = max_h // sh, max_v // sv
        img_coefs = _quantize_q1(fdct_islow(_tile(
            _downsample(img_planes[c], he, ve))))
        image_blocks.append(img_coefs.astype(np.float32))

        a_coefs = _quantize_q1(fdct_islow(_tile(
            _downsample(alpha_planes[c], he, ve)))).copy()
        a_coefs[..., 0, 0] += 1024  # dropon.c:545 (JCOEF add)
        # b[i] = (float)coef * <double constant>  -> rounds once to float
        alpha_weights.append(
            (a_coefs.astype(np.float64) * _ALPHA_FACTORS).astype(np.float32))
    return image_blocks, alpha_weights


# ------------------------------------------------------------ convolve.c

def _col_pass(X: np.ndarray, l: int) -> np.ndarray:
    """z = S_l column operator, mj_convolve's first switch.  X: [N, 64]
    float32 (rows of 8).  M_SQRT2 expressions evaluate in double then round
    to float on assignment; plain expressions stay float32."""
    n = X.shape[0]
    z = np.empty_like(X)
    for r in range(8):
        b = r * 8
        if l == 0:
            z[:, b:b + 8] = (2.0 * X[:, b:b + 8].astype(np.float64)) \
                .astype(np.float32)
            continue
        z[:, b + 0] = (SQRT2 * X[:, b + l].astype(np.float64)) \
            .astype(np.float32)
        for m in range(1, 8):
            p = m + l
            if m == l:
                e = SQRT2 * X[:, b + 0].astype(np.float64)
                if p < 8:
                    e = e + X[:, b + p].astype(np.float64)
                elif p > 8:
                    e = e - X[:, b + 16 - p].astype(np.float64)
                z[:, b + m] = e.astype(np.float32)
            else:
                t = X[:, b + abs(m - l)]
                if p < 8:
                    z[:, b + m] = t + X[:, b + p]
                elif p > 8:
                    z[:, b + m] = t - X[:, b + 16 - p]
                else:
                    z[:, b + m] = t
    return z


def _row_update(Y: np.ndarray, z: np.ndarray, w: np.ndarray, k: int) -> None:
    """Y[m] += (S_k row expr of z) * w, mj_convolve's second switch, with the
    `if (w == 0.0) return;` skip.  Y, z: [N, 64] float32; w: [N] float32."""
    live = w != 0.0
    if not live.any():
        return
    w64 = w.astype(np.float64)
    for m in range(8):
        o = m * 8
        if k == 0:
            e = (2.0 * z[:, o:o + 8].astype(np.float64)) * w64[:, None]
            upd = (Y[:, o:o + 8].astype(np.float64) + e).astype(np.float32)
        elif m == 0:
            e = (SQRT2 * z[:, k * 8:k * 8 + 8].astype(np.float64)) \
                * w64[:, None]
            upd = (Y[:, 0:8].astype(np.float64) + e).astype(np.float32)
        elif m == k:
            e = SQRT2 * z[:, 0:8].astype(np.float64)
            p = m + k
            if p < 8:
                e = e + z[:, p * 8:p * 8 + 8].astype(np.float64)
            elif p > 8:
                e = e - z[:, (16 - p) * 8:(16 - p) * 8 + 8].astype(np.float64)
            upd = (Y[:, o:o + 8].astype(np.float64) + e * w64[:, None]) \
                .astype(np.float32)
        else:
            t = z[:, abs(m - k) * 8:abs(m - k) * 8 + 8]
            p = m + k
            if p < 8:
                e32 = t + z[:, p * 8:p * 8 + 8]
            elif p > 8:
                e32 = t - z[:, (16 - p) * 8:(16 - p) * 8 + 8]
            else:
                e32 = t
            upd = Y[:, o:o + 8] + e32 * w[:, None]
        Y[:, o:o + 8] = np.where(live[:, None], upd, Y[:, o:o + 8])


def _wrap_i16(v: np.ndarray) -> np.ndarray:
    return ((v.astype(np.int64) + 32768) % 65536 - 32768).astype(np.int64)


def blend_bitexact(coefs: np.ndarray, quant: np.ndarray,
                   image_blocks: np.ndarray,
                   alpha_weights: np.ndarray) -> np.ndarray:
    """mj_compose_with_mask inner loop over a batch of blocks.

    coefs: [N, 64] int16 quantized image coefficients (in/out semantics of
    compose.c's JCOEF rows, including the int16 dequantize wraparound);
    quant: [64] uint16; image_blocks/alpha_weights: [N, 64] float32.
    Returns the requantized [N, 64] int16.
    """
    q = quant.astype(np.int64).reshape(-1)
    c16 = _wrap_i16(coefs.astype(np.int64) * q[None, :])  # in-place dequant
    X = image_blocks - c16.astype(np.float32)               # x = x0 - x1
    Y = np.zeros_like(X)
    zs = [_col_pass(X, l) for l in range(8)]
    for k in range(8):                                       # compose.c order
        for l in range(8):
            _row_update(Y, zs[l], alpha_weights[:, k * 8 + l], k)
    yint = np.trunc(Y.astype(np.float64)).astype(np.int64)   # (int)Y
    c16 = _wrap_i16(c16 + yint)                              # y = x1 + y'
    out = np.sign(c16) * (np.abs(c16) // q[None, :])         # JCOEF /= qval
    return out.astype(np.int16)

