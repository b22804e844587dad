"""Compose driver: placement, dropon compilation, compose (PyTorch port of
libmodjpeg_tpu.composer).

Placement mirrors compose.c:57-172 with its edge-case quirks; the dropon
compilation (dropon.c:325-428) runs color convert -> box subsample ->
batched FDCT -> round on ``device`` and returns the host CompiledDropon
model (model.py, the port's copy of the JAX package's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import constants as C
from .errors import NullDataError, UnsupportedColorspaceError
from .model import CoefImage, CompiledDropon, Dropon

from .ops import dct as dctops
from .ops.compose import mask_pix_np


@dataclasses.dataclass
class Placement:
    """Resolved placement of a dropon on an image (compose.c:57-172)."""

    noop: bool
    crop_x: int = 0
    crop_y: int = 0
    crop_w: int = 0
    crop_h: int = 0
    blockoffset_x: int = 0
    blockoffset_y: int = 0
    block_x: int = 0
    block_y: int = 0
    position_x: int = 0
    position_y: int = 0


def plan_placement(img: CoefImage, d: Dropon, align: int, offset_x: int,
                   offset_y: int) -> Placement:
    """Placement/crop/block-offset math, mirroring compose.c:57-172 with its
    edge-case quirks (C-style truncation, negative clamping)."""
    if d.blend == C.BLEND_NONE:
        return Placement(noop=True)

    if align & C.ALIGN_LEFT:
        px = 0
    elif align & C.ALIGN_RIGHT:
        px = img.width - d.width
    else:
        px = img.width // 2 - d.width // 2
    px += offset_x
    if align & C.ALIGN_TOP:
        py = 0
    elif align & C.ALIGN_BOTTOM:
        py = img.height - d.height
    else:
        py = img.height // 2 - d.height // 2
    py += offset_y

    crop_x = -px if px < 0 else 0
    crop_w = d.width - crop_x
    if crop_x > d.width or px > img.width:
        crop_w = 0
    elif px + crop_x + crop_w > img.width:
        crop_w = img.width - crop_x - px
    crop_y = -py if py < 0 else 0
    crop_h = d.height - crop_y
    if crop_y > d.height or py > img.height:
        crop_h = 0
    elif py + crop_y + crop_h > img.height:
        crop_h = img.height - crop_y - py

    if crop_w <= 0 or crop_h <= 0:
        return Placement(noop=True)

    return Placement(
        noop=False, crop_x=crop_x, crop_y=crop_y, crop_w=crop_w,
        crop_h=crop_h,
        blockoffset_x=px % img.sampling.h_factor if px >= 0 else 0,
        blockoffset_y=py % img.sampling.v_factor if py >= 0 else 0,
        block_x=max(0, int(np.trunc(px / img.sampling.h_factor))),
        block_y=max(0, int(np.trunc(py / img.sampling.v_factor))),
        position_x=px, position_y=py)


# mask-DCT normalization factors (dropon.c:544-566)
_ALPHA_FACTORS = np.full((8, 8), 0.25 / 1020.0, dtype=np.float32)
_ALPHA_FACTORS[0, :] = 0.3535534 * 0.5 / 1020.0
_ALPHA_FACTORS[:, 0] = 0.5 * 0.3535534 / 1020.0
_ALPHA_FACTORS[0, 0] = 0.3535534 * 0.3535534 / 1020.0


def _plane_to_dct_blocks(plane: torch.Tensor, fh: int,
                         fv: int) -> torch.Tensor:
    """[H, W] float plane -> rounded Q100 DCT blocks [H/8fv, W/8fh, 8, 8]
    after box subsampling by (fh, fv)."""
    sub = dctops.subsample_plane(plane, fh, fv)
    return torch.round(dctops.fdct_blocks(dctops.tile_blocks(sub)))


def _alpha_to_weights(plane: torch.Tensor, fh: int, fv: int) -> torch.Tensor:
    """Alpha plane -> normalized convolution weights w' (dropon.c:497-576):
    Q100 DCT, DC+1024 level-shift undo, scale by c(i)c(j)/1020."""
    d = _plane_to_dct_blocks(plane, fh, fv).clone()
    d[..., 0, 0] += 1024.0
    return d * torch.from_numpy(_ALPHA_FACTORS).to(d.device)


def _convert_canvas(cf: torch.Tensor, src_cs: int, jpeg_cs: int) -> list:
    """3-channel float32 canvas in src colorspace -> list of target-space
    planes.

    CMYK/YCCK targets: Adobe stores CMYK inverted (sample 255 = no ink), so
    an RGB dropon maps to (C',M',Y') = (R,G,B) with a constant K' = 255
    plane; YCCK applies the YCC transform on top."""
    if jpeg_cs in (C.JCS_CMYK, C.JCS_YCCK):
        if src_cs == C.COLORSPACE_YCC:
            rgb = dctops.ycc_to_rgb(cf)
        elif src_cs in (C.COLORSPACE_RGB, C.COLORSPACE_GRAYSCALE):
            rgb = cf
        else:
            raise UnsupportedColorspaceError(str(src_cs))
        out = dctops.rgb_to_ycc(rgb) if jpeg_cs == C.JCS_YCCK else rgb
        k = torch.full_like(cf[..., 0], 255.0)
        return [out[..., 0], out[..., 1], out[..., 2], k]
    if jpeg_cs == C.JCS_YCbCr:
        if src_cs == C.COLORSPACE_RGB:
            out = dctops.rgb_to_ycc(cf)
        elif src_cs == C.COLORSPACE_YCC:
            out = cf
        elif src_cs == C.COLORSPACE_GRAYSCALE:
            # gray replicated: Y = g, neutral chroma
            out = torch.stack([cf[..., 0], torch.full_like(cf[..., 0], 128.0),
                               torch.full_like(cf[..., 0], 128.0)], dim=-1)
        else:
            raise UnsupportedColorspaceError(str(src_cs))
        return [out[..., i] for i in range(3)]
    if jpeg_cs == C.JCS_RGB:
        if src_cs == C.COLORSPACE_RGB or src_cs == C.COLORSPACE_GRAYSCALE:
            return [cf[..., i] for i in range(3)]
        if src_cs == C.COLORSPACE_YCC:
            out = dctops.ycc_to_rgb(cf)
            return [out[..., i] for i in range(3)]
        raise UnsupportedColorspaceError(str(src_cs))
    if jpeg_cs == C.JCS_GRAYSCALE:
        if src_cs == C.COLORSPACE_RGB:
            return [dctops.rgb_to_ycc(cf)[..., 0]]
        return [cf[..., 0]]
    raise UnsupportedColorspaceError(f"jpeg colorspace {jpeg_cs}")


def compile_dropon(d: Dropon, img: CoefImage, blockoffset_x: int,
                   blockoffset_y: int, crop_x: int, crop_y: int, crop_w: int,
                   crop_h: int, device="cuda") -> CompiledDropon:
    """mj_compile_dropon (dropon.c:325-428), computed on ``device``.

    Pads the cropped dropon by the block offsets (top-left) and up to the MCU
    multiple (bottom-right) with zeros — zero alpha means those pixels leave
    the image untouched, which is how sub-MCU placement is realized.
    """
    h_factor = img.sampling.h_factor
    v_factor = img.sampling.v_factor
    width = crop_w + blockoffset_x
    if width % h_factor:
        width += h_factor - (width % h_factor)
    height = crop_h + blockoffset_y
    if height % v_factor:
        height += v_factor - (height % v_factor)

    img_canvas = np.zeros((height, width, 3), dtype=np.float32)
    img_canvas[blockoffset_y:blockoffset_y + crop_h,
               blockoffset_x:blockoffset_x + crop_w] = \
        d.image[crop_y:crop_y + crop_h, crop_x:crop_x + crop_w]
    alpha_canvas = np.zeros((height, width, 3), dtype=np.float32)
    alpha_canvas[blockoffset_y:blockoffset_y + crop_h,
                 blockoffset_x:blockoffset_x + crop_w] = \
        d.alpha[crop_y:crop_y + crop_h, crop_x:crop_x + crop_w]

    jcs = img.jpeg_color_space
    planes = _convert_canvas(torch.from_numpy(img_canvas).to(device),
                             d.colorspace, jcs)
    alpha_dev = torch.from_numpy(alpha_canvas).to(device)

    max_h, max_v = img.sampling.max_h_samp, img.sampling.max_v_samp
    # 12-bit target frames: an 8-bit dropon sample p maps to the 12-bit
    # sample p<<4, so the dropon's DCT scales linearly by 16 (the alpha
    # weights are a 0..1 blend fraction and stay precision-independent)
    scale = float(1 << (getattr(img, "precision", 8) - 8))
    image_blocks, alpha_weights, samp = [], [], []
    for c in range(len(planes)):
        ci = img.components[c]
        fh, fv = max_h // ci.h_samp, max_v // ci.v_samp
        blocks = np.ascontiguousarray(
            _plane_to_dct_blocks(planes[c], fh, fv).cpu())
        image_blocks.append(blocks * scale if scale != 1.0 else blocks)
        # alpha: no color transform (dropon.c:402-415); the three alpha
        # channels are identical, so each component subsamples one plane
        aplane = alpha_dev[..., min(c, 2)]
        alpha_weights.append(np.ascontiguousarray(
            _alpha_to_weights(aplane, fh, fv).cpu()))
        samp.append((ci.h_samp, ci.v_samp))

    return CompiledDropon(image_colorspace=jcs, image_blocks=image_blocks,
                          alpha_weights=alpha_weights, samp_factors=samp,
                          mask_pixels=[mask_pix_np(w) for w in alpha_weights])


def compose(img: CoefImage, d: Dropon, align: int = 0, offset_x: int = 0,
            offset_y: int = 0, device="cuda") -> CoefImage:
    """mj_compose (compose.c:33-180).  Returns a new CoefImage; only the
    overlay footprint travels to ``device`` and back."""
    if img is None or d is None:
        raise NullDataError("image and dropon required")
    from .parallel.batch import BatchComposer

    out = img.copy()
    bc = BatchComposer(out, d, align, offset_x, offset_y, device=device)
    bc.compose_images([out])
    return out


def compose_bitexact(img: CoefImage, d: Dropon, align: int = 0,
                     offset_x: int = 0, offset_y: int = 0) -> CoefImage:
    """mj_compose with reference-identical arithmetic, on the host (the
    port of libmodjpeg_tpu.bitexact.compose_bitexact around this module's
    plan_placement; that module's own wrapper imports the JAX composer).
    Returns a new image."""
    from .bitexact import blend_bitexact, compile_dropon_bitexact

    if img is None or d is None:
        raise NullDataError("image and dropon required")
    out = img.copy()
    p = plan_placement(img, d, align, offset_x, offset_y)
    if p.noop:
        return out
    samp = [(ci.h_samp, ci.v_samp) for ci in img.components]
    image_blocks, alpha_weights = compile_dropon_bitexact(
        d, img.jpeg_color_space, img.sampling.max_h_samp,
        img.sampling.max_v_samp, samp, p.blockoffset_x, p.blockoffset_y,
        p.crop_x, p.crop_y, p.crop_w, p.crop_h)
    for c in range(len(image_blocks)):
        ci = img.components[c]
        r0 = p.block_y * ci.v_samp
        c0 = p.block_x * ci.h_samp
        hib, wib = image_blocks[c].shape[:2]
        region = out.coefs[c][r0:r0 + hib, c0:c0 + wib]
        blended = blend_bitexact(
            region.reshape(-1, 64),
            img.quant_table_for(c).reshape(-1),
            image_blocks[c].reshape(-1, 64),
            alpha_weights[c].reshape(-1, 64))
        out.coefs[c][r0:r0 + hib, c0:c0 + wib] = \
            blended.reshape(hib, wib, 8, 8)
    return out
