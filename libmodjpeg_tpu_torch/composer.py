"""Compose driver: placement, dropon compilation, compose (PyTorch port of
libmodjpeg_tpu.composer).

Placement mirrors compose.c:57-172 with its edge-case quirks; the dropon
compilation (dropon.c:325-428) runs color convert -> box subsample ->
batched FDCT -> round -> pixel-domain mask on ``device`` and leaves the
result there (``compile_dropon_device``), or copies it down once as the
host CompiledDropon model (``compile_dropon``; model.py, the port's copy
of the JAX package's).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import constants as C
from .errors import NullDataError, UnsupportedColorspaceError
from .model import CoefImage, CompiledDropon, Dropon
from .state import DeviceDropon, compiled_dropon_to_torch

from .ops import dct as dctops
from .ops.compose import mask_pix


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


@functools.lru_cache(maxsize=None)
def _alpha_factors_on(device: torch.device) -> torch.Tensor:
    """_ALPHA_FACTORS on ``device``, made once per device."""
    return torch.from_numpy(_ALPHA_FACTORS).to(device)


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
    return d * _alpha_factors_on(d.device)


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


def _dropon_canvas(d: Dropon, width: int, height: int, blockoffset_x: int,
                   blockoffset_y: int, crop_x: int, crop_y: int, crop_w: int,
                   crop_h: int, device: torch.device) -> tuple:
    """The cropped dropon's image and alpha, each padded by the block
    offsets (top-left) and up to ``width`` x ``height`` (bottom-right) with
    zeros: two float32 [height, width, 3] tensors on ``device``.

    Both go up in one [2, height, width, 3] copy, in uint8 when the
    dropon's pixels are, from page-locked memory on a CUDA device, so the
    copy queues on the stream without waiting for it."""
    dtype = (torch.uint8 if d.image.dtype == np.uint8
             and d.alpha.dtype == np.uint8 else torch.float32)
    canvas = torch.zeros((2, height, width, 3), dtype=dtype,
                         pin_memory=device.type == "cuda")
    host = canvas.numpy()
    for k, src in enumerate((d.image, d.alpha)):
        host[k, blockoffset_y:blockoffset_y + crop_h,
             blockoffset_x:blockoffset_x + crop_w] = \
            src[crop_y:crop_y + crop_h, crop_x:crop_x + crop_w]
    up = canvas.to(device, non_blocking=True).float()
    return up[0], up[1]


def compile_dropon_device(d: Dropon, img: CoefImage, blockoffset_x: int,
                          blockoffset_y: int, crop_x: int, crop_y: int,
                          crop_w: int, crop_h: int,
                          device="cuda") -> DeviceDropon:
    """mj_compile_dropon (dropon.c:325-428) on ``device``, left there: the
    DeviceDropon the compose reads, with the alpha weights.

    Pads the cropped dropon by the block offsets (top-left) and up to the MCU
    multiple (bottom-right) with zeros — zero alpha means those pixels leave
    the image untouched, which is how sub-MCU placement is realized.  Colour
    convert, box subsample, FDCT and round, then the pixel-domain masks as
    one float64 product (ops.compose.mask_pix).  Nothing comes back to the
    host and nothing waits for the stream: on a CUDA device the work queues
    behind what is already there.
    """
    device = torch.device(device)
    h_factor = img.sampling.h_factor
    v_factor = img.sampling.v_factor
    width = crop_w + blockoffset_x
    if width % h_factor:
        width += h_factor - (width % h_factor)
    height = crop_h + blockoffset_y
    if height % v_factor:
        height += v_factor - (height % v_factor)

    image, alpha = _dropon_canvas(d, width, height, blockoffset_x,
                                  blockoffset_y, crop_x, crop_y, crop_w,
                                  crop_h, device)
    planes = _convert_canvas(image, d.colorspace, img.jpeg_color_space)

    max_h, max_v = img.sampling.max_h_samp, img.sampling.max_v_samp
    # 12-bit target frames: an 8-bit dropon sample p maps to the 12-bit
    # sample p<<4, so the dropon's DCT scales linearly by 16 (the alpha
    # weights are a 0..1 blend fraction and stay precision-independent)
    scale = float(1 << (getattr(img, "precision", 8) - 8))
    drops, weights, masks, shapes = [], [], [], []
    for c in range(len(planes)):
        ci = img.components[c]
        fh, fv = max_h // ci.h_samp, max_v // ci.v_samp
        blocks = _plane_to_dct_blocks(planes[c], fh, fv)
        if scale != 1.0:
            blocks = blocks * scale
        # alpha: no color transform (dropon.c:402-415); the three alpha
        # channels are identical, so each component subsamples one plane
        w = _alpha_to_weights(alpha[..., min(c, 2)], fh, fv)
        shapes.append(tuple(blocks.shape[:2]))
        drops.append(blocks.reshape(-1, 64).contiguous())
        weights.append(w.reshape(-1, 64).contiguous())
        masks.append(mask_pix(weights[-1]))
    return DeviceDropon(drops=tuple(drops), masks=tuple(masks),
                        shapes=tuple(shapes), weights=tuple(weights))


def compile_dropon(d: Dropon, img: CoefImage, blockoffset_x: int,
                   blockoffset_y: int, crop_x: int, crop_y: int, crop_w: int,
                   crop_h: int, device="cuda") -> CompiledDropon:
    """mj_compile_dropon (dropon.c:325-428) as the host CompiledDropon
    model: compile_dropon_device on ``device`` and one copy of its drops,
    alpha weights and masks down to the host."""
    dd = compile_dropon_device(d, img, blockoffset_x, blockoffset_y, crop_x,
                               crop_y, crop_w, crop_h, device=device)
    flat = torch.cat(dd.drops + dd.weights + dd.masks).cpu().numpy()
    counts = [h * w for h, w in dd.shapes] * 3
    parts = np.split(flat, np.cumsum(counts)[:-1])
    n = len(dd.shapes)

    def blocks(k):       # the k-th of drops, weights, masks, per component
        return [parts[k * n + c].reshape(h, w, 8, 8)
                for c, (h, w) in enumerate(dd.shapes)]

    return CompiledDropon(
        image_colorspace=img.jpeg_color_space, image_blocks=blocks(0),
        alpha_weights=blocks(1),
        samp_factors=[(ci.h_samp, ci.v_samp) for ci in img.components[:n]],
        mask_pixels=blocks(2))


def _place_dropon(img: CoefImage, d: Dropon, align: int, offset_x: int,
                  offset_y: int, device, compiled=None):
    """Placement and compile of ``d`` against ``img`` on ``device``.

    Returns None when the placement is a no-op, else (placement, dropon,
    origins, host_bytes).  ``dropon`` is the DeviceDropon, compiled on
    ``device`` (compile_dropon_device) or, from a ready ``compiled``
    CompiledDropon (a JAX-package one carried over by
    state.from_reference), copied up from the host; ``host_bytes`` counts
    the bytes of it that passed through host memory, 0 when it was
    compiled on ``device``.  ``origins``: per component (row0, col0, h, w),
    the footprint's rectangle in blocks.
    """
    p = plan_placement(img, d, align, offset_x, offset_y)
    if p.noop:
        return None
    if compiled is None:
        dd = compile_dropon_device(d, img, p.blockoffset_x, p.blockoffset_y,
                                   p.crop_x, p.crop_y, p.crop_w, p.crop_h,
                                   device=device)
        host_bytes = 0
    else:
        dd = compiled_dropon_to_torch(compiled, device)
        host_bytes = sum(t.numel() * t.element_size()
                         for t in dd.drops + dd.masks)
    origins = tuple((p.block_y * ci.v_samp, p.block_x * ci.h_samp, h, w)
                    for ci, (h, w) in zip(img.components, dd.shapes))
    return p, dd, origins, host_bytes


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
