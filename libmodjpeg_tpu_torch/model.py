"""The port's copy of libmodjpeg_tpu.model (the coefficient-domain model).

TPU-first design decision: unlike the reference, which keeps coefficients in
libjpeg virtual block arrays attached to a live decompress struct
(libmodjpeg.h:99-107), coefficients here are dense numpy /
JAX arrays of shape ``[rows_padded, cols_padded, 8, 8]`` per component in
natural (row-major spatial-frequency) order, zero-padded to the MCU multiple.
That layout batches directly onto the VPU/MXU and shards cleanly over a device
mesh along the leading (block-grid) axes.
"""

from __future__ import annotations

import dataclasses


import numpy as np

from . import constants as C


@dataclasses.dataclass
class ComponentInfo:
    """Static per-component metadata (analog of jpeg_component_info)."""

    component_id: int
    h_samp: int
    v_samp: int
    quant_tbl_no: int
    # true (unpadded) block-grid dims, per T.81 A.1.1: ceil(comp_samples / 8)
    width_in_blocks: int
    height_in_blocks: int
    # padded-to-MCU-multiple dims == the array dims that hold the coefficients
    padded_width_in_blocks: int
    padded_height_in_blocks: int


@dataclasses.dataclass
class Sampling:
    """Sampling geometry of an image (analog of mj_sampling_t, libmodjpeg.h:76-84)."""

    max_h_samp: int
    max_v_samp: int

    @property
    def h_factor(self) -> int:
        return self.max_h_samp * C.DCTSIZE

    @property
    def v_factor(self) -> int:
        return self.max_v_samp * C.DCTSIZE


@dataclasses.dataclass
class CoefImage:
    """A JPEG held entirely in quantized-DCT-coefficient space.

    Analog of ``mj_jpeg_t`` (libmodjpeg.h:99-107) but self-contained: no open
    decoder state, just arrays.  ``coefs[c]`` has dtype int16 and shape
    ``[padded_height_in_blocks, padded_width_in_blocks, 8, 8]`` (natural order,
    NOT zigzag).  ``quant_tables[t]`` is uint16 ``[8, 8]`` natural order.
    """

    width: int
    height: int
    jpeg_color_space: int  # one of C.JCS_*
    components: list[ComponentInfo]
    coefs: list[np.ndarray]
    quant_tables: dict[int, np.ndarray]
    sampling: Sampling
    # (marker_code, payload) pairs; marker_code is the full 0xFFEn/0xFFFE code.
    # Saved on read, re-emitted on write (image.c:66-72,196-200 semantics).
    markers: list[tuple[int, bytes]] = dataclasses.field(default_factory=list)
    progressive: bool = False
    arithmetic: bool = False
    restart_interval: int = 0
    # sample precision (T.81 B.2.2): 8, or 12 for extended/progressive frames
    precision: int = 8

    @property
    def num_components(self) -> int:
        return len(self.components)

    def quant_table_for(self, c: int) -> np.ndarray:
        return self.quant_tables[self.components[c].quant_tbl_no]

    def copy(self) -> "CoefImage":
        return CoefImage(
            width=self.width,
            height=self.height,
            jpeg_color_space=self.jpeg_color_space,
            components=[dataclasses.replace(ci) for ci in self.components],
            coefs=[a.copy() for a in self.coefs],
            quant_tables={k: v.copy() for k, v in self.quant_tables.items()},
            sampling=dataclasses.replace(self.sampling),
            markers=list(self.markers),
            progressive=self.progressive,
            arithmetic=self.arithmetic,
            restart_interval=self.restart_interval,
            precision=self.precision,
        )


@dataclasses.dataclass
class Dropon:
    """Raw-pixel overlay, normalized to 3-channel image + 3-channel alpha.

    Analog of ``mj_dropon_t`` (libmodjpeg.h:109-118).  ``image`` and ``alpha``
    are uint8 arrays of shape ``[height, width, 3]``.  ``colorspace`` is the
    normalized storage colorspace (RGB, YCC or GRAYSCALE).  ``blend`` is
    C.BLEND_NONUNIFORM when a per-pixel alpha channel is present, otherwise the
    uniform blend value 0..255.
    """

    image: np.ndarray
    alpha: np.ndarray
    width: int
    height: int
    colorspace: int
    blend: int


@dataclasses.dataclass
class CompiledDropon:
    """Dropon compiled against a target image's colorspace/sampling/grid.

    Analog of ``mj_compileddropon_t`` (libmodjpeg.h:120-127) but arrays are
    dense: per component, ``image_blocks[c]`` is float32
    ``[h_blocks, w_blocks, 8, 8]`` holding the dropon's (effectively
    unquantized, Q100) DCT coefficients, and ``alpha_weights[c]`` the
    normalized mask-DCT convolution weights (DC level shift +1024, scaled by
    c(i)c(j)/1020 — dropon.c:542-566 semantics).  ``mask_pixels[c]`` is the
    mathematically equivalent per-coefficient PIXEL-domain mask (the
    operator's diagonal in the orthonormal DCT basis — ops/compose.py:
    mask_pix_np), which is what the hot compose kernels consume: with it
    the blend is 2 GEMMs instead of 16.
    """

    image_colorspace: int
    image_blocks: list[np.ndarray]
    alpha_weights: list[np.ndarray]
    # per-component sampling factors used at compile time
    samp_factors: list[tuple[int, int]]
    # pixel-domain masks, same shapes as alpha_weights
    mask_pixels: list[np.ndarray] = dataclasses.field(default_factory=list)
