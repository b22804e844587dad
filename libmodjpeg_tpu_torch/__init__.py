"""libmodjpeg_tpu_torch — the DCT-domain JPEG watermarking engine of
libmodjpeg_tpu, ported to PyTorch with a hand-written CUDA kernel for
NVIDIA Hopper.

The host layer (the C++ entropy codec, the CoefImage/Dropon models, PNG and
raw dropon ingestion, the surgical splice planner, the bit-exact compose
arithmetic) is the port's own copy of libmodjpeg_tpu's: nothing here
imports libmodjpeg_tpu, and the codec is built by g++ into
``build/torch_codec/`` at first use.  What ran on the TPU (dropon compilation, JPEG-dropon decoding to
pixels, the compose step, the effects, the packed device step of the
streaming pipeline, the huge-image GridSession and its Huffman-optimize
histograms) runs here on a torch ``device``: ``"cuda"`` by default,
``"cpu"`` for the plain-torch path.  Nothing falls back from one to the
other.  ``parallel`` holds the batch composer, the meshes of devices, the
row-split grid helpers and ``GridSession``.  ``python -m
libmodjpeg_tpu_torch.cli`` is the modjpeg CLI, and ``python -m
libmodjpeg_tpu_torch.corpus`` the corpus runner.
"""

from .constants import (  # noqa: F401
    ALIGN_BOTTOM,
    ALIGN_CENTER,
    ALIGN_LEFT,
    ALIGN_RIGHT,
    ALIGN_TOP,
    BLEND_FULL,
    BLEND_NONE,
    BLEND_NONUNIFORM,
    COLORSPACE_GRAYSCALE,
    COLORSPACE_GRAYSCALEA,
    COLORSPACE_RGB,
    COLORSPACE_RGBA,
    COLORSPACE_YCC,
    COLORSPACE_YCCA,
    OPTION_ARITHMETIC,
    OPTION_ARITHMETRIC,
    OPTION_NONE,
    OPTION_OPTIMIZE,
    OPTION_PROGRESSIVE,
    VERSION_STR,
)
from .errors import (  # noqa: F401
    DecodeError,
    DroponDimensionsError,
    EncodeError,
    FileIOError,
    ImageSizeError,
    ModJpegError,
    NullDataError,
    UnsupportedColorspaceError,
    UnsupportedFiletypeError,
)
from .model import CoefImage, CompiledDropon, Dropon  # noqa: F401

__version__ = VERSION_STR


def read_jpeg(source, max_pixel: int = 0,
              allow_cmyk: bool = False) -> "CoefImage":
    """Read a JPEG (path or bytes) into coefficient space."""
    from .jpegio import read_jpeg as _impl

    return _impl(source, max_pixel=max_pixel, allow_cmyk=allow_cmyk)


def write_jpeg(img: "CoefImage", dest=None, options: int = 0,
               ref_markers: bool = False):
    """Write a CoefImage to a path (dest=str) or return bytes (dest=None)."""
    from .jpegio import write_jpeg as _impl

    return _impl(img, dest, options=options, ref_markers=ref_markers)


def read_dropon(source, mask=None, blend: int = BLEND_FULL,
                device="cuda") -> "Dropon":
    """Load a dropon from a PNG/JPEG path or bytes, with optional JPEG mask;
    a JPEG decodes to pixels on ``device``.

    Mirrors mj_read_dropon_from_file/_memory (dropon.c:34,66).
    """
    from .dropon import read_dropon as _impl

    return _impl(source, mask=mask, blend=blend, device=device)


def read_dropon_from_raw(rawdata, colorspace: int, width: int, height: int,
                         blend: int = BLEND_FULL) -> "Dropon":
    """Mirrors mj_read_dropon_from_raw (dropon.c:203)."""
    from .dropon import read_dropon_from_raw as _impl

    return _impl(rawdata, colorspace, width, height, blend)


def compose(img: "CoefImage", dropon: "Dropon", align: int = 0,
            offset_x: int = 0, offset_y: int = 0, bitexact: bool = False,
            device="cuda") -> "CoefImage":
    """Compose a dropon onto an image entirely in the DCT domain on
    ``device`` (mj_compose semantics).  Returns a new CoefImage.

    ``bitexact=True`` selects the host-side reference-parity path (numpy on
    the host whatever ``device`` says): with
    ``write_jpeg(..., ref_markers=True)`` whole output files are
    byte-identical to the reference binary's.
    """
    from . import composer

    if bitexact:
        return composer.compose_bitexact(img, dropon, align, offset_x,
                                         offset_y)
    return composer.compose(img, dropon, align, offset_x, offset_y,
                            device=device)


_WATERMARK_CACHE: dict = {}  # (dropon fp, geometry, placement, device) -> composer
_WATERMARK_CACHE_MAX = 16


def _dropon_fingerprint(d) -> str:
    """Content hash of a dropon, memoized on the instance (dropons are
    immutable after ingestion)."""
    fp = getattr(d, "_fingerprint", None)
    if fp is None:
        import hashlib

        import numpy as _np

        h = hashlib.sha1()
        h.update(_np.ascontiguousarray(d.image).tobytes())
        h.update(_np.ascontiguousarray(d.alpha).tobytes())
        h.update(f"{d.colorspace}/{d.blend}".encode())
        fp = h.hexdigest()
        try:
            d._fingerprint = fp
        except AttributeError:
            pass  # slotted/frozen instance: just recompute next time
    return fp


def watermark(data: bytes, dropon: "Dropon", align: int = 0,
              offset_x: int = 0, offset_y: int = 0, surgical=None,
              device="cuda") -> bytes:
    """One-shot bytes-in/bytes-out compose on ``device``: decode + compose +
    encode through BatchComposer.watermark_stream (surgical or band splice
    where the input allows; ``surgical=False`` forces the full pipeline).

    The composer (with its compiled dropon) is cached keyed by (dropon
    content, image geometry + quant tables, placement, device), so repeated
    calls with the same logo over same-shaped images skip the dropon
    compilation.
    """
    import torch

    from . import codec
    from .corpus import _geometry_key
    from .surgical import parse_structure

    from .parallel.batch import BatchComposer

    # header-only geometry probe where possible; DNL-deferred-height streams
    # (height 0 in the SOF) need a decode for their real height
    st = parse_structure(data)
    if st is not None and st.height == 0:
        st = None
    template = None
    if st is not None:
        gkey = st.geometry_key()
    else:
        template = codec.decode(data)
        gkey = _geometry_key(template)
    dev = torch.device(device)
    key = (_dropon_fingerprint(dropon), gkey, align, offset_x, offset_y,
           str(dev))
    bc = _WATERMARK_CACHE.get(key)
    if bc is None:
        if template is None:
            template = codec.decode(data)
        bc = BatchComposer(template, dropon, align, offset_x, offset_y,
                           device=dev)
        while len(_WATERMARK_CACHE) >= _WATERMARK_CACHE_MAX:
            _WATERMARK_CACHE.pop(next(iter(_WATERMARK_CACHE)))
        _WATERMARK_CACHE[key] = bc
    if bc.noop:
        return codec.encode(template if template is not None
                            else codec.decode(data))
    return next(iter(bc.watermark_stream(iter([data]), batch=1,
                                         surgical=surgical)))


def effect_grayscale(img: "CoefImage", device="cuda") -> "CoefImage":
    from .effects import grayscale

    return grayscale(img, device=device)


def effect_pixelate(img: "CoefImage", device="cuda") -> "CoefImage":
    from .effects import pixelate

    return pixelate(img, device=device)


def effect_tint(img: "CoefImage", cb_value: int, cr_value: int,
                device="cuda") -> "CoefImage":
    from .effects import tint

    return tint(img, cb_value, cr_value, device=device)


def effect_luminance(img: "CoefImage", value: int,
                     device="cuda") -> "CoefImage":
    from .effects import luminance

    return luminance(img, value, device=device)
