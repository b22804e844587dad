"""Device-resident compose state built from a host CompiledDropon, and
the carry-across from the JAX package's model objects.

The port's model (model.py) is a copy of the JAX package's, field for
field.  ``from_reference`` turns a JAX-package CoefImage, Dropon or
CompiledDropon into the port's own type by reading those fields, without
importing the JAX package: that is how a test runs the two packages on
identical state (for example a dropon compiled by the JAX package driving
the port's compose).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .model import CoefImage, CompiledDropon, ComponentInfo, Dropon, Sampling

_MODEL_TYPES = {t.__name__: t for t in (CoefImage, ComponentInfo, Sampling,
                                        Dropon, CompiledDropon)}


def _carry(value):
    """A field value with every model object in it carried over and every
    array copied into a numpy array."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return from_reference(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_carry(v) for v in value)
    if isinstance(value, dict):
        return {k: _carry(v) for k, v in value.items()}
    if hasattr(value, "__array__") and not isinstance(value, np.generic):
        return np.array(value)
    return value


def from_reference(obj):
    """The port's own model object for ``obj``: a CoefImage, ComponentInfo,
    Sampling, Dropon or CompiledDropon of either package, matched by its
    class name.  Each field of the port's dataclass is read from ``obj`` by
    name, arrays as new numpy arrays.  A port object comes back as it is.
    """
    cls = _MODEL_TYPES.get(type(obj).__name__)
    if cls is None or not dataclasses.is_dataclass(obj):
        raise TypeError(f"not a model object: {type(obj).__name__}")
    if isinstance(obj, cls):
        return obj
    return cls(**{f.name: _carry(getattr(obj, f.name))
                  for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class DeviceDropon:
    """Per component c: ``drops[c]`` the dropon's DCT coefficients and
    ``masks[c]`` the pixel-domain mask, both float32 [h_c * w_c, 64] on the
    device; ``shapes[c]`` = (h_c, w_c) in blocks."""

    drops: tuple
    masks: tuple
    shapes: tuple

    @property
    def meta(self) -> tuple:
        """Blocks per component (h_c * w_c), the packed step's layout."""
        return tuple(h * w for h, w in self.shapes)


def compiled_dropon_to_torch(cd: CompiledDropon, device) -> DeviceDropon:
    """Move a compiled dropon's image blocks and pixel masks to ``device``
    as flattened [blocks, 64] float32 tensors."""
    def flat(a):  # copies: the arrays may be read-only views
        return torch.tensor(np.asarray(a, np.float32).reshape(-1, 64),
                            device=device)

    return DeviceDropon(
        drops=tuple(flat(b) for b in cd.image_blocks),
        masks=tuple(flat(m) for m in cd.mask_pixels),
        shapes=tuple(tuple(b.shape[:2]) for b in cd.image_blocks))
