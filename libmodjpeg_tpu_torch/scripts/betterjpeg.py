"""betterjpeg on a torch device: apply edits to a JPEG while keeping every
block the edit did not touch bit-exact (PyTorch port of the repository's
scripts/betterjpeg.py).

    python -m libmodjpeg_tpu_torch.scripts.betterjpeg original.jpg \
        edited.png output.jpg [--threshold N] [--options OPA]

Given the original JPEG and an edited copy of it (PNG or JPEG), it finds the
pixels that changed and composites only those back onto the original in
the DCT domain: the edited frame becomes a dropon the size of the whole
frame, alpha 255 on changed pixels and 0 elsewhere, placed at the top left.
Arguments, messages and exits are the JAX script's.  The original (and a
JPEG edited input) decodes to pixels on ``device`` and the compose runs
there; the PNG reader and the pixel diff are host numpy.  From Python,
``main(argv, device="cpu")`` runs the plain-torch path; "cuda" without a
card raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import constants as C
from ..codec import decode
from ..dropon import read_dropon_from_raw
from ..png_reader import PNG_SIGNATURE, decode_png

from .. import compose, read_jpeg, write_jpeg
from ..parallel.session import _require_device
from ..pixels import to_pixels

# --options letters -> encode options
OPTIONS = {"O": C.OPTION_OPTIMIZE, "P": C.OPTION_PROGRESSIVE,
           "A": C.OPTION_ARITHMETRIC}


def load_pixels(path: str, device) -> np.ndarray:
    """The edited image as RGB uint8 [H, W, 3]: a JPEG decodes to pixels on
    ``device``, a PNG on the host."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] == b"\xff\xd8\xff":
        return to_pixels(decode(data), C.COLORSPACE_RGB, device=device)
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data)[..., :3]
    raise SystemExit(f"{path}: unsupported format (JPEG or PNG)")


def edit_dropon(orig_pix: np.ndarray, edit_pix: np.ndarray,
                threshold: int = 0):
    """The changed-pixel mask [H, W] (a per-channel difference above
    ``threshold``) and the sparse whole-frame overlay: the edited pixels,
    alpha 255 where changed and 0 elsewhere.  The overlay is None when no
    pixel changed."""
    orig = orig_pix.astype(np.int16)
    edit = edit_pix.astype(np.int16)
    if edit.shape != orig.shape:
        raise SystemExit("edited image dimensions do not match the original")
    changed = (np.abs(edit - orig) > threshold).any(axis=-1)
    if not changed.any():
        return changed, None
    h, w = changed.shape
    rgba = np.zeros((h, w, 4), dtype=np.uint8)
    rgba[..., :3] = np.clip(edit, 0, 255).astype(np.uint8)
    rgba[..., 3] = np.where(changed, 255, 0).astype(np.uint8)
    return changed, read_dropon_from_raw(rgba, C.COLORSPACE_RGBA, w, h)


def main(argv=None, device="cuda", timings=None) -> int:
    """Run the script; returns 0.  Bad input raises SystemExit with the JAX
    script's message.  ``timings``, when given a dict, receives the wall
    seconds of each stage: read, to_pixels, read_edited, diff_dropon, and
    then write (no change) or compose and write."""
    ap = argparse.ArgumentParser()
    ap.add_argument("original")
    ap.add_argument("edited")
    ap.add_argument("output")
    ap.add_argument("--threshold", type=int, default=0,
                    help="per-channel difference below this counts as "
                         "unchanged")
    ap.add_argument("--options", default="",
                    help="encode options: any of O,P,A")
    args = ap.parse_args(argv)
    device = _require_device(torch.device(device))

    stages = {} if timings is None else timings
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        stages[name] = now - t
        t = now

    img = read_jpeg(args.original)
    lap("read")
    orig_pix = to_pixels(img, C.COLORSPACE_RGB, device=device)
    lap("to_pixels")
    edit_pix = load_pixels(args.edited, device)
    lap("read_edited")
    changed, dropon = edit_dropon(orig_pix, edit_pix, args.threshold)
    lap("diff_dropon")
    if dropon is None:
        print("no changes detected; copying original losslessly")
        write_jpeg(img, args.output)
        lap("write")
        return 0

    out = compose(img, dropon, C.ALIGN_TOP | C.ALIGN_LEFT, 0, 0,
                  device=device)
    lap("compose")
    options = 0
    for letter, flag in OPTIONS.items():
        if letter in args.options:
            options |= flag
    write_jpeg(out, args.output, options=options)
    lap("write")

    pct = 100.0 * changed.mean()
    print(f"composited {pct:.1f}% changed pixels; "
          f"untouched JPEG blocks preserved bit-exact")
    return 0


if __name__ == "__main__":
    main()
