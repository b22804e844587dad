"""The comparison that decides ``correct``: the program's output files,
read back by the frozen coder, against the plain reference worked out from
the same input files and logo pixels.

Numbers (each held to the cell's limit in ``limits/<workload>.json``):

- ``missing``: requests taken in the window whose answer never came;
- ``unreadable``: checked outputs the frozen coder cannot decode, or whose
  geometry or quantization tables are not the input's;
- ``outside_diff``: coefficients outside the logo's footprint that differ
  from the reference (effects included), exact;
- ``foot_beyond_1``: footprint coefficients off by more than 1;
- ``foot_diff_share``: the share of footprint coefficients that differ at
  all (the program's float32 order of operations may tip a truncation);
- ``bytes_diff``: checked outputs whose bytes differ from the frozen
  coder's encoding of their own coefficients in the stated output coding
  (standard or optimized Huffman tables, restart interval), so that the
  entropy layer, the optimized tables and the splice are judged too;
- ``lengths_diff``: answers whose length differs from the checked answer
  for the same input (the program is deterministic).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import coder
from .references import dct_compose as ref

NAMES = ("missing", "unreadable", "outside_diff", "foot_beyond_1",
         "foot_diff_share", "bytes_diff", "lengths_diff")


class Judge:
    """Reference outputs for one cell's inputs.  ``precision`` "f32" is the
    reference; "tf32" makes the control."""

    def __init__(self, config: dict, files: list, logo: np.ndarray,
                 precision: str = "f32", device="cpu", workers: int = 8):
        self.cfg = config
        self.files = files
        self.logo = logo
        self.precision = precision
        self.device = device
        self.workers = workers
        place = config["placement"]
        self.align = ref.align_bits(place["align"])
        self.ox, self.oy = place["offset_x"], place["offset_y"]
        out = config["output"]
        self.out_options = coder.OPTION_OPTIMIZE if out["optimize"] else 0
        self.out_ri = out["restart_interval"]
        self._fps = None

    def footprints(self, img: dict) -> list:
        """Compiled once: every input shares the geometry and tables."""
        if self._fps is None:
            self._fps = ref.footprints(img, self.logo, self.align, self.ox,
                                       self.oy, self.precision, self.device)
        return self._fps

    def expected(self, j: int) -> tuple:
        """(input image dict, expected planes) for input file ``j``."""
        img = coder.decode(self.files[j], nthreads=0)
        fps = self.footprints(img)
        return img, ref.expected(img, self.cfg["effects"], fps,
                                 self.precision, self.device)

    def compare(self, j: int, out: bytes) -> dict:
        """The numbers for one checked answer to input ``j``."""
        img, want = self.expected(j)
        res = {"unreadable": 0, "outside_diff": 0, "foot_beyond_1": 0,
               "foot_diff": 0, "foot_total": 0, "bytes_diff": 0}
        try:
            got = coder.decode(out, nthreads=0)
        except coder.CoderError:
            res["unreadable"] = 1
            return res
        if (got["comps"] != img["comps"]
                or (got["width"], got["height"]) != (img["width"],
                                                      img["height"])
                or any(not np.array_equal(got["qtables"].get(t), q)
                       for t, q in img["qtables"].items())):
            res["unreadable"] = 1
            return res
        res.update(compare_planes(got["coefs"], want, self.footprints(img)))
        again = coder.encode(got, self.out_options, self.out_ri, nthreads=0)
        res["bytes_diff"] = int(again != out)
        return res

    def judge(self, samples: list, lengths: list, attempted: int,
              completed: int) -> dict:
        """samples: [(input index, answer bytes)] checked in full;
        lengths: [(input index, answer length)] of every answer.  Returns
        name -> value for NAMES."""
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            per = list(pool.map(lambda s: self.compare(*s), samples))
        checked = {j: len(out) for j, out in samples}
        tot = {k: sum(r[k] for r in per) for k in
               ("unreadable", "outside_diff", "foot_beyond_1", "foot_diff",
                "foot_total", "bytes_diff")}
        return {
            "missing": attempted - completed,
            "unreadable": tot["unreadable"],
            "outside_diff": tot["outside_diff"],
            "foot_beyond_1": tot["foot_beyond_1"],
            "foot_diff_share": (tot["foot_diff"] / tot["foot_total"]
                                if tot["foot_total"] else 1.0),
            "bytes_diff": tot["bytes_diff"],
            "lengths_diff": sum(1 for j, n in lengths
                                if j in checked and n != checked[j]),
        }


def compare_planes(got: list, want: list, fps: list) -> dict:
    """Per component: exact outside the footprint, off by at most 1 inside,
    and the count of footprint coefficients that differ."""
    res = {"outside_diff": 0, "foot_beyond_1": 0, "foot_diff": 0,
           "foot_total": 0}
    for c, (a, b) in enumerate(zip(got, want)):
        inside = np.zeros(a.shape[:2], bool)
        if c < len(fps):
            r0, c0, drop, _mask = fps[c]
            inside[r0:r0 + drop.shape[0], c0:c0 + drop.shape[1]] = True
        d = a != b
        res["outside_diff"] += int(d[~inside].sum())
        foot = np.abs(a[inside].astype(np.int32) - b[inside])
        res["foot_beyond_1"] += int((foot > 1).sum())
        res["foot_diff"] += int((foot != 0).sum())
        res["foot_total"] += foot.size
    return res


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit is a harness fault."""
    checks, ok = {}, True
    for name in NAMES:
        v, lim = values[name], limits[name]
        checks[name] = {"value": v, "limit": lim}
        ok = ok and v <= lim
    return ok, checks
