"""The PyTorch port imports and composes with JAX and the JAX package
unavailable, and no module of the port, nor chip_smoke.py, imports jax or
anything of libmodjpeg_tpu (the machine with the card has no JAX)."""

import ast
import os
import subprocess
import sys

from conftest import FIXTURE_IMAGES, REPO

_PKG = os.path.join(REPO, "libmodjpeg_tpu_torch")

_SCRIPT = r"""
import os
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["libmodjpeg_tpu"] = None   # ... and any import of the JAX package
sys.path.insert(0, {repo!r})
import libmodjpeg_tpu_torch as mt
from libmodjpeg_tpu_torch.parallel import batch  # noqa: F401
from libmodjpeg_tpu_torch.ops import compose_kernel  # noqa: F401
img = mt.read_jpeg({img!r})
d = mt.read_dropon({png!r})
out = mt.compose(img, d, mt.ALIGN_BOTTOM | mt.ALIGN_RIGHT, -10, -10,
                 device="cpu")
changed = sum(int((a != b).sum()) for a, b in zip(img.coefs, out.coefs))
assert changed > 0, changed
with open({img!r}, "rb") as f:
    data = f.read()
assert mt.watermark(data, d, mt.ALIGN_TOP | mt.ALIGN_LEFT, 8, 8,
                    device="cpu")[:2] == b"\xff\xd8"
jd = mt.read_dropon({jpg!r}, mask={mask!r}, device="cpu")
assert jd.colorspace == mt.COLORSPACE_RGB and jd.blend == mt.BLEND_NONUNIFORM
# the CLI with a JPEG dropon + mask, an effect and the bit-exact path
from libmodjpeg_tpu_torch import cli
for flags in ([], ["-X"]):
    rc = cli.main(flags + ["-i", {img!r}, "-y", "20", "-p", "br", "-d",
                           {jpg!r} + "," + {mask!r}, "-g", "-o", {out!r}],
                  device="cpu")
    assert rc == 0, rc
    with open({out!r}, "rb") as f:
        assert f.read(2) == b"\xff\xd8"
# the betterjpeg script, with the CLI's output as the edited (JPEG) image
import contextlib, io, json
from libmodjpeg_tpu_torch.scripts import betterjpeg
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = betterjpeg.main([{img!r}, {out!r}, {bj_out!r}], device="cpu")
assert rc == 0 and buf.getvalue().startswith("composited "), buf.getvalue()
with open({bj_out!r}, "rb") as f:
    assert f.read(2) == b"\xff\xd8"
# the huge-image, histogram, mesh and corpus modules, and the corpus CLI
from libmodjpeg_tpu_torch.ops import histogram  # noqa: F401
from libmodjpeg_tpu_torch.parallel import grid, mesh, session  # noqa: F401
from libmodjpeg_tpu_torch import corpus
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = corpus.main(["--inputs", {img!r}, "--out", {corpus_out!r},
                      "--dropon", {png!r}, "--luminance", "10",
                      "--optimize"], device="cpu")
assert rc == 0 and json.loads(buf.getvalue())["files_done"] == 1, rc
sess = session.GridSession(img, device="cpu").effect("pixelate")
sess.compose(d, mt.ALIGN_CENTER, 3, -5)
assert sess.to_jpeg(options=mt.OPTION_OPTIMIZE)[:2] == b"\xff\xd8"
# the bench at its smallest, and the scaling bench's corpus
from libmodjpeg_tpu_torch.scripts import bench, scaling_bench
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    r = bench.main(["--batch", "1", "--iters", "1", "--windows", "1",
                    "--grid-size", "128x64"], device="cpu")
assert json.loads(buf.getvalue()) == r and r["value"] > 0, r
os.makedirs({scaling_in!r})
scaling_bench.synth_corpus({scaling_in!r}, 1, 0.05)
assert mt.read_jpeg(os.path.join({scaling_in!r}, "img0000.jpg")).width > 0
leaked = sorted(m for m in sys.modules
                if (m == "jax" or m.startswith("jax.")
                    or m == "libmodjpeg_tpu" or m.startswith("libmodjpeg_tpu."))
                and sys.modules[m])
assert not leaked, leaked
# the port's own codec build is mapped, the JAX package's is not
with open("/proc/self/maps") as f:
    maps = f.read()
assert "build/torch_codec/libmjtcodec_" in maps
assert "libmodjpeg_tpu/codec/native" not in maps
print("OK", changed)
"""


def test_port_composes_with_jax_blocked(tmp_path):
    """A fresh interpreter (the test process already imported jax) with jax
    and libmodjpeg_tpu blocked drives compose, watermark, the CLI with and
    without -X, betterjpeg, the corpus CLI, a GridSession compose, the
    bench and the scaling bench's corpus: the port needs neither package,
    and loads its own codec library."""
    script = _SCRIPT.format(repo=REPO,
                            img=os.path.join(FIXTURE_IMAGES, "image.jpg"),
                            png=os.path.join(FIXTURE_IMAGES, "dropon.png"),
                            jpg=os.path.join(FIXTURE_IMAGES, "dropon.jpg"),
                            mask=os.path.join(FIXTURE_IMAGES, "mask.jpg"),
                            out=str(tmp_path / "out.jpg"),
                            bj_out=str(tmp_path / "betterjpeg.jpg"),
                            corpus_out=str(tmp_path / "corpus"),
                            scaling_in=str(tmp_path / "scaling_in"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK")


def _forbidden(m: str) -> bool:
    """jax, or any module of the JAX package (libmodjpeg_tpu)."""
    return (m == "jax" or m.startswith("jax.") or m == "libmodjpeg_tpu"
            or m.startswith("libmodjpeg_tpu."))


def _imports(path: str) -> list:
    """(line, module) of every import in a Python file; a relative import
    counts as the port's own."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            found += [(node.lineno, node.module or "")]
    return found


def test_no_module_of_the_port_imports_jax():
    """An AST scan: no import of jax, nor of any module of the JAX package,
    anywhere in the port."""
    found, scanned = [], set()
    for root, _, files in os.walk(_PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            scanned.add(os.path.relpath(path, _PKG).replace(os.sep, "/"))
            found += [f"{path}:{line} {m}" for line, m in _imports(path)
                      if _forbidden(m)]
    assert not found, found
    assert {"cli.py", "corpus.py", "dropon.py", "effects.py", "pixels.py",
            "codec/__init__.py", "jpegio.py", "surgical.py", "bitexact.py",
            "model.py", "ops/effects.py", "ops/histogram.py",
            "parallel/grid.py", "parallel/mesh.py", "parallel/session.py",
            "scripts/betterjpeg.py", "scripts/kernel_bench.py",
            "scripts/bench.py", "scripts/scaling_bench.py"} <= scanned, \
        scanned


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py, which runs on the machine with the card, imports
    neither jax nor the JAX package, and does import the port."""
    mods = [m for _, m in _imports(os.path.join(REPO, "chip_smoke.py"))]
    assert not [m for m in mods if _forbidden(m)], mods
    assert any(m.startswith("libmodjpeg_tpu_torch") for m in mods)


def test_the_scan_sees_a_forbidden_import(tmp_path):
    """The scan's own check: it reports an absolute import of the JAX
    package and ignores the port's relative imports."""
    f = tmp_path / "m.py"
    f.write_text("from . import codec\nfrom libmodjpeg_tpu import codec\n"
                 "import libmodjpeg_tpu_torch\n")
    assert [m for _, m in _imports(str(f)) if _forbidden(m)] == \
        ["libmodjpeg_tpu"]
