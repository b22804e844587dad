"""The port's corpus runner against the JAX package's, on the CPU: resume,
failure isolation, host sharding, the effects CLI, the streaming route, and
a two-process torch.distributed (gloo) run.

Outputs must be byte-identical to the JAX runner's wherever the
coefficients match; elsewhere only the compose footprint may differ, by
+-1 on under 0.5% of its coefficients (the dropon-compile rounding of
ROADMAP Queue 3 item 1).

Run as a script, this file is the worker of the two-process test:
``python test_torch_corpus.py <rank> <world> <port> <in> <out>``.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from libmodjpeg_tpu import constants as C

_BR = C.ALIGN_BOTTOM | C.ALIGN_RIGHT
_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
IMAGES = os.path.join(_HERE, "fixtures")


def _corpus_cfg(inputs, out, **kw):
    from libmodjpeg_tpu_torch.corpus import CorpusConfig

    kw.setdefault("dropon_path", f"{IMAGES}/dropon.png")
    kw.setdefault("align", _BR)
    kw.setdefault("batch_size", 4)
    return CorpusConfig(inputs=[str(i) for i in inputs], output_dir=str(out),
                        **kw)


@pytest.fixture()
def corpus_dir(tmp_path):
    """A small mixed corpus: some 256x256, some odd-size, one corrupt
    (test_corpus.py's)."""
    import io

    from PIL import Image

    src = open(f"{IMAGES}/image.jpg", "rb").read()
    d = tmp_path / "in"
    d.mkdir()
    for i in range(5):
        (d / f"a{i}.jpg").write_bytes(src)
    small = Image.open(io.BytesIO(src)).crop((0, 0, 100, 60))
    for i in range(3):
        buf = io.BytesIO()
        small.save(buf, format="JPEG", quality=80)
        (d / f"b{i}.jpg").write_bytes(buf.getvalue())
    (d / "corrupt.jpg").write_bytes(b"\xff\xd8\xff\xdb garbage")
    return d


def _assert_like_jax(port_dir, jax_dir, align, ox=0, oy=0):
    """Same file names; bytes identical where the coefficients match;
    elsewhere identical outside the footprint and +-1 on under 0.5% of it.
    Returns the number of byte-identical files."""
    from libmodjpeg_tpu import codec
    from libmodjpeg_tpu_torch.dropon import read_dropon
    from libmodjpeg_tpu_torch.parallel.batch import BatchComposer

    names = sorted(p.name for p in jax_dir.glob("*.jpg"))
    assert names and names == sorted(p.name for p in port_dir.glob("*.jpg"))
    dropon = read_dropon(f"{IMAGES}/dropon.png", device="cpu")
    same = differing = total = 0
    for n in names:
        a, b = (port_dir / n).read_bytes(), (jax_dir / n).read_bytes()
        x, y = codec.decode(a), codec.decode(b)
        if all(np.array_equal(p, q) for p, q in zip(x.coefs, y.coefs)):
            assert a == b, n
            same += 1
            continue
        bc = BatchComposer(x, dropon, align, ox, oy, device="cpu")
        for c, (r0, c0, h, w) in enumerate(bc._region_origins()):
            outside = np.ones(x.coefs[c].shape[:2], bool)
            outside[r0:r0 + h, c0:c0 + w] = False
            np.testing.assert_array_equal(x.coefs[c][outside],
                                          y.coefs[c][outside])
            d = np.abs(x.coefs[c][~outside].astype(int) - y.coefs[c][~outside])
            assert d.max() <= 1, n
            differing += int((d != 0).sum())
            total += d.size
    assert differing < 0.005 * max(total, 1)
    return same


def test_corpus_run_and_resume(corpus_dir, tmp_path):
    from libmodjpeg_tpu import codec
    from libmodjpeg_tpu.corpus import run_corpus as jax_run_corpus
    from libmodjpeg_tpu_torch.corpus import run_corpus

    out = tmp_path / "out"
    summary = run_corpus(_corpus_cfg([corpus_dir], out), device="cpu")
    assert summary["files_done"] == 8
    assert summary["files_failed"] == 1  # corrupt.jpg isolated, not fatal
    assert summary["mp_per_s"] > 0
    assert summary["pipeline"] == "stream"
    ref = codec.decode(open(f"{IMAGES}/image.jpg", "rb").read())
    got = codec.decode((out / "a0.jpg").read_bytes())
    assert not all(np.array_equal(ref.coefs[c], got.coefs[c])
                   for c in range(3))
    records = [json.loads(line) for line in
               (out / "manifest_h0.jsonl").read_text().splitlines()]
    assert sum(r["status"] == "error" for r in records) == 1

    jout = tmp_path / "jax"
    jax_run_corpus(_corpus_cfg([corpus_dir], jout))
    _assert_like_jax(out, jout, _BR)

    again = run_corpus(_corpus_cfg([corpus_dir], out, resume=True),
                       device="cpu")
    assert again["files_done"] == 0
    assert again["skipped_resume"] == 8


def test_corpus_host_sharding(corpus_dir, tmp_path):
    from libmodjpeg_tpu_torch.corpus import run_corpus

    done = set()
    for host in range(3):
        out = tmp_path / f"out{host}"
        run_corpus(_corpus_cfg([corpus_dir], out, num_hosts=3,
                               host_id=host), device="cpu")
        with open(out / f"manifest_h{host}.jsonl") as f:
            for line in f:
                rec = json.loads(line)
                if rec["status"] == "done":
                    assert rec["input"] not in done  # disjoint shards
                    done.add(rec["input"])
    assert len(done) == 8


def test_corpus_effects_cli(corpus_dir, tmp_path):
    """Effects only, progressive output: byte-identical to the JAX CLI."""
    from libmodjpeg_tpu import codec
    from libmodjpeg_tpu.corpus import main as jax_main
    from libmodjpeg_tpu_torch.corpus import main

    args = ["--inputs", str(corpus_dir / "a0.jpg"), str(corpus_dir / "a1.jpg"),
            "--pixelate", "--tint", "40,-20", "--progressive"]
    assert main(args + ["--out", str(tmp_path / "fx")], device="cpu") == 0
    assert jax_main(args + ["--out", str(tmp_path / "jfx")]) == 0
    img = codec.decode((tmp_path / "fx" / "a0.jpg").read_bytes())
    assert img.progressive
    for c in range(3):
        assert (img.coefs[c][..., 0, 1:] == 0).all()
    for n in ("a0.jpg", "a1.jpg"):
        assert ((tmp_path / "fx" / n).read_bytes()
                == (tmp_path / "jfx" / n).read_bytes())


def test_corpus_effects_with_dropon_like_jax(corpus_dir, tmp_path):
    """The batch loop (compose then luminance) against the JAX runner's."""
    from libmodjpeg_tpu.corpus import run_corpus as jax_run_corpus
    from libmodjpeg_tpu_torch.corpus import run_corpus

    kw = {"effects": [("luminance", (35,))]}
    s = run_corpus(_corpus_cfg([corpus_dir], tmp_path / "p", **kw),
                   device="cpu")
    assert s["files_done"] == 8 and s["files_failed"] == 1
    assert "pipeline" not in s
    jax_run_corpus(_corpus_cfg([corpus_dir], tmp_path / "j", **kw))
    _assert_like_jax(tmp_path / "p", tmp_path / "j", _BR)


def test_corpus_max_failures(corpus_dir, tmp_path):
    from libmodjpeg_tpu_torch.corpus import run_corpus

    with pytest.raises(RuntimeError):
        run_corpus(_corpus_cfg([corpus_dir], tmp_path / "mf",
                               max_failures=0), device="cpu")


def test_corpus_stream_surgical_engages(tmp_path):
    """Restart-segmented inputs take the surgical path from run_corpus, a
    restart-free one falls back per file in the same bucket, and the
    outputs match the JAX runner's."""
    import PIL.Image

    from libmodjpeg_tpu import codec
    from libmodjpeg_tpu.corpus import run_corpus as jax_run_corpus
    from libmodjpeg_tpu_torch.corpus import run_corpus
    from libmodjpeg_tpu_torch.encode_pixels import from_pixels

    rng = np.random.RandomState(3)
    d = tmp_path / "in"
    d.mkdir()
    for i in range(4):
        pix = rng.randint(0, 255, (240, 320, 3), dtype=np.uint8)
        img = from_pixels(pix, quality=85, subsampling="420", device="cpu")
        (d / f"s{i}.jpg").write_bytes(codec.encode(img, restart_interval=8))
    pix = rng.randint(0, 255, (240, 320, 3), dtype=np.uint8)
    img = from_pixels(pix, quality=85, subsampling="420", device="cpu")
    (d / "zfree.jpg").write_bytes(codec.encode(img))
    logo = rng.randint(0, 255, (40, 96, 4), dtype=np.uint8)
    PIL.Image.fromarray(logo, "RGBA").save(tmp_path / "logo.png")

    kw = {"dropon_path": str(tmp_path / "logo.png"), "batch_size": 8}
    summary = run_corpus(_corpus_cfg([d], tmp_path / "out", **kw),
                         device="cpu")
    assert summary["files_done"] == 5
    assert summary["files_failed"] == 0
    assert summary["pipeline"] == "stream"
    assert summary["stream_paths"] == {"mixed": 5}
    assert summary["surgical_fallbacks"] == {"restart-interval": 1}
    jsum = jax_run_corpus(_corpus_cfg([d], tmp_path / "jax", **kw))
    assert jsum["stream_paths"] == summary["stream_paths"]
    # the footprint check needs this logo, not the fixture dropon
    from libmodjpeg_tpu_torch.dropon import read_dropon
    from libmodjpeg_tpu_torch.parallel.batch import BatchComposer

    dropon = read_dropon(str(tmp_path / "logo.png"), device="cpu")
    for f in sorted(d.glob("*.jpg")):
        a = codec.decode((tmp_path / "out" / f.name).read_bytes())
        b = codec.decode((tmp_path / "jax" / f.name).read_bytes())
        bc = BatchComposer(a, dropon, _BR, 0, 0, device="cpu")
        for c, (r0, c0, h, w) in enumerate(bc._region_origins()):
            outside = np.ones(a.coefs[c].shape[:2], bool)
            outside[r0:r0 + h, c0:c0 + w] = False
            np.testing.assert_array_equal(a.coefs[c][outside],
                                          b.coefs[c][outside])
            diff = np.abs(a.coefs[c].astype(int) - b.coefs[c])
            assert diff.max() <= 1 and (diff != 0).sum() < 0.005 * (
                h * w * 64)


def test_corpus_trace_dir(corpus_dir, tmp_path):
    """trace_dir writes a torch.profiler Chrome trace per host."""
    from libmodjpeg_tpu_torch.corpus import run_corpus

    trace = tmp_path / "trace"
    s = run_corpus(_corpus_cfg([corpus_dir / "a0.jpg"], tmp_path / "o",
                               trace_dir=str(trace)), device="cpu")
    assert s["files_done"] == 1
    with open(trace / "trace_h0.json") as f:
        assert json.load(f)["traceEvents"]


def test_init_distributed_noop(monkeypatch):
    from libmodjpeg_tpu_torch.parallel import init_distributed

    monkeypatch.delenv("MJT_COORDINATOR", raising=False)
    assert init_distributed() is False  # no coordinator configured


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _perturbed_corpus(d, n):
    """n perturbed copies of the fixture image as JPEG files."""
    from libmodjpeg_tpu import codec

    base = codec.decode(open(f"{IMAGES}/image.jpg", "rb").read())
    rng = np.random.RandomState(42)
    for i in range(n):
        im = base.copy()
        for c in range(3):
            m = rng.randint(0, 3, im.coefs[c].shape[:2])[..., None, None]
            im.coefs[c] = (im.coefs[c] + m.astype(np.int16)).astype(np.int16)
        (d / f"img{i:03d}.jpg").write_bytes(codec.encode(im))


def test_two_process_corpus_matches_single_host(tmp_path):
    """init_distributed (gloo) in 2 processes, each running run_corpus on
    its host shard: the union of their outputs is byte-identical to a
    1-host run, the manifests partition the corpus, and an all_reduce of
    the counts agrees."""
    from libmodjpeg_tpu_torch.corpus import run_corpus

    indir = tmp_path / "in"
    indir.mkdir()
    _perturbed_corpus(indir, 6)
    out1 = tmp_path / "single"
    s = run_corpus(_corpus_cfg([indir], out1,
                               effects=[("luminance", (35,))]), device="cpu")
    assert s["files_failed"] == 0 and s["files_done"] == 6

    out2 = tmp_path / "multi"
    port = _free_port()
    env = dict(os.environ)
    for k in ("MJT_COORDINATOR", "MJT_NUM_PROCS", "MJT_PROC_ID"):
        env.pop(k, None)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), "2",
         str(port), str(indir), str(out2)],
        env=env, cwd=_REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err.decode()[-3000:]
            outs.append(json.loads(out.decode().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert sum(o["files_done"] for o in outs) == 6
    assert all(o["files_done_all_hosts"] == 6 for o in outs)
    names = sorted(p.name for p in out1.iterdir() if p.suffix == ".jpg")
    assert sorted(p.name for p in out2.iterdir()
                  if p.suffix == ".jpg") == names
    for n in names:
        assert (out1 / n).read_bytes() == (out2 / n).read_bytes(), n
    h = [{json.loads(line)["input"] for line in
          (out2 / f"manifest_h{r}.jsonl").read_text().splitlines()}
         for r in range(2)]
    assert not (h[0] & h[1]) and len(h[0] | h[1]) == 6


def _worker(rank: int, world: int, port: str, indir: str,
            outdir: str) -> None:
    """One host of the two-process test: join the gloo group through
    MJT_* variables, run its shard, all_reduce the done count."""
    import torch
    import torch.distributed as dist

    from libmodjpeg_tpu_torch.corpus import run_corpus
    from libmodjpeg_tpu_torch.parallel import init_distributed

    os.environ.update(MJT_COORDINATOR=f"127.0.0.1:{port}",
                      MJT_NUM_PROCS=str(world), MJT_PROC_ID=str(rank),
                      MJT_CPU_COLLECTIVES="gloo")
    assert init_distributed() is True
    assert dist.get_world_size() == world and dist.get_rank() == rank
    try:
        s = run_corpus(_corpus_cfg([indir], outdir, num_hosts=world,
                                   host_id=rank,
                                   effects=[("luminance", (35,))]),
                       device="cpu")
        count = torch.tensor([s["files_done"]], dtype=torch.int64)
        dist.all_reduce(count)
        s["files_done_all_hosts"] = int(count.item())
    finally:
        dist.destroy_process_group()
    print(json.dumps(s), flush=True)
    if s["files_failed"]:
        sys.exit(1)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
