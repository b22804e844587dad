"""The harness: the last line's keys, a cell added as files only, no run
without a card, and the import guard."""

import ast
import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import harness

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2**31 + 11


def run(bench, cell, trace=0, seconds=0.6):
    res, info, code = harness.run_cell(bench, cell, SEED, seconds,
                                       bool(trace), "cpu",
                                       time.perf_counter())
    assert code == 0
    return res, info


@pytest.mark.parametrize("cell", ["wm.stream-baseline", "wm.single-call",
                                  "fx.grid-chain",
                                  "wm.stream-progressive"])
def test_last_line_keys(tiny, cell, capsys):
    res, info = run(tiny, cell)
    harness.emit(res, info)
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    keys = list(last)
    assert keys[:5] == REQUIRED and keys[-1] == "checks"
    assert set(keys) <= set(REQUIRED) | {"checks", "breakdown"}
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0
    assert set(last["metrics"]) >= {"setup_s"}
    for name, c in last["checks"].items():
        assert set(c) == {"value", "limit"}
    # the numbers compared are the last lines of standard error
    err = out.err.strip().splitlines()
    assert [ln.split(":")[0] for ln in err[-len(last["checks"]):]] == \
        [f"check {n}" for n in last["checks"]]


def test_traced_run_reports_per_layer_metrics(tiny):
    res, _ = run(tiny, "wm.stream-baseline", trace=1)
    assert set(res["metrics"]) == {"decode_ms.stream", "encode_ms.stream",
                                   "dispatch_ms.stream",
                                   "stream_p95_ms"}   # no device here
    assert res["device"]["busy_s"] is None
    assert res["device"]["window_s"] > 0


def test_traced_single_call_times_the_encode_apart(tiny):
    """The traced one-call run reports the call's encode apart from the
    entry API's own time, and puts the program's encoders back after."""
    from libmodjpeg_tpu_torch import codec

    before = (codec.encode, codec.encode_splice_band)
    res, _ = run(tiny, "wm.single-call", trace=1)
    assert (codec.encode, codec.encode_splice_band) == before
    m = res["metrics"]
    assert set(m) == {"decode_ms.single", "encode_ms.single",
                      "outside_stages_ms.single"}    # no device here
    assert m["encode_ms.single"]["value"] > 0


def test_a_cell_added_as_files(tiny):
    """A configuration, a traffic mix and a per-layer metric, each a new
    file, plus entries in BENCHMARK.json: no existing file is edited."""
    root = tiny.root
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "configs", "wm.json")) as f:
        cfg = json.load(f)
    cfg.update(width=128, height=64, corpus_files=3,
               placement={"align": ["TOP", "LEFT"], "offset_x": 0,
                          "offset_y": 0})
    with open(os.path.join(bdir, "configs", "wmtopleft.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bdir, "traffic", "stream-batch4.json"),
              "w") as f:
        json.dump({"driver": "stream", "caller": "closed loop",
                   "input": {"progressive": False, "restart_interval": 0},
                   "batch": 4, "stream_kwargs": {"batch": 4},
                   "expect_path": "splice"}, f)
    with open(os.path.join(bdir, "metrics", "batches.stream4.py"),
              "w") as f:
        f.write('def read(rec):\n'
                '    return rec["counters"]["stream"]["batches"]\n')
    with open(os.path.join(bdir, "limits", "wmtopleft.stream-batch4.json"),
              "w") as f:
        with open(os.path.join(bdir, "limits",
                               "wm.stream-baseline.json")) as g:
            f.write(g.read())
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "wmtopleft", "source": "test",
                            "file": "benchmark/configs/wmtopleft.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "wmtopleft.stream-batch4",
                              "config": "wmtopleft",
                              "traffic": "stream-batch4", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "batches.stream4", "unit": "1",
                              "better": "higher",
                              "source": "program_counter",
                              "layer": "stream pipeline",
                              "moves": "stream_mp_s",
                              "workloads": ["wmtopleft.stream-batch4"]})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("stream_mp_s", "stream_p95_ms"):
            m["workloads"].append("wmtopleft.stream-batch4")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    bench = harness.Bench(root)
    res, info = run(bench, "wmtopleft.stream-batch4", trace=1)
    assert res["correct"] is True
    assert res["metrics"]["batches.stream4"]["value"] >= 1
    assert info["stream_path"] == "splice"
    res, _ = run(bench, "wmtopleft.stream-batch4", trace=0)
    assert set(res["metrics"]) == {"stream_mp_s", "setup_s"}


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no result: no
    fallback to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "wm1080.stream-progressive", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_no_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, the command fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "wm1080.stream-progressive", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.banned_loaded() == []
    import types

    monkeypatch.setitem(sys.modules, "libmodjpeg_tpu_torchx",
                        types.ModuleType("libmodjpeg_tpu_torchx"))
    assert harness.banned_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "libmodjpeg_tpu.codec",
                        types.ModuleType("y"))
    assert harness.banned_loaded() == ["jax", "libmodjpeg_tpu"]
    monkeypatch.setitem(sys.modules, "jax", None)     # a blocked import
    monkeypatch.delitem(sys.modules, "jax.numpy")
    assert harness.banned_loaded() == ["libmodjpeg_tpu"]


def test_a_banned_module_loaded_by_a_metric_reader_refuses_the_run(
        tiny, capsys):
    """A metric reader, loaded after the window, that imports a module the
    benchmark may not load (a stand-in ``flax`` on the path): the run
    exits 3 and prints no result line."""
    bdir = os.path.join(tiny.root, "benchmark")
    stand_in = os.path.join(tiny.root, "stand_in")
    os.makedirs(os.path.join(stand_in, "flax"))
    with open(os.path.join(stand_in, "flax", "__init__.py"), "w") as f:
        f.write("")
    with open(os.path.join(bdir, "metrics", "loads_flax.py"), "w") as f:
        f.write("def read(rec):\n"
                "    import flax  # noqa: F401\n"
                "    return 1.0\n")
    spec_path = os.path.join(tiny.root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["end_to_end"].append({"name": "loads_flax", "unit": "1",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["wm.single-call"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    sys.path.insert(0, stand_in)
    try:
        res, info, code = harness.run_cell(
            harness.Bench(tiny.root), "wm.single-call", SEED, 0.3, False,
            "cpu", time.perf_counter())
        harness.emit(res, info)
    finally:
        sys.path.remove(stand_in)
        sys.modules.pop("flax", None)
    assert code == 3 and res is None
    out = capsys.readouterr()
    assert out.out.strip() == ""
    assert "refused: modules ['flax'] were loaded" in out.err


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    for d, _, files in os.walk(harness.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imports(path) & {"jax", "jaxlib", "flax", "libmodjpeg_tpu"}
        assert not bad, (path, bad)


def test_reference_and_yardstick_import_nothing_of_the_program():
    yard = [os.path.join(harness.BENCH_DIR, p) for p in
            ("references/dct_compose.py", "check.py", "inputs.py",
             "roofline.py", "stats.py", "trace.py", "coder/__init__.py")]
    for path in yard:
        assert "libmodjpeg_tpu_torch" not in _imports(path), path


def test_a_run_with_jax_blocked(tiny):
    """A whole CPU run of every driver with jax and the JAX package made
    unimportable: nothing the run loads reaches for them."""
    code = (
        "import sys, time\n"
        "for m in ('jax', 'jaxlib', 'flax', 'libmodjpeg_tpu'):\n"
        "    sys.modules[m] = None\n"
        "sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "b = harness.Bench(%r)\n"
        "for cell in ('wm.stream-baseline', 'wm.single-call',\n"
        "             'fx.grid-chain'):\n"
        "    res, info, rc = harness.run_cell(b, cell, 5, 0.3, True, 'cpu',\n"
        "                                     time.perf_counter())\n"
        "    assert rc == 0 and res['correct'], (cell, res)\n"
        "print('ok')\n" % (harness.ROOT, tiny.root))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


@pytest.mark.cuda
def test_card_run(card):
    """On the card: one short run of a stream cell is correct and reports
    its metrics and device."""
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "wm1080.stream-progressive", "--seed", str(SEED),
                        "--seconds", "2", "--trace", "1"],
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["correct"] is True
    assert last["device"]["platform"] == "gpu"
    assert last["device"]["busy_s"] > 0
    assert "step_roofline.stream" in last["metrics"]
