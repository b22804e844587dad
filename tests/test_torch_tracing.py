"""The port's in-program tracing (libmodjpeg_tpu_torch.tracing), the stream's
counters (BatchComposer.last_stream_stats) and the band decode's phase
times, on the CPU."""

import json
import os
import sys
import threading
import time

import pytest
import torch

import libmodjpeg_tpu_torch as mt
from libmodjpeg_tpu_torch import codec as tcodec
from libmodjpeg_tpu_torch import tracing
from libmodjpeg_tpu_torch.parallel import BatchComposer, GridSession

from conftest import FIXTURE_IMAGES

PLACE = (mt.ALIGN_BOTTOM | mt.ALIGN_RIGHT, -8, -8)
SURGICAL = ("surgical_extract_s", "surgical_window_cpu_s",
            "surgical_reencode_cpu_s", "surgical_recoded_bytes",
            "surgical_entropy_bytes")
ALWAYS_ON = {"batches", "start_s", "decode_s", "decode_cpu_s", *SURGICAL,
             "band_prefix_s", "band_decode_s", "band_after_s",
             "pack_dispatch_s", "fetch_s", "scatter_s", "encode_s",
             "encode_cpu_s", "producer_blocked_s", "dispatcher_idle_s",
             "dispatcher_blocked_s", "fetcher_idle_s", "fetcher_blocked_s",
             "consumer_idle_s", "stop_s"}
WAITS = ("producer_blocked_s", "dispatcher_idle_s", "dispatcher_blocked_s",
         "fetcher_idle_s", "fetcher_blocked_s", "consumer_idle_s")


@pytest.fixture(autouse=True)
def empty_buffer():
    assert not tracing.on()
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture(scope="module")
def data():
    """The fixture image re-encoded with standard tables (band-splice
    eligible, 16 MCU rows)."""
    with open(os.path.join(FIXTURE_IMAGES, "image.jpg"), "rb") as f:
        return tcodec.encode(tcodec.decode(f.read()))


@pytest.fixture(scope="module")
def rst_data(data):
    """The same picture with a restart marker every 4 MCUs (the surgical
    splice's input)."""
    return tcodec.encode(tcodec.decode(data), restart_interval=4)


@pytest.fixture(scope="module")
def dropon():
    return mt.read_dropon(os.path.join(FIXTURE_IMAGES, "dropon.png"),
                          device="cpu")


def _names(spans):
    return [s.name for s in spans]


def test_nothing_is_recorded_with_tracing_off(monkeypatch, data, dropon):
    """Off: no span, no profiler annotation and no timing event, through
    the tracer's own calls, a watermark() call and a GridSession chain."""
    def refuse(*args, **kwargs):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    with tracing.span("mjt.test.a", batch=1):
        pass
    with tracing.device_span("mjt.test.b", torch.device("cuda")):
        pass
    with tracing.device_span("mjt.test.c"):
        pass
    stats = {"k": 0.0}
    with tracing.timed(stats, "k", "mjt.test.d"):
        time.sleep(0.002)
    assert stats["k"] >= 0.002
    mt.watermark(data, dropon, *PLACE, device="cpu")
    sess = GridSession(tcodec.decode(data), device="cpu")
    sess.effect("luminance", value=10).compose(dropon, mt.ALIGN_CENTER)
    sess.to_jpeg(options=mt.OPTION_OPTIMIZE)
    assert tracing.spans() == ([], 0)


def test_recording_takes_name_thread_parent_and_ids():
    with tracing.recording():
        assert tracing.on()
        with tracing.span("mjt.test.outer", stream=7, batch=2):
            with tracing.span("mjt.test.inner"):
                pass
            with tracing.span("mjt.test.own", file=5):
                pass

        def work():
            with tracing.span("mjt.test.worker", file=1):
                pass
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
        stats = {"t": 0.0}
        with tracing.timed(stats, "t", "mjt.test.timed", batch=3):
            time.sleep(0.001)
    assert not tracing.on()
    got, dropped = tracing.spans()
    assert dropped == 0
    by = {s.name: s for s in got}
    assert _names(got) == ["mjt.test.inner", "mjt.test.own",
                           "mjt.test.outer", "mjt.test.worker",
                           "mjt.test.timed"]
    me = threading.get_ident()
    assert by["mjt.test.outer"].parent is None
    assert by["mjt.test.outer"].ids == {"stream": 7, "batch": 2}
    assert by["mjt.test.inner"].parent == "mjt.test.outer"
    assert by["mjt.test.inner"].ids == {"stream": 7, "batch": 2}
    assert by["mjt.test.own"].ids == {"file": 5}
    assert by["mjt.test.worker"].thread != me
    assert by["mjt.test.worker"].parent is None
    assert all(by[n].thread == me for n in ("mjt.test.outer",
                                            "mjt.test.inner"))
    outer, inner = by["mjt.test.outer"], by["mjt.test.inner"]
    assert outer.start <= inner.start <= inner.end <= outer.end
    # one clock for the counter and the span
    t = by["mjt.test.timed"]
    assert stats["t"] == t.end - t.start >= 0.001
    assert t.device_ms is None
    # a window of the buffer: spans that ended inside it
    got, _ = tracing.spans(outer.end, t.end)
    assert _names(got) == ["mjt.test.outer", "mjt.test.worker",
                           "mjt.test.timed"]


def test_device_span_on_the_cpu_is_a_host_span():
    with tracing.recording():
        with tracing.device_span("mjt.test.dev", torch.device("cpu"),
                                 session=4) as sp:
            torch.ones(8).sum()
    assert sp.end_event is None and sp.device_ms is None
    assert tracing.spans()[0] == [sp] and sp.ids == {"session": 4}


def test_profiler_annotates_main_thread_spans(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert tracing.on()
        with tracing.span("mjt.test.outer", batch=1):
            with tracing.span("mjt.test.inner"):
                torch.ones(16).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", []) if isinstance(events, dict) \
        else events
    ann = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"mjt.test.outer", "mjt.test.inner"} <= ann
    assert _names(tracing.spans()[0]) == ["mjt.test.inner", "mjt.test.outer"]


def test_a_full_buffer_drops_the_oldest_and_counts_them():
    extra = 5
    with tracing.recording():
        for _ in range(tracing.CAPACITY + extra):
            with tracing.span("mjt.test.fill"):
                pass
        t = time.perf_counter()
        with tracing.span("mjt.test.after"):
            pass
    got, dropped = tracing.spans()
    assert len(got) == tracing.CAPACITY and dropped == extra + 1
    got, dropped = tracing.spans(since=t)
    assert _names(got) == ["mjt.test.after"] and dropped == 0


def test_threads_lose_no_span():
    """Many threads record at once, with a short switch interval: every
    span reaches the buffer, under its own thread and parent."""
    threads_n, per = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording():
            def work(k):
                for i in range(per):
                    with tracing.span("mjt.test.p", worker=k):
                        with tracing.span("mjt.test.c", i=i):
                            pass
            ths = [threading.Thread(target=work, args=(k,))
                   for k in range(threads_n)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in ths)
    finally:
        sys.setswitchinterval(old)
    got, dropped = tracing.spans()
    assert dropped == 0 and len(got) == threads_n * per * 2
    kids = [s for s in got if s.name == "mjt.test.c"]
    assert all(s.parent == "mjt.test.p" for s in kids)
    threads_of = {}
    for s in got:
        if s.name == "mjt.test.p":
            threads_of.setdefault(s.ids["worker"], set()).add(s.thread)
    assert sorted(threads_of) == list(range(threads_n))
    assert all(len(t) == 1 for t in threads_of.values())


def test_one_file_watermark_counts_its_encode(data, dropon):
    """A one-file watermark() closes its stream after the first output:
    the encode is counted all the same, with the start, stop and CPU
    counters, and the call's spans are taken under recording()."""
    mt._WATERMARK_CACHE.clear()
    mt.watermark(data, dropon, *PLACE, device="cpu")      # builds the cache
    with tracing.recording():
        out = mt.watermark(data, dropon, *PLACE, device="cpu")
    (bc,) = mt._WATERMARK_CACHE.values()
    assert bc.last_stream_path == "splice"
    st = bc.last_stream_stats
    assert set(st) == ALWAYS_ON
    assert st["batches"] == 1 and st["encode_s"] > 0
    for k in ("start_s", "stop_s", "decode_cpu_s", "encode_cpu_s",
              "band_prefix_s", "band_decode_s"):
        assert st[k] > 0, k
    assert out == mt.watermark(data, dropon, *PLACE, device="cpu")
    names = _names(tracing.spans()[0])
    for n in ("mjt.watermark.probe", "mjt.stream.start", "mjt.stream.decode",
              "mjt.stream.dispatch", "mjt.stream.fetch", "mjt.stream.scatter",
              "mjt.stream.encode", "mjt.stream.consumer_idle",
              "mjt.stream.stop"):
        assert n in names, n
    assert names.index("mjt.stream.encode") < names.index("mjt.stream.stop")


@pytest.mark.parametrize("path", ["splice", "full", "surgical"])
def test_stream_counters(data, rst_data, dropon, path):
    """A stream of three batches: every documented counter, the waits
    non-negative, no wall_s, no device step off the card and with tracing
    off; the caller's time at each output is not the stream's encode; the
    band counters only on the band splice, the surgical ones only on the
    surgical splice, the extract inside the decode."""
    src = rst_data if path == "surgical" else data
    bc = BatchComposer(tcodec.decode(src), dropon, *PLACE, device="cpu")
    n, pause = 7, 0.02
    outs = []
    for out in bc.watermark_stream(iter([src] * n), batch=3,
                                   surgical=False if path == "full" else None):
        outs.append(out)
        time.sleep(pause)
    assert len(outs) == n
    assert bc.last_stream_path == path
    st = bc.last_stream_stats
    assert set(st) == ALWAYS_ON
    assert st["batches"] == 3
    assert all(st[k] >= 0 for k in WAITS)
    assert st["encode_s"] > 0 and st["encode_cpu_s"] > 0
    assert st["encode_s"] < n * pause
    band = st["band_prefix_s"] + st["band_decode_s"] + st["band_after_s"]
    assert (band > 0) == (path == "splice")
    assert all((st[k] > 0) == (path == "surgical") for k in SURGICAL), st
    assert all(st[k] >= 0 for k in SURGICAL)
    assert st["surgical_extract_s"] <= st["decode_s"]
    assert st["surgical_window_cpu_s"] < st["decode_cpu_s"]
    assert st["surgical_reencode_cpu_s"] <= st["encode_cpu_s"]
    assert st["surgical_recoded_bytes"] <= st["surgical_entropy_bytes"]


def test_surgical_spans_nest(rst_data, dropon):
    """Each batch's mjt.stream.surgical_extract lies in its
    mjt.stream.decode (same thread, same ids; the counter is the spans'
    sum); each file's mjt.stream.surgical_reencode, taken on a pool
    thread, carries the file's ids and lies in its batch's encode: after
    the batch's first mjt.stream.encode starts, before the file's own
    ends."""
    bc = BatchComposer(tcodec.decode(rst_data), dropon, *PLACE, device="cpu")
    with tracing.recording():
        outs = list(bc.watermark_stream(iter([rst_data] * 5), batch=2))
    assert len(outs) == 5 and bc.last_stream_path == "surgical"
    got = tracing.spans()[0]
    by_name = {}
    for s in got:
        by_name.setdefault(s.name, []).append(s)
    dec = by_name["mjt.stream.decode"]
    ext = by_name["mjt.stream.surgical_extract"]
    assert len(dec) == len(ext) == 3
    for d, e in zip(dec, ext):
        assert e.parent == "mjt.stream.decode" and e.thread == d.thread
        assert e.ids == d.ids
        assert d.start <= e.start <= e.end <= d.end
    st = bc.last_stream_stats
    assert st["surgical_extract_s"] == pytest.approx(
        sum(e.end - e.start for e in ext))
    enc = {(s.ids["batch"], s.ids["file"]): s
           for s in by_name["mjt.stream.encode"]}
    first = {}
    for (b, f), s in enc.items():
        first[b] = min(first.get(b, s.start), s.start)
    re = by_name["mjt.stream.surgical_reencode"]
    assert sorted((s.ids["batch"], s.ids["file"]) for s in re) == \
        sorted(enc)
    for s in re:
        own = enc[(s.ids["batch"], s.ids["file"])]
        assert s.ids["stream"] == own.ids["stream"]
        assert first[s.ids["batch"]] <= s.start <= s.end <= own.end


def test_stream_spans_carry_ids(data, dropon):
    bc = BatchComposer(tcodec.decode(data), dropon, *PLACE, device="cpu")
    with tracing.recording():
        outs = list(bc.watermark_stream(iter([data] * 5), batch=2))
    assert len(outs) == 5
    got = tracing.spans()[0]
    streams = {s.ids["stream"] for s in got}
    assert len(streams) == 1
    enc = [s for s in got if s.name == "mjt.stream.encode"]
    assert [(s.ids["batch"], s.ids["file"]) for s in enc] == \
        [(0, 0), (0, 1), (1, 2), (1, 3), (2, 4)]
    dec = [s for s in got if s.name == "mjt.stream.decode"]
    assert [(s.ids["batch"], s.ids["file"]) for s in dec] == \
        [(0, 0), (1, 2), (2, 4)]
    st = bc.last_stream_stats
    assert st["decode_s"] == pytest.approx(sum(s.end - s.start for s in dec))
    assert "device_step_s" not in st          # no CUDA stream on the CPU


def test_band_decode_phases(data):
    """decode_band's slots 13-15 are the three phase times: each > 0, their
    sum within the call; the spliced bytes do not depend on them."""
    row0, row1 = 2, 5
    t0 = time.perf_counter()
    img, sp = tcodec.decode_band(data, row0, row1)
    call = time.perf_counter() - t0
    assert len(sp) == 16 and sp[7] >= 0          # a band with a suffix
    phases = sp[13:16]
    assert all(p > 0 for p in phases)
    assert sum(phases) * 1e-9 <= call
    c0 = img.components[0]
    img.coefs[0][row0 * c0.v_samp:][:2, 1:4, 0, 0] += 3
    out = tcodec.encode_splice_band(data, img, row0, row1, sp)
    for other in ((0, 0, 0), (1, 2**40, 7)):
        assert tcodec.encode_splice_band(data, img, row0, row1,
                                         sp[:13] + other) == out
    full = tcodec.decode(data)
    full.coefs[0][row0 * full.components[0].v_samp:][:2, 1:4, 0, 0] += 3
    assert out == tcodec.encode(full)
