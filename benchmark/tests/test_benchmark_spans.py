"""The readers of the program's spans (`harness/spans.py` and the
`program_span` metrics), on hand-built traces and span records: silent
where the spans are absent; a kernel given to the stage whose span holds
its launch, from any thread; the device-idle share inside the upload."""
from __future__ import annotations

import json
import time

import pytest

from benchmark.harness import spans, trace
from benchmark.harness.manifest import MANIFEST, load_json, metric_reader
from ttl_tpu_torch.utils import profiling

BASE = profiling.trace_base_ns(time.time_ns())
SPAN_METRICS = [m["name"] for m in load_json(MANIFEST)["per_layer"]
                if m["source"] == "program_span"]


def ns(us: float) -> int:
    """A wall-clock stamp that lands at `us` on the trace's clock."""
    return BASE + int(us * 1000)


def rec(name, t0, t1, key=None, tid=1, step=None, i=[0]):
    i[0] += 1
    return profiling.Span(name, i[0], None, key, tid, ns(t0), ns(t1), step)


def reading(events):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.SPAN,
           "ts": 1000, "dur": 1000}] + events
    return trace.Reading(ev)


def launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 5, "tid": tid, "args": {"correlation": corr}}


def kernel(corr, ts, dur, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


CONFIG = {"ttl": {"sample_batch": 8}}


@pytest.fixture
def records(monkeypatch):
    """The program's records the readers see."""
    held = []
    monkeypatch.setattr(profiling, "recorded", lambda: list(held))
    return held


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_readers_are_silent_without_their_spans(name, records):
    read = metric_reader(name)
    assert read({"config": CONFIG}) is None          # no trace
    r = reading([launch(1, 1100), kernel(1, 1150, 100)])
    assert read({"reading": r, "config": CONFIG}) is None   # no span
    # a span of the name that ends after the traced span is not read
    records.extend(rec(n, 1500, 2500) for n in
                   ("predict.loader_wait", "loader.decode", "loader.upload",
                    "step", "step.render", "step.prefix", "step.adapt",
                    "step.classify", "serve.queued", "serve.gather",
                    "serve.decode", "serve.upload", "serve.collect"))
    assert read({"reading": r, "config": CONFIG}) is None


def test_readers_are_silent_without_the_recorder(monkeypatch):
    """A program with no recorder (an older checkout) reads as nothing."""
    import builtins

    real = builtins.__import__

    def no_recorder(name, *a, **kw):
        if name == "ttl_tpu_torch.utils.profiling":
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_recorder)
    r = reading([launch(1, 1100), kernel(1, 1150, 100)])
    for name in SPAN_METRICS:
        assert metric_reader(name)({"reading": r, "config": CONFIG}) is None


def test_kernels_go_to_the_stage_that_holds_their_launch(records):
    """Two steps; the adapt stage's second kernel is launched from another
    thread (autograd's worker), inside the stage's interval; one kernel is
    launched outside every stage."""
    r = reading([
        launch(1, 1010), kernel(1, 1020, 10),            # render, step 0
        launch(2, 1060), kernel(2, 1070, 40),            # prefix
        launch(3, 1120), kernel(3, 1130, 100),           # adapt
        launch(4, 1200, tid=2), kernel(4, 1240, 200),    # adapt, 2nd thread
        launch(5, 1300), kernel(5, 1450, 20),            # classify
        launch(6, 1330), kernel(6, 1480, 5),             # no stage
        launch(7, 1510), kernel(7, 1520, 30),            # render, step 1
        launch(8, 1560), kernel(8, 1570, 60),            # prefix
        launch(9, 1620), kernel(9, 1630, 150),           # adapt
        launch(10, 1800), kernel(10, 1810, 10),          # classify
    ])
    for k, off in ((0, 0), (1, 500)):
        records.extend([
            rec("step", 1005 + off, 1320 + off, key=k),
            rec("step.render", 1005 + off, 1050 + off, key=k),
            rec("step.prefix", 1050 + off, 1100 + off, key=k),
            rec("step.adapt", 1100 + off, 1290 + off, key=k),
            rec("step.classify", 1290 + off, 1320 + off, key=k)])
    records[-1] = rec("step.classify", 1790, 1820, key=1)
    records[-5] = rec("step", 1505, 1820, key=1)
    by_stage = spans.stage_device_us({"reading": r})
    assert by_stage == {"step.render": 40.0, "step.prefix": 100.0,
                        "step.adapt": 450.0, "step.classify": 30.0, "": 5.0}
    run = {"reading": r, "config": CONFIG}
    got = {n: metric_reader(f"{n}_device_ms.offline")(run)
           for n in ("render", "prefix", "adapt", "classify")}
    assert got == pytest.approx({"render": 0.02, "prefix": 0.05,
                                 "adapt": 0.225, "classify": 0.015})


def test_means_per_span_and_per_image(records):
    r = reading([launch(1, 1100), kernel(1, 1150, 100)])
    records.extend([
        rec("predict.loader_wait", 1100, 1102, key=0),
        rec("predict.loader_wait", 1300, 1306, key=1),
        rec("loader.decode", 1200, 1280, key=4),
        rec("loader.decode", 1400, 1560, key=5),
        rec("loader.upload", 1600, 1610, key=4),
        rec("serve.queued", 900, 1100, key=0, step=3),   # began before
        rec("serve.queued", 1000, 1400, key=1, step=3),
        rec("serve.collect", 1500, 1650, key=3)])
    run = {"reading": r, "config": CONFIG}
    read = metric_reader
    assert read("loader_wait_ms.offline")(run) == pytest.approx(0.004)
    # 240 us over two batches of 8 images
    assert read("decode_ms_per_image.offline")(run) == pytest.approx(0.015)
    assert read("upload_ms.offline")(run) == pytest.approx(0.01)
    assert read("queue_wait_ms.serve")(run) == pytest.approx(0.3)
    assert read("result_wait_ms.serve")(run) == pytest.approx(0.15)
    assert read("gather_ms.serve")(run) is None


def test_idle_share_inside_the_upload(records):
    """Device busy 1100-1300 and 1500-1900 of the span 1000-2000: idle
    1000-1100, 1300-1500 and 1900-2000 (400 us); the uploads 1250-1450
    and two that overlap, 1950-1990 and 1960-1995, cover 150 + 45 us of
    it (an overlap counted once)."""
    r = reading([launch(1, 1050), kernel(1, 1100, 200),
                 launch(2, 1400), kernel(2, 1500, 300),
                 {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
                  "ts": 1700, "dur": 200, "args": {"correlation": 3}}])
    records.extend([rec("serve.upload", 1250, 1450, key=0),
                    rec("serve.upload", 1950, 1990, key=1),
                    rec("serve.upload", 1960, 1995, key=2)])
    run = {"reading": r}
    assert spans.idle(r) == [(1000.0, 1100.0), (1300.0, 1500.0),
                             (1900.0, 2000.0)]
    got = metric_reader("idle_in_upload_pct.serve")(run)
    assert got == pytest.approx(100.0 * (150 + 45) / 400)


def test_manifest_lists_the_cells_of_each_span_metric():
    assert len(SPAN_METRICS) == 13
    for entry in load_json(MANIFEST)["per_layer"]:
        if entry["source"] == "program_span":
            assert entry["workloads"] and entry["unit"] in ("ms", "%")


# ------------------------------------------------------------- on the card

def traced_run(name, card, tmp_path, seconds):
    """A traced run of a cell at its own size, and its per-layer metrics."""
    from benchmark.harness import session
    from benchmark.harness.manifest import load_cell

    cell = load_cell(name)
    res = session.execute(cell, 2 ** 31 + 4321, seconds, True, card,
                          time.time(), str(tmp_path))
    metrics, _, _ = session.per_layer(cell, res)
    with open(res["trace_path"]) as f:
        data = json.load(f)
    return cell, res, metrics, data


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vitb16-offline", "vitl14-offline"])
def test_stages_hold_the_steps_kernel_time_on_the_card(name, card,
                                                       tmp_path):
    """The trace's base time is trace_us's; the four stage metrics account
    for at least 97 % of the traced steps' kernel time; every metric of
    the cell reads a number."""
    cell, res, metrics, data = traced_run(name, card, tmp_path, 12.0)
    r = trace.read(res["trace_path"])
    run = {"reading": r}
    steps = spans.in_span(run, ("step",))
    assert int(data["baseTimeNanoseconds"]) == \
        profiling.trace_base_ns(profiling.recorded()[-1].t0_ns)
    by_stage = spans.stage_device_us(run)
    total = sum(float(e["dur"]) for e in r.span_kernels)
    share = sum(v for k, v in by_stage.items() if k) / total
    print(f"{name}: {len(steps)} steps, stage us {by_stage}, "
          f"kernel us {total}, share {share:.5f}, metrics {metrics}")
    assert len(steps) == res["traced_steps"]
    assert share >= 0.97
    stage_ms = sum(metrics[f"{n}_device_ms.offline"]["value"]
                   for n in ("render", "prefix", "adapt", "classify"))
    assert stage_ms == pytest.approx(share * total / len(steps) / 1e3)
    for m in cell.per_layer:
        assert metrics.get(m["name"], {}).get("value") is not None, m


def runtime_tid(native: int) -> int:
    """The `tid` torch 2.11's trace gives the CUDA runtime calls of a
    thread other than the one that started the profiler: Kineto's
    `threadId()`, the low 32 bits of `pthread_self()` as a signed number,
    made positive by the exporter (the span records hold the thread's
    native id)."""
    import ctypes
    import threading

    (ident,) = [t.ident for t in threading.enumerate()
                if t.native_id == native]
    return abs(ctypes.c_int32(ident & 0xFFFFFFFF).value)


@pytest.mark.cuda
def test_serving_uploads_lie_inside_their_spans_on_the_card(card, tmp_path):
    """Every host-to-device cudaMemcpyAsync the batcher's thread made in
    the traced span lies, once the spans are mapped with trace_us, inside
    one of that thread's serve.upload spans (the canvases, sizes and
    draws: 3 + the draws' tensors a step) or step.render spans (the two
    normalisation constants `ops/image.py` makes on the card each step);
    every metric of the cell reads a number."""
    cell, res, metrics, data = traced_run("vitb16-serve", card, tmp_path,
                                          10.0)
    r = trace.read(res["trace_path"])
    held = spans.in_span({"reading": r}, ("serve.upload", "step.render"))
    (native,) = {s.tid for s in held if s.name == "serve.upload"}
    batcher = runtime_tid(native)
    ev = data["traceEvents"]
    h2d = {e["args"]["correlation"] for e in ev if e.get("ph") == "X"
           and e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]}
    copies = [e for e in ev if e.get("ph") == "X"
              and e.get("cat") == "cuda_runtime"
              and e["name"].startswith("cudaMemcpyAsync")
              and e.get("tid") == batcher
              and e.get("args", {}).get("correlation") in h2d
              and r.t0 <= float(e["ts"]) <= r.t1 - 1e5]
    assert copies
    where, margins = {}, []
    for e in copies:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        inside = [s for s in held if s.tid == native
                  and s.t0 <= a and b <= s.t1]
        assert inside, (e, min(held, key=lambda s: abs(s.t0 - a)))
        where[inside[0].name] = where.get(inside[0].name, 0) + 1
        margins.append((a - inside[0].t0, inside[0].t1 - b))
    idle_in = {n: spans.idle_share_in({"reading": r}, n) for n in
               ("serve.gather", "serve.decode", "serve.dispatch",
                "serve.upload", "serve.collect", "step")}
    print(f"vitb16-serve: batcher {native} ({batcher}), copies {where}, "
          f"least margins (us) {min(m[0] for m in margins)} / "
          f"{min(m[1] for m in margins)}, idle % inside {idle_in}, "
          f"metrics {metrics}")
    assert where["serve.upload"] > where.get("step.render", 0)
    for m in cell.per_layer:
        assert metrics.get(m["name"], {}).get("value") is not None, m
