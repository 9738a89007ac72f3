"""The port's profiling utilities (`ttl_tpu_torch/utils/profiling.py`).

- `op_stats`, `device_busy_us` and `device_union_us` over Chrome traces the
  test writes: the device events (kernels, memcpys, memsets) by name, their
  sums, order, fractions and `top`; CPU operators, runtime calls and
  annotation ranges left out; the newest of two traces read.
- An empty or missing directory gives [] and None, as
  tests/test_cli_subprocess.py holds for the JAX package's `op_stats`.
- `trace()` on the CPU, around `runner.run`, writes one trace that the
  readers parse: CPU operators and no device time.
- `PhaseTimer` prints what the JAX package's prints for the same clock.
- `cli.main(["--profile", DIR, ...])` prints the top rows as the JAX CLI
  formats them (a fake run and trace stand in for the card); without CUDA
  it raises before it traces anything.
"""
import json
import os

import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (torch threads per worker)
from ttl_tpu.utils import profiling as jprofiling
from ttl_tpu_torch import cli as tcli
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.data.views import ArrayDataset
from ttl_tpu_torch.utils import profiling
from ttl_tpu_torch.utils.profiling import (PhaseTimer, device_busy_us,
                                           device_union_us, op_stats, trace)


def event(name, cat, ts, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {}}


EVENTS = [
    {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "x"}},
    event("gemm", "kernel", 0.0, 10.0),
    event("gemm", "kernel", 12.0, 10.0),
    event("attention", "kernel", 30.0, 30.0),
    event("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 25.0, 6.0),
    event("Memset (Device)", "gpu_memset", 70.0, 1.0),
    event("aten::mm", "cpu_op", 0.0, 100.0),
    event("cudaLaunchKernel", "cuda_runtime", 1.0, 2.0),
    event("step", "gpu_user_annotation", 0.0, 71.0),
    event("gemm", "kernel", 90.0, 0.0, ph="i"),
]


def write_trace(directory, events, name="1.1.pt.trace.json", mtime=None):
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    if mtime is not None:
        os.utime(path, (mtime, mtime))
    return path


def test_op_stats_sums_orders_and_fractions_the_device_events(tmp_path):
    write_trace(tmp_path, EVENTS)
    rows = op_stats(str(tmp_path))
    assert [(r["operation"], r["type"], r["self_time_us"], r["occurrences"])
            for r in rows] == [
        ("attention", "kernel", 30.0, 1), ("gemm", "kernel", 20.0, 2),
        ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 6.0, 1),
        ("Memset (Device)", "gpu_memset", 1.0, 1)]
    np.testing.assert_allclose([r["fraction"] for r in rows],
                               [30 / 57, 20 / 57, 6 / 57, 1 / 57])
    assert all(r["bound_by"] is None for r in rows)
    assert set(rows[0]) == {"operation", "type", "self_time_us", "fraction",
                            "bound_by", "occurrences"}


def test_top_truncates_the_rows_but_not_the_busy_time(tmp_path):
    write_trace(tmp_path, EVENTS)
    rows = op_stats(str(tmp_path), top=2)
    assert [r["operation"] for r in rows] == ["attention", "gemm"]
    assert rows[1]["fraction"] == pytest.approx(20 / 57)
    assert device_busy_us(str(tmp_path)) == 57.0


def test_union_counts_overlapping_device_time_once(tmp_path):
    write_trace(tmp_path, EVENTS)
    # [0, 10], [12, 22], [25, 31] and [30, 60] overlap by 1, [70, 71]
    assert device_union_us(str(tmp_path)) == 10 + 10 + 35 + 1
    assert device_busy_us(str(tmp_path)) - device_union_us(str(tmp_path)) \
        == 1.0


def test_the_newest_trace_is_read(tmp_path):
    write_trace(tmp_path, EVENTS, "1.1.pt.trace.json", mtime=1000)
    write_trace(tmp_path, [event("later", "kernel", 0.0, 4.0)],
                "2.2.pt.trace.json", mtime=2000)
    write_trace(tmp_path, [event("not a trace", "kernel", 0.0, 9.0)],
                "notes.json", mtime=3000)
    assert [r["operation"] for r in op_stats(str(tmp_path))] == ["later"]
    assert device_busy_us(str(tmp_path)) == 4.0


@pytest.mark.parametrize("sub", ["", "missing"])
def test_no_trace_gives_empty_rows_and_none(tmp_path, sub):
    directory = str(tmp_path / sub)
    assert op_stats(directory) == [] == jprofiling.op_stats(directory)
    assert device_busy_us(directory) is None
    assert jprofiling.device_busy_us(directory) is None
    assert device_union_us(directory) is None


def test_trace_on_the_cpu_around_a_run_writes_one_trace(tmp_path):
    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8),
                      np.array([3, 1]))
    cfg = TTLConfig(arch="test-tiny", resolution=64, batch_size=8,
                    sample_batch=2, compute_dtype="float32",
                    param_dtype="float32", workers=1, tta_steps=0)
    log_dir = str(tmp_path / "trace")
    with trace(log_dir, "cpu") as prof:
        trunner.run(cfg, device="cpu", datasets={"A": ds})
    assert prof is not None
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(log_dir, files[0])) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "cpu_op"}
    assert {"aten::matmul", "aten::softmax"} <= names
    # the CPU is no device: no device operation, zero device time
    assert op_stats(log_dir) == []
    assert device_busy_us(log_dir) == 0.0 == device_union_us(log_dir)


def test_phase_timer_prints_what_the_jax_one_prints(monkeypatch):
    def run(module):
        clock = iter([10.0, 10.25, 11.0, 11.5, 12.0, 12.125])
        monkeypatch.setattr(module.time, "time", lambda: next(clock))
        t = module.PhaseTimer()
        for name in ("decode", "decode", "adapt"):
            with t.phase(name):
                pass
        return t

    got, want = run(profiling), run(jprofiling)
    assert got.summary() == want.summary() == \
        "adapt: 0.125s/1 | decode: 0.750s/2"
    assert dict(got.counts) == dict(want.counts)


def test_cli_profile_prints_the_top_rows_as_the_jax_cli(tmp_path, monkeypatch,
                                                         capsys):
    """On a card `--profile DIR` runs the run under `trace(DIR, device)`;
    here a fake run and a fake trace that writes EVENTS stand in."""
    seen = {}

    def fake_run(cfg, *, device, max_samples=None):
        seen["device"] = device
        return {"A": [50.0, 100.0]}

    import contextlib

    @contextlib.contextmanager
    def fake_trace(log_dir, device):
        seen["trace"] = (log_dir, device)
        yield
        write_trace(log_dir, EVENTS)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.setdefault("current", d))
    monkeypatch.setattr(trunner, "run", fake_run)
    monkeypatch.setattr(profiling, "trace", fake_trace)
    log_dir = str(tmp_path / "prof")
    got = tcli.main(["data", "--test_sets", "A", "--profile", log_dir,
                     "--gpu", "2"])
    assert got == {"A": [50.0, 100.0]}
    assert seen == {"current": torch.device("cuda:2"),
                    "device": torch.device("cuda:2"),
                    "trace": (log_dir, torch.device("cuda:2"))}
    lines = capsys.readouterr().out.splitlines()
    assert lines == [" 52.6%              attention",
                     " 35.1%              gemm",
                     " 10.5%              Memcpy HtoD (Pinned -> Device)",
                     "  1.8%              Memset (Device)"]


def test_cli_profile_without_cuda_raises_before_tracing(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    log_dir = tmp_path / "prof"
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["data", "--test_sets", "A", "--profile", str(log_dir)])
    assert not log_dir.exists()


# ---------------------------------------------------------------- spans

def _cpu_profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


def _since(first_id, name=None):
    return [s for s in profiling.recorded() if s.id > first_id
            and (name is None or s.name == name)]


def _last_id():
    return max((s.id for s in profiling.recorded()), default=0)


def test_spans_without_a_profiler_record_nothing(monkeypatch):
    """No profiler: one shared no-op, no stamp, no record_function."""
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    first = _last_id()
    a, b = profiling.span("off"), profiling.span("off", key=3)
    assert a is b
    with a, b:
        pass
    profiling.record("off.record", 1, 2, key=1)
    assert entered == [] and _since(first) == []


def test_spans_of_another_thread_are_recorded_with_its_id_and_parents():
    import threading

    got = {}

    def work():
        got["tid"] = threading.get_native_id()
        with profiling.span("other.outer", key=7):
            with profiling.span("other.inner"):
                with profiling.span("other.leaf", key=9):
                    pass

    first = _last_id()
    with _cpu_profile():
        t = threading.Thread(target=work)
        t.start()
        t.join()
    spans = {s.name: s for s in _since(first)}
    outer, inner, leaf = (spans[f"other.{n}"]
                          for n in ("outer", "inner", "leaf"))
    assert {outer.tid, inner.tid, leaf.tid} == {got["tid"]}
    assert got["tid"] != threading.get_native_id()
    assert outer.parent is None
    assert inner.parent == outer.id and leaf.parent == inner.id
    # a span without a key takes its parent's
    assert (outer.key, inner.key, leaf.key) == (7, 7, 9)
    assert outer.t0_ns <= inner.t0_ns <= leaf.t0_ns <= leaf.t1_ns \
        <= inner.t1_ns <= outer.t1_ns


def test_record_keeps_an_interval_stamped_elsewhere():
    first = _last_id()
    with _cpu_profile():
        profiling.record("queued", 1000, 5000, key=4, step=2)
    (s,) = _since(first)
    assert (s.name, s.key, s.step, s.t0_ns, s.t1_ns, s.parent) == \
        ("queued", 4, 2, 1000, 5000, None)


def test_trace_us_agrees_with_the_traces_own_annotations(tmp_path):
    """Spans on the profiling thread are also user_annotation events; the
    recorder's stamps mapped by trace_us land within 200 us of them (the
    first span, which pays the first record_function, left out)."""
    import time

    first = _last_id()
    with _cpu_profile() as prof:
        for i in range(8):
            with profiling.span("clock", key=i):
                torch.ones(64).sum()
                time.sleep(0.001)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    marks = sorted((e for e in data["traceEvents"]
                    if e.get("cat") == "user_annotation"
                    and e.get("name") == "clock"), key=lambda e: e["ts"])
    spans = sorted(_since(first, "clock"), key=lambda s: s.t0_ns)
    assert len(marks) == len(spans) == 8
    if "baseTimeNanoseconds" in data:
        assert int(data["baseTimeNanoseconds"]) == \
            profiling.trace_base_ns(spans[0].t0_ns)
    for m, s in list(zip(marks, spans))[1:]:
        assert abs(profiling.trace_us(s.t0_ns) - m["ts"]) < 200
        assert abs(profiling.trace_us(s.t1_ns) - (m["ts"] + m["dur"])) < 200
        assert m["tid"] == s.tid



def test_spans_from_many_threads_lose_nothing():
    """More threads than cores record nested spans while another thread
    takes snapshots, at a short switch interval: every span is kept once,
    with a unique id and its own thread's parent."""
    import sys
    import threading

    n_threads = (os.cpu_count() or 1) + 4
    per_thread = 100
    stop = threading.Event()
    snapshots = []

    def work(k):
        for i in range(per_thread):
            with profiling.span("stress.outer", key=k):
                with profiling.span("stress.inner", key=i):
                    pass

    def read():
        while not stop.is_set():
            snapshots.append(len(profiling.recorded()))

    first = _last_id()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            reader = threading.Thread(target=read)
            reader.start()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            stop.set()
            reader.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not reader.is_alive()
    assert not any(t.is_alive() for t in threads)
    assert snapshots
    spans = _since(first)
    assert len(spans) == 2 * n_threads * per_thread
    assert len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "stress.inner":
            outer = by_id[s.parent]
            assert outer.name == "stress.outer" and outer.tid == s.tid
            assert outer.t0_ns <= s.t0_ns <= s.t1_ns <= outer.t1_ns
    assert len({s.key for s in spans if s.name == "stress.outer"}) == \
        n_threads

def test_the_span_buffer_is_bounded(monkeypatch):
    from collections import deque

    monkeypatch.setattr(profiling, "_records", deque(maxlen=5))
    with _cpu_profile():
        for i in range(12):
            with profiling.span("bounded", key=i):
                pass
    kept = profiling.recorded()
    assert [s.key for s in kept] == list(range(7, 12))
    assert profiling.CAPACITY == 65536


def test_trace_json_carries_other_threads_spans(tmp_path):
    import threading

    tids = []

    def work():
        tids.append(threading.get_native_id())
        with profiling.span("loader.like", key=11):
            pass

    log_dir = str(tmp_path / "trace")
    with trace(log_dir, "cpu"):
        with profiling.span("main.like", key=1):
            t = threading.Thread(target=work)
            t.start()
            t.join()
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    ours = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(ours) == {"main.like", "loader.like"}
    assert ours["loader.like"]["tid"] == tids[0]
    assert ours["loader.like"]["args"]["key"] == 11
    assert ours["main.like"]["ts"] <= ours["loader.like"]["ts"]
    assert ours["loader.like"]["ts"] + ours["loader.like"]["dur"] <= \
        ours["main.like"]["ts"] + ours["main.like"]["dur"] + 1
    # the profiling thread's span is an annotation of the trace too
    assert any(e.get("cat") == "user_annotation"
               and e.get("name") == "main.like" for e in events)


def _tiny_cfg(**kw):
    return TTLConfig(arch="test-tiny", resolution=64, batch_size=8,
                     layer_range=(2, 3), rank=4, compute_dtype="float32",
                     param_dtype="float32", sample_batch=2, workers=1, **kw)


def test_predict_records_each_steps_stages_under_its_key():
    """predict_directory on the CPU under a profiler: every step's spans,
    from the loader's thread and the caller's, keyed by the step."""
    import io
    import threading

    from ttl_tpu_torch.predict import predict_directory

    rng = np.random.default_rng(1)
    ds = ArrayDataset(rng.integers(0, 256, (4, 40, 56, 3), dtype=np.uint8),
                      np.zeros(4, np.int64))
    first = _last_id()
    with _cpu_profile():
        n = predict_directory(_tiny_cfg(), ["a", "b", "c"], device="cpu",
                              dataset=ds, topk=2, out=io.StringIO())
    assert n == 4
    spans = _since(first)
    by_id = {s.id: s for s in spans}
    me = threading.get_native_id()
    for step in (0, 1):
        mine = {s.name: s for s in spans if s.key == step}
        assert {"predict.loader_wait", "predict.dispatch", "predict.drain",
                "loader.decode", "loader.upload", "step", "step.render",
                "step.prefix", "step.adapt", "step.classify"} <= set(mine)
        assert mine["loader.decode"].tid == mine["loader.upload"].tid != me
        assert mine["step"].tid == mine["predict.dispatch"].tid == me
        assert by_id[mine["step"].parent].name == "predict.dispatch"
        stages = [mine[f"step.{n}"] for n in ("render", "prefix", "adapt",
                                              "classify")]
        assert {by_id[s.parent].name for s in stages} == {"step"}
        # one after another, inside the step
        assert mine["step"].t0_ns <= stages[0].t0_ns
        for a, b in zip(stages, stages[1:]):
            assert a.t1_ns <= b.t0_ns
        assert stages[-1].t1_ns <= mine["step"].t1_ns


def test_microbatcher_records_each_request_once_with_its_step():
    """Every served request has one serve.queued record, and the step it
    rode is the key of a serve.dispatch span with its upload and stages."""
    from ttl_tpu_torch.models.clip import init_clip_params
    from ttl_tpu_torch.models.zoo import TEST_TINY
    from ttl_tpu_torch.serve import MicroBatcher, TTLPredictor
    from PIL import Image
    import io

    params = init_clip_params(TEST_TINY, torch.Generator().manual_seed(0),
                              device="cpu", param_dtype=torch.float32)
    predictor = TTLPredictor(["a", "b", "c"], _tiny_cfg(), device="cpu",
                             params=params, clip_cfg=TEST_TINY, warmup=False)
    blobs = []
    for i in range(5):
        buf = io.BytesIO()
        Image.fromarray(np.random.RandomState(i).randint(
            0, 255, (48, 64, 3), dtype=np.uint8)).save(buf, format="PNG")
        blobs.append(buf.getvalue())
    first = _last_id()
    with _cpu_profile():
        mb = MicroBatcher(predictor, max_delay_ms=20.0)
        futs = [mb.submit(b) for b in blobs]
        for fut in futs:
            assert fut.result(timeout=60)["label"] in ("a", "b", "c")
    spans = _since(first)
    queued = [s for s in spans if s.name == "serve.queued"]
    assert sorted(s.key for s in queued) == list(range(5))
    dispatched = {s.key: s for s in spans if s.name == "serve.dispatch"}
    assert {s.step for s in queued} == set(dispatched)
    by_id = {s.id: s for s in spans}
    for step, d in dispatched.items():
        mine = {s.name: s for s in spans if s.key == step}
        assert {"serve.gather", "serve.decode", "serve.upload",
                "serve.collect", "step", "step.adapt"} <= set(mine)
        assert by_id[mine["serve.upload"].parent] == d
        assert mine["serve.upload"].tid == d.tid == mine["step"].tid
        assert mine["serve.collect"].t0_ns >= d.t1_ns
    for s in queued:
        assert s.t0_ns <= s.t1_ns <= dispatched[s.step].t0_ns
