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
