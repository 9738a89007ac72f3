"""The result line and the trace readers, on made-up runs: the line has
the contract's keys and `checks` last; a short trace is refused."""
from __future__ import annotations

import json
import types

import pytest
import torch

from benchmark.harness import session, trace
from benchmark.harness.manifest import load_cell, metric_reader

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


def events(drop_second_kernel=False):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.SPAN,
         "ts": 1000, "dur": 1000},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 1650,
         "dur": 300},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1100, "dur": 5, "args": {"correlation": 1}},
        # returns after the span closed: not counted as launched in it
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1998, "dur": 5, "args": {"correlation": 9}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1200, "dur": 5, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "mma_fwd_kernel<64>",
         "ts": 1150, "dur": 300, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "mma_bwd_rows_kernel<64>",
         "ts": 1400, "dur": 200, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 1900, "dur": 50, "args": {"correlation": 3}},
        # before the span: clipped away
        {"ph": "X", "cat": "kernel", "name": "early", "ts": 900,
         "dur": 50, "args": {"correlation": 0}},
    ]
    if drop_second_kernel:
        ev = [e for e in ev if e["name"] != "mma_bwd_rows_kernel<64>"]
    return ev


def write(tmp_path, ev):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_reading_of_a_whole_trace(tmp_path):
    r = trace.read(write(tmp_path, events()))
    assert r.window_s == pytest.approx(1e-3)
    assert r.busy_s == pytest.approx(500e-6)   # 1150-1600, 1900-1950
    assert r.kernel_seconds(("mma_fwd",)) == (pytest.approx(300e-6), 1)
    assert r.top_ops(1)[0][0] == "mma_fwd_kernel<64>"
    gaps = r.idle_gaps(3)
    assert gaps[0] == ["aten::item", pytest.approx(300e-6)]
    idle = metric_reader("device_idle_pct.offline")({"reading": r})
    assert idle == pytest.approx(50.0)


def test_short_trace_is_refused(tmp_path):
    with pytest.raises(trace.TraceError, match="short trace"):
        trace.read(write(tmp_path, events(drop_second_kernel=True)))


def test_readers_stay_silent_without_a_trace():
    cell = load_cell("vitb16-offline")
    for m in cell.per_layer:
        assert metric_reader(m["name"])({"config": cell.config}) is None


def fake_result(trace_path=None):
    res = {"correct": True, "attempted": 40, "failed": 0, "setup_s": 12.5,
           "end_to_end": {"images_per_s": 35.25}, "info": {},
           "launches": {"K1": 18}, "memory_peak_bytes": 123,
           "traced_steps": 2, "traced_images": 16,
           "checks": {"adapted_logprob_gap": {"value": 0.01,
                                              "limit": 0.1}}}
    if trace_path:
        res["trace_path"] = trace_path
    return res


@pytest.mark.parametrize("traced", [0, 1])
def test_last_line_has_the_contract_keys(tmp_path, monkeypatch, capsys,
                                         traced):
    path = write(tmp_path, events()) if traced else None
    monkeypatch.setattr(session, "require_cards",
                        lambda chips: torch.device("cpu"))
    monkeypatch.setattr(session, "card_info",
                        lambda: {"power.limit": "700.00 W"})
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(session, "execute",
                        lambda *a, **k: fake_result(path))
    args = types.SimpleNamespace(workload="vitb16-offline", seed=3,
                                 seconds=5.0, trace=traced, rate=None)
    assert session.main(args) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    want = CONTRACT + (["breakdown"] if traced else []) + ["checks"]
    assert list(line) == want
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    assert err.strip().splitlines()[-1] == "check correct True"
    if traced:
        assert set(line["metrics"]) <= {m["name"] for m in
                                        load_cell("vitb16-offline").per_layer}
        assert line["device"]["busy_s"] > 0
        assert "mfu.offline" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"setup_s", "images_per_s"}
