"""The EVA02 cell (`eva02l14-336-offline`): the harness runs a tiny cut of
it on the CPU through the program's `eva02-tiny` tower and its reference
(`reference/arch/eva02.py`), `correct`, with the float8 control departing;
its operation and byte counts are pinned at the published widths; its two
readers on made-up traces; on the card, the control at the cell's own
size, and a traced run whose every metric reads a number."""
from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from conftest import TINY_TEXT, run_cpu

from benchmark.harness import session, spans, trace, work
from benchmark.harness.manifest import (BENCH, Cell, load_cell, load_json,
                                        metric_reader, work_counts)
from ttl_tpu_torch.utils import profiling

CELL = "eva02l14-336-offline"
EVA = load_json(BENCH / "configs" / "eva02-clip-l14-336.json")
TINY_VISION = {"hidden_size": 32, "num_hidden_layers": 4,
               "num_attention_heads": 2, "intermediate_size": 85,
               "patch_size": 16, "image_size": 64, "rope_theta": 10000,
               "rope_pretrain_grid": 2}


def tiny_eva_cell(dtype: str = "float32") -> Cell:
    """The cell cut to the program's `eva02-tiny` tower: small images, 8
    views, a small check."""
    cell = load_cell(CELL)
    config = copy.deepcopy(cell.config)
    config.update(program_arch="eva02-tiny", projection_dim=16,
                  vision=dict(TINY_VISION), text=dict(TINY_TEXT))
    config["ttl"].update(views=8, lora_layers=[1, 3], compute_dtype=dtype,
                         param_dtype=dtype)
    traffic = dict(cell.traffic, long_side_px=[100, 160], canvas=160,
                   distinct_images=16)
    check = dict(cell.check, sample=32, block=8)
    return Cell(cell.name, 1, config, traffic, check, cell.end_to_end,
                cell.per_layer)


def test_the_cell_names_eva02():
    cell = load_cell(CELL)
    assert cell.config["architecture"] == "eva02"
    assert cell.config["program_arch"] == "EVA02-CLIP-L-14-336"
    v = cell.config["vision"]
    assert (v["hidden_size"], v["num_hidden_layers"],
            v["num_attention_heads"], v["intermediate_size"],
            v["patch_size"], v["image_size"]) == (1024, 24, 16, 2730, 14, 336)
    assert cell.config["text"]["hidden_act"] == "gelu"
    names = {m["name"] for m in cell.per_layer}
    assert {"swiglu_roofline", "rope_device_ms.offline", "mfu.offline",
            "k1_roofline", "prefix_device_ms.offline"} <= names
    assert {m["name"] for m in cell.end_to_end} == {"images_per_s",
                                                    "setup_s"}


def test_tiny_cut_is_correct_and_the_control_departs(tmp_path):
    """The port in float32 against the reference: the printed
    probabilities carry 6 digits, and over 1000 classes the tiny tower's
    fifth probability goes down to about 1e-3 (0.0034 in one run), where
    the rounding alone moves ln p by up to 5e-4."""
    cell = tiny_eva_cell()
    res = run_cpu(cell, tmp_path=tmp_path)
    values = {k: v["value"] for k, v in res["checks"].items()}
    assert values["adapted_logprob_gap"] < 1e-3
    assert values["adapted_top1_gap"] == 0.0
    assert values["zero_shot_gap"] == 0.0
    assert res["attempted"] > 8 and res["failed"] == 0 and res["correct"]
    low = run_cpu(cell, tmp_path=tmp_path, control="fp8")
    assert low["checks"]["adapted_logprob_gap"]["value"] > 1e-2


def test_counts_are_pinned():
    # 2 (4 d^2 + 3 d F) + 4 S d a token and layer: 27.5 MFLOP
    assert work.layer_flops(EVA) == 577 * (2 * (4 * 1024 ** 2
                                                + 3 * 1024 * 2730)
                                           + 4 * 577 * 1024)
    assert work.layer_flops(EVA) / 577 == 27525120
    assert work.image_flops(EVA) == pytest.approx(27797224528281.6)
    assert work.image_flops(EVA) / 1e12 == pytest.approx(27.8, abs=0.01)
    fwd, bwd = work.attention_calls(EVA, 8)
    views = work.AttentionCall(512, 577, 16, 64)
    assert fwd == [views] * 24 + [views._replace(batch=8)] * 6
    assert bwd == [views] * 3
    calls = work_counts(EVA).swiglu_calls(EVA, 8)
    row = 2730 * 2
    assert calls == [512 * 577 * 3 * row] * 24 + [8 * 577 * 3 * row] * 6 \
        + [512 * 577 * 5 * row] * 3
    assert sum(calls) / 3.35e12 * 1e3 == pytest.approx(42.026, abs=1e-3)


# --------------------------------------------------------- the two readers

BASE = profiling.trace_base_ns(time.time_ns())


def _reading(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.SPAN,
           "ts": 1000, "dur": 1000}]
    for corr, (ts, name, dur) in enumerate(
            [(1100, "swiglu_fwd_pairs_kernel", 100),
             (1300, "elementwise_kernel", 40),
             (1320, "elementwise_kernel", 30),
             (1500, "swiglu_bwd_pairs_kernel", 200),
             (1700, "elementwise_kernel", 50)]):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": ts, "dur": 5, "tid": 1,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts + 10,
                   "dur": dur, "args": {"correlation": corr}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read(str(path))


def _span(name, t0, t1, i):
    return profiling.Span(name, i, None, None, 1, BASE + int(t0 * 1000),
                          BASE + int(t1 * 1000))


def test_swiglu_roofline_reads_the_swiglu_kernels(tmp_path):
    run = {"reading": _reading(tmp_path), "config": EVA, "traced_steps": 2}
    got = metric_reader("swiglu_roofline")(run)
    bound = 2 * sum(work_counts(EVA).swiglu_calls(EVA, 8)) / 3.35e12
    assert got == pytest.approx(100.0 * bound / 300e-6)
    clip = load_cell("vitl14-offline").config
    assert metric_reader("swiglu_roofline")(dict(run, config=clip)) is None
    assert metric_reader("swiglu_roofline")({"config": EVA}) is None


def test_rope_device_ms_reads_the_kernels_launched_in_its_spans(
        tmp_path, monkeypatch):
    run = {"reading": _reading(tmp_path), "config": EVA}
    held = [_span("step", 1050, 1990, 1), _span("step", 1060, 1995, 2),
            _span("eva.rope", 1290, 1330, 3),
            _span("eva.rope", 1690, 1710, 4)]
    monkeypatch.setattr(profiling, "recorded", lambda: list(held))
    assert spans.steps_in_span(run) == 2
    got = metric_reader("rope_device_ms.offline")(run)
    assert got == pytest.approx((40 + 30 + 50) / 2 / 1e3)
    held[2:] = []
    assert metric_reader("rope_device_ms.offline")(run) is None


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_fp8_control_is_not_correct_at_the_cells_size(card, tmp_path):
    res = session.execute(load_cell(CELL), 2 ** 31 + 4321, 4.0, False, card,
                          time.time(), str(tmp_path), control="fp8")
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_traced_run_reads_every_metric(card, tmp_path):
    cell = load_cell(CELL)
    res = session.execute(cell, 2 ** 31 + 4322, 14.0, True, card,
                          time.time(), str(tmp_path))
    metrics, _, _ = session.per_layer(cell, res)
    assert set(metrics) == {m["name"] for m in cell.per_layer}
    assert 0 < metrics["swiglu_roofline"]["value"] <= 100
    assert metrics["rope_device_ms.offline"]["value"] > 0
    steps = res["traced_steps"]
    # the window's forward runs twice (its layers are recomputed in the
    # backward): RoPE 2 x (21 + 3 x 4), SwiGLU 21 + 3 x 5 a step
    assert res["counters"]["rope.launches"] == 66 * steps
    assert res["counters"]["swiglu.launches"] == 36 * steps
    assert res["counters"]["ln_matmul.linear_launches"] == 42 * steps
    assert res["correct"] and torch.cuda.max_memory_allocated(card) \
        <= 75e9
