"""The AIMv2 cell (`aimv2l14-224-offline`): the harness runs a tiny cut of
it on the CPU through the program's `aimv2-tiny` towers and its reference
(`reference/arch/lit_aimv2.py`), `correct`, with the float8 control
departing; its operation and byte counts are pinned at the published
widths; the `rms_norm_roofline` reader on a made-up trace; on the card, the
control at the cell's own size, and a traced run whose every metric reads a
number, with the RMS counters."""
from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from conftest import run_cpu

from benchmark.harness import session, trace, work
from benchmark.harness.manifest import (BENCH, Cell, load_cell, load_json,
                                        metric_reader, work_counts)

CELL = "aimv2l14-224-offline"
AIM = load_json(BENCH / "configs" / "aimv2-large-patch14-224-lit.json")
TINY = {"hidden_size": 256, "num_hidden_layers": 4,
        "num_attention_heads": 2, "intermediate_size": 704, "patch_size": 16,
        "image_size": 64, "rms_norm_eps": 1e-5}


def tiny_aim_cell(dtype: str = "float32") -> Cell:
    """The cell cut to the program's `aimv2-tiny` towers: small images, 8
    views, a small check."""
    cell = load_cell(CELL)
    config = copy.deepcopy(cell.config)
    config.update(program_arch="aimv2-tiny", projection_dim=16,
                  vision=dict(TINY), text=dict(TINY, vocab_size=49408,
                                               max_position_embeddings=77))
    config["ttl"].update(views=8, lora_layers=[1, 3], compute_dtype=dtype,
                         param_dtype=dtype)
    traffic = dict(cell.traffic, long_side_px=[100, 160], canvas=160,
                   distinct_images=16)
    check = dict(cell.check, sample=32, block=8)
    return Cell(cell.name, 1, config, traffic, check, cell.end_to_end,
                cell.per_layer)


def test_the_cell_names_aimv2():
    cell = load_cell(CELL)
    assert cell.config["architecture"] == "lit_aimv2"
    assert cell.config["program_arch"] == "AIMv2-L-14-224-LiT"
    v = cell.config["vision"]
    assert (v["hidden_size"], v["num_hidden_layers"],
            v["num_attention_heads"], v["intermediate_size"],
            v["patch_size"], v["image_size"]) == (1024, 24, 8, 2816, 14, 224)
    names = {m["name"] for m in cell.per_layer}
    assert {"rms_norm_roofline", "swiglu_roofline", "mfu.offline",
            "k1_roofline", "k2_roofline", "prefix_device_ms.offline"} <= names
    assert "rope_device_ms.offline" not in names
    assert {m["name"] for m in cell.end_to_end} == {"images_per_s",
                                                    "setup_s"}


def test_tiny_cut_is_correct_and_the_control_departs(tmp_path):
    """The port in float32 against the reference, as the EVA02 cell's tiny
    cut: 6 printed digits of a probability near 1e-3 move ln p by up to
    5e-4."""
    cell = tiny_aim_cell()
    res = run_cpu(cell, tmp_path=tmp_path)
    values = {k: v["value"] for k, v in res["checks"].items()}
    assert values["adapted_logprob_gap"] < 1e-3
    assert values["adapted_top1_gap"] == 0.0
    assert values["zero_shot_gap"] == 0.0
    assert res["attempted"] > 8 and res["failed"] == 0 and res["correct"]
    low = run_cpu(cell, tmp_path=tmp_path, control="fp8")
    assert low["checks"]["adapted_logprob_gap"]["value"] > 1e-2


def test_counts_are_pinned():
    # 2 (4 d^2 + 3 d F) + 4 S d a token and layer: 26.7 MFLOP, 256 tokens
    assert work.layer_flops(AIM) / 256 == 26738688
    assert work.image_flops(AIM) / 1e12 == pytest.approx(12.1, abs=0.05)
    fwd, bwd = work.attention_calls(AIM, 8)
    views = work.AttentionCall(512, 256, 8, 128)
    assert fwd == [views] * 24 + [views._replace(batch=8)] * 6
    assert bwd == [views] * 3
    counts = work_counts(AIM)
    row = 2816 * 2
    assert counts.swiglu_calls(AIM, 8) == \
        [512 * 256 * 3 * row] * 24 + [8 * 256 * 3 * row] * 6 \
        + [512 * 256 * 5 * row] * 3
    # RMSNorm_e, the window's six and RMSNorm_f forward over every view,
    # the clean view's two passes (six and RMSNorm_f each), five window
    # backwards and RMSNorm_f's
    row = 1024 * 2
    assert counts.rms_norm_calls(AIM, 8) == \
        [512 * 256 * 2 * row] * 8 + [8 * 256 * 2 * row] * 14 \
        + [512 * 256 * 3 * row] * 6


def _reading(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.SPAN,
           "ts": 1000, "dur": 1000}]
    for corr, (ts, name, dur) in enumerate(
            [(1100, "rms_norm_fwd_kernel", 100),
             (1300, "layer_norm_fwd_kernel", 40),
             (1500, "rms_norm_bwd_kernel", 200),
             (1700, "elementwise_kernel", 50)]):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": ts, "dur": 5, "tid": 1,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts + 10,
                   "dur": dur, "args": {"correlation": corr}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read(str(path))


def test_rms_norm_roofline_reads_the_rms_kernels(tmp_path):
    run = {"reading": _reading(tmp_path), "config": AIM, "traced_steps": 2}
    got = metric_reader("rms_norm_roofline")(run)
    bound = 2 * sum(work_counts(AIM).rms_norm_calls(AIM, 8)) / 3.35e12
    assert got == pytest.approx(100.0 * bound / 300e-6)
    for other in ("vitl14-offline", "eva02l14-336-offline"):
        config = load_cell(other).config
        assert metric_reader("rms_norm_roofline")(
            dict(run, config=config)) is None
    assert metric_reader("rms_norm_roofline")({"config": AIM}) is None


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_fp8_control_is_not_correct_at_the_cells_size(card, tmp_path):
    res = session.execute(load_cell(CELL), 2 ** 31 + 5321, 4.0, False, card,
                          time.time(), str(tmp_path), control="fp8")
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_traced_run_reads_every_metric(card, tmp_path):
    cell = load_cell(CELL)
    res = session.execute(cell, 2 ** 31 + 5322, 14.0, True, card,
                          time.time(), str(tmp_path))
    metrics, _, _ = session.per_layer(cell, res)
    assert set(metrics) == {m["name"] for m in cell.per_layer}
    assert 0 < metrics["rms_norm_roofline"]["value"] <= 100
    steps = res["traced_steps"]
    counters = res["counters"]
    # every vision norm of a step runs the RMS code: 22 forwards, 6 dx;
    # the 21 folded prefix layers launch K6 twice each
    assert counters["layer_norm.rms_launches"] == 28 * steps
    assert counters["layer_norm.launches"] == 28 * steps
    assert counters["ln_matmul.rms_launches"] == 42 * steps
    assert counters["attention_bshd.fwd_launches"] == 30 * steps
    assert res["correct"] and torch.cuda.max_memory_allocated(card) \
        <= 75e9
