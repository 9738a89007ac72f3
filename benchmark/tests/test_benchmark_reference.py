"""The float32 reference against the port at `test-tiny` on the CPU: the
whole run (images, the program's window, the sample, the reference)
through each traffic driver, the port in float32. The printed
probabilities carry 6 digits, so the log-probability gap stays above 0."""
from __future__ import annotations

import pytest

from conftest import run_cpu, tiny_cell

import ttl_tpu_torch.ops.attention as fa


@pytest.mark.parametrize("cell", ["vitb16-offline", "vitb16-serve"])
def test_reference_agrees_with_the_port(cell, tmp_path):
    res = run_cpu(tiny_cell(cell), tmp_path=tmp_path)
    values = {k: v["value"] for k, v in res["checks"].items()}
    assert values["adapted_logprob_gap"] < 2e-4
    assert values["adapted_top1_gap"] == 0.0
    assert values["zero_shot_gap"] == 0.0
    assert res["attempted"] > 8 and res["failed"] == 0
    assert res["correct"]


def test_reference_is_independent_of_the_program():
    import ast
    from pathlib import Path

    ref = Path(__file__).resolve().parents[1] / "reference"
    paths = sorted(ref.rglob("*.py"))
    assert ref / "arch" / "clip.py" in paths
    for path in paths:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(
                    node, ast.Import) else [node.module or ""]
                for name in names:
                    assert name.split(".")[0] not in (
                        "ttl_tpu_torch", "ttl_tpu", "jax", "benchmark"), \
                        (str(path.relative_to(ref)), name)


def test_bfloat16_port_is_not_exact(tmp_path):
    """The tiny port in bfloat16 departs from the float32 reference by far
    more than the float32 port does: the check sees precision."""
    res = run_cpu(tiny_cell("vitb16-offline", dtype="bfloat16"),
                  tmp_path=tmp_path)
    assert res["checks"]["adapted_logprob_gap"]["value"] > 2e-3
    assert fa.attention_bshd.fwd_launches == 0   # plain versions on the CPU


@pytest.mark.parametrize("cell", ["vitb16-offline", "vitb16-serve"])
def test_fp8_control_departs(cell, tmp_path):
    """The float8 reference in the program's place reads far above the
    float32 port."""
    res = run_cpu(tiny_cell(cell), tmp_path=tmp_path, control="fp8")
    assert res["checks"]["adapted_logprob_gap"]["value"] > 1e-2
