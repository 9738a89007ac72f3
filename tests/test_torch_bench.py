"""bench_torch.py, the port's counterpart of bench.py, on the CPU.

- `emit_once` prints the one result line once; `measure` runs the fused
  step on the CPU.
- `make_step` against `bench.make_step` at f32 and test-tiny: the same
  weights (`params_from_numpy`, `adapters_from_numpy`), JAX's view draws
  carried across (`jax_draws` of `sample_key(seed, i)`), the adapted logits
  of two steps within rtol/atol 5e-4 (the fused-step bound of
  tests/test_torch_slice.py) and the counts equal.
- `main` in a subprocess (TTL_BENCH_PLATFORM=cpu TTL_BENCH_ARCH=test-tiny,
  its windows cut to one of two steps so that the run takes seconds): one
  JSON line with bench.py's kept keys and `device`; under a tight budget
  `skipped_stages`; the watchdog's partial line once the clock passes the
  budget during a stage; exit 1 with nothing printed when nothing was
  measured; and without TTL_BENCH_PLATFORM and with no card, a failure.
- The aggregate stage over two gloo ranks, as tests/test_torch_multiprocess
  starts them: rank 0 prints `aggregate_sps`, `per_chip_sps` and
  `device_count`, rank 1 nothing; then `make_step` over the two ranks
  gives the logits and counts of one process's step over all the samples.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_threads
from test_torch_image import jax_draws, stack_draws

import bench
import bench_torch
from ttl_tpu.adapt.ttl import sample_key
from ttl_tpu.config import TTLConfig as JTTLConfig
from ttl_tpu.models.clip import init_clip_params
from ttl_tpu.models.prompts import build_text_classifier as j_classifier
from ttl_tpu.models.prompts import prompt_tokens as j_prompt_tokens
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.ops import attention as jfa
from ttl_tpu.ops.lora import init_adapters
from ttl_tpu.parallel import eval as jeval
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.models.convert import adapters_from_numpy, params_from_numpy
from ttl_tpu_torch.models.zoo import TEST_TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(arch="test-tiny", resolution=64, batch_size=8, layer_range=(2, 3),
            rank=4, compute_dtype="float32", param_dtype="float32")
# `main` with every window cut to 1 window of 2 steps (bench.py's 5 x 10
# would take minutes at 512-pixel canvases on one CPU thread)
SHORT = textwrap.dedent("""
    import sys
    import bench_torch
    measure = bench_torch.measure
    bench_torch.measure = lambda *a, **k: measure(
        *a, **{**k, "windows": 1, "iters": 2})
    {extra}
    sys.exit(bench_torch.main())
""")
# the clock jumps past budget + grace where `name` is called, and the call
# never returns: the watchdog must end the run
STUCK = textwrap.dedent("""
    import time, types
    offset = [0.0]
    bench_torch.time = types.SimpleNamespace(
        time=lambda: time.time() + offset[0], sleep=time.sleep,
        perf_counter=time.perf_counter)

    def stuck(*a, **k):
        offset[0] = 1e6
        time.sleep(600)

    bench_torch.{name} = stuck
""")


def run_main(extra: str = "", **env):
    env = {**test_torch_threads.subprocess_env(),
           "TTL_BENCH_PLATFORM": "cpu", "TTL_BENCH_ARCH": "test-tiny",
           "TTL_BENCH_S": "2", "PYTHONPATH": REPO, **env}
    return subprocess.run(
        [sys.executable, "-c", SHORT.replace("{extra}", extra)],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)


def json_lines(stdout: str) -> list:
    return [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith("{")]


def test_emit_once_prints_exactly_once(capsys):
    bench_torch._PRINTED.clear()
    try:
        bench_torch.emit_once({"a": 1})
        bench_torch.emit_once({"a": 2})
    finally:
        lines = capsys.readouterr().out.strip().splitlines()
        bench_torch._PRINTED.clear()
    assert lines == ['{"a": 1}']


def tiny_inputs(S: int, n_classes: int = 6):
    """JAX's tiny weights, classifier and adapters (numpy), and S canvases
    of mixed sizes."""
    params = jax.tree.map(np.array, init_clip_params(
        jax.random.PRNGKey(0), J_TINY, param_dtype=jnp.float32))
    toks = jnp.asarray(j_prompt_tokens([f"class {i}" for i in
                                        range(n_classes)]))
    text_cls = np.array(j_classifier(params["text"], toks, J_TINY.text,
                                     compute_dtype=jnp.float32))
    adapters0 = jax.tree.map(np.array, init_adapters(
        jax.random.PRNGKey(1), 2, J_TINY.vision.hidden, 4, "xavier"))
    rng = np.random.RandomState(0)
    canv = (rng.rand(S, 96, 96, 3) * 255).astype(np.uint8)
    hs = np.array([96, 70, 41][:S], np.int32)
    ws = np.array([96, 52, 88][:S], np.int32)
    return params, text_cls, adapters0, canv, hs, ws


def port_args(params, text_cls, adapters0):
    return (params_from_numpy(params, "cpu"), torch.from_numpy(text_cls),
            adapters_from_numpy(adapters0, "cpu"))


def test_measure_runs_on_the_cpu():
    params, text_cls, adapters0, canv, hs, ws = tiny_inputs(2)
    cfg = TTLConfig(**TINY, sample_batch=2)
    sps = bench_torch.measure(TEST_TINY, cfg,
                              *port_args(params, text_cls, adapters0),
                              canv, hs, ws, windows=1, iters=2)
    assert np.isfinite(sps) and sps > 0


def test_make_step_matches_bench_make_step(monkeypatch):
    S = 3
    params, text_cls, adapters0, canv, hs, ws = tiny_inputs(S)
    jlogits, tlogits = [], []
    j_count_fn, t_count_fn = jeval.make_count_fn, bench_torch.make_count_fn

    def recording(into, make):
        def make_fn(mesh=None):
            counts = make(mesh)

            def fn(logits, labels, valid):
                into.append(np.asarray(logits))
                return counts(logits, labels, valid)
            return fn
        return make_fn

    monkeypatch.setattr(jeval, "make_count_fn", recording(jlogits,
                                                          j_count_fn))
    monkeypatch.setattr(bench_torch, "make_count_fn",
                        recording(tlogits, t_count_fn))
    monkeypatch.setattr(trunner, "draw_batch", lambda s, indices, n: (
        stack_draws([jax_draws(sample_key(s, int(i)), n) for i in indices])))
    with jfa.force_mode("bshd"):
        jstep, jS = bench.make_step(J_TINY, JTTLConfig(**TINY, sample_batch=S),
                                    params, text_cls, adapters0, canv, hs, ws)
        want = [np.asarray(jstep(i)) for i in (0, 2)]
    tstep, tS = bench_torch.make_step(
        TEST_TINY, TTLConfig(**TINY, sample_batch=S),
        *port_args(params, text_cls, adapters0), canv, hs, ws)
    got = [tstep(i).numpy() for i in (0, 2)]
    assert tS == jS == S
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert len(jlogits) == len(tlogits) == 2
    for g, w in zip(tlogits, jlogits):
        assert g.shape == w.shape == (S, 6)
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-4)
    # the second step's samples are 6, 7 and 8: other draws, other logits
    assert np.abs(tlogits[0] - tlogits[1]).max() > 1e-3


def test_main_prints_one_json_line_with_the_kept_keys():
    r = run_main()
    assert r.returncode == 0, r.stderr[-3000:]
    (out,) = json_lines(r.stdout)
    assert out["unit"] == "samples/s/chip" and out["value"] > 0
    assert "test-tiny" in out["metric"] and out["sample_batch"] == 2
    assert out["value_1000_classes"] > 0 and out["value_int8_prefix"] > 0
    assert out["device"] == {"platform": "cpu", "name": "cpu",
                             "power_limit": None, "ranks": 1}
    assert set(out["launches"]) == {"headline", "1000_classes",
                                    "int8_prefix"}
    # the CPU runs the plain versions: no kernel, and no device time
    assert all(n == 0 for stage in out["launches"].values()
               for n in stage.values())
    assert not any(k.startswith("busy") or k.startswith("device_busy")
                   for k in out)
    for gone in ("provisional", "skipped_stages", "aggregate_sps",
                 "watchdog_timeout", "vs_baseline", "probe_ok"):
        assert gone not in out


def test_a_tight_budget_skips_the_optional_stages():
    r = run_main(TTL_BENCH_BUDGET_S="45", TTL_BENCH_WATCHDOG_GRACE_S="600")
    assert r.returncode == 0, r.stderr[-3000:]
    (out,) = json_lines(r.stdout)
    assert out["value"] > 0
    assert out["skipped_stages"] == ["busy_trace", "1000_classes",
                                     "int8_prefix"]
    assert "value_1000_classes" not in out and "value_int8_prefix" not in out


def test_the_watchdog_prints_what_was_measured():
    r = run_main(STUCK.replace("{name}", "busy_ms_for"),
                 TTL_BENCH_WATCHDOG_GRACE_S="0")
    assert r.returncode == 0, r.stderr[-3000:]
    (out,) = json_lines(r.stdout)
    assert out["watchdog_timeout"] is True and out["value"] > 0
    assert "provisional" not in out and "value_1000_classes" not in out


def test_the_watchdog_fails_the_run_when_nothing_was_measured():
    r = run_main(STUCK.replace("{name}", "make_step"),
                 TTL_BENCH_WATCHDOG_GRACE_S="0")
    assert r.returncode == 1
    assert json_lines(r.stdout) == []
    assert "nothing was measured" in r.stderr


def test_without_a_card_the_script_fails():
    env = {**test_torch_threads.subprocess_env(), "CUDA_VISIBLE_DEVICES": "",
           "TTL_BENCH_ARCH": "test-tiny"}
    env.pop("TTL_BENCH_PLATFORM", None)
    r = subprocess.run([sys.executable, "bench_torch.py"], capture_output=True,
                       text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode != 0
    assert json_lines(r.stdout) == []
    assert "no CUDA device" in r.stderr


RANK_WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import bench_torch
    from ttl_tpu_torch.config import TTLConfig
    from ttl_tpu_torch.models.clip import init_clip_params
    from ttl_tpu_torch.models.zoo import TEST_TINY
    from ttl_tpu_torch.ops.lora import init_adapters
    from ttl_tpu_torch.parallel.eval import all_gather_rows
    from ttl_tpu_torch.parallel.mesh import make_mesh

    measure = bench_torch.measure
    bench_torch.measure = lambda *a, **k: measure(
        *a, **{**k, "windows": 1, "iters": 2})
    assert bench_torch.main() == 0

    # make_step over the two ranks against one process's over all samples
    os.environ["MASTER_PORT"] = sys.argv[1]
    dist.init_process_group("gloo", init_method="env://")
    cfg = TTLConfig(arch="test-tiny", resolution=64, batch_size=8,
                    layer_range=(2, 3), rank=4, compute_dtype="float32",
                    param_dtype="float32", sample_batch=4)
    params = init_clip_params(TEST_TINY, torch.Generator().manual_seed(0),
                              device="cpu")
    adapters0 = init_adapters(torch.Generator().manual_seed(1), 2, 32, 4,
                              "xavier", device="cpu")
    text_cls = torch.nn.functional.normalize(
        torch.randn(5, 16, generator=torch.Generator().manual_seed(2)),
        dim=-1)
    rng = np.random.RandomState(0)
    canv = (rng.rand(4, 96, 96, 3) * 255).astype(np.uint8)
    hs = np.array([96, 70, 41, 80], np.int32)
    ws = np.array([96, 52, 88, 33], np.int32)
    logits = []
    count_fn = bench_torch.make_count_fn

    def recording(mesh=None):
        counts = count_fn(mesh)
        return lambda lg, *rest: logits.append(lg) or counts(lg, *rest)

    bench_torch.make_count_fn = recording
    mesh = make_mesh((2,), "cpu")
    step, S = bench_torch.make_step(TEST_TINY, cfg, params, text_cls,
                                    adapters0, canv, hs, ws, mesh=mesh)
    counts = step(3).tolist()
    sharded = all_gather_rows(logits.pop())
    one, _ = bench_torch.make_step(TEST_TINY, cfg, params, text_cls,
                                   adapters0, canv, hs, ws)
    want = one(3).tolist()
    err = (sharded - logits.pop()).abs().max().item()
    dist.destroy_process_group()
    print("RESULT:" + json.dumps({"S": S, "counts": counts, "want": want,
                                  "err": err, "rows": len(sharded)}),
          flush=True)
""")


def free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def test_the_aggregate_stage_over_two_gloo_ranks(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(RANK_WORKER)
    env = {**test_torch_threads.subprocess_env(), "WORLD_SIZE": "2",
           "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": free_port(), "TTL_BENCH_PLATFORM": "cpu",
           "TTL_BENCH_ARCH": "test-tiny", "TTL_BENCH_S": "1",
           "PYTHONPATH": REPO}
    second = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), second], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO,
        env={**env, "RANK": str(r)}) for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    lines = [json_lines(out) for out, _ in outs]
    assert lines[1] == []
    (out,) = lines[0]
    assert out["aggregate_sps"] > 0 and out["device_count"] == 2
    assert out["per_chip_sps"] == pytest.approx(out["aggregate_sps"] / 2,
                                                abs=1e-3)
    assert out["device"]["ranks"] == 2
    assert set(out["launches"]) == {"headline", "1000_classes", "aggregate",
                                    "int8_prefix"}
    assert "skipped_stages" not in out
    results = [json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith("RESULT:"))[len("RESULT:"):])
               for out, _ in outs]
    for res in results:
        assert res["S"] == 4 and res["rows"] == 4
        assert res["counts"] == res["want"]
        assert res["err"] < 1e-5
