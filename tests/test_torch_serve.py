"""Serving (`ttl_tpu_torch.serve`) on the CPU: the cases of
tests/test_serve.py for the port's predictor, micro-batcher and HTTP
endpoint, and the port's `TTLPredictor` against `ttl_tpu.serve.TTLPredictor`.

The parity case feeds both predictors the same images, JAX's weights and
adapters bridged across, and JAX's view draws of each image's key (the
crc32 of its bytes) handed to the port's `runner.draw_batch`; everything in
f32 at the `test-tiny` size. Tolerance: 1e-5 relative (and 1e-6 absolute)
at f32, on the probabilities.

Serving over several ranks (the port of tests/test_serve.py's mesh
cases): two gloo ranks started with `subprocess`, on mesh (2,) and (1, 2),
rank 0 serving HTTP and rank 1 following, answer a burst as the
one-process predictor does (labels equal, probabilities within RTOL/ATOL),
and SIGTERM to rank 0 drains and stops both, each exiting 0. In one
process `use_mesh=True` is a mesh of that process; a two-rank shape raises
the world check's ValueError.
"""
import io
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
import test_torch_threads
from test_torch_image import jax_draws, stack_draws

from ttl_tpu import runner as jrunner
from ttl_tpu import serve as jserve
from ttl_tpu.adapt.ttl import sample_key
from ttl_tpu.config import TTLConfig as JTTLConfig
from ttl_tpu.models import clip as jclip
from ttl_tpu.models.zoo import TEST_TINY as J_TINY
from ttl_tpu.models.zoo import get_arch as j_get_arch
from ttl_tpu.ops import attention as jfa
from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch import serve as tserve
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.models.clip import init_clip_params
from ttl_tpu_torch.models.convert import adapters_from_numpy, params_from_numpy
from ttl_tpu_torch.models.zoo import TEST_TINY, get_arch
from ttl_tpu_torch.serve import MicroBatcher, Overloaded, TTLPredictor, serve

RTOL, ATOL = 1e-5, 1e-6
KW = dict(arch="test-tiny", resolution=64, batch_size=8, layer_range=(2, 3),
          rank=4, compute_dtype="float32", param_dtype="float32",
          sample_batch=2)
CFG = TTLConfig(**KW)
CLASSES = ["forest", "river", "highway"]


def _params():
    return init_clip_params(TEST_TINY, torch.Generator().manual_seed(0),
                            device="cpu", param_dtype=torch.float32)


@pytest.fixture(scope="module")
def predictor():
    return TTLPredictor(CLASSES, CFG, device="cpu", params=_params(),
                        clip_cfg=TEST_TINY, warmup=False)


def _image(seed, shape=(64, 64, 3)):
    return np.random.RandomState(seed).randint(0, 255, shape, dtype=np.uint8)


def _encoded(img, fmt="JPEG") -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt)
    return buf.getvalue()


def _start(predictor, **kw) -> int:
    """serve() in a daemon thread on a free port, once /healthz answers."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    threading.Thread(target=serve, args=(predictor, "127.0.0.1", port),
                     kwargs=kw, daemon=True).start()
    for _ in range(50):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=1) as r:
                assert r.read() == b"ok"
            return port
        except OSError:
            time.sleep(0.1)
    raise AssertionError("the server did not come up")


def _post(port, body, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), None
    except urllib.error.HTTPError as e:
        return e.code, None, e.headers.get("Retry-After")


def test_predict_structure(predictor):
    out = predictor.predict([_image(i, (100, 120, 3)) for i in range(3)])
    assert len(out) == 3
    for r in out:
        assert r["label"] in CLASSES
        assert r["zero_shot_label"] in CLASSES
        probs = [t["prob"] for t in r["topk"]]
        assert abs(sum(probs) - 1.0) < 1e-3
        assert probs == sorted(probs, reverse=True)


def test_predict_bytes(predictor):
    out = predictor.predict_bytes([_encoded(_image(0, (80, 80, 3)))])
    assert out[0]["label"] in CLASSES


def test_http_endpoint(predictor):
    port = _start(predictor)
    code, payload, _ = _post(port, _encoded(_image(1)))
    assert code == 200
    assert payload["label"] in CLASSES
    assert "latency_ms" in payload
    # a garbage body -> 400, not a crash
    assert _post(port, b"not an image", timeout=60)[0] == 400


def test_prediction_independent_of_batch_slot(predictor):
    """Content-keyed view draws: the same image gives the same prediction
    alone (slot 0) and packed after another request (slot 1)."""
    imgs = [_image(i, (90, 110, 3)) for i in range(3)]
    solo = predictor.predict([imgs[1]])[0]
    batched = predictor.predict(imgs)[1]  # slot 1 of the first chunk
    assert solo == batched


def test_http_concurrent_posts_batch(predictor):
    """Concurrent posts all succeed (one device step shared across
    connections), and a malformed body fails alone without poisoning its
    batch."""
    port = _start(predictor, max_delay_ms=50.0)
    bodies = [_encoded(_image(i)) for i in range(4)]
    bodies.insert(2, b"garbage, not an image")
    with ThreadPoolExecutor(max_workers=5) as ex:
        results = list(ex.map(lambda b: _post(port, b), bodies))
    codes = [c for c, _, _ in results]
    assert codes.count(200) == 4 and codes.count(400) == 1
    for c, payload, _ in results:
        if c == 200:
            assert payload["label"] in CLASSES


class _SlowPredictor:
    """Delegating wrapper that makes each device step take ~`delay` seconds,
    so a request burst reliably outruns the drain rate."""

    def __init__(self, inner, delay=0.25):
        self._inner, self._delay = inner, delay
        self.cfg = inner.cfg

    def dispatch(self, images):
        time.sleep(self._delay)
        return self._inner.dispatch(images)

    def collect(self, handle, **kw):
        return self._inner.collect(handle, **kw)


def test_microbatcher_backpressure(predictor):
    """A burst beyond device throughput is shed promptly with Overloaded
    (bounded queue), while every accepted request completes."""
    blob = _encoded(_image(0))
    mb = MicroBatcher(_SlowPredictor(predictor), max_delay_ms=1.0,
                      max_queue=2)
    assert mb.max_queue == 2
    accepted, shed = [], 0
    for _ in range(12):
        try:
            accepted.append(mb.submit(blob))
        except Overloaded as e:
            assert e.retry_after >= 1.0
            shed += 1
    assert shed > 0, "burst of 12 into a 2-deep queue must shed"
    assert len(accepted) >= 2
    t0 = time.time()
    for fut in accepted:
        assert fut.result(timeout=30)["label"] in CLASSES
    # bounded latency: the accepted backlog is at most max_queue + 2
    # in-flight groups of the slowed step
    assert time.time() - t0 < 20


# slow tier, as in tests/test_serve.py: canvas invariance is pinned at the
# runner level
@pytest.mark.slow
def test_predictor_small_canvas_matches_default(predictor):
    """cfg.canvas shrinks the per-request upload; predictions are identical
    whenever the image fits the canvas."""
    small = TTLPredictor(CLASSES, TTLConfig(**KW, canvas=128), device="cpu",
                         params=_params(), clip_cfg=TEST_TINY, warmup=False)
    assert small._canvas == 128
    imgs = [_image(i, (100, 120, 3)) for i in range(3)]
    assert small.predict(imgs) == predictor.predict(imgs)


def test_drain_waits_for_accepted_requests(predictor):
    """serve()'s graceful shutdown drains every accepted request - served
    and failed (a malformed body resolves with an exception and must not
    stall the drain)."""
    mb = MicroBatcher(_SlowPredictor(predictor), max_delay_ms=1.0)
    blob = _encoded(_image(1))
    good = [mb.submit(blob) for _ in range(3)]
    bad = mb.submit(b"not an image")
    assert tserve.drain(mb, timeout_s=30.0)
    for fut in good:
        assert fut.result(timeout=1)["label"] in CLASSES
    with pytest.raises(Exception):
        bad.result(timeout=1)
    m = mb.metrics()
    assert m["served_total"] == 3 and m["failed_total"] == 1
    # an already-drained batcher drains at once
    assert tserve.drain(mb, timeout_s=0.5)


def test_failed_device_step_fails_its_requests(predictor):
    """A dispatch that raises fails every request of its group and counts
    them in failed_total; the batcher keeps serving."""
    class Broken(_SlowPredictor):
        calls = 0

        def dispatch(self, images):
            Broken.calls += 1
            if Broken.calls == 1:
                raise RuntimeError("device step failed")
            return self._inner.dispatch(images)

    mb = MicroBatcher(Broken(predictor, 0.0), max_delay_ms=50.0)
    blob = _encoded(_image(2))
    first = [mb.submit(blob) for _ in range(2)]
    for fut in first:
        with pytest.raises(RuntimeError, match="device step failed"):
            fut.result(timeout=30)
    assert mb.submit(blob).result(timeout=30)["label"] in CLASSES
    assert tserve.drain(mb, timeout_s=30.0)
    m = mb.metrics()
    assert m["failed_total"] == 2 and m["served_total"] == 1


def test_microbatcher_rejects_unbounded_queue(predictor):
    """queue.Queue(maxsize=0) means unbounded, which would silently disable
    the backpressure watermark."""
    with pytest.raises(ValueError, match="max_queue"):
        MicroBatcher(_SlowPredictor(predictor), max_queue=0)
    with pytest.raises(ValueError, match="max_queue"):
        MicroBatcher(_SlowPredictor(predictor), max_queue=-3)


def test_http_overload_returns_503(predictor):
    """Overload requests get 503 + Retry-After at once; accepted ones still
    return 200."""
    port = _start(_SlowPredictor(predictor), max_delay_ms=1.0, max_queue=1)
    blob = _encoded(_image(2))
    with ThreadPoolExecutor(max_workers=10) as ex:
        results = list(ex.map(lambda _: _post(port, blob, 60), range(10)))
    codes = [c for c, _, _ in results]
    assert 200 in codes
    assert 503 in codes, codes
    for c, _, retry in results:
        if c == 503:
            assert retry is not None and int(retry) >= 1


def test_http_metrics_endpoint(predictor):
    """GET /metrics reports live counters: accepted/served/shed/queue."""
    port = _start(predictor)
    assert _post(port, _encoded(_image(5)))[0] == 200
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        m = json.loads(r.read())
    assert m["accepted_total"] >= 1 and m["served_total"] >= 1
    assert m["shed_total"] == 0 and m["queue_depth"] == 0
    assert m["sample_batch"] == predictor.cfg.sample_batch
    assert m["step_ewma_ms"] > 0 and m["uptime_s"] >= 0
    # submit->result latency percentiles over the served window
    assert m["latency_p50_ms"] > 0
    assert m["latency_p50_ms"] <= m["latency_p95_ms"] <= m["latency_p99_ms"]


@pytest.mark.parametrize("cfg_kw,match", [
    ({"arch": "RN50"}, "ResNet vision tower"),
    ({"lora_encoder": "prompt"}, "LoRA modes")])
def test_predictor_validates_modes(cfg_kw, match):
    """The JAX package's ValueErrors, before any weight is read."""
    cfg = TTLConfig(**cfg_kw)
    with pytest.raises(ValueError, match=match) as got:
        TTLPredictor(["a"], cfg, device="cpu", params={},
                     clip_cfg=get_arch(cfg.arch), warmup=False)
    with pytest.raises(ValueError) as want:
        jserve.TTLPredictor(["a"], JTTLConfig(**cfg_kw), params={},
                            clip_cfg=j_get_arch(cfg.arch), warmup=False)
    # the same message, up to the name of the package's tuning function
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


@pytest.mark.parametrize("how", ["use_mesh", "mesh_shape"])
def test_mesh_serving_raises_not_implemented(predictor, how):
    """Mesh serving is ported (name kept): in one process `use_mesh` is a
    mesh of that process and predicts as the plain predictor; a two-rank
    shape raises ValueError."""
    if how == "mesh_shape":
        with pytest.raises(ValueError, match=r"\(4, 2\) != 1 process"):
            TTLPredictor(CLASSES, TTLConfig(**KW, mesh_shape=(4, 2)),
                         device="cpu", params={}, clip_cfg=TEST_TINY,
                         warmup=False)
        return
    mesh_pred = TTLPredictor(CLASSES, CFG, device="cpu", params=_params(),
                             clip_cfg=TEST_TINY, warmup=False, use_mesh=True)
    assert mesh_pred.mesh.shape == {"data": 1}
    imgs = [_image(i, (100, 120, 3)) for i in range(3)]
    assert mesh_pred.predict(imgs) == predictor.predict(imgs)


def test_mesh_predictor_needs_a_multiple_of_the_data_axis(monkeypatch):
    """JAX's ValueError where sample_batch does not split over the data
    axis, before any weight is read."""
    from ttl_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
    monkeypatch.setattr(tserve, "make_mesh", lambda shape, device: Mesh(
        {DATA_AXIS: 2}, 0, 2, torch.device("cpu")))
    cfg = TTLConfig(**{**KW, "sample_batch": 3})
    with pytest.raises(ValueError) as got:
        TTLPredictor(CLASSES, cfg, device="cpu", params={},
                     clip_cfg=TEST_TINY, warmup=False, use_mesh=True)
    assert str(got.value) == ("sample_batch (3) must be a multiple of the "
                              "data axis (2)")


@pytest.mark.parametrize("flags,error,match", [
    (["--mesh"], RuntimeError, "CUDA"),
    (["--mesh_shape", "4,2"], ValueError, "torch.distributed.run")])
def test_cli_mesh_flags_raise_not_implemented(monkeypatch, flags, error,
                                              match):
    """Ported (name kept): outside torch.distributed.run `--mesh` is the
    one-process server, which needs the card; a two-rank shape raises the
    world check's ValueError before the card is touched."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match=match):
        tserve.main(["--test_sets", "eurosat", *flags])


def test_main_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--test_sets", "eurosat"])


def test_predictor_matches_jax(monkeypatch):
    """The same images through both predictors, on the same weights,
    adapters and crc32-keyed view draws: equal labels, top-k labels and
    zero-shot labels, probabilities within the tolerance."""
    params = jax.tree.map(np.array, jclip.init_clip_params(
        jax.random.PRNGKey(0), J_TINY, param_dtype=jnp.float32))
    jcfg = JTTLConfig(**KW)
    adapters0 = jax.tree.map(np.array, jrunner.make_adapters0(jcfg, J_TINY))
    monkeypatch.setattr(tserve, "make_adapters0", lambda c, clip, device:
                        adapters_from_numpy(adapters0, device))
    monkeypatch.setattr(
        trunner, "draw_batch",
        lambda seed, indices, n: stack_draws(
            [jax_draws(sample_key(seed, int(i)), n) for i in indices]))
    imgs = [_image(i, (70 + 9 * i, 90, 3)) for i in range(3)]
    assert len({zlib.crc32(im.tobytes()) for im in imgs}) == 3
    got = TTLPredictor(CLASSES, CFG, device="cpu",
                       params=params_from_numpy(params, "cpu"),
                       clip_cfg=TEST_TINY, warmup=False).predict(imgs,
                                                                 topk=3)
    with jfa.force_mode("bshd"):
        want = jserve.TTLPredictor(CLASSES, jcfg, params=params,
                                   clip_cfg=J_TINY,
                                   warmup=False).predict(imgs, topk=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["label"] == w["label"]
        assert g["zero_shot_label"] == w["zero_shot_label"]
        assert [t["label"] for t in g["topk"]] == \
            [t["label"] for t in w["topk"]]
        np.testing.assert_allclose([t["prob"] for t in g["topk"]],
                                   [t["prob"] for t in w["topk"]],
                                   rtol=RTOL, atol=ATOL)


SERVE_RANK = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from ttl_tpu_torch.config import TTLConfig
    from ttl_tpu_torch.models.clip import init_clip_params
    from ttl_tpu_torch.models.zoo import TEST_TINY
    from ttl_tpu_torch.serve import TTLPredictor, serve

    dist.init_process_group("gloo", init_method="env://")
    kw, classes, shape, port = json.loads(sys.argv[1])
    params = init_clip_params(TEST_TINY, torch.Generator().manual_seed(0),
                              device="cpu", param_dtype=torch.float32)
    pred = TTLPredictor(classes, TTLConfig(**kw, mesh_shape=tuple(shape)),
                        device="cpu", params=params, clip_cfg=TEST_TINY,
                        use_mesh=True)
    if dist.get_rank() == 0:
        serve(pred, "127.0.0.1", port)
    else:
        pred.follow()
    dist.destroy_process_group()
    print("RESULT:" + json.dumps({"mesh": pred.mesh.shape}), flush=True)
""")


@pytest.mark.parametrize("shape", [(2,), (1, 2)])
def test_http_serve_over_two_ranks_answers_as_one_process(predictor,
                                                          tmp_path, shape):
    """The port of tests/test_serve.py's mesh cases: rank 0 serves, rank 1
    follows; a burst of 6 PNGs (sample_batch 2: one row a rank on (2,), both
    rows on each rank of (1, 2)) gets the one-process predictor's labels
    and probabilities; SIGTERM drains and both ranks exit 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        master = s.getsockname()[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "rank.py"
    script.write_text(SERVE_RANK)
    env = {**test_torch_threads.subprocess_env(), "WORLD_SIZE": "2",
           "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(master)}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    argv = [sys.executable, str(script),
            json.dumps([KW, CLASSES, list(shape), port])]
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=repo,
                              env={**env, "RANK": str(r)}) for r in range(2)]
    try:
        for _ in range(600):
            assert all(p.poll() is None for p in procs), \
                procs[0].communicate()[1][-3000:]
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=1) as r:
                    assert r.read() == b"ok"
                break
            except OSError:
                time.sleep(0.1)
        imgs = [_image(40 + i, (70 + 4 * i, 90, 3)) for i in range(6)]
        with ThreadPoolExecutor(len(imgs)) as ex:
            answers = list(ex.map(lambda img: _post(
                port, _encoded(img, "PNG")), imgs))
        procs[0].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "RESULT:" in out
    want = predictor.predict(imgs)
    for (code, got, _), ref in zip(answers, want):
        assert code == 200
        assert got["label"] == ref["label"]
        assert got["zero_shot_label"] == ref["zero_shot_label"]
        assert [t["label"] for t in got["topk"]] == \
            [t["label"] for t in ref["topk"]]
        np.testing.assert_allclose([t["prob"] for t in got["topk"]],
                                   [t["prob"] for t in ref["topk"]],
                                   rtol=RTOL, atol=ATOL)

