"""Serving: a persistent TTL predictor and a batched HTTP endpoint.

Counterpart of `ttl_tpu/serve.py`: load the model once, keep the episodic
step ready, and serve adapt-and-classify requests. Each request image gets
the full 64-view TTL treatment and an episodic reset, so requests are
stateless and order-independent by construction.

`TTLPredictor` is the embeddable API; `python -m ttl_tpu_torch.serve`
exposes it over HTTP (stdlib ThreadingHTTPServer - POST a JPEG/PNG body to
/predict). Concurrent requests are micro-batched across connections onto one
device step (up to `sample_batch` requests a step, a few ms of gathering
delay), so throughput under load approaches the eval pipeline's instead of
serializing one 64-view adaptation per request.

The command runs on a CUDA card (`--gpu`); `TTLPredictor(...,
device="cpu")` runs the plain versions of the kernels on the CPU.
Data-parallel serving over several devices (`use_mesh`, `--mesh`,
`--mesh_shape`) is not ported and raises NotImplementedError.
"""
from __future__ import annotations

import contextlib
import io
import json
import queue
import sys
import threading
import time
import traceback
import zlib
from collections import deque
from concurrent.futures import Future
from typing import List, Sequence

import numpy as np
import torch

from .adapt.ttl import compute_dtype, make_fused_ttl_fn
from .config import TTLConfig
from .data.views import DEFAULT_CANVAS, place_on_canvas
from .models.clip import VisionConfig
from .models.prompts import build_text_classifier, prompt_tokens
from .models.zoo import get_arch
from .predict import softmax_np
from .runner import (full_f32_products, load_model, make_adapters0,
                     sample_draws)

NOT_PORTED_MESH = ("data-parallel serving (use_mesh, --mesh, --mesh_shape) "
                   "is not ported to ttl_tpu_torch yet (ROADMAP Queue 1, "
                   "item 17)")


class TTLPredictor:
    """Load once, adapt-and-classify forever.

    Each call runs the episodic TTL step per image (fresh LoRA + AdamW
    state), classifies the clean view, and returns top-k labels with
    softmax confidences plus the zero-shot prediction for comparison.
    """

    def __init__(self, classnames: Sequence[str],
                 cfg: TTLConfig = TTLConfig(), *, device,
                 params=None, clip_cfg=None, warmup: bool = True,
                 use_mesh: bool = False):
        if use_mesh or cfg.mesh_shape is not None:
            raise NotImplementedError(NOT_PORTED_MESH)
        self.cfg = cfg
        self.classnames = list(classnames)
        self.device = torch.device(device)
        # the JAX package's mode validation (otherwise unsupported combos
        # die with opaque errors at warmup)
        vision = (clip_cfg or get_arch(cfg.arch)).vision
        if cfg.lora_encoder == "prompt":
            raise ValueError(
                "TTLPredictor serves the LoRA modes (lora_encoder="
                "'image'|'text'); for TPT prompt adaptation use "
                "ttl_tpu_torch.adapt.ttl.make_tpt_adapt_fn / the CLI runner")
        if cfg.lora_encoder == "image" and not isinstance(vision,
                                                          VisionConfig):
            raise ValueError(
                f"arch {cfg.arch!r} has a ResNet vision tower; image-encoder "
                "LoRA adaptation requires a ViT backbone. Use "
                "lora_encoder='text' or a ViT arch.")
        full_f32_products(self.device)
        if params is None:
            clip_cfg, params = load_model(cfg, self.device)
        self.clip_cfg, self.params = clip_cfg, params
        toks = prompt_tokens(self.classnames,
                             cfg.ctx_init.replace("_", " "))
        text_mode = cfg.lora_encoder == "text"
        # text mode encodes the class prompts at every step, from their tokens
        self.text_cls = None if text_mode else build_text_classifier(
            params["text"], toks, clip_cfg.text, device=self.device,
            compute_dtype=compute_dtype(cfg))
        self.adapters0 = make_adapters0(cfg, clip_cfg, self.device)
        # one fused step per batch: view rendering + episodic adaptation;
        # responses include the pre-adaptation label, so opt into the
        # zero-shot aux pass (the eval runner leaves it off)
        self.step_fn = make_fused_ttl_fn(clip_cfg, cfg,
                                         tokens=toks if text_mode else None,
                                         zero_shot_aux=True)
        # --canvas: smaller canvases cut the per-step host->device upload;
        # requests larger than the canvas are downscaled to fit, as in the
        # eval loader
        self._canvas = cfg.canvas if cfg.canvas > 0 else DEFAULT_CANVAS
        self._lock = threading.Lock()  # one step dispatched at a time
        if warmup:  # also builds the kernels at their first launch
            self.predict([np.zeros((64, 64, 3), np.uint8)])

    def _on_device(self):
        """The predictor's card as the thread's current device: a kernel
        launches on the current device of the thread that dispatches it."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _batch(self, images: Sequence[np.ndarray]):
        s = self.cfg.sample_batch
        canv = np.zeros((s, self._canvas, self._canvas, 3), np.uint8)
        hs = np.full((s,), 1, np.int32)
        ws = np.full((s,), 1, np.int32)
        for i, img in enumerate(images):
            hs[i], ws[i] = place_on_canvas(canv[i], img)
        return canv, hs, ws

    def dispatch(self, images: Sequence[np.ndarray]):
        """Enqueue one fused device step for up to sample_batch images
        (asynchronous on a card: the device computes while the host does
        other work). Returns an opaque handle for `collect`."""
        chunk = list(images)
        if len(chunk) > self.cfg.sample_batch:
            raise ValueError(f"{len(chunk)} images in one step; at most "
                             f"sample_batch={self.cfg.sample_batch}")
        canv, hs, ws = self._batch(chunk)
        # content-keyed draws: the views of an image are drawn from a hash
        # of its bytes, so the same image always gets the same views - the
        # prediction is the same whichever batch slot the micro-batcher
        # packs it into and whatever else is in flight (episodic adaptation
        # is stateless by design)
        idxs = np.zeros((self.cfg.sample_batch,), np.int64)
        for i, img in enumerate(chunk):
            idxs[i] = zlib.crc32(np.ascontiguousarray(img).tobytes()) \
                & 0x7FFFFFFF
        draws = sample_draws(self.cfg, idxs)
        with self._lock, self._on_device():
            def put(x):
                return torch.as_tensor(x).to(self.device)
            res = self.step_fn(self.params, self.text_cls, self.adapters0,
                               put(canv), put(hs), put(ws),
                               {k: put(t) for k, t in draws.items()})
        return res, len(chunk)

    def collect(self, handle, *, topk: int = 5) -> List[dict]:
        """Fetch a dispatched step's results (waits for the device)."""
        res, n = handle
        out: List[dict] = []
        logits = res.logits.float().cpu().numpy()[:n]
        zs = res.zero_shot_logits.float().cpu().numpy()[:n]
        for p, z in zip(softmax_np(logits), zs):
            order = np.argsort(-p)[:topk]
            out.append({
                "label": self.classnames[int(order[0])],
                "topk": [{"label": self.classnames[int(i)],
                          "prob": float(p[i])} for i in order],
                "zero_shot_label":
                    self.classnames[int(np.argmax(z))],
            })
        return out

    def predict(self, images: Sequence[np.ndarray], *,
                topk: int = 5) -> List[dict]:
        """images: uint8 [H,W,3] arrays. Returns one dict per image.
        Pipelined at depth 2 over sample_batch-sized chunks."""
        out: List[dict] = []
        s = self.cfg.sample_batch
        pending = None
        for start in range(0, len(images), s):
            handle = self.dispatch(images[start: start + s])
            if pending is not None:
                out.extend(self.collect(pending, topk=topk))
            pending = handle
        if pending is not None:
            out.extend(self.collect(pending, topk=topk))
        return out

    def predict_bytes(self, blobs: Sequence[bytes], **kw) -> List[dict]:
        from PIL import Image

        images = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB"))
                  for b in blobs]
        return self.predict(images, **kw)


class Overloaded(RuntimeError):
    """Raised by MicroBatcher.submit when the request queue is full; carries
    a client retry hint in seconds."""

    def __init__(self, retry_after: float):
        super().__init__(f"server overloaded; retry after {retry_after:.0f}s")
        self.retry_after = retry_after


class MicroBatcher:
    """Gathers concurrent requests into one device dispatch.

    Each submitted image blob gets a Future; a single worker drains the
    queue, waits up to `max_delay_ms` for the batch to fill to
    `predictor.cfg.sample_batch`, decodes each blob individually (a
    malformed image fails only its own request), and runs ONE fused TTL
    step for the whole group.

    Backpressure: the queue is bounded at `max_queue` requests (default
    4x sample_batch - two in-flight pipeline batches plus two gathering).
    A burst beyond device throughput is shed at submit time with
    `Overloaded` (HTTP 503 + Retry-After) instead of growing an unbounded
    backlog where every request eventually times out; accepted requests
    therefore see bounded queueing latency (~max_queue/sample_batch device
    steps).
    """

    def __init__(self, predictor: TTLPredictor, max_delay_ms: float = 5.0,
                 max_queue: int | None = None):
        self.predictor = predictor
        self.max_delay = max_delay_ms / 1e3
        s = predictor.cfg.sample_batch
        self.max_queue = max_queue if max_queue is not None else 4 * s
        if self.max_queue < 1:
            # queue.Queue(maxsize=0) means UNBOUNDED - the exact backlog
            # this watermark exists to prevent - so reject it loudly
            raise ValueError(
                f"max_queue must be >= 1 (got {self.max_queue})")
        self.q: queue.Queue = queue.Queue(maxsize=self.max_queue)
        # EWMA of the fused-step wall time, for the Retry-After hint
        self._step_s = 0.5
        self._t0 = time.time()
        # counters are mutated from concurrent handler threads; guard the
        # read-modify-writes so /metrics cannot undercount
        self._m_lock = threading.Lock()
        self.accepted = 0
        self.shed = 0
        self.served = 0
        self.failed = 0  # accepted but resolved with an exception
        self.batches = 0
        # submit->result latency of the last 512 served requests, for the
        # /metrics percentiles; appends (batcher thread) and the sorted
        # snapshot (HTTP threads) both run under _m_lock - iterating a
        # deque while another thread appends raises RuntimeError
        self._lat_ms: deque = deque(maxlen=512)
        t = threading.Thread(target=self._loop, daemon=True)
        t.start()

    def submit(self, blob: bytes) -> Future:
        fut: Future = Future()
        try:
            self.q.put_nowait((blob, fut, time.time()))
        except queue.Full:
            with self._m_lock:
                self.shed += 1
            s = self.predictor.cfg.sample_batch
            steps_backlogged = (self.max_queue + s - 1) // s
            raise Overloaded(max(1.0, steps_backlogged * self._step_s))
        with self._m_lock:
            self.accepted += 1
        return fut

    def metrics(self) -> dict:
        """Live serving counters (served by GET /metrics)."""
        with self._m_lock:
            lat = sorted(self._lat_ms)
        pct = {}
        if lat:
            pct = {f"latency_p{p}_ms":
                   round(lat[min(len(lat) - 1, int(len(lat) * p / 100))], 1)
                   for p in (50, 95, 99)}
        return {
            **pct,
            "uptime_s": round(time.time() - self._t0, 1),
            "accepted_total": self.accepted,
            "shed_total": self.shed,
            "served_total": self.served,
            "failed_total": self.failed,
            "batches_total": self.batches,
            "queue_depth": self.q.qsize(),
            "max_queue": self.max_queue,
            "sample_batch": self.predictor.cfg.sample_batch,
            "step_ewma_ms": round(self._step_s * 1e3, 1),
        }

    def _fail(self, futs, e: Exception) -> None:
        """Resolve a group's futures with the device step's exception, and
        report it: the worker keeps serving."""
        traceback.print_exception(e, file=sys.stderr)
        for fut, _ in futs:
            fut.set_exception(e)
            with self._m_lock:
                self.failed += 1

    def _resolve(self, pending):
        futs, handle = pending
        try:
            t0 = time.time()
            results = self.predictor.collect(handle)
        except Exception as e:  # the device step failed
            self._fail(futs, e)
            return
        with self._m_lock:
            self._step_s = 0.7 * self._step_s + 0.3 * (time.time() - t0)
            self.batches += 1
        done = time.time()
        for (fut, ts), res in zip(futs, results):
            fut.set_result(res)
            with self._m_lock:
                self.served += 1
                self._lat_ms.append((done - ts) * 1e3)

    def _loop(self):
        from PIL import Image

        s = self.predictor.cfg.sample_batch
        pending = None  # depth-2 pipeline: dispatch group i+1, then fetch i
        while True:
            try:
                first = self.q.get(timeout=0.002 if pending else None)
            except queue.Empty:
                self._resolve(pending)
                pending = None
                continue
            group = [first]
            deadline = time.time() + self.max_delay
            while len(group) < s:
                left = deadline - time.time()
                if left <= 0:
                    break
                try:
                    group.append(self.q.get(timeout=left))
                except queue.Empty:
                    break
            images, futs = [], []
            for blob, fut, ts in group:
                try:
                    images.append(np.asarray(
                        Image.open(io.BytesIO(blob)).convert("RGB")))
                    futs.append((fut, ts))
                except Exception as e:  # a malformed image fails alone
                    fut.set_exception(e)
                    with self._m_lock:
                        self.failed += 1
            if not images:
                continue
            try:
                handle = self.predictor.dispatch(images)
            except Exception as e:  # the device step failed
                self._fail(futs, e)
                continue
            if pending is not None:
                self._resolve(pending)
            pending = (futs, handle)


def serve(predictor: TTLPredictor, host: str = "127.0.0.1",
          port: int = 8787, *, max_delay_ms: float = 5.0,
          max_queue: int | None = None):
    """Threaded HTTP endpoint with cross-request batching: POST an image
    body to /predict; concurrent posts share one fused device step.
    Overload (queue past `max_queue`, default 4x sample_batch) is shed
    with 503 + Retry-After instead of queueing toward timeout."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    batcher = MicroBatcher(predictor, max_delay_ms, max_queue=max_queue)

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: dict, headers=()):
            body = json.dumps(payload).encode()
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802
            if self.path.rstrip("/") != "/predict":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            t0 = time.time()
            try:
                fut = batcher.submit(body)
            except Overloaded as e:
                self._json(503, {"error": "overloaded",
                                 "retry_after_s": e.retry_after},
                           [("Retry-After", str(int(round(e.retry_after))))])
                return
            try:
                result = fut.result(timeout=120)
            except Exception as e:  # malformed image etc.
                self.send_error(400, str(e)[:200])
                return
            result["latency_ms"] = round((time.time() - t0) * 1e3, 1)
            self._json(200, result)

        def do_GET(self):  # noqa: N802
            if self.path.rstrip("/") == "/healthz":
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")
            elif self.path.rstrip("/") == "/metrics":
                self._json(200, batcher.metrics())
            else:
                self.send_error(404)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    print(f"ttl_tpu_torch serving on http://{host}:{port}/predict "
          f"(batch {predictor.cfg.sample_batch}, "
          f"gather {max_delay_ms}ms)", flush=True)
    _install_graceful_shutdown(httpd, batcher)
    httpd.serve_forever()
    drain(batcher)


def _install_graceful_shutdown(httpd, batcher) -> None:
    """SIGTERM/SIGINT stop the accept loop; already-accepted requests are
    drained afterwards (serve() calls drain()). Signal handlers only bind
    in the main thread - under a test harness thread this is a no-op and
    the caller shuts the server down directly."""
    import signal

    def _stop(signum, frame):
        print(f"ttl_tpu_torch serve: signal {signum}, draining "
              f"{batcher.q.qsize()} queued request(s)...", flush=True)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _stop)
        signal.signal(signal.SIGINT, _stop)
    except ValueError:  # not the main thread
        pass


def drain(batcher: MicroBatcher, timeout_s: float = 60.0) -> bool:
    """Block until every accepted request has been resolved (served or
    failed), up to timeout_s. Returns True when fully drained. Shed
    requests were rejected at submit and need no draining."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        with batcher._m_lock:
            pending = batcher.accepted - batcher.served - batcher.failed
        if pending <= 0 and batcher.q.empty():
            return True
        time.sleep(0.05)
    return False


def build_parser():
    import argparse

    p = argparse.ArgumentParser(description="TTL serving endpoint")
    p.add_argument("--test_sets", default="eurosat",
                   help="set_id whose classname table to serve")
    p.add_argument("--arch", default="ViT-B/16")
    p.add_argument("--resolution", default=224, type=int)
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--sample_batch", default=4, type=int,
                   help="max requests batched into one device step")
    p.add_argument("--canvas", default=0, type=int,
                   help="request canvas edge in px (0 = 512); set to the "
                        "expected max image dim to cut upload bandwidth - "
                        "larger images are downscaled to fit")
    p.add_argument("--mesh", action="store_true",
                   help="not ported yet: raises NotImplementedError")
    p.add_argument("--mesh_shape", default=None,
                   type=lambda s: tuple(int(x) for x in s.split(",")),
                   help="not ported yet: raises NotImplementedError")
    p.add_argument("--prefix_quant", default="none",
                   choices=["none", "int8"],
                   help="int8-quantize the frozen vision prefix "
                        "(throughput over exact parity)")
    p.add_argument("--max_delay_ms", default=5.0, type=float,
                   help="how long to gather concurrent requests")
    p.add_argument("--max_queue", default=None, type=int,
                   help="queued-request watermark before requests are shed "
                        "with 503 + Retry-After (default 4x sample_batch)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8787, type=int)
    p.add_argument("--gpu", default=0, type=int,
                   help="index of the CUDA card to serve from")
    return p


def main(argv=None):
    from .data.classnames import resolve_classnames

    args = build_parser().parse_args(argv)
    if args.mesh or args.mesh_shape is not None:
        raise NotImplementedError(NOT_PORTED_MESH)
    if not torch.cuda.is_available():
        raise RuntimeError("ttl_tpu_torch needs a CUDA device; none is "
                           "available")
    cfg = TTLConfig(arch=args.arch, resolution=args.resolution,
                    checkpoint_path=args.checkpoint_path,
                    sample_batch=args.sample_batch,
                    test_sets=args.test_sets, canvas=args.canvas,
                    prefix_quant=args.prefix_quant, gpu=args.gpu)
    predictor = TTLPredictor(resolve_classnames(args.test_sets), cfg,
                             device=torch.device(f"cuda:{args.gpu}"))
    serve(predictor, args.host, args.port, max_delay_ms=args.max_delay_ms,
          max_queue=args.max_queue)


if __name__ == "__main__":
    main()
