"""The port's runner: its out-of-memory hint and its two A/B switches.

- A device out-of-memory error, raised at the dispatch or when the counts
  are read, comes out as a RuntimeError that names the set, `--sample_batch`
  and the class count, chained from the original, as the reference's
  `_oom_hint` does (`ttl_tpu/runner.py`), without its TPU figures.
- `TTL_UPLOAD_OVERLAP=0` moves the draws and the upload from the loader's
  prefetch thread to the main thread; `TTL_CANVAS_BUCKETS=0` keeps every
  batch at the full canvas. The reference reads both so ('0' turns a switch
  off); neither changes the counts, which the runs compare exactly.
"""
import threading

import numpy as np
import pytest
import torch

from ttl_tpu_torch import runner as trunner
from ttl_tpu_torch.config import TTLConfig
from ttl_tpu_torch.data.classnames import resolve_classnames
from ttl_tpu_torch.data.views import ArrayDataset

# a full-canvas image among small ones: auto-canvas 256, bucket ladder
# (64, 128, 256), so batches of small images shrink to 64
SIZES = [(256, 200), (30, 40), (40, 30), (36, 36), (24, 50), (50, 24)]
_UPLOAD = trunner._make_upload


def _dataset():
    rng = np.random.default_rng(30)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in SIZES]

    class Mixed(ArrayDataset):
        def __getitem__(self, idx):
            return images[idx], int(self.labels[idx])

    return Mixed(np.zeros((len(SIZES), 256, 256, 3), np.uint8),
                 np.array([3, 1, 4, 1, 5, 9]))


def _cfg(**kw):
    return TTLConfig(arch="test-tiny", resolution=64, batch_size=4,
                     sample_batch=2, compute_dtype="float32",
                     param_dtype="float32", workers=1, print_freq=100, **kw)


def _run(monkeypatch, env: dict):
    """runner.run on the CPU with `env` set; returns (results, for each
    upload: (ran in the main thread, canvas size))."""
    for name in ("TTL_UPLOAD_OVERLAP", "TTL_CANVAS_BUCKETS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    seen = []

    def recording(*args, **kw):
        upload = _UPLOAD(*args, **kw)

        def record(b):
            seen.append((threading.current_thread() is threading.main_thread(),
                         b.canvases.shape[1]))
            return upload(b)
        return record

    monkeypatch.setattr(trunner, "_make_upload", recording)
    res = trunner.run(_cfg(), device="cpu", datasets={"A": _dataset()})
    return res["A"], seen


@pytest.mark.parametrize("name", ["TTL_UPLOAD_OVERLAP", "TTL_CANVAS_BUCKETS"])
def test_switch_at_zero_turns_it_off_with_the_same_counts(monkeypatch, name):
    on, seen_on = _run(monkeypatch, {})
    off, seen_off = _run(monkeypatch, {name: "0"})
    assert off == on
    assert len(seen_on) == len(seen_off) == 3
    in_main_on, canvas_on = zip(*seen_on)
    in_main_off, canvas_off = zip(*seen_off)
    # by default: the prefetch thread uploads, small batches shrink
    assert not any(in_main_on) and min(canvas_on) == 64
    if name == "TTL_UPLOAD_OVERLAP":
        assert all(in_main_off) and canvas_off == canvas_on
    else:
        assert not any(in_main_off) and set(canvas_off) == {256}
    # any other value leaves the switch on, as in the reference
    again, seen_again = _run(monkeypatch, {name: "1"})
    assert again == on and seen_again == seen_on


class _OutOfMemory:
    """Stands in for the counts of a step whose kernels ran out of memory:
    the error comes when the host reads them."""

    def tolist(self):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 2.00 GiB")


@pytest.mark.parametrize("where", ["dispatch", "drain"])
def test_out_of_memory_names_sample_batch(monkeypatch, where):
    original = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                           "allocate 2.00 GiB")
    if where == "dispatch":
        def make_step(*args, **kw):
            def step(*a):
                raise original
            return step
        monkeypatch.setattr(trunner, "make_fused_ttl_fn", make_step)
    else:
        monkeypatch.setattr(trunner, "topk_counts",
                            lambda *a: _OutOfMemory())
    n_classes = len(resolve_classnames("A"))
    with pytest.raises(RuntimeError) as info:
        trunner.run(_cfg(), device="cpu", datasets={"A": _dataset()})
    msg = str(info.value)
    assert "on the A step" in msg and "sample_batch=2" in msg
    assert f"{n_classes} classes" in msg and "--sample_batch" in msg
    assert isinstance(info.value.__cause__, torch.cuda.OutOfMemoryError)
    if where == "dispatch":
        assert info.value.__cause__ is original


def test_other_errors_pass_through(monkeypatch):
    def make_step(*args, **kw):
        def step(*a):
            raise RuntimeError("shape mismatch")
        return step
    monkeypatch.setattr(trunner, "make_fused_ttl_fn", make_step)
    with pytest.raises(RuntimeError, match="^shape mismatch$"):
        trunner.run(_cfg(), device="cpu", datasets={"A": _dataset()})
