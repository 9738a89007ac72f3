"""Host-side sample loading: decode -> static canvas -> device view batch.

The reference's DataLoader workers run the full PIL augmentation stack on the
host per view (data/datautils.py:129-157). Here the host does the minimum
non-jittable work - JPEG decode and placement onto a fixed-size uint8 canvas -
and ships ONE image per test sample; the 64-view expansion happens on device
(`ops/image.py`). A background thread prefetches and batches samples so
decode overlaps device compute. The port's own copy of
`ttl_tpu/data/views.py`.

Canvas protocol: images larger than the canvas are downscaled (never
upscaled) to fit, preserving aspect; (h, w) carry the true extents so the
device pipeline crops in original-geometry coordinates.

Bucketed canvases (bucket_canvas=True): each assembled batch is shrunk to
the smallest power-of-two ladder size (canvas/4, canvas/2, canvas) that
still fits every image in the batch. Results are bit-identical - the device
pipeline reads only the [h, w] image region, and no image is downscaled
that would not have been at the full canvas - while the host->device upload
drops quadratically for small-image batches (upload-bound programs).
At most 3 distinct canvas shapes reach the step. Off by default; the runner enables
it for single-process auto-canvas runs (TTL_CANVAS_BUCKETS=0 opts out).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

DEFAULT_CANVAS = 512


@dataclass
class SampleBatch:
    canvases: np.ndarray   # [B, S, S, 3] uint8
    heights: np.ndarray    # [B] int32
    widths: np.ndarray     # [B] int32
    labels: np.ndarray     # [B] int64
    indices: np.ndarray    # [B] int64  (dataset positions)
    pad: int = 0           # trailing entries that are padding (last batch)


def place_on_canvas(canvas_row: np.ndarray, img: np.ndarray
                    ) -> Tuple[int, int]:
    """Place an [H,W,3] uint8 image onto a square canvas row (top-left),
    downscaling (never upscaling) to fit. Returns the placed (h, w)."""
    canvas = canvas_row.shape[0]
    h, w = img.shape[:2]
    if max(h, w) > canvas:
        s = canvas / max(w, h)
        w2, h2 = max(1, round(w * s)), max(1, round(h * s))
        img = np.asarray(Image.fromarray(img).resize((w2, h2),
                                                     Image.BICUBIC))
        h, w = h2, w2
    canvas_row[:h, :w] = img
    return h, w


def load_canvas(path: str, canvas: int = DEFAULT_CANVAS
                ) -> Tuple[np.ndarray, int, int]:
    """Decode to RGB uint8, downscale to fit the canvas if needed, zero-pad."""
    with Image.open(path) as img:
        img = img.convert("RGB")
        w, h = img.size
        if max(w, h) > canvas:
            s = canvas / max(w, h)
            w, h = max(1, int(round(w * s))), max(1, int(round(h * s)))
            img = img.resize((w, h), Image.BICUBIC)
        arr = np.asarray(img, np.uint8)
    out = np.zeros((canvas, canvas, 3), np.uint8)
    out[:h, :w] = arr
    return out, h, w


class SampleLoader:
    """Iterate a (path,label) dataset as device-ready SampleBatch objects.

    Shuffling matches the reference's DataLoader(shuffle=True) with the run
    seed (ttl.py:275-278); a single prefetch thread hides decode latency
    behind device compute. The final short batch is padded and marked so the
    caller can drop the padded rows from its metrics.
    """

    def __init__(self, dataset, batch_size: int = 1, *, shuffle: bool = True,
                 seed: int = 0, canvas: int = DEFAULT_CANVAS,
                 max_samples: Optional[int] = None, prefetch: int = 4,
                 shard: Optional[Tuple[int, int]] = None,
                 workers: int = 4, total_batches: Optional[int] = None,
                 transform=None, bucket_canvas: bool = False):
        self.dataset = dataset
        # applied to each SampleBatch INSIDE the prefetch thread before it
        # is queued - the runner uses this to upload batches so the
        # ~6-8 MB host->device canvas upload overlaps device compute
        # instead of riding the dispatch path (upload-bound programs).
        # Exceptions propagate like decode errors.
        self.transform = transform
        self.batch_size = batch_size
        self.canvas = canvas
        # ascending ladder of batch canvas sizes, ending at the full canvas.
        # MUST NOT be used with multi-host input sharding: the sharded step
        # is a collective program, and hosts picking different buckets for
        # the same step would run different programs.
        self.bucket_ladder = None
        if bucket_canvas and canvas >= 128:
            assert shard is None, \
                "bucket_canvas is incompatible with multi-host input shards"
            self.bucket_ladder = sorted({max(64, canvas // 4),
                                         max(64, canvas // 2), canvas})
        order = np.arange(len(dataset))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        if max_samples is not None:
            order = order[:max_samples]
        if shard is not None:
            # multi-host input sharding: process i of n takes every n-th
            # sample of the (seed-shared) shuffled order - the DCN-side
            # split of the file list (SURVEY.md section 5); accuracy
            # reduction across hosts goes through parallel.eval psum
            i, n = shard
            order = order[i::n]
        self.order = order
        self.prefetch = prefetch
        self.workers = workers  # native decoder thread count (ttl.py:388)
        # multi-host: every process must execute the SAME number of device
        # dispatches (the sharded step is a collective program). When host
        # shards are uneven, short hosts emit trailing all-padding batches
        # up to the globally agreed count.
        self._own_batches = (len(self.order) + batch_size - 1) // batch_size
        self.total_batches = (self._own_batches if total_batches is None
                              else max(total_batches, self._own_batches))

    def __len__(self):
        return self.total_batches

    @property
    def num_samples(self):
        return len(self.order)

    def _make_batch(self, idxs: Sequence[int]) -> SampleBatch:
        b = self.batch_size
        canv = np.zeros((b, self.canvas, self.canvas, 3), np.uint8)
        hs = np.full((b,), 1, np.int32)
        ws = np.full((b,), 1, np.int32)
        labels = np.zeros((b,), np.int64)
        indices = np.zeros((b,), np.int64)

        items = [self.dataset[int(i)] for i in idxs]
        done = [False] * len(idxs)
        # native threaded decode for the JPEG entries; PIL picks up the rest
        jpegs = [k for k, (item, _) in enumerate(items)
                 if isinstance(item, str)
                 and item.lower().endswith((".jpg", ".jpeg"))]
        if jpegs:
            from . import native_decode
            if native_decode.available():
                sub_h = np.zeros((len(jpegs),), np.int32)
                sub_w = np.zeros((len(jpegs),), np.int32)
                sub_c = np.zeros((len(jpegs), self.canvas, self.canvas, 3),
                                 np.uint8)
                ok = native_decode.decode_batch(
                    [items[k][0] for k in jpegs], sub_c, sub_h, sub_w,
                    n_threads=self.workers)
                for j, k in enumerate(jpegs):
                    if ok[j]:
                        canv[k] = sub_c[j]
                        hs[k], ws[k] = sub_h[j], sub_w[j]
                        done[k] = True

        for k, i in enumerate(idxs):
            if done[k]:
                labels[k] = items[k][1]
                indices[k] = i
                continue
            item, label = items[k]
            if isinstance(item, str):
                canv[k], hs[k], ws[k] = load_canvas(item, self.canvas)
            else:  # in-memory [H,W,3] uint8 (tests/bench datasets)
                hs[k], ws[k] = place_on_canvas(canv[k], item)
            labels[k] = label
            indices[k] = i
        if self.bucket_ladder is not None:
            # shrink to the smallest ladder size that fits every image:
            # bit-identical results (the device reads only [h, w] regions),
            # quadratically less host->device transfer. Pad rows carry
            # h = w = 1 so they never inflate the bucket.
            m = max(int(hs.max()), int(ws.max()))
            for c in self.bucket_ladder:
                if c >= m:
                    if c < self.canvas:
                        canv = np.ascontiguousarray(canv[:, :c, :c])
                    break
        return SampleBatch(canv, hs, ws, labels, indices,
                           pad=b - len(idxs))

    def __iter__(self) -> Iterator[SampleBatch]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        failure = []

        def worker():
            tf = self.transform or (lambda b: b)
            try:
                for s in range(0, len(self.order), self.batch_size):
                    q.put(tf(self._make_batch(
                        self.order[s: s + self.batch_size])))
                for _ in range(self.total_batches - self._own_batches):
                    q.put(tf(self._make_batch([])))  # all-padding filler
            except BaseException as e:  # surface decode errors to the caller
                failure.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                if failure:
                    raise failure[0]
                break
            yield item


class ArrayDataset:
    """In-memory (images, labels) dataset for tests/bench; images are
    [N, H, W, 3] uint8."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, tmpdir=None):
        self.images = images
        self.labels = labels
        # lets the runner auto-fit the canvas (TTLConfig.canvas == 0)
        self.max_image_dim = int(max(images.shape[1], images.shape[2]))

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return self.images[idx], int(self.labels[idx])


# in-memory datasets go through the same loader (array items are detected
# per-sample in _make_batch)
ArrayLoader = SampleLoader
