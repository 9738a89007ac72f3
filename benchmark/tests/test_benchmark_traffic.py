"""The traffic the seed makes: the same seed, the same traffic; another
seed, the same image sizes in another order and the same arrivals."""
from __future__ import annotations

import numpy as np
import pytest
from PIL import Image

from benchmark.harness import images
from benchmark.harness.manifest import driver

SEED = 2 ** 31 + 5


def test_open_loop_schedule_repeats_from_the_seed():
    serve = driver("serve")
    files = [f"f{i}" for i in range(16)]
    poisson = {"process": "poisson", "seed": 17}
    a = serve.schedule(SEED, poisson, 27.0, 30.0, files)
    assert a == serve.schedule(SEED, poisson, 27.0, 30.0, files)
    # another seed: the same arrivals, other images
    b = serve.schedule(SEED + 1, poisson, 27.0, 30.0, files)
    assert [t for t, _ in a] == [t for t, _ in b]
    assert [f for _, f in a] != [f for _, f in b]
    # another arrival seed: other arrivals
    c = serve.schedule(SEED, dict(poisson, seed=18), 27.0, 30.0, files)
    assert [t for t, _ in a] != [t for t, _ in c]
    assert a[0][0] == 0.0 and a[-1][0] < 30.0


def test_arrivals_are_poisson():
    """Exponential gaps at the rate: counts a second spread as a Poisson
    count's (variance = mean), not as a fixed load's."""
    serve = driver("serve")
    at = np.array([t for t, _ in serve.schedule(
        SEED, {"process": "poisson", "seed": 17}, 25.0, 400.0, ["f"])])
    gaps = np.diff(at)
    assert abs(len(at) / 400.0 - 25.0) < 1.0
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.08)
    counts = np.histogram(at, bins=np.arange(0.0, 401.0, 1.0))[0]
    assert counts.var() / counts.mean() == pytest.approx(1.0, abs=0.25)
    with pytest.raises(ValueError):
        serve.schedule(SEED, {"process": "even", "seed": 1}, 25.0, 4.0,
                       ["f"])


def test_quantile_matches_statistics():
    import statistics

    serve = driver("serve")
    vals = list(np.random.default_rng(0).exponential(1.0, 101))
    assert serve.quantile(vals, 0.95) == pytest.approx(
        statistics.quantiles(vals, n=20)[18])
    assert serve.quantile(vals + [float("inf")] * 10, 0.95) == float("inf")


def test_images_share_sizes_across_seeds(tmp_path):
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    a_dir.mkdir()
    b_dir.mkdir()
    a = images.write_set(SEED, 12, 300, 512, str(a_dir))
    b = images.write_set(SEED + 9, 12, 300, 512, str(b_dir))

    def sizes(paths):
        return [Image.open(p).size for p in paths]
    assert sorted(sizes(a)) == sorted(sizes(b)) \
        == sorted(images.sizes(12, 300, 512))
    assert sizes(a) != sizes(b)
    for w, h in sizes(a):
        assert 300 <= max(w, h) <= 512 and 0.74 <= w / h <= 1.34
    again = tmp_path / "c"
    again.mkdir()
    c = images.write_set(SEED, 12, 300, 512, str(again))
    assert [open(p, "rb").read() for p in a] == \
        [open(p, "rb").read() for p in c]


def test_images_are_smooth_not_noise(tmp_path):
    path = images.write_set(SEED, 1, 400, 400, str(tmp_path))[0]
    x = images.decode(path).astype(np.float32)
    # neighbouring pixels differ far less than the image varies
    step = np.abs(np.diff(x, axis=1)).mean()
    assert step < 0.2 * x.std()
