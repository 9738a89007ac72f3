"""View rendering of the PyTorch port against `ttl_tpu.ops.image`.

The JAX view function draws its randomness inside from a key; the port takes
the draws as input. `jax_draws` pulls JAX's own draws out of the same key
splits `make_view_fn` and `sample_rrc_box` make, so both sides render the
same crops. Compared at f32 in normalized units.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (torch threads per worker)
from ttl_tpu.ops.image import make_view_fn, preprocess_center
from ttl_tpu_torch.ops import image as timg

OUT = 32
N_VIEWS = 6


def jax_draws(key, n_views: int) -> dict:
    """The draws `make_view_fn(n_views)` consumes for `key`, as numpy."""
    keys = jax.random.split(key, n_views - 1)
    area, log_r, pos, flip = [], [], [], []
    for k in keys:
        k_box, k_flip, _ = jax.random.split(k, 3)
        k_area, k_ratio, k_ij = jax.random.split(k_box, 3)
        area.append(jax.random.uniform(k_area, (10,), minval=0.08,
                                       maxval=1.0))
        log_r.append(jax.random.uniform(
            k_ratio, (10,), minval=jnp.log(3.0 / 4.0),
            maxval=jnp.log(4.0 / 3.0)))
        pos.append(jax.random.uniform(k_ij, (2,)))
        flip.append(jax.random.bernoulli(k_flip))
    return {"area": np.stack(area), "log_ratio": np.stack(log_r),
            "pos": np.stack(pos), "flip": np.stack(flip)}


def stack_draws(draws: list) -> dict:
    return {k: torch.from_numpy(np.stack([d[k] for d in draws]))
            for k in draws[0]}


def _canvases(rng, canvas, sizes):
    canv = np.zeros((len(sizes), canvas, canvas, 3), np.uint8)
    for i, (h, w) in enumerate(sizes):
        canv[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return canv


@pytest.mark.parametrize("canvas,sizes", [
    (48, [(48, 48), (20, 33)]),          # full canvas; small non-square
    (40, [(17, 40), (40, 9), (25, 25)]),  # wide, tall (fallback boxes)
])
def test_render_views_matches_jax(canvas, sizes):
    rng = np.random.default_rng(0)
    canv = _canvases(rng, canvas, sizes)
    view_fn = jax.jit(make_view_fn(N_VIEWS, OUT, out_dtype=jnp.float32))
    keys = [jax.random.fold_in(jax.random.PRNGKey(3), i)
            for i in range(len(sizes))]
    want = np.stack([np.asarray(view_fn(jnp.asarray(canv[i]), h, w, keys[i]))
                     for i, (h, w) in enumerate(sizes)])
    hs = torch.tensor([h for h, _ in sizes])
    ws = torch.tensor([w for _, w in sizes])
    draws = stack_draws([jax_draws(k, N_VIEWS) for k in keys])
    got = timg.render_views(torch.from_numpy(canv), hs, ws, draws,
                            out_size=OUT, out_dtype=torch.float32)
    assert got.shape == (len(sizes), N_VIEWS, 3, OUT, OUT)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_weight_mat_rows_sum_to_one_inside():
    """Each output pixel's weights sum to 1 when it samples inside the
    input (the normalisation JAX applies)."""
    w = timg.weight_mat(torch.tensor([3.0]), torch.tensor([20.0]), 32, 16)
    np.testing.assert_allclose(w.sum(dim=-2).numpy(), 1.0, atol=1e-6)


def test_draws_depend_only_on_seed_and_index():
    a = timg.draw_view_params(0, 7, N_VIEWS)
    b = timg.draw_batch(0, [3, 7], N_VIEWS)
    for k in a:
        assert torch.equal(a[k], b[k][1])
    c = timg.draw_view_params(1, 7, N_VIEWS)
    assert not torch.equal(a["area"], c["area"])
    assert ((a["area"] >= 0.08) & (a["area"] < 1.0)).all()
    assert a["flip"].dtype == torch.bool and a["flip"].shape == (N_VIEWS - 1,)


@pytest.mark.parametrize("canvas,sizes", [
    (48, [(48, 48), (20, 33)]),
    (40, [(17, 40), (40, 9)]),
])
def test_preprocess_center_matches_jax(canvas, sizes):
    """The zero-shot eval view: the centered short-side square, resized."""
    rng = np.random.default_rng(1)
    canv = _canvases(rng, canvas, sizes)
    want = np.stack([np.asarray(jax.jit(
        lambda c, h, w: preprocess_center(c, h, w, OUT))(
            jnp.asarray(canv[i]), h, w)) for i, (h, w) in enumerate(sizes)])
    got = timg.preprocess_center(
        torch.from_numpy(canv), torch.tensor([h for h, _ in sizes]),
        torch.tensor([w for _, w in sizes]), OUT)
    assert got.shape == (len(sizes), 3, OUT, OUT)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
