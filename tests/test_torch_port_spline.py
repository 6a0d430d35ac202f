"""The port's cubic B-spline module (maxstyle_tpu_torch/ops/spline.py)
against the JAX package's (maxstyle_tpu/ops/spline.py).

Tolerances are those of tests/test_spline.py: the prefilter at atol 2e-5
(5e-6 for n <= 28, where both use the exact closed-form causal init), the
samplers at 2e-5. The matrix form of the 2-D prefilter (the recursion
applied to the identity in float64, then two float32 products) is held to
the same 2e-5 against JAX's recursion and to 1e-5 against the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.ops import spline as JS
from maxstyle_tpu_torch.ops import spline as TS

torch.set_num_threads(2)


@pytest.mark.parametrize("n,atol", [(40, 2e-5), (29, 2e-5), (16, 5e-6), (7, 5e-6), (2, 5e-6)])
def test_spline_filter1d_matches_jax(n, atol):
    x = np.random.RandomState(n).rand(n, 5).astype(np.float32)
    want = np.asarray(JS.spline_filter1d(jnp.asarray(x), axis=0))
    got = TS.spline_filter1d(torch.from_numpy(x), axis=0)
    np.testing.assert_allclose(got.numpy(), want, atol=atol)
    got1 = TS.spline_filter1d(torch.from_numpy(np.ascontiguousarray(x.T)), axis=1)
    np.testing.assert_allclose(got1.numpy().T, want, atol=1e-6)


@pytest.mark.parametrize("form", ["loop", "matrix"])
def test_spline_filter2d_matches_jax(form):
    imgs = np.random.RandomState(1).rand(3, 40, 36).astype(np.float32)
    want = np.stack([np.asarray(JS.spline_filter2d(jnp.asarray(i))) for i in imgs])
    fn = TS.spline_filter2d if form == "loop" else TS.spline_filter2d_matrix
    got = fn(torch.from_numpy(imgs))
    assert got.shape == imgs.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_matrix_form_matches_loop_and_is_cached():
    imgs = torch.from_numpy(np.random.RandomState(2).rand(2, 24, 30).astype(np.float32))
    np.testing.assert_allclose(TS.spline_filter2d_matrix(imgs).numpy(),
                               TS.spline_filter2d(imgs).numpy(), atol=1e-5)
    assert TS.spline_matrix(24, "cpu") is TS.spline_matrix(24, torch.device("cpu"))
    m = TS.spline_matrix(24, "cpu")
    assert m.shape == (24, 24) and m.dtype == torch.float32


def coords(rng, n, h, w, src, margin):
    ys = (rng.rand(n, h, w) * (src - 1 + 2 * margin) - margin).astype(np.float32)
    xs = (rng.rand(n, h, w) * (src - 1 + 2 * margin) - margin).astype(np.float32)
    rim = np.array([0.0, src - 1.0, -0.0001, src - 0.9999, 0.5, src - 1.5], np.float32)
    ys[0, 0, :len(rim)] = rim
    xs[0, 0, :len(rim)] = rim[::-1]
    return ys, xs


@pytest.mark.parametrize("src,margin", [(40, 3.0), (7, 2.0)])
def test_sample_cubic_and_map_coordinates_match_jax(src, margin):
    rng = np.random.RandomState(src)
    imgs = rng.rand(2, src, src).astype(np.float32)
    ys, xs = coords(rng, 2, 16, 16, src, margin)
    coef = np.stack([np.asarray(JS.spline_filter2d(jnp.asarray(i))) for i in imgs])
    want_s = np.asarray(jax.vmap(JS.sample_cubic)(jnp.asarray(coef), jnp.asarray(ys),
                                                  jnp.asarray(xs)))
    want_m = np.asarray(jax.vmap(JS.map_coordinates_cubic)(jnp.asarray(imgs), jnp.asarray(ys),
                                                           jnp.asarray(xs)))
    t = [torch.from_numpy(a) for a in (coef, imgs, ys, xs)]
    np.testing.assert_allclose(TS.sample_cubic(t[0], t[2], t[3]).numpy(), want_s, atol=2e-5)
    np.testing.assert_allclose(TS.map_coordinates_cubic(t[1], t[2], t[3]).numpy(), want_m,
                               atol=2e-5)


def test_far_outside_coordinates_index_safely():
    coef = torch.rand(1, 8, 8)
    ys = torch.tensor([[[-1e9, 1e9, 3.5]]])
    xs = torch.tensor([[[2.0, -5e8, 3.5]]])
    out = TS.sample_cubic(coef, ys, xs)
    assert float(out[0, 0, 0]) == 0.0 and float(out[0, 0, 1]) == 0.0
    assert torch.isfinite(out).all() and float(out[0, 0, 2]) != 0.0
