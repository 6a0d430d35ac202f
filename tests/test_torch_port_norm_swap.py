"""The port's norm swapping (``models/norm_swap.py``) and the blocks of
``maxstyle_tpu/models/layers.py:458-682`` against the JAX package's, with
the weights carried across by ``convert.py``; the cases of
``tests/test_norm_swap.py`` that do not need the reference's code.

Held at that file's tolerances: the batch-instance norms' train-mode
output and running statistics and eval-mode output (atol 2e-5; the
statistics atol 1e-6 / rtol 1e-5), the 3-D norm against the numpy
derivation, the straight-through gate (an out-of-range gate keeps its
gradient, its value is clipped), ``affine=False``, and the swaps of the
small encoder: what carries over, what starts fresh, and the swapped
encoder's forward against the JAX package's. The SE blocks, AdaIN, SPP,
the additive upsampling and the adaptive norms: forward at rtol 1e-5 /
atol 1e-6, gradients at rtol 1e-4 / atol 1e-6 of the largest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.models import layers as jl
from maxstyle_tpu.models import norm_swap as jns
from maxstyle_tpu.models.encoder_decoder import Encoder as JEncoder
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.models import encoder_decoder as ted
from maxstyle_tpu_torch.models import layers as tl
from maxstyle_tpu_torch.models import norm_swap as tns

KEY = jax.random.key(0)
torch.set_num_threads(2)


def to_torch(a):
    """Channels-last array -> channels-first tensor."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(np.moveaxis(a, -1, 1)))


def to_np(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def port_sd(v):
    return convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, v["params"]),
                                      jax.tree_util.tree_map(np.asarray,
                                                             v.get("batch_stats", {})))


# ---------------------------------------------------------------------------
# BatchInstanceNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spatial", [(7,), (7, 8), (7, 8, 6)])
def test_batch_instance_norm_matches_jax(spatial):
    rng = np.random.RandomState(0)
    c = 3
    x = rng.randn(4, *spatial, c).astype(np.float32)
    params = {"gate": np.array([0.2, 0.7, 1.3], np.float32),  # 1.3: the clamp
              "scale": rng.rand(c).astype(np.float32) + 0.5,
              "bias": rng.randn(c).astype(np.float32)}
    nd = len(spatial) + 2
    jm = jl.BatchInstanceNorm(expected_ndim=nd)
    v = jm.init(KEY, jnp.asarray(x), train=True)
    v = {"params": jax.tree_util.tree_map(jnp.asarray, params),
         "batch_stats": v["batch_stats"]}
    y_j, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    cls = {3: tl.BatchInstanceNorm1d, 4: tl.BatchInstanceNorm2d, 5: tl.BatchInstanceNorm3d}[nd]
    tm = cls(c)
    tm.load_state_dict(port_sd(v), strict=True)
    y_t = tm(to_torch(x), "train")
    np.testing.assert_allclose(to_np(y_t), np.asarray(y_j), atol=2e-5)
    np.testing.assert_allclose(tm.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(tm.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5)
    frozen = tm.running_mean.clone()
    tm(to_torch(x), "frozen")
    assert torch.equal(tm.running_mean, frozen)
    y_ev = jm.apply({"params": v["params"], "batch_stats": upd["batch_stats"]},
                    jnp.asarray(x), train=False)
    np.testing.assert_allclose(to_np(tm(to_torch(x), "eval")), np.asarray(y_ev), atol=2e-5)
    with pytest.raises(ValueError):
        tm(to_torch(x)[None], "train")


def test_batch_instance_3d_matches_numpy():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 5, 6, 3).astype(np.float32)  # channels-last
    gate = np.array([0.2, 0.7, 1.0], np.float32)
    w = rng.rand(3).astype(np.float32) + 0.5
    b = rng.randn(3).astype(np.float32)
    eps = 1e-5
    bn = (x - x.mean(axis=(0, 1, 2, 3))) / np.sqrt(x.var(axis=(0, 1, 2, 3)) + eps)
    inn = (x - x.mean(axis=(1, 2, 3), keepdims=True)) / np.sqrt(
        x.var(axis=(1, 2, 3), keepdims=True) + eps)
    expect = bn * (w * gate) + b + inn * (w * (1 - gate))
    m = tl.BatchInstanceNorm3d(3)
    with torch.no_grad():
        m.gate.copy_(torch.from_numpy(gate))
        m.weight.copy_(torch.from_numpy(w))
        m.bias.copy_(torch.from_numpy(b))
    np.testing.assert_allclose(to_np(m(to_torch(x), "train")), expect, atol=2e-5)


def test_affine_false_keeps_the_gate_and_uses_batch_statistics():
    m = tl.BatchInstanceNorm(3, affine=False, track_running_stats=False)
    assert list(m.state_dict()) == ["gate"]
    x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    y = m(x, "eval")  # batch statistics even in eval
    assert float(y.std()) == pytest.approx(1.0, abs=0.05)
    for kind in ("batch_instance", "batch_instance_noaffine"):
        norm = tl.Norm2d(kind, 3)
        out = norm(x, "train")
        assert out.shape == x.shape and torch.isfinite(out).all()
        # gate 1: the pure BatchNorm branch
        bn = tl.BatchNorm(3)
        with torch.no_grad():
            bn.weight.fill_(1.0)
        torch.testing.assert_close(out, bn(x, "frozen"), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bad", [1.3, -0.2])
def test_out_of_range_gate_keeps_gradient_and_clips_value(bad):
    x = torch.randn(2, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    m = tl.BatchInstanceNorm(3)
    with torch.no_grad():
        m.gate.fill_(bad)
    (m(x, "frozen") ** 2).sum().backward()
    assert float(m.gate.grad.abs().min()) > 0
    clipped = tl.BatchInstanceNorm(3)
    with torch.no_grad():
        clipped.gate.fill_(min(max(bad, 0.0), 1.0))
    torch.testing.assert_close(m(x, "frozen"), clipped(x, "frozen"), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the swaps
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_encoder():
    enc = JEncoder(out_ch=8, feature_reduce=16)
    x = jnp.linspace(0, 1, 2 * 32 * 32).reshape(2, 32, 32, 1)
    return enc, dict(enc.init(jax.random.key(1), x, train=True)), x


def small_encoder():
    """tests/test_norm_swap.py's encoder (initialised once) and a fresh
    port copy of it."""
    enc, v, x = jax_encoder()
    tenc = ted.Encoder(1, 8, feature_reduce=16)
    tenc.load_state_dict(port_sd(v), strict=True)
    return enc, v, x, tenc


@pytest.mark.parametrize("affine,bn_in", [(False, False), (True, False), (True, True),
                                          (False, True)])
def test_replace_bn_with_in_matches_jax(affine, bn_in):
    enc, v, x, tenc = small_encoder()
    new_j, nv = jns.replace_bn_with_in(enc, v, jax.random.key(2), x, train=True,
                                       affine=affine, bn_in=bn_in)
    new_t = tns.replace_bn_with_in(tenc, affine=affine, bn_in=bn_in)
    assert type(tenc.inc.norm1) is tl.BatchNorm  # the given module is untouched
    want = port_sd(nv)
    got = new_t.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        assert torch.equal(got[key], w), key
    if bn_in:
        assert torch.equal(new_t.inc.norm1.gate, torch.ones(4))
    out_j, _ = new_j.apply(nv, x, train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(to_np(new_t(to_torch(x), "train")), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    if not bn_in:  # instance norms: train and eval forward agree
        torch.testing.assert_close(new_t(to_torch(x), "train"), new_t(to_torch(x), "eval"))


def test_recover_model_w_bn_gives_fresh_batch_norms():
    enc, v, x, tenc = small_encoder()
    bin_t = tns.replace_bn_with_in(tenc, affine=True, bn_in=True)
    bin_j, bv = jns.replace_bn_with_in(enc, v, jax.random.key(2), x, train=True, affine=True,
                                       bn_in=True)
    rec_t = tns.recover_model_w_bn(bin_t, seed=4)
    rec_j, rv = jns.recover_model_w_bn(bin_j, bv, jax.random.key(4), x, train=True)
    want = port_sd(rv)
    got = rec_t.state_dict()
    assert set(got) == set(want)
    old = tenc.state_dict()
    for key, w in want.items():
        if key.endswith((".running_mean", ".running_var")):
            assert torch.equal(got[key], w), key  # fresh: 0 and 1
        elif any(key.endswith(f"norm{i}.{p}") for i in (1, 2) for p in ("weight", "bias")) \
                or key.startswith("final_norm."):
            # fresh BatchNorm affine: N(1, 0.02) scale, zero bias, not the old one
            assert not torch.equal(got[key], old[key]) or key.endswith("bias"), key
            if key.endswith("weight"):
                assert float((got[key] - 1).abs().max()) < 0.1, key
        else:
            assert torch.equal(got[key], w), key  # trained convolutions survive
    assert isinstance(rec_t.inc.norm1, tl.BatchNorm)
    assert torch.equal(tns.recover_model_w_bn(bin_t, seed=4).inc.norm1.weight,
                       rec_t.inc.norm1.weight)  # fresh draws from the seed


# ---------------------------------------------------------------------------
# the blocks of layers.py:458-682
# ---------------------------------------------------------------------------


def _check_block(jm, tm, x, *extra, mode=None, jkw=None, mutable=False):
    """Forward and the input's and parameters' gradients of sum(out * r),
    r a fixed pattern (sum(out^2) of a normalized output is nearly
    constant, its gradient a rounding residue)."""
    v = jm.init(KEY, jnp.asarray(x), *extra, **(jkw or {}))
    tm.load_state_dict(port_sd(v), strict=True)
    xt = to_torch(x).requires_grad_(True)
    ex = [torch.from_numpy(np.asarray(e)) for e in extra]
    out_t = tm(xt, *ex, mode) if mode else tm(xt, *ex)

    def j_loss(params, xx):
        out = jm.apply({**v, "params": params}, xx, *extra,
                       **({**(jkw or {}), "mutable": ["batch_stats"]} if mutable
                          else (jkw or {})))
        out = out[0] if mutable else out
        r = jnp.cos(jnp.arange(out.size, dtype=jnp.float32)).reshape(out.shape)
        return jnp.sum(out * r), out

    (_, out_j), (g_p, g_x) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    np.testing.assert_allclose(to_np(out_t), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    r = torch.cos(torch.arange(out_t.numel(), dtype=torch.float32))
    (out_t * to_torch(r.reshape(out_j.shape).numpy())).sum().backward()
    gx = np.asarray(g_x)
    np.testing.assert_allclose(to_np(xt.grad), gx, rtol=1e-4, atol=1e-6 * np.abs(gx).max())
    want = port_sd({"params": g_p})
    for name, p in tm.named_parameters():
        g = want[name]
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(g.abs().max()) + 1e-12, err_msg=name)


X4 = np.random.RandomState(3).randn(2, 6, 6, 4).astype(np.float32)


@pytest.mark.parametrize("name", ["se", "sse", "scse"])
def test_squeeze_excite_blocks_match_jax(name):
    jm, tm = {"se": (jl.SqueezeExcite(2), tl.SqueezeExcite(4, 2)),
              "sse": (jl.SpatialSqueezeExcite(), tl.SpatialSqueezeExcite(4)),
              "scse": (jl.ChannelSpatialSqueezeExcite(2),
                       tl.ChannelSpatialSqueezeExcite(4, 2))}[name]
    _check_block(jm, tm, X4)


def test_adaptive_instance_norm_matches_jax():
    rng = np.random.RandomState(4)
    gamma, beta = rng.randn(2, 4).astype(np.float32), rng.randn(2, 4).astype(np.float32)
    out_j = jl.AdaptiveInstanceNorm2d().apply({}, jnp.asarray(X4), jnp.asarray(gamma),
                                              jnp.asarray(beta))
    out_t = tl.AdaptiveInstanceNorm2d()(to_torch(X4), torch.from_numpy(gamma),
                                        torch.from_numpy(beta))
    np.testing.assert_allclose(to_np(out_t), np.asarray(out_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(8, 8), (7, 5)])
def test_spatial_pyramid_pool_and_additive_upsampling_match_jax(hw):
    x = np.random.RandomState(5).randn(2, *hw, 4).astype(np.float32)
    np.testing.assert_array_equal(tl.spatial_pyramid_pool(to_torch(x)).numpy(),
                                  np.asarray(jl.spatial_pyramid_pool(jnp.asarray(x))))
    up_j = jl.bilinear_additive_upsampling(jnp.asarray(x), 2)
    np.testing.assert_allclose(to_np(tl.bilinear_additive_upsampling(to_torch(x), 2)),
                               np.asarray(up_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("train", [True, False])
def test_adaptive_norms_match_jax(train):
    mode = "train" if train else "eval"
    _check_block(jl.AdaptiveBatchNorm2d(), tl.AdaptiveBatchNorm2d(4), X4, mode=mode,
                 jkw={"train": train}, mutable=train)
    _check_block(jl.AdaptiveBatchInstanceNorm(), tl.AdaptiveBatchInstanceNorm(4), X4,
                 mode=mode, jkw={"train": train}, mutable=train)
