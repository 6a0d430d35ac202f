"""The port's MaxStyle op against the JAX package's.

Both port versions — the plain autograd op (ops/maxstyle.py) and the fused
autograd Function (ops/maxstyle_kernels.py, which on CPU tensors runs its
kernels' plain versions) — are held against the JAX ``apply_maxstyle`` and
``apply_maxstyle_pallas`` (Pallas in interpret mode) on the same numpy
inputs. Tolerances are those of tests/test_maxstyle_pallas.py: forward rtol
2e-4 / atol 2e-5, gradients rtol 2e-3 / atol 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.config import MaxStyleConfig as JMaxStyleConfig
from maxstyle_tpu.ops import maxstyle as jms
from maxstyle_tpu.ops.maxstyle_pallas import apply_maxstyle_pallas
from maxstyle_tpu_torch import prng
from maxstyle_tpu_torch.config import MaxStyleConfig
from maxstyle_tpu_torch.ops import maxstyle as tms
from maxstyle_tpu_torch.ops.maxstyle_kernels import apply_maxstyle_kernels

torch.set_num_threads(2)

B, H, W, C = 4, 8, 16, 8
CFGS = {
    "default": {},
    "no_noise": {"no_noise": True},
    "no_mix": {"mix_style": False},
    "grouped": {"style_group_size": 2},
}
PORT_OPS = {"plain": tms.apply_maxstyle, "kernels": apply_maxstyle_kernels}
JAX_OPS = {"jnp": jms.apply_maxstyle, "pallas": apply_maxstyle_pallas}


def nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def case(cfg_name, seed=0, gate=1.0, lmda=None):
    kw = CFGS[cfg_name]
    jcfg, tcfg = JMaxStyleConfig(**kw), MaxStyleConfig(**kw)
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, H, W, C) * 2 + 1).astype(np.float32)
    lm = rng.rand(B, 1, 1, 1).astype(np.float32) if lmda is None else \
        np.full((B, 1, 1, 1), lmda, np.float32)
    gn = rng.randn(B, 1, 1, C).astype(np.float32)
    bn = rng.randn(B, 1, 1, C).astype(np.float32)
    perm = np.array([1, 0, 3, 2]) if kw.get("style_group_size") else np.array([1, 2, 3, 0])
    spread_rows = B if kw.get("style_group_size") else 1
    nan = np.full((spread_rows, 1, 1, C), np.nan, np.float32)
    jp = jms.MaxStyleParams(lmda=jnp.asarray(lm), gamma_noise=jnp.asarray(gn),
                            beta_noise=jnp.asarray(bn))
    js = jms.MaxStyleState(perm=jnp.asarray(perm), gate=jnp.asarray(gate, jnp.float32),
                           gamma_std=jnp.asarray(nan), beta_std=jnp.asarray(nan))
    tp = tms.MaxStyleParams(lmda=torch.from_numpy(lm), gamma_noise=nchw(gn),
                            beta_noise=nchw(bn))
    ts = tms.MaxStyleState(perm=torch.from_numpy(perm), gate=torch.tensor(gate),
                           gamma_std=nchw(nan), beta_std=nchw(nan))
    return jcfg, tcfg, x, jp, js, tp, ts


_JAX_FWD = {}


def jax_forward(cfg_name, jax_op):
    key = (cfg_name, jax_op)
    if key not in _JAX_FWD:
        jcfg, _, x, jp, js, _, _ = case(cfg_name)
        out, st = JAX_OPS[jax_op](jnp.asarray(x), jp, js, jcfg)

        def loss(x_, p_):
            o, _ = JAX_OPS[jax_op](x_, p_, js, jcfg)
            return jnp.sum(jnp.sin(o))

        gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp)
        _JAX_FWD[key] = (np.asarray(out), np.asarray(st.gamma_std), np.asarray(st.beta_std),
                         np.asarray(gx), np.asarray(gp.lmda), np.asarray(gp.gamma_noise),
                         np.asarray(gp.beta_noise))
    return _JAX_FWD[key]


@pytest.mark.parametrize("jax_op", sorted(JAX_OPS))
@pytest.mark.parametrize("port_op", sorted(PORT_OPS))
@pytest.mark.parametrize("cfg_name", sorted(CFGS))
class TestParity:
    def test_forward_and_spreads(self, cfg_name, port_op, jax_op):
        out_j, gstd_j, bstd_j = jax_forward(cfg_name, jax_op)[:3]
        _, tcfg, x, _, _, tp, ts = case(cfg_name)
        out, st = PORT_OPS[port_op](nchw(x), tp, ts, tcfg)
        np.testing.assert_allclose(out.numpy(), out_j.transpose(0, 3, 1, 2),
                                   rtol=2e-4, atol=2e-5)
        if not tcfg.no_noise or tcfg.mix_style:
            np.testing.assert_allclose(st.gamma_std.numpy(), gstd_j.transpose(0, 3, 1, 2),
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(st.beta_std.numpy(), bstd_j.transpose(0, 3, 1, 2),
                                       rtol=1e-4, atol=1e-6)

    def test_all_grads(self, cfg_name, port_op, jax_op):
        _, _, _, gx_j, gl_j, ggn_j, gbn_j = jax_forward(cfg_name, jax_op)
        _, tcfg, x, _, _, tp, ts = case(cfg_name)
        xt = nchw(x).requires_grad_(True)
        leaves = [t.clone().requires_grad_(True) for t in tp.tensors()]
        out, _ = PORT_OPS[port_op](xt, tms.MaxStyleParams(*leaves), ts, tcfg)
        grads = torch.autograd.grad(torch.sin(out).sum(), [xt] + leaves, allow_unused=True)
        # an input the op does not use (lmda without mixing) has gradient zero
        gx, gl, ggn, gbn = (torch.zeros_like(t) if g is None else g
                            for g, t in zip(grads, [xt] + leaves))
        tol = dict(rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(gx.numpy(), gx_j.transpose(0, 3, 1, 2), **tol)
        np.testing.assert_allclose(gl.numpy(), gl_j, **tol)
        np.testing.assert_allclose(ggn.numpy(), ggn_j.transpose(0, 3, 1, 2), **tol)
        np.testing.assert_allclose(gbn.numpy(), gbn_j.transpose(0, 3, 1, 2), **tol)


@pytest.mark.parametrize("port_op", sorted(PORT_OPS))
class TestSemantics:
    def test_gate_off_identity(self, port_op):
        _, tcfg, x, _, _, tp, ts = case("default", gate=0.0)
        out, _ = PORT_OPS[port_op](nchw(x), tp, ts, tcfg)
        np.testing.assert_allclose(out.numpy(), nchw(x).numpy(), rtol=1e-5, atol=1e-6)

    def test_cached_spreads_reused(self, port_op):
        _, tcfg, x, _, _, tp, ts = case("default")
        _, st1 = PORT_OPS[port_op](nchw(x), tp, ts, tcfg)
        _, st2 = PORT_OPS[port_op](nchw(x) * 3 + 1, tp, st1, tcfg)
        assert torch.equal(st1.gamma_std, st2.gamma_std)
        assert torch.equal(st1.beta_std, st2.beta_std)

    def test_clamp_outside_zero_grad(self, port_op):
        _, tcfg, x, _, _, tp, ts = case("default", lmda=3.0)
        lm = tp.lmda.clone().requires_grad_(True)
        out, _ = PORT_OPS[port_op](nchw(x), dataclasses.replace(tp, lmda=lm), ts, tcfg)
        (g,) = torch.autograd.grad((out ** 2).sum(), [lm])
        np.testing.assert_allclose(g.numpy(), 0.0, atol=1e-6)

    def test_stats_are_detached(self, port_op):
        """dx = g * scale: with a constant cotangent, dx is constant per plane."""
        _, tcfg, x, _, _, tp, ts = case("default")
        xt = nchw(x).requires_grad_(True)
        out, _ = PORT_OPS[port_op](xt, tp, ts, tcfg)
        (g,) = torch.autograd.grad((out * 2.0).sum(), [xt])
        np.testing.assert_allclose(g.numpy().std(axis=(2, 3)), 0.0, atol=1e-4)


class TestInitFromJaxDraws:
    """The deterministic part of init_maxstyle, fed the numbers JAX drew,
    reproduces JAX's init_maxstyle exactly."""

    @pytest.mark.parametrize("kw", [{}, {"style_group_size": 2},
                                    {"mix_style": False, "no_noise": True}])
    def test_matches_jax(self, kw):
        jcfg, tcfg = JMaxStyleConfig(**kw), MaxStyleConfig(**kw)
        key = jax.random.key(5)
        jp, js = jms.init_maxstyle(key, B, C, jcfg)
        k_perm, k_gate, k_lmda, k_gn, k_bn = jax.random.split(key, 5)
        g = jms._group_size(jcfg, B)
        perms = jax.vmap(lambda k: jax.random.permutation(k, g))(
            jax.random.split(k_perm, B // g)) if g < B else \
            jax.random.permutation(k_perm, B)[None]
        draws = {"perms": torch.from_numpy(np.array(perms)),
                 "gate_u": torch.tensor(float(jax.random.uniform(k_gate))),
                 "lmda": torch.from_numpy(np.array(jax.random.uniform(k_lmda, (B, 1, 1, 1)))),
                 "gamma_noise": nchw(jax.random.normal(k_gn, (B, 1, 1, C))),
                 "beta_noise": nchw(jax.random.normal(k_bn, (B, 1, 1, C)))}
        tp, ts = tms.maxstyle_from_draws(draws, tcfg)
        np.testing.assert_array_equal(ts.perm.numpy(), np.asarray(js.perm))
        assert float(ts.gate) == float(js.gate)
        np.testing.assert_array_equal(tp.lmda.numpy(), np.asarray(jp.lmda))
        np.testing.assert_array_equal(tp.gamma_noise.numpy(),
                                      np.asarray(jp.gamma_noise).transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(tp.beta_noise.numpy(),
                                      np.asarray(jp.beta_noise).transpose(0, 3, 1, 2))
        assert ts.gamma_std.shape == np.asarray(js.gamma_std).transpose(0, 3, 1, 2).shape
        assert torch.isnan(ts.gamma_std).all() and torch.isnan(ts.beta_std).all()
        assert tms.learnable_mask(tcfg) == tuple(
            float(v) for v in jax.tree_util.tree_leaves(jms.learnable_mask(jcfg)))


class TestDraws:
    def test_identity_falls_back_to_cyclic_shift(self):
        out = prng.non_identity_permutation(torch.arange(5))
        assert out.tolist() == np.asarray(jnp.roll(jnp.arange(5), 1)).tolist()
        perm = torch.tensor([2, 0, 1])
        assert torch.equal(prng.non_identity_permutation(perm), perm)

    def test_random_draws_never_identity_and_distributed(self):
        g = torch.Generator().manual_seed(0)
        cfg = MaxStyleConfig(always_use_beta=True)
        lmdas, gates = [], []
        for _ in range(200):
            p, s = tms.init_maxstyle(g, 2, 3, cfg)
            assert s.perm.tolist() == [1, 0]
            lmdas.append(p.lmda.flatten())
            gates.append(float(s.gate))
        lm = torch.cat(lmdas)
        # Beta(0.1, 0.1) piles its mass near 0 and 1, symmetric about 0.5
        assert ((lm < 0.1) | (lm > 0.9)).float().mean() > 0.6
        assert abs(float(lm.mean()) - 0.5) < 0.1
        assert 0.35 < np.mean(gates) < 0.65
