"""The port's style map (``style_apply``: the MaxStyle coefficients folded
and applied in one kernel) against the JAX package's ``_coefficients`` and
``_batched_apply`` (Pallas in interpret mode, as tests/test_maxstyle_pallas.py
runs it); the kernel's order of operations against the plain version, bit
for bit; and the backward pass of ``_FusedStyle``, which
returns None for every input that needs no gradient.

On the CPU ``style_apply`` runs its plain version, ``style_apply_plain``.
Tolerances are those of tests/test_maxstyle_pallas.py: forward rtol 2e-4 /
atol 2e-5, gradients rtol 2e-3 / atol 2e-4.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.config import MaxStyleConfig as JMaxStyleConfig
from maxstyle_tpu.ops import maxstyle_pallas as jmp
from maxstyle_tpu_torch.config import MaxStyleConfig
from maxstyle_tpu_torch.ops import maxstyle_kernels as mk

torch.set_num_threads(2)

B, C, H, W = 4, 8, 6, 10
# (mix_style, no_noise, gate, spread rows, lmda range)
BRANCHES = list(itertools.product((True, False), (False, True), (1.0, 0.0), (1, B),
                                  ((0.0, 1.0), (-1.0, 2.0))))


def branch_id(b):
    mix, no_noise, gate, rows, (lo, hi) = b
    return (f"{'mix' if mix else 'nomix'}-{'nonoise' if no_noise else 'noise'}-gate{gate:g}"
            f"-spreads{rows}-lmda[{lo:g},{hi:g})")


def inputs(rows, gate, lo, hi, seed=0):
    """numpy inputs of the style map: x [B,C,H,W], lmda [B,1], gn, bn, mu,
    sig [B,C], perm [B], spreads [rows,C], gate [1,1]."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    x = (rng.randn(B, C, H, W) * 2 + 1).astype(f32)
    lmda = (rng.rand(B, 1) * (hi - lo) + lo).astype(f32)
    gn, bn = (rng.randn(B, C).astype(f32) for _ in range(2))
    mu = rng.randn(B, C).astype(f32)
    sig = (rng.rand(B, C) + 0.5).astype(f32)
    perm = np.array([1, 2, 3, 0])
    gstd, bstd = (rng.rand(rows, C).astype(f32) for _ in range(2))
    return x, lmda, gn, bn, mu, sig, perm, gstd, bstd, np.full((1, 1), gate, f32)


def torch_inputs(arrays):
    return [torch.from_numpy(a) for a in arrays]


def kernel_order_coefficients(cfg, lmda, gn, bn, mu, sig, perm, gstd, bstd, gate):
    """(scale, shift) as csrc/maxstyle.cu's style_coefficients computes them:
    every float32 operation rounded once, in its order (numpy float32
    scalars round each operation as the explicitly rounded CUDA ops do)."""
    f = np.float32
    scale = np.empty(mu.shape, f)
    shift = np.empty(mu.shape, f)
    for b, c in np.ndindex(*mu.shape):
        m, s = mu[b, c], sig[b, c]
        m2, s2 = mu[perm[b], c], sig[perm[b], c]
        s_mix, m_mix = s, m
        if cfg.mix_style:
            lm = min(max(lmda[b, 0], f(0)), f(1))
            keep = f(1) - lm
            s_mix = s * keep + s2 * lm
            m_mix = m * keep + m2 * lm
        if cfg.no_noise:
            sc = s_mix / s
            sh = m_mix - m * sc
        else:
            r = 0 if gstd.shape[0] == 1 else b
            sc = (s_mix + gn[b, c] * gstd[r, c]) / s
            sh = (m_mix + bn[b, c] * bstd[r, c]) - m * sc
        g = gate[0, 0]
        scale[b, c] = g * sc + (f(1) - g)
        shift[b, c] = g * sh
    return scale, shift


@pytest.mark.parametrize("branch", BRANCHES, ids=branch_id)
def test_style_apply_plain_matches_jax_coefficients_and_apply(branch):
    mix, no_noise, gate, rows, (lo, hi) = branch
    arrays = inputs(rows, gate, lo, hi)
    x, lmda, gn, bn, mu, sig, perm, gstd, bstd, g = arrays
    jcfg = JMaxStyleConfig(mix_style=mix, no_noise=no_noise)
    j = jnp.asarray
    j_scale, j_shift = jmp._coefficients(jcfg, j(lmda), j(gn), j(bn), j(mu), j(sig), j(mu[perm]),
                                         j(sig[perm]), j(gstd), j(bstd), j(g))
    x2d = j(x.transpose(0, 2, 3, 1).reshape(B, H * W, C))
    j_out = np.asarray(jmp._batched_apply(x2d, j_scale, j_shift))
    j_out = j_out.reshape(B, H, W, C).transpose(0, 3, 1, 2)

    cfg = MaxStyleConfig(mix_style=mix, no_noise=no_noise)
    out, scale, shift, mu2, sig2 = mk.style_apply(cfg, *torch_inputs(arrays))
    np.testing.assert_allclose(out.numpy(), j_out, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(scale.numpy(), np.asarray(j_scale), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(shift.numpy(), np.asarray(j_shift), rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(mu2.numpy(), mu[perm])
    np.testing.assert_array_equal(sig2.numpy(), sig[perm])


@pytest.mark.parametrize("branch", BRANCHES, ids=branch_id)
def test_scale_is_bit_equal_to_coefficients_and_to_the_kernels_order(branch):
    mix, no_noise, gate, rows, (lo, hi) = branch
    arrays = inputs(rows, gate, lo, hi, seed=1)
    t = torch_inputs(arrays)
    cfg = MaxStyleConfig(mix_style=mix, no_noise=no_noise)
    _, scale, shift, mu2, sig2 = mk.style_apply_plain(cfg, *t)
    lmda, gn, bn, mu, sig, perm, gstd, bstd, gate_t = t[1:]
    ref_scale, ref_shift = mk._coefficients(cfg, lmda, gn, bn, mu, sig, mu[perm], sig[perm],
                                            gstd, bstd, gate_t)
    assert torch.equal(scale, ref_scale) and torch.equal(shift, ref_shift)
    k_scale, k_shift = kernel_order_coefficients(cfg, *arrays[1:])
    np.testing.assert_array_equal(scale.numpy(), k_scale)
    np.testing.assert_array_equal(shift.numpy(), k_shift)


@pytest.mark.parametrize("mix,no_noise", [(True, False), (True, True), (False, False)])
def test_backward_returns_none_where_no_gradient_is_needed(mix, no_noise):
    arrays = inputs(1, 1.0, -0.5, 1.5, seed=2)
    x, lmda, gn, bn, mu, sig, perm, gstd, bstd, gate = arrays
    g = np.random.RandomState(3).randn(*x.shape).astype(np.float32)
    cfg = MaxStyleConfig(mix_style=mix, no_noise=no_noise)
    t = torch_inputs(arrays)
    for i in range(4):                       # x, lmda and the two noise tensors
        t[i].requires_grad_(True)
    out = mk._FusedStyle.apply(cfg, *t)
    grads = out.grad_fn.apply(torch.from_numpy(g))
    assert len(grads) == 11
    assert all(d is None for d in grads[5:])  # mu, sig, perm, spreads, gate
    assert (grads[2] is None) == (not mix)
    assert (grads[3] is None) == no_noise and (grads[4] is None) == no_noise

    jcfg = JMaxStyleConfig(mix_style=mix, no_noise=no_noise)
    j = jnp.asarray
    x2d = j(x.transpose(0, 2, 3, 1).reshape(B, H * W, C))
    g2d = j(g.transpose(0, 2, 3, 1).reshape(B, H * W, C))
    _, vjp = jax.vjp(lambda *a: jmp._fused_core(jcfg, *a), x2d, j(lmda), j(gn), j(bn), j(mu),
                     j(sig), j(mu[perm]), j(sig[perm]), j(gstd), j(bstd), j(gate))
    j_grads = vjp(g2d)
    tol = dict(rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(
        grads[1].detach().numpy(),
        np.asarray(j_grads[0]).reshape(B, H, W, C).transpose(0, 3, 1, 2), **tol)
    for port, ref in zip(grads[2:5], j_grads[1:4]):
        np.testing.assert_allclose(np.zeros_like(ref) if port is None else port.detach().numpy(),
                                   np.asarray(ref), **tol)


def test_backward_skips_inputs_that_do_not_require_grad():
    arrays = inputs(1, 1.0, 0.0, 1.0, seed=4)
    t = torch_inputs(arrays)
    t[0].requires_grad_(True)                # x only
    out = mk._FusedStyle.apply(MaxStyleConfig(), *t)
    grads = out.grad_fn.apply(torch.ones_like(out))
    assert grads[1] is not None and all(d is None for d in grads[2:])
