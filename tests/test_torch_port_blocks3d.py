"""The port's 3D blocks (``models/blocks3d.py``) against the JAX package's,
with the weights carried across by ``convert.py``; the cases of
``tests/test_blocks3d.py``. ``UnetConv3`` and ``UnetUp3``: the shapes of
that file, the "train" (batch statistics) and "eval" outputs at rtol 1e-5
/ atol 1e-5, the running statistics at rtol 1e-5 / atol 1e-6, and the
gradients of every weight at rtol 1e-4 / atol 1e-5 of the block's largest.
``FixableDropout3d``: one mask a step, replayed (the same seed gives the
same mask), channel-wise, and the identity in "eval"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.models.blocks3d import UnetConv3 as JUnetConv3
from maxstyle_tpu.models.blocks3d import UnetUp3 as JUnetUp3
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.models import blocks3d as tb
from maxstyle_tpu_torch.models.layers import dropout_step

KEY = jax.random.key(0)
torch.set_num_threads(2)


def to_torch(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def to_np(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def load(tm, v):
    tm.load_state_dict(convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, v["params"]),
        jax.tree_util.tree_map(np.asarray, v["batch_stats"])), strict=True)


def check(jm, tm, args):
    """Forward in train and eval, the updated statistics, and the weights'
    gradients of sum(out * r), r a fixed pattern."""
    v = jm.init(KEY, *[jnp.asarray(a) for a in args], train=True)
    load(tm, v)
    ta = [to_torch(a) for a in args]

    def j_loss(params):
        out, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                            *[jnp.asarray(a) for a in args], train=True,
                            mutable=["batch_stats"])
        r = jnp.cos(jnp.arange(out.size, dtype=jnp.float32)).reshape(out.shape)
        return jnp.sum(out * r), (out, upd)

    (_, (out_j, upd)), g_j = jax.value_and_grad(j_loss, has_aux=True)(v["params"])
    out_t = tm(*ta, "train")
    np.testing.assert_allclose(to_np(out_t), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    r = torch.cos(torch.arange(out_t.numel(), dtype=torch.float32))
    (out_t * to_torch(r.reshape(out_j.shape).numpy())).sum().backward()
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, g_j))
    top = max(float(g.abs().max()) for g in want.values())
    for name, p in tm.named_parameters():
        # a conv bias before a "train" BatchNorm has gradient 0: both sides
        # hold rounding residues, so the bar is relative to the module's
        # largest gradient
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5 * top, err_msg=name)
    stats = convert.flax_to_state_dict({}, jax.tree_util.tree_map(np.asarray,
                                                                  upd["batch_stats"]))
    for key, w in stats.items():
        np.testing.assert_allclose(tm.state_dict()[key].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    ev_j = jm.apply({"params": v["params"], "batch_stats": upd["batch_stats"]},
                    *[jnp.asarray(a) for a in args], train=False)
    with torch.no_grad():
        np.testing.assert_allclose(to_np(tm(*ta, "eval")), np.asarray(ev_j), rtol=1e-5,
                                   atol=1e-5)
    return out_t


def test_unet_conv3_matches_jax():
    x = np.random.RandomState(0).randn(2, 4, 8, 8, 2).astype(np.float32)
    out = check(JUnetConv3(out_ch=8), tb.UnetConv3(2, 8), [x])
    assert out.shape == (2, 8, 4, 8, 8)


def test_unet_up3_doubles_resolution_and_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 2, 4, 4, 8).astype(np.float32)
    skip = rng.randn(2, 4, 8, 8, 4).astype(np.float32)
    out = check(JUnetUp3(out_ch=4), tb.UnetUp3(8, 4, 4), [x, skip])
    assert out.shape == (2, 4, 4, 8, 8)


@pytest.mark.parametrize("rate", [0.5, 0.0])
def test_dropout3d_replayable(rate):
    m = tb.FixableDropout3d(rate)
    x = torch.ones((2, 8, 4, 4, 4))
    outs = []
    for _ in range(2):
        with dropout_step(m, 3):
            y = m(x, "train")
            assert torch.equal(y, m(x, "frozen"))  # one mask a step, every pass
        outs.append(y)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(m(x, "eval"), x)
    if rate:
        # channel-wise: each (sample, channel) is all kept (x2) or all dropped
        per = outs[0].reshape(2, 8, -1)
        assert torch.equal(per.amin(-1), per.amax(-1))
        assert set(per.unique().tolist()) <= {0.0, 2.0}
    else:
        assert torch.equal(outs[0], x)
