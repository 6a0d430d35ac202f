"""The baseline ``SegmentationModel`` and its network zoo in the port against
the JAX package (``maxstyle_tpu/basic_solver.py``, ``models/baselines.py``,
``models/unet.py``).

At 64x64, batch 4, from converted weights:

* the zoo's forwards in "train" and "eval" mode (``UNet_16``, ``FCN_16``,
  ``ResUNet_16``) and the other networks of the two files
  (``ResConvUNet`` with its bottleneck self-attention, ``UNetv2``,
  ``DeeplySupervisedUNet``); logits at rtol 1e-4 with an absolute floor of
  1e-4 of their largest value (test_torch_port_unet's bar);
* one ``make_train_step`` step of each zoo network with Adam and EMA: the
  loss at rtol 1e-4, the BatchNorm statistics at rtol 1e-4 / atol 5e-5,
  the weights after Adam within 2.1*lr + 1e-6 of JAX's and the update
  cosine > 0.95 (test_torch_port_train_step's bars), the EMA weights within
  the same bound, and ``predict`` on JAX's stepped weights (softmax, with
  and without the EMA weights) at rtol 1e-4 / atol 1e-5;
* ``build_network``'s names and the 16/64 channel plans.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu import basic_solver as jbs
from maxstyle_tpu.models import baselines as jbl
from maxstyle_tpu.models import unet as jun
from maxstyle_tpu_torch import basic_solver as tbs
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.models import baselines as tbl
from maxstyle_tpu_torch.models import unet as tun

torch.set_num_threads(2)

HW, N, LR = 64, 4, 1e-4
ZOO = ["UNet_16", "FCN_16", "ResUNet_16"]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def close_scaled(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-4,
                               atol=1e-4 * float(np.abs(j).max()))


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(N, HW, HW, 1).astype(np.float32)
    label = rng.randint(0, 4, (N, HW, HW)).astype(np.int32)
    return x, label


def check_forward(jnet, tnet, x):
    """Train and eval forwards from the JAX init's weights and statistics;
    the port's statistics after its train pass against JAX's."""
    variables = jnet.init(jax.random.key(0), jnp.asarray(x), train=False)
    params, stats = to_np(variables["params"]), to_np(variables.get("batch_stats", {}))
    tnet.load_state_dict(convert.flax_to_state_dict(params, stats), strict=True)
    out, upd = jnet.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = tnet(nchw(x), "train")
    outs = out if isinstance(out, list) else [out]
    gots = got if isinstance(got, list) else [got]
    assert len(outs) == len(gots)
    for t, j in zip(gots, outs):
        close_scaled(t, np.asarray(j).transpose(0, 3, 1, 2))
    want = convert.flax_to_state_dict(params, to_np(upd["batch_stats"]))
    for key, value in tnet.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-4, atol=5e-5,
                                   err_msg=key)
    variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
    out = jnet.apply(variables, jnp.asarray(x), train=False)
    got = tnet(nchw(x), "eval")
    for t, j in zip(got if isinstance(got, list) else [got], out if isinstance(out, list) else [out]):
        close_scaled(t, np.asarray(j).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("network_type", ZOO)
def test_zoo_networks_match_jax(network_type):
    x, _ = inputs()
    check_forward(jbs.build_network(network_type, 4), tbs.build_network(network_type, 4), x)


@pytest.mark.parametrize("name", ["ResConvUNet_attention", "UNetv2", "DeeplySupervisedUNet"])
def test_other_baseline_networks_match_jax(name):
    """The self-attention's gate is zero at init; it is set to 0.5 so that
    the attention reaches the output."""
    x, _ = inputs(1)
    if name == "ResConvUNet_attention":
        jnet = jbl.ResConvUNet(num_classes=4, feature_scale=4, self_attention=True)
        tnet = tbl.ResConvUNet(4, feature_scale=4, self_attention=True)
        variables = jnet.init(jax.random.key(0), jnp.asarray(x), train=False)
        variables = {**variables, "params": {**variables["params"], "self_attn": {
            **variables["params"]["self_attn"], "gamma": jnp.asarray(0.5)}}}
        jnet = _Fixed(jnet, variables)
    elif name == "UNetv2":
        jnet, tnet = jun.UNetv2(num_classes=4, feature_reduce=4), tun.UNetv2(4, 4)
    else:
        jnet = jun.DeeplySupervisedUNet(num_classes=4, feature_reduce=4)
        tnet = tun.DeeplySupervisedUNet(4, 4)
    check_forward(jnet, tnet, x)


class _Fixed:
    """A flax module whose ``init`` returns the given variables."""

    def __init__(self, module, variables):
        self.module, self.variables = module, variables

    def init(self, *a, **kw):
        return self.variables

    def apply(self, *a, **kw):
        return self.module.apply(*a, **kw)


@pytest.mark.parametrize("network_type", ZOO)
def test_one_step_with_adam_and_ema_matches_jax(network_type):
    x, label = inputs(2)
    jm = jbs.SegmentationModel(network_type, num_classes=4, lr=LR, use_ema=True)
    state = jm.init_state(jax.random.key(0), (HW, HW), batch_size=N)
    params0, stats0 = to_np(state.params), to_np(state.batch_stats)
    new_state, metrics = jm.make_train_step()(state, {"image": jnp.asarray(x),
                                                      "label": jnp.asarray(label)},
                                              jax.random.key(1))

    tm = tbs.SegmentationModel(network_type, num_classes=4, lr=LR, use_ema=True, device="cpu")
    before = convert.flax_to_state_dict(params0, stats0)
    tstate = tm.init_state(state_dict=before)
    tstate, tmetrics = tm.make_train_step()(tstate, {"image": torch.from_numpy(x),
                                                     "label": torch.from_numpy(label)})
    np.testing.assert_allclose(float(tmetrics["loss"]), float(metrics["loss"]), rtol=1e-4)
    assert tstate.step == 1
    after = convert.flax_to_state_dict(to_np(new_state.params), to_np(new_state.batch_stats))
    ema = convert.flax_to_state_dict(to_np(new_state.ema_params))
    sd = tstate.network.state_dict()
    ours, theirs = [], []
    for key, want in after.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), want.numpy(), rtol=1e-4, atol=5e-5,
                                       err_msg=key)
            continue
        assert float((sd[key] - want).abs().max()) <= 2.1 * LR + 1e-6, key
        assert float((tstate.ema_params[key] - ema[key]).abs().max()) <= 2.1 * LR + 1e-6, key
        ours.append((sd[key] - before[key]).double().flatten())
        theirs.append((want - before[key]).double().flatten())
    a, b = torch.cat(ours), torch.cat(theirs)
    assert float(a @ b / (a.norm() * b.norm())) > 0.95
    # predict on JAX's stepped weights, statistics and EMA weights
    pstate = tm.init_state(state_dict=after)
    pstate.ema_params = {k: ema[k] for k in pstate.ema_params}
    for use_ema in (False, True):
        want = jm.predict(new_state, jnp.asarray(x), softmax=True, use_ema=use_ema)
        got = tm.predict(pstate, torch.from_numpy(x), softmax=True, use_ema=use_ema)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_build_network_names_and_channel_plans():
    assert isinstance(tbs.build_network("UNet_64", 4), tun.UNet)
    assert isinstance(tbs.build_network("FCN_64", 2), tbl.FCN)
    assert isinstance(tbs.build_network("ResConvUNet_16", 4), tbl.ResConvUNet)
    wide = tbs.build_network("UNet_64", 4)
    assert wide.encoder.inc.conv1.weight.shape == (64, 1, 3, 3)
    assert tbs.build_network("UNet_16", 4).encoder.inc.conv1.weight.shape == (16, 1, 3, 3)
    with pytest.raises(ValueError):
        tbs.build_network("UNet", 4)
    with pytest.raises(NotImplementedError):
        tbs.build_network("VNet_16", 4)
