"""DS_FCN (domain-specific BatchNorm) in the port against the JAX package.

* ``TorchSNConv3x3``, the spectral-norm conv1 of the domain-specific down
  blocks, at an odd size: outputs in the three modes, u and v after a
  "train" pass (one power iteration written back) and a "frozen" one (the
  iteration runs, nothing is written), and the gradients of the input, the
  weight (with the quotient-rule term of W / sigma) and the bias. Outputs
  and u/v at rtol 1e-5 / atol 1e-6 (one small layer), gradients at rtol
  1e-4 / atol 1e-5 of the largest.
* ``DomainSpecificNorm2d``: a "train" pass on domain d moves only
  ``bn_domain{d}``'s statistics, to JAX's (rtol 1e-5).
* The solver on DS_FCN_16_standard at 64x64, batch 4, from converted
  weights: both codes for domains 0 and 1 in every BatchNorm mode, the
  hard-example pass (domain 1 in "train" mode: losses, BatchNorm statistics
  and SN vectors, gradients), and one whole ``make_train_step`` step with
  MaxStyle (n_iter=1, at test_torch_port_train_step's 32x32). The bars are
  test_torch_port_model's and test_torch_port_train_step's: forwards rtol
  1e-4 / atol 5e-5, losses rtol 1e-4 (2e-3 in the whole step's hard
  example), statistics rtol 1e-4 / atol 5e-5. The hard-example losses
  include the STN's refinement, so the gradients are held as
  tests/test_torch_port_stn.py holds the STN's
  (``test_torch_port_grad_bars.assert_grads_match``: the port's float64
  gradients against JAX's float64 ones, the float32 gaps against JAX's own
  distance from float64). The solver
  tests run at 64x64: at 32x32 (16 values a channel in the deepest
  BatchNorms) JAX's single-pass variance puts its encoder's float32
  gradients 0.48 of the largest away from float64 on this input (measured),
  while the port's stay within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.config import (DataConfig, ExperimentConfig, LearningConfig,
                                 MaxStyleConfig, SegmentationModelConfig)
from maxstyle_tpu.models import layers as jl
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.models import layers as tl
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver
from tests.test_torch_port_grad_bars import assert_grads_match, jax_grads, port_grads
from tests.test_torch_port_train_step import assert_port_step_matches, config, jax_step

torch.set_num_threads(2)

HW, N = 64, 4
FWD = dict(rtol=1e-4, atol=5e-5)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@pytest.mark.parametrize("mode", ["train", "frozen", "eval"])
def test_sn_conv_matches_jax_in_every_mode(mode):
    rng = np.random.RandomState(5)
    cin, cout = 4, 5
    x = rng.randn(2, 7, 9, cin).astype(np.float32)
    g = rng.randn(2, 7, 9, cout).astype(np.float32)
    params = {"kernel": (0.3 * rng.randn(3, 3, cin, cout)).astype(np.float32),
              "bias": (0.1 * rng.randn(cout)).astype(np.float32)}
    u0 = rng.randn(cout).astype(np.float32)
    v0 = rng.randn(cin * 9).astype(np.float32)
    stats = {"u": u0 / np.linalg.norm(u0), "v": v0 / np.linalg.norm(v0)}
    mod = jl.TorchSNConv3x3(cout)

    def j_loss(p, xx):
        if mode == "eval":
            out = mod.apply({"params": p, "batch_stats": stats}, xx, train=False)
            new = stats
        else:
            out, upd = mod.apply({"params": p, "batch_stats": stats}, xx, train=True,
                                 mutable=["batch_stats"])
            new = upd["batch_stats"] if mode == "train" else stats
        return jnp.sum(out * g), (out, new)

    (_, (jout, jstats)), (jgp, jgx) = jax.value_and_grad(j_loss, argnums=(0, 1),
                                                          has_aux=True)(params, jnp.asarray(x))

    conv = tl.TorchSNConv3x3(cin, cout)
    conv.load_state_dict(convert.flax_to_state_dict(params, stats), strict=True)
    tx = nchw(x).requires_grad_(True)
    out = conv(tx, mode)
    (out * nchw(g)).sum().backward()
    tight = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout).transpose(0, 3, 1, 2),
                               **tight)
    for key in ("u", "v"):
        np.testing.assert_allclose(getattr(conv, key).numpy(), np.asarray(jstats[key]), **tight)
        if mode != "train":
            np.testing.assert_array_equal(getattr(conv, key).numpy(), stats[key])
    want = convert.flax_to_state_dict(to_np(jgp))
    for got, w in ((conv.weight.grad, want["weight"]), (conv.bias.grad, want["bias"]),
                   (tx.grad, nchw(jgx))):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))


def test_sn_conv_eval_uses_the_stored_vectors_and_train_normalizes_them():
    """After a "train" pass u and v are unit vectors and sigma = u.(W v)
    estimates the largest singular value of the weight matrix from below."""
    torch.manual_seed(0)
    conv = tl.TorchSNConv3x3(3, 6)
    x = torch.randn(2, 3, 8, 8)
    for _ in range(30):
        conv(x, "train")
    assert abs(float(conv.u.norm()) - 1) < 1e-5 and abs(float(conv.v.norm()) - 1) < 1e-5
    w = conv.weight.detach().reshape(6, -1)
    sigma = float(conv.u @ (w @ conv.v))
    top = float(torch.linalg.matrix_norm(w, ord=2))
    assert sigma <= top * (1 + 1e-5) and sigma > 0.99 * top
    before = (conv.u.clone(), conv.v.clone())
    conv(x, "eval")
    conv(x, "frozen")
    assert torch.equal(conv.u, before[0]) and torch.equal(conv.v, before[1])


@pytest.mark.parametrize("domain", [0, 1])
def test_domain_specific_norm_trains_only_its_domain(domain):
    rng = np.random.RandomState(domain)
    x = (1.5 * rng.randn(3, 5, 4, 6) + 0.3).astype(np.float32)
    mod = jl.DomainSpecificNorm2d(2)
    variables = mod.init(jax.random.key(1), jnp.asarray(x), domain_id=domain, train=False)
    out, upd = mod.apply(variables, jnp.asarray(x), domain_id=domain, train=True,
                         mutable=["batch_stats"])
    norm = tl.DomainSpecificNorm2d(2, 6)
    norm.load_state_dict(convert.flax_to_state_dict(to_np(variables["params"]),
                                                    to_np(variables["batch_stats"])))
    before = {k: v.clone() for k, v in norm.state_dict().items()}
    tout = norm(nchw(x), "train", domain)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    want = convert.flax_to_state_dict(to_np(variables["params"]), to_np(upd["batch_stats"]))
    for key, value in norm.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-6)
        moved = not torch.equal(value, before[key])
        assert moved == (key.startswith(f"bn_domain{domain}.running")), key


def ds_config(max_style=False, n_iter=1):
    return ExperimentConfig(
        data=DataConfig(crop_size=(HW, HW, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(network_type="DS_FCN_16_standard",
                                                   num_classes=4),
        learning=LearningConfig(lr=1e-4, batch_size=N, optimizer_type="AdamW",
                                max_style=max_style),
        max_style=MaxStyleConfig(n_iter=n_iter))


@pytest.fixture(scope="module")
def pair():
    cfg = ds_config()
    js = JSolver(cfg)
    state = js.init_state(jax.random.key(0), (HW, HW), batch_size=N)
    params, stats = to_np(state.params), to_np(state.batch_stats)
    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    rng = np.random.RandomState(0)
    x = rng.rand(N, HW, HW, 1).astype(np.float32)
    label = rng.randint(0, 4, (N, HW, HW)).astype(np.int32)
    return js, params, stats, ts, x, label


def fresh(pair):
    _, params, stats, ts, _, _ = pair
    return ts.init_state(state_dicts=convert.convert_train_state(params, stats)).modules


def test_ds_modules_have_domain_norms_and_sn_convs(pair):
    nets = fresh(pair)
    enc = nets["image_encoder"].general_encoder
    assert isinstance(enc.final_norm, tl.DomainSpecificNorm2d)
    assert isinstance(enc.inc.norm1, tl.DomainSpecificNorm2d)
    assert all(isinstance(getattr(enc, f"down{i}").conv1, tl.TorchSNConv3x3)
               for i in range(1, 5))
    assert isinstance(nets["image_encoder"].code_decoupler.norm1, tl.BatchNorm)


@pytest.mark.parametrize("domain", [0, 1])
@pytest.mark.parametrize("mode", ["train", "frozen", "eval"])
def test_ds_encoder_codes_match_jax(pair, mode, domain):
    """"eval" runs after one "train" pass on the same domain: with the
    init's statistics and unit-norm random u, v the eval forward grows to
    ~1e5 and compares only to its conditioning."""
    js, params, stats, ts, x, _ = pair
    nets = fresh(pair)
    if mode == "eval":
        _, stats = js.encode_image(params, stats, jnp.asarray(x), mode="train",
                                   domain_id=domain)
        stats = to_np(stats)
        ts.encode_image(nets, nchw(x), mode="train", domain_id=domain)
    (z_i, z_s), new_stats = js.encode_image(params, stats, jnp.asarray(x), mode=mode,
                                            domain_id=domain)
    tz_i, tz_s = ts.encode_image(nets, nchw(x), mode=mode, domain_id=domain)
    np.testing.assert_allclose(tz_i.detach().numpy(), np.asarray(z_i).transpose(0, 3, 1, 2),
                               **FWD)
    np.testing.assert_allclose(tz_s.detach().numpy(), np.asarray(z_s).transpose(0, 3, 1, 2),
                               **FWD)
    want = convert.convert_train_state(params, to_np(new_stats))["image_encoder"]
    for key, value in nets["image_encoder"].state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), err_msg=key, **FWD)


def test_hard_example_pass_trains_domain_one(pair):
    """DS_FCN's hard-example pass runs domain 1 in "train" mode: its losses,
    every module's statistics afterwards (domain 0's unmoved) and the
    gradients of the summed losses match JAX's."""
    js, params, stats, ts, x, label = pair
    nets = fresh(pair)
    image = np.clip(x + 0.1 * np.random.RandomState(3).randn(*x.shape), 0, 1).astype(np.float32)

    def j_loss(p, dtype=jnp.float32):
        s = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), stats)
        out, new_stats = js.hard_example_training(
            p, s, jnp.asarray(image, dtype), jnp.asarray(x, dtype), jnp.asarray(label))
        return sum(out), (out, new_stats)

    (_, (jl_out, jstats)), jgrads = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))

    def port_run(n, dtype):
        out = ts.hard_example_training(n, nchw(image).to(dtype), nchw(x).to(dtype),
                                       torch.from_numpy(label).long())
        sum(out).backward()

    assert_grads_match(port_grads(nets, port_run),
                       jax_grads(lambda p, dtype: jax.grad(lambda q: j_loss(q, dtype)[0])(p),
                                 params, jgrads))
    before = {k: v.clone() for k, v in nets["image_encoder"].state_dict().items()}
    out = ts.hard_example_training(nets, nchw(image), nchw(x), torch.from_numpy(label).long())
    out = [o.detach() for o in out]
    for got, want in zip(out, jl_out):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-6)
    assert float(out[2]) > 0  # the STN's refinement of the prediction
    want_stats = convert.convert_train_state(params, to_np(jstats))
    for name, module in nets.items():
        sd = module.state_dict()
        for key, want in want_stats[name].items():
            if key.endswith(("running_mean", "running_var", ".u", ".v")):
                np.testing.assert_allclose(sd[key].numpy(), want.numpy(), err_msg=key, **FWD)
    moved = {k for k, v in nets["image_encoder"].state_dict().items()
             if not torch.equal(v, before[k])}
    assert moved and all(".bn_domain0." not in k for k in moved)
    assert any(".bn_domain1.running" in k for k in moved)
    # a branch's pass computes the same losses and writes nothing
    nets2 = fresh(pair)
    before2 = {n: {k: v.clone() for k, v in m.state_dict().items()} for n, m in nets2.items()}
    out2 = ts.hard_example_training(nets2, nchw(image), nchw(x), torch.from_numpy(label).long(),
                                    commit_stats=False)
    for a, b in zip(out2, out):
        assert float(a.detach()) == float(b)
    for n, m in nets2.items():
        assert all(torch.equal(v, before2[n][k]) for k, v in m.state_dict().items())


def test_one_ds_fcn_step_with_maxstyle_matches_jax():
    """The whole step (standard pass on domain 0, MaxStyle, hard-example
    pass training domain 1) against JAX's, at test_torch_port_train_step's
    bars: BatchNorm statistics of both domains and the SN vectors included,
    at rtol 2e-4 instead of 1e-4, since DS_FCN's hard-example pass also
    writes them."""
    base = config(n_iter=1)
    cfg = dataclasses.replace(base, segmentation_model=dataclasses.replace(
        base.segmentation_model, network_type="DS_FCN_16_standard"))
    r = jax_step(cfg, init_cfg=cfg)
    assert r["metrics"]["loss/hard/shape"] > 0 and r["metrics"]["loss/standard/gt_shape"] > 0
    # the hard-example pass writes the statistics of the stylized image,
    # which holds to the hard-example bar (2e-3): momentum 0.1 of it is 2e-4
    assert_port_step_matches(r, stats_rtol=2e-4)
