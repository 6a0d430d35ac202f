"""EMA, the LR schedules and SGD (``maxstyle_tpu_torch/utils/ema.py`` and
``solver.make_optimizer``) against the JAX package's optax versions.

* every ``make_lr_schedule`` policy at counts 0-30 (and a few beyond the
  warm-start thresholds): equal to optax's values bit for bit (the port
  computes them on the host in float32 with optax's operations);
* ``ema_update`` with and without the warm-up decay: bit for bit;
* SGD(momentum 0.99) + StepLR(5, 0.5) with ``steps_per_epoch=1`` over 12
  updates against optax.sgd on the same schedule: the learning rate of each
  update equal, the parameters at rtol 1e-6 (torch's update may fuse a
  multiply-add that optax rounds twice); a checkpoint restored mid-way
  resumes the schedule at its step;
* two whole training steps of an SGD config (FCN_16_standard_no_STN, lr
  1e-2, no MaxStyle — see ``sgd_config``) on the recipe of
  test_torch_port_train_step.py (40 -> 32, the noisy input pinned): the
  losses of both steps at rtol 1e-4, and each module's update of each step
  against JAX's with cosine > 0.9999 and every element within 2% of the
  module's largest update (measured: 0.99999 and 0.4%).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maxstyle_tpu.data import augment as JA
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu.solver import make_optimizer as j_make_optimizer
from maxstyle_tpu.train_step import make_train_step as j_make_train_step
from maxstyle_tpu.utils import ema as jema
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver
from maxstyle_tpu_torch.solver import make_optimizer
from maxstyle_tpu_torch.train_step import LOSS_KEYS, make_train_step
from maxstyle_tpu_torch.utils import checkpoint as ckpt
from maxstyle_tpu_torch.utils import ema as tema
from tests.test_torch_port_train_step import CROP, HALF, PAD, config, to_np

torch.set_num_threads(2)

POLICIES = [("constant", {}), ("step", {"lr_decay_epochs": 2, "steps_per_epoch": 3,
                                        "total_epochs": 12}),
            ("step2", {"lr_decay_epochs": 3, "steps_per_epoch": 2, "total_epochs": 20}),
            ("step", {"gamma": 0.3, "lr_decay_epochs": 1, "steps_per_epoch": 4,
                      "total_epochs": 9}),
            ("lambda", {"steps_per_epoch": 3, "total_epochs": 10}),
            ("step_warmstart", {"steps_per_epoch": 2}),
            ("step_warmstart2", {"steps_per_epoch": 1})]
COUNTS = list(range(31)) + [49, 50, 99, 100, 150, 199, 200, 250, 401]


@pytest.mark.parametrize("policy,kw", POLICIES, ids=[f"{p}{i}" for i, (p, _) in
                                                      enumerate(POLICIES)])
def test_lr_schedules_equal_optax(policy, kw):
    base = 3e-3
    jsched = jema.make_lr_schedule(policy, base, **kw)
    tsched = tema.make_lr_schedule(policy, base, **kw)
    for c in COUNTS:
        want = float(np.float32(jsched if policy == "constant" else jsched(jnp.int32(c))))
        got = tsched(c)
        assert got == want, (policy, c, got, want)


@pytest.mark.parametrize("num_updates", [None, 1, 2, 7, 50, 5000])
def test_ema_update_equals_jax(num_updates):
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(7, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    ema = {k: v + rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
    want = jema.ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                           {k: jnp.asarray(v) for k, v in params.items()},
                           decay=0.99, num_updates=num_updates)
    tinit = tema.ema_init({k: torch.from_numpy(v) for k, v in ema.items()})
    got = tema.ema_update(tinit, {k: torch.from_numpy(v) for k, v in params.items()},
                          decay=0.99, num_updates=num_updates)
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert tinit["a"].data_ptr() != torch.from_numpy(ema["a"]).data_ptr()


def test_sgd_with_steplr_follows_optax():
    lr, n = 0.05, 12
    rng = np.random.RandomState(1)
    w0 = rng.randn(6).astype(np.float32)
    grads = [rng.randn(6).astype(np.float32) for _ in range(n)]
    tx = j_make_optimizer("SGD", lr, steps_per_epoch=1, n_epochs=n)
    jsched = jema.make_lr_schedule("step", lr, lr_decay_epochs=5, steps_per_epoch=1,
                                   total_epochs=n)
    w, opt_state, jw = jnp.asarray(w0), None, []
    opt_state = tx.init(w)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, w)
        w = optax.apply_updates(w, updates)
        jw.append(np.asarray(w))

    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt, sched = make_optimizer("SGD", [p], lr, steps_per_epoch=1, n_epochs=n)
    assert opt.param_groups[0]["momentum"] == 0.99
    for i, g in enumerate(grads):
        assert opt.param_groups[0]["lr"] == float(np.float32(jsched(jnp.int32(i)))), i
        p.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        np.testing.assert_allclose(p.detach().numpy(), jw[i], rtol=1e-6, atol=1e-7)
    assert opt.param_groups[0]["lr"] == float(np.float32(lr) * np.float32(0.25))
    # no schedule without a step count, as in the JAX package's solver
    assert make_optimizer("SGD", [p], lr)[1] is None


def test_a_restored_sgd_state_resumes_its_schedule(tmp_path):
    cfg = tconfig.ExperimentConfig.from_dict(dataclasses.asdict(config(n_iter=1)))
    cfg = dataclasses.replace(cfg, learning=dataclasses.replace(cfg.learning,
                                                                optimizer_type="SGD", lr=0.01))
    ts = TSolver(cfg, device="cpu")
    state = ts.init_state(0, steps_per_epoch=2)
    assert set(state.schedulers) == set(state.modules)
    state.step = 13
    ckpt.save_checkpoint(str(tmp_path), "interrupted", state)
    restored, _ = ckpt.load_checkpoint(str(tmp_path), "interrupted",
                                       ts.init_state(1, steps_per_epoch=2))
    want = tema.make_lr_schedule("step", 0.01, lr_decay_epochs=5, steps_per_epoch=2,
                                 total_epochs=cfg.learning.n_epochs)
    for name, opt in restored.optimizers.items():
        assert restored.schedulers[name].last_epoch == 13
        assert opt.param_groups[0]["lr"] == want(13) == float(np.float32(0.01) * np.float32(0.5))


def sgd_config():
    """The recipe's config with SGD at lr 1e-2 and without MaxStyle. At the
    recipe's 1e-4 an SGD update is a few float32 ulps of its weight, so the
    difference of two weights would measure the rounding. MaxStyle's inner
    Adam takes lr*sign(g) on its first update, so rounding-size gradient
    differences of the first step flip style tensors in the second step's
    generation (its hard-example loss moves by 8e-4 in JAX itself when the
    input moves by 1e-6)."""
    cfg = config()
    return dataclasses.replace(cfg, learning=dataclasses.replace(
        cfg.learning, lr=1e-2, optimizer_type="SGD", max_style=False))


@pytest.fixture(scope="module")
def two_steps():
    cfg = sgd_config()
    solver = JSolver(cfg, maxstyle_backend="pallas")
    state = solver.init_state(jax.random.key(0), (CROP, CROP), batch_size=2 * HALF)
    params0, stats0 = to_np(state.params), to_np(state.batch_stats)
    rng = np.random.RandomState(0)
    raw_img = np.clip(0.5 + 0.25 * rng.randn(HALF, PAD, PAD), 0, 1).astype(np.float32)
    raw_lab = rng.randint(0, 4, (HALF, PAD, PAD)).astype(np.int32)
    policy = JA.get_policy("ACDC_affine_elastic_intensity", (PAD, PAD), (CROP, CROP))
    aug_i, aug_l = JA.augment_batch_inner(jax.random.key(1), jnp.asarray(raw_img),
                                          jnp.asarray(raw_lab), policy, warp_backend="pallas")
    org_i, org_l = JA.norm_batch(jnp.asarray(raw_img), jnp.asarray(raw_lab), (CROP, CROP))
    image = np.concatenate([np.asarray(aug_i), np.asarray(org_i)])
    label = np.concatenate([np.asarray(aug_l), np.asarray(org_l)]).astype(np.int32)
    noise = 0.05 * np.random.RandomState(2).randn(*image.shape).astype(np.float32)
    image_n = np.clip(image + noise, image.min(), image.max()).astype(np.float32)
    step = j_make_train_step(solver)
    jparams, jmetrics = [params0], []
    for k in range(2):
        state, m = step(state, {"image": jnp.asarray(image), "label": jnp.asarray(label)},
                        jax.random.key(3 + k),
                        overrides={"image_n": jnp.asarray(image_n)})
        jparams.append(to_np(state.params))
        jmetrics.append({k: float(v) for k, v in m.items()})

    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    tstate = ts.init_state(state_dicts=convert.convert_train_state(params0, stats0))
    assert not tstate.schedulers
    tstep = make_train_step(ts)
    tparams, tmetrics = [convert.convert_train_state(params0, stats0)], []
    for k in range(2):
        tstate, m = tstep(tstate, {"image": torch.from_numpy(image),
                                   "label": torch.from_numpy(label)},
                          torch.Generator().manual_seed(k),
                          overrides={"image_n": torch.from_numpy(image_n)})
        tparams.append({name: {n: t.clone() for n, t in mod.state_dict().items()}
                        for name, mod in tstate.modules.items()})
        tmetrics.append({k: float(v) for k, v in m.items()})
    return jparams, jmetrics, tparams, tmetrics, stats0


def test_two_sgd_steps_losses_match_jax(two_steps):
    _, jmetrics, _, tmetrics, _ = two_steps
    for jm, tm in zip(jmetrics, tmetrics):
        for key in LOSS_KEYS + ("loss/total",):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-4, atol=1e-6, err_msg=key)


def test_two_sgd_steps_updates_match_jax(two_steps):
    jparams, _, tparams, _, stats0 = two_steps
    jsd = [convert.convert_train_state(p, stats0) for p in jparams]
    for k in (1, 2):
        for name in tparams[0]:
            ours, theirs = [], []
            for key, want in jsd[k][name].items():
                if key.endswith(("running_mean", "running_var")):
                    continue
                ours.append((tparams[k][name][key] - tparams[k - 1][name][key]).double().flatten())
                theirs.append((want - jsd[k - 1][name][key]).double().flatten())
            a, b = torch.cat(ours), torch.cat(theirs)
            cos = float(a @ b / (a.norm() * b.norm() + 1e-30))
            err = float((a - b).abs().max() / b.abs().max())
            assert cos > 0.9999 and err < 2e-2, f"step {k} {name}: cosine {cos:.5f}, err {err:.2e}"
