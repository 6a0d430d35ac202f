"""The port's device-resident training (``maxstyle_tpu_torch/data/device_data.py``)
against the JAX package's.

* ``_pack_slices`` of a slice dataset, and of a concatenation of two, equal
  to JAX's bit for bit, and ``DeviceDataset.from_slice_dataset`` equal to
  the per-slice loop.
* One call of ``make_device_train_loop`` with K=2 steps on the recipe of
  test_torch_port_train_step.py (FCN_16_standard_no_STN, ACDC policy,
  40 -> 32, AdamW 1e-4, half-batch 2 from 6 resident slices) against JAX's
  loop from the same weights. JAX draws everything from its key chain; the
  port gets the same numbers through ``overrides``, rebuilt from that chain
  as tests/torch_port_branch_steps.py does: each step's indices
  (``permutation(k_idx, n)[:half]``), augmentation draws, noisy input and
  MaxStyle initial styles. MaxStyle runs with n_iter 0 (the drawn styles
  decode the hard example; test_torch_port_train_step.py holds the inner
  loop): with JAX's own drawn styles the inner Adam's first update,
  lr*sign(g), turns rounding-size gradient differences into 0.1 steps of
  style tensors, and one iteration already moves the hard-example loss by
  1.6e-3 and the update cosines to 0.90-0.96 (measured). Compared: the
  K-step mean of each loss (standard rtol 1e-4, hard-example and total
  rtol 2e-3, the bars of test_torch_port_train_step.py; measured 1e-5 and
  3.5e-5); the weights after the two AdamW steps (every element within two
  sign-flipped steps, 2 * 2.1 * lr + 1e-6; each module's update cosine
  > 0.95, measured 0.998); the BatchNorm running statistics at atol 2e-3
  (the second step's batch statistics come from weights that the first
  step moved differently by up to 2*lr where a gradient is at rounding
  size; measured 7.9e-4).
* Without overrides, each step's indices are distinct and drawn on the
  tensors' device, and ``train_device_resident`` trains.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu import prng as jprng
from maxstyle_tpu.data import augment as JA
from maxstyle_tpu.data import datasets as jds
from maxstyle_tpu.data import device_data as jdd
from maxstyle_tpu.ops import maxstyle as jms
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu.train_step import add_input_noise
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.data import augment as TA
from maxstyle_tpu_torch.data import datasets as tds
from maxstyle_tpu_torch.data import device_data as tdd
from maxstyle_tpu_torch.ops import maxstyle as tms
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver
from maxstyle_tpu_torch.train_step import LOSS_KEYS
from tests.test_data import make_synthetic_site
from tests.test_torch_port_augment import jax_draws
from tests.test_torch_port_train_step import CHANNELS, CROP, HALF, INDEXES, LR, PAD, config, to_np

torch.set_num_threads(2)
K, N_SLICES = 2, 6


def test_pack_slices_equals_the_jax_package(tmp_path):
    a = make_synthetic_site(str(tmp_path / "a"), n_patients=3, shape=(4, 36, 30))
    b = make_synthetic_site(str(tmp_path / "b"), n_patients=2, shape=(3, 44, 40), seed=1)
    for pad in (40, 32):
        jset = jds.build_general_dataset(a, "{pid}/img.nii.gz", "{pid}/seg.nii.gz",
                                         pad_hw=(pad, pad), crop_hw=(32, 32))
        tset = tds.build_general_dataset(a, "{pid}/img.nii.gz", "{pid}/seg.nii.gz",
                                         pad_hw=(pad, pad), crop_hw=(32, 32))
        jb = jds.build_general_dataset(b, "{pid}/img.nii.gz", "{pid}/seg.nii.gz",
                                       pad_hw=(pad, pad), crop_hw=(32, 32))
        tb = tds.build_general_dataset(b, "{pid}/img.nii.gz", "{pid}/seg.nii.gz",
                                       pad_hw=(pad, pad), crop_hw=(32, 32))
        for js, ts in ((jset, tset), (jds.ConcatSliceDataset([jset, jb]),
                                      tds.ConcatSliceDataset([tset, tb]))):
            want, got = jdd._pack_slices(js), tdd._pack_slices(ts)
            for w, g in zip(want, got):
                assert w.dtype == g.dtype and w.shape == g.shape
                np.testing.assert_array_equal(g, w)
            dds = tdd.DeviceDataset.from_slice_dataset(ts, device="cpu")
            assert len(dds) == len(ts) and dds.images.device.type == "cpu"
            for i in range(len(ts)):
                img, lab, _ = ts.get_raw_slice(i)
                np.testing.assert_array_equal(dds.images[i].numpy(), img)
                np.testing.assert_array_equal(dds.labels[i].numpy(), lab)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def port_style_init(params, state):
    """JAX's initial MaxStyle params/state ({idx: ...}) in the port's layout."""
    tp, tst = {}, {}
    for idx in params:
        p, s = params[idx], state[idx]
        tp[idx] = tms.MaxStyleParams(lmda=torch.from_numpy(np.array(p.lmda).reshape(-1, 1, 1, 1)),
                                     gamma_noise=nchw(p.gamma_noise),
                                     beta_noise=nchw(p.beta_noise))
        tst[idx] = tms.MaxStyleState(perm=torch.from_numpy(np.array(s.perm)),
                                     gate=torch.tensor(float(s.gate)),
                                     gamma_std=nchw(s.gamma_std), beta_std=nchw(s.beta_std))
    return tp, tst


@pytest.fixture(scope="module")
def loop_pair():
    cfg = config(n_iter=0)
    solver = JSolver(cfg, maxstyle_backend="pallas")
    state = solver.init_state(jax.random.key(0), (CROP, CROP), batch_size=2 * HALF)
    params0, stats0 = to_np(state.params), to_np(state.batch_stats)
    rng = np.random.RandomState(0)
    images = np.clip(0.5 + 0.25 * rng.randn(N_SLICES, PAD, PAD), 0, 1).astype(np.float32)
    labels = rng.randint(0, 4, (N_SLICES, PAD, PAD)).astype(np.int32)
    policy = JA.get_policy("ACDC_affine_elastic_intensity", (PAD, PAD), (CROP, CROP))
    run = jdd.make_device_train_loop(solver, policy, keep_orig=True, half_batch=HALF,
                                     steps_per_call=K)
    key = jax.random.key(5)
    new_state, metrics = run(state, jnp.asarray(images), jnp.asarray(labels), key)

    # the draws of each step, rebuilt from the loop's key chain
    indices, steps = [], []
    for sk in jax.random.split(key, K):
        k_idx, k_step = jax.random.split(sk)
        idx = jax.random.permutation(k_idx, N_SLICES)[:HALF]
        raw_i, raw_l = jnp.asarray(images)[idx], jnp.asarray(labels)[idx]
        k_aug, k_train = jax.random.split(k_step)
        aug_i, _ = JA.augment_batch_inner(k_aug, raw_i, raw_l, policy)
        org_i, _ = JA.norm_batch(raw_i, raw_l, (CROP, CROP))
        clean = jnp.concatenate([aug_i, org_i], 0)
        k = jprng.split_dict(k_train, ("noise", "maxstyle", "dropout", "branches"))
        image_n = add_input_noise(clean, k["noise"], "min_max")
        sp, st = {}, {}
        for sub, hook in zip(jax.random.split(k["maxstyle"], len(INDEXES)), INDEXES):
            sp[hook], st[hook] = jms.init_maxstyle(sub, 2 * HALF, CHANNELS[hook], cfg.max_style)
        indices.append(torch.from_numpy(np.array(idx)))
        steps.append({"aug_draws": jax_draws(jax.random.split(k_aug, HALF), policy),
                      "image_n": torch.from_numpy(np.array(image_n)),
                      "style_init": port_style_init(sp, st)})

    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    tstate = ts.init_state(state_dicts=convert.convert_train_state(params0, stats0))
    tpolicy = TA.get_policy("ACDC_affine_elastic_intensity", (PAD, PAD), (CROP, CROP))
    trun = tdd.make_device_train_loop(ts, tpolicy, keep_orig=True, half_batch=HALF,
                                      steps_per_call=K)
    tstate, tmetrics = trun(tstate, torch.from_numpy(images), torch.from_numpy(labels),
                            torch.Generator().manual_seed(0),
                            overrides={"indices": indices, "steps": steps})
    return dict(params0=params0, stats0=stats0, params1=to_np(new_state.params),
                stats1=to_np(new_state.batch_stats),
                metrics={k: float(v) for k, v in metrics.items()},
                tstate=tstate, tmetrics={k: float(v) for k, v in tmetrics.items()})


def test_loop_losses_match_jax(loop_pair):
    m, want = loop_pair["tmetrics"], loop_pair["metrics"]
    assert set(m) == set(want) == set(LOSS_KEYS) | {"loss/total"}
    assert m["loss/hard/total"] > 0
    for key in LOSS_KEYS + ("loss/total",):
        rtol = 1e-4 if key.startswith("loss/standard") else 2e-3
        np.testing.assert_allclose(m[key], want[key], rtol=rtol, atol=1e-6, err_msg=key)


def test_loop_weights_match_jax(loop_pair):
    r = loop_pair
    before = convert.convert_train_state(r["params0"], r["stats0"])
    after = convert.convert_train_state(r["params1"], r["stats1"])
    for name, module in r["tstate"].modules.items():
        sd = module.state_dict()
        ours, theirs = [], []
        for key, want in after[name].items():
            got = sd[key]
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-3,
                                           err_msg=f"{name}.{key}")
                continue
            diff = float((got - want).abs().max())
            assert diff <= 2 * 2.1 * LR + 1e-6, f"{name}.{key}: weight diff {diff:.2e}"
            ours.append((got - before[name][key]).double().flatten())
            theirs.append((want - before[name][key]).double().flatten())
        a, b = torch.cat(ours), torch.cat(theirs)
        cos = float(a @ b / (a.norm() * b.norm() + 1e-12))
        assert cos > 0.95, f"{name}: update cosine {cos:.4f}"
    assert r["tstate"].step == K


def test_indices_are_distinct_within_a_step_and_the_loop_trains(monkeypatch):
    seen = []

    def fake_fused(solver, policy, keep_orig):
        def fused(state, raw, generator, overrides=None):
            seen.append(raw["image"][:, 0, 0].long().tolist())
            state.step += 1
            return state, {"loss/total": raw["image"].mean()}
        return fused

    import maxstyle_tpu_torch.train_step as tstep
    monkeypatch.setattr(tstep, "make_fused_train_step", fake_fused)
    n = 9
    images = torch.arange(n, dtype=torch.float32)[:, None, None].expand(n, 4, 4).contiguous()
    run = tdd.make_device_train_loop(None, None, True, half_batch=6, steps_per_call=25)
    state = type("S", (), {"step": 0})()
    state, m = run(state, images, images.int(), torch.Generator().manual_seed(1))
    assert state.step == 25 and len(seen) == 25
    assert all(len(set(s)) == 6 and set(s) <= set(range(n)) for s in seen)
    assert len({tuple(s) for s in seen}) > 20
    monkeypatch.undo()

    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(config(n_iter=1))),
                 device="cpu")
    tstate = ts.init_state(1)
    g = torch.Generator().manual_seed(2)
    ds = tdd.DeviceDataset(torch.rand((5, PAD, PAD), generator=g),
                           torch.randint(0, 4, (5, PAD, PAD), generator=g, dtype=torch.int32))
    w0 = tstate.modules["image_encoder"].general_encoder.inc.conv1.weight.detach().clone()
    calls = []
    policy = TA.get_policy("ACDC_affine_elastic_intensity", (PAD, PAD), (CROP, CROP))
    tstate, m = tdd.train_device_resident(ts, tstate, ds, policy, True, HALF, total_steps=3,
                                          generator=g, steps_per_call=2,
                                          log_fn=lambda c, mm: calls.append(c))
    assert calls == [0, 1] and tstate.step == 4
    assert all(np.isfinite(float(v)) for v in m.values())
    assert not torch.equal(w0, tstate.modules["image_encoder"].general_encoder.inc.conv1.weight)
