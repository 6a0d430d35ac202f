"""Data parallelism (``parallel/mesh.py``) in CPU processes over gloo,
against the port's single process on the global batch, and against the JAX
package's sharded standard step.

Worlds of 2 and 4 processes, started with ``spawn`` and a ``file://`` store
under the test's directory (as ``test_torch_port_unetr_tp.py`` starts its
worlds), run every case of one world in the same processes and write their
results; each test holds one case. The cases:

* one fused MaxStyle step (``make_fused_train_step``: 8 raw 40^2 slices
  augmented to 32^2 and paired with their originals, global effective
  batch 16, n_iter 2, dropout 0.1 after every block) at worlds 2 and 4;
* one fused step of each other method branch at world 2: MixStyle, DSU,
  LSM (latent_DA), RSC, RandConv, AdvNoise and AdvBias;
* one grouped MaxStyle step (``make_train_step`` on a batch of 16,
  ``style_group_size`` 8, so each style group spans two ranks of the world
  of 4, as ``tests/test_sharding.py:83-119`` spans its devices), with
  n_iter 2 and with n_iter 0;
* the standard step of ``tests/test_sharding.py:57-81`` (batch 8 at 32^2,
  the JAX package's seed-0 weights) at world 2, held against the JAX
  package's step sharded over its 8-virtual-device mesh;
* ``evaluate.TestSegmentationNetwork(mesh=...)``'s labels at world 2.

Every draw is injected: the augmentation's (each rank the rows of its raw
shard), the noisy input, the style tensors, the dropout masks and the
branches' draws, so both sides see one global batch. The single process
orders the fused batch [aug | orig]; a world orders it rank-major,
[aug_0 | orig_0 | aug_1 | orig_1 | ...] (``parallel/mesh.py``), so the
draws with a row (style tensors, masks, MixStyle mixing weights and noise)
are moved to their row's place and the permutations are conjugated by the
same map. Compared, with these bars:

* every loss: rtol 2e-4 (``tests/test_sharding.py:81``'s);
* every updated weight: within 2.1 * lr + 1e-6 of the single process's
  (Adam's first step moves a weight by about lr * sign(g), and a gradient
  of rounding size can flip its sign), and each module's update with
  cosine > 0.995 against the single process's, or > 0.95 after a MaxStyle
  inner loop. The gradients themselves are only as stable as float32
  makes them here: the same single process with the data group's
  BatchNorm formula (world 1, no collectives) moves the encoder's gradient
  by 6e-4 of its norm, measured; the worlds' MixStyle, DSU and n_iter-0
  steps stay within that noise (update cosines 0.998-0.99998, measured).
  The inner loop's Adam steps are sign-like, so a rounding-size gap in a
  style gradient can flip a step of the stylized image, and the
  hard-example losses and gradients follow. With the configs' inner lr
  0.1 that moved the world of 4's hard loss by 9e-4 of itself (measured),
  past the loss bar, against 7e-8 with n_iter 0; so the cases run the
  inner loop at lr 0.01, where it moved it by 6e-5 (measured), and the
  n_iter-0 grouped case holds the style map without the loop;
* the BatchNorm running statistics: rtol 1e-4 / atol 1e-6;
* the style tensors after the inner loop (rows gathered and put back in
  the single process's order): within 2.1 * the inner lr * n_iter + 1e-6
  (the sign-like steps again), with cosine > 0.95 of the inner loop's
  whole update (0.02 the largest gap, measured).

A world of one is the single-device step: ``shard_train_step`` returns the
step itself and its results are bit-equal. Sharded prediction gives the
single process's labels.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch.data import augment as A
from maxstyle_tpu_torch.models.encoder_decoder import decoder_style_channels
from maxstyle_tpu_torch.models.layers import FixableDropout
from maxstyle_tpu_torch.ops import advchain
from maxstyle_tpu_torch.ops import latent_masking as lm
from maxstyle_tpu_torch.ops import maxstyle as ms
from maxstyle_tpu_torch.ops import randconv as rc
from maxstyle_tpu_torch.parallel import mesh
from maxstyle_tpu_torch.solver import TripletSegmentationSolver

PAD, CROP, RAW = 40, 32, 8
LR = 1e-4
RATE = 0.1
N_ITER = 2
STYLE_LR = 0.01  # the inner loop's Adam lr (module docstring)
INDEXES = (3, 4, 5)
JOIN_TIMEOUT = 150  # seconds; a world runs its cases in ~20 s
POLICY = "ACDC_affine_elastic_intensity"
# the method branches held at world 2: case name -> LearningConfig flag
BRANCHES = {"mixstyle": "mix_style", "dsu": "DSU", "lsm": "latent_DA", "rsc": "RSC",
            "randconv": "rand_conv", "adv_noise": "adv_noise", "adv_bias": "adv_bias"}


def config(max_style=True, n_iter=N_ITER, group=None, rate=RATE, **learning):
    return tconfig.ExperimentConfig(
        data=tconfig.DataConfig(crop_size=(CROP, CROP, 1), pad_size=(PAD, PAD, 1),
                                num_classes=4, data_aug_policy=POLICY),
        segmentation_model=tconfig.SegmentationModelConfig(
            network_type="FCN_16_standard_no_STN", num_classes=4),
        learning=tconfig.LearningConfig(lr=LR, batch_size=2 * RAW, optimizer_type="AdamW",
                                        max_style=max_style, encoder_dropout=rate,
                                        decoder_dropout=rate, **learning),
        max_style=tconfig.MaxStyleConfig(n_iter=n_iter, lr=STYLE_LR,
                                         decoder_layers_indexes=INDEXES,
                                         style_group_size=group))


def policy():
    return A.get_policy(POLICY, (PAD, PAD), (CROP, CROP))


# ---------------------------------------------------------------------------
# the global batch's two orders
# ---------------------------------------------------------------------------


def fused_order(world: int) -> np.ndarray:
    """sigma: the single process's row at each row of the world's global
    batch ([aug | orig] against rank-major [aug_r | orig_r])."""
    n = RAW // world
    order = []
    for r in range(world):
        order += [r * n + j for j in range(n)] + [RAW + r * n + j for j in range(n)]
    return np.asarray(order)


def reorder(t: torch.Tensor, sigma) -> torch.Tensor:
    return t[torch.as_tensor(sigma)]


def reorder_perm(perm: torch.Tensor, sigma) -> torch.Tensor:
    """A permutation of the single process's rows as one of the world's."""
    sigma = torch.as_tensor(sigma)
    inv = torch.empty_like(sigma)
    inv[sigma] = torch.arange(len(sigma))
    return inv[perm[sigma]]


def map_draws(ov, sigma):
    """The overrides of the single process's batch, moved to the order
    ``sigma``."""
    out = dict(ov)
    if "image_n" in ov:
        out["image_n"] = reorder(ov["image_n"], sigma)
    if "style_init" in ov:
        params, state = ov["style_init"]
        out["style_init"] = (
            {i: ms.MaxStyleParams(*(reorder(t, sigma) for t in p.tensors()))
             for i, p in params.items()},
            {i: dataclasses.replace(s, perm=reorder_perm(s.perm, sigma)) for i, s in
             state.items()})
    if "dropout_masks" in ov:
        out["dropout_masks"] = {k: reorder(v, sigma) for k, v in ov["dropout_masks"].items()}
    if "branch_draws" in ov:
        out["branch_draws"] = _map_rows(ov["branch_draws"], sigma)
    return out


def _map_rows(obj, sigma):
    """Branch draws moved to the order ``sigma``: every tensor with a row a
    sample of the batch reordered, every permutation ("perm") conjugated,
    the rest (scalars, RandConv's kernel) as they are."""
    if isinstance(obj, dict):
        return {k: reorder_perm(v, sigma) if k == "perm" else _map_rows(v, sigma)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_map_rows(v, sigma) for v in obj]
    if torch.is_tensor(obj) and obj.dim() and obj.shape[0] == len(sigma):
        return reorder(obj, sigma)
    return obj


# ---------------------------------------------------------------------------
# the cases' inputs
# ---------------------------------------------------------------------------


def raw_batch(seed=0):
    rng = np.random.RandomState(seed)
    img = np.clip(0.5 + 0.25 * rng.randn(RAW, PAD, PAD), 0, 1).astype(np.float32)
    return {"image": torch.from_numpy(img),
            "label": torch.from_numpy(rng.randint(0, 4, (RAW, PAD, PAD)).astype(np.int32))}


def dropout_masks(solver, n, seed=4):
    """A keep-mask [n,C,1,1] for every FixableDropout of ``solver``'s modules."""
    nets = solver.build_modules()
    g = torch.Generator().manual_seed(seed)
    masks = {}
    for name, m in nets.named_modules():
        if isinstance(m, FixableDropout):
            c = nets.get_submodule(name.rpartition(".")[0]).conv2.out_channels
            masks[name] = torch.rand((n, c, 1, 1), generator=g) < 1.0 - RATE
    assert masks
    return masks


def style_init(solver, cfg, n, seed=3):
    chans = decoder_style_channels(solver.spec.feature_reduce, 1)
    g = torch.Generator().manual_seed(seed)
    params, state = {}, {}
    for idx in INDEXES:
        params[idx], st = ms.init_maxstyle(g, n, chans[idx], cfg.max_style)
        state[idx] = dataclasses.replace(st, gate=torch.tensor(1.0))
    return params, state


def mixstyle_draws(solver, image, dsu, seed=6):
    """Draws of every hook of the MixStyle (1-3) or DSU (1-6) replay, the
    gate on."""
    nets = solver.build_modules()
    hooks = (1, 2, 3, 4, 5, 6) if dsu else (1, 2, 3)
    chans = {}

    def rec(i):
        def hook(v):
            chans[i] = v.shape[1]
            return v
        return hook

    with torch.no_grad():
        nets["image_encoder"].encode(image.permute(0, 3, 1, 2), "eval",
                                     {i: rec(i) for i in hooks})
    cfg = ms.MixStyleConfig(mix="gaussian" if dsu else "random")
    g = torch.Generator().manual_seed(seed)
    draws = {}
    for i in hooks:
        d = ms.draw_mixstyle(g, image.shape[0], chans[i], cfg)
        d["gate_u"] = torch.tensor(0.0)
        draws[i] = d
    return draws


def branch_draws(solver, cfg, image, flag, seed=21):
    """The draws of one step of branch ``flag`` for the batch ``image``."""
    if flag in ("mix_style", "DSU"):
        return mixstyle_draws(solver, image, flag == "DSU")
    nets = solver.build_modules()
    x = image.permute(0, 3, 1, 2)
    with torch.no_grad():
        z_i, z_s = solver.encode_image(nets, x, mode="eval")
    g = torch.Generator().manual_seed(seed)
    if flag == "latent_DA":
        c = cfg.latent_DA.image_code
        return {"image": lm.draw_masking(g, z_i.shape, c.mask_type, c.max_threshold)}
    if flag == "RSC":
        return {"image": lm.draw_masking(g, z_i.shape, "RSC", 1 / 3),
                "shape": lm.draw_masking(g, z_s.shape, "RSC", 1 / 3)}
    if flag == "rand_conv":
        return [rc.draw_rand_conv(g, 1) for _ in range(3)]
    draw = advchain.draw_adv_noise if flag == "adv_noise" else advchain.draw_adv_bias
    return draw(g, x.shape)


def fused_case(cfg, flag=None):
    """A fused step's inputs: the raw batch, the augmentation's draws and
    the single process's overrides."""
    solver = TripletSegmentationSolver(cfg, device="cpu")
    raw = raw_batch()
    pol = policy()
    aug = A.draw_aug(torch.Generator().manual_seed(1), pol, RAW)
    img, lab = A.augment_batch_inner(torch.Generator(), raw["image"], raw["label"], pol,
                                     draws=aug)
    oi, _ = A.norm_batch(raw["image"], raw["label"], (CROP, CROP))
    clean = torch.cat([img, oi])
    noise = 0.05 * torch.randn(clean.shape, generator=torch.Generator().manual_seed(2))
    ov = {"image_n": torch.clamp(clean + noise, clean.min(), clean.max()),
          "dropout_masks": dropout_masks(solver, 2 * RAW)}
    if cfg.learning.max_style:
        ov["style_init"] = style_init(solver, cfg, 2 * RAW)
    if flag is not None:
        ov["branch_draws"] = {flag: branch_draws(solver, cfg, clean, flag)}
    return {"kind": "fused", "cfg": cfg, "raw": raw, "aug_draws": aug, "overrides": ov}


def grouped_case(n_iter=N_ITER):
    cfg = config(group=8, rate=None, n_iter=n_iter)
    solver = TripletSegmentationSolver(cfg, device="cpu")
    g = torch.Generator().manual_seed(11)
    image = torch.rand((2 * RAW, CROP, CROP, 1), generator=g)
    label = torch.randint(0, 4, (2 * RAW, CROP, CROP), generator=g)
    noise = 0.05 * torch.randn(image.shape, generator=g)
    ov = {"image_n": torch.clamp(image + noise, image.min(), image.max()),
          "style_init": style_init(solver, cfg, 2 * RAW)}
    return {"kind": "base", "cfg": cfg, "batch": {"image": image, "label": label},
            "overrides": ov}


def for_world(case, world):
    """The case as a world of ``world`` ranks gets it."""
    case = dict(case)
    if case["kind"] == "fused":
        case["overrides"] = map_draws(case["overrides"], fused_order(world))
    return case


# ---------------------------------------------------------------------------
# running a case (in a worker, or in the test's own process)
# ---------------------------------------------------------------------------


def run_case(case, grid=None):
    """One step of ``case`` from seed-1 weights (or ``case["weights"]``),
    sharded over ``grid``'s data group; returns the metrics, the modules'
    state dicts and the style tensors of the rank's rows."""
    from maxstyle_tpu_torch.train_step import make_fused_train_step, make_train_step

    cfg = case["cfg"]
    solver = TripletSegmentationSolver(cfg, device="cpu")
    state = solver.init_state(seed=1, state_dicts=case.get("weights"))
    styles = {}
    plain = solver.generate_max_style_image

    def capture(*args, **kwargs):
        out, params = plain(*args, return_style=True, **kwargs)
        styles.update({i: [t.clone() for t in p.tensors()] for i, p in params.items()})
        return out

    solver.generate_max_style_image = capture
    ov = dict(case["overrides"])
    if case["kind"] == "fused":
        step = make_fused_train_step(solver, policy(), keep_orig=True)
        batch = mesh.shard_batch(case["raw"], grid)
        ov["aug_draws"] = mesh.shard_batch(case["aug_draws"], grid)
    else:
        step = make_train_step(solver)
        batch = mesh.shard_batch(case["batch"], grid)
    step = mesh.shard_train_step(step, grid)
    state, m = step(state, batch, torch.Generator().manual_seed(5), overrides=ov)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": {n: {k: v.clone() for k, v in mod.state_dict().items()}
                      for n, mod in state.modules.items()},
            "grads": {n: {k: p.grad.clone() for k, p in mod.named_parameters()}
                      for n, mod in state.modules.items()},
            "style": styles}


def predict_case(grid=None):
    from maxstyle_tpu_torch.evaluate import TestSegmentationNetwork

    solver = TripletSegmentationSolver(config(max_style=False, rate=None), device="cpu")
    state = solver.init_state(seed=1)

    class _DS:
        patient_ids = []

    h = TestSegmentationNetwork(solver, state, _DS(), maximum_batch_size=5,
                                crop_hw=(CROP, CROP), mesh=grid)
    vol = np.random.RandomState(0).rand(10, CROP, CROP).astype(np.float32)
    return {"chunk": h.chunk, "labels": h.predict_volume(vol)}


def _worker(rank, world, store, inputs, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        grid = mesh.make_mesh()
        cases = torch.load(inputs, weights_only=False)
        out = {name: (predict_case(grid) if case == "predict" else run_case(case, grid))
               for name, case in cases.items()}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(tmp_path, world, cases):
    d = tmp_path / f"world{world}"
    d.mkdir()
    torch.save(cases, d / "cases.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, str(d / "store"), str(d / "cases.pt"),
                                               str(d)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} of {world} processes still ran after {JOIN_TIMEOUT} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def assert_matches(ranks, ref, case, sigma, label):
    lr = case["cfg"].learning.lr
    chaotic = case["cfg"].learning.max_style and case["cfg"].max_style.n_iter > 0
    cos_bar = 0.95 if chaotic else 0.995
    for r in ranks:
        assert set(r["metrics"]) == set(ref["metrics"]), label
        for k, want in ref["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], want, rtol=2e-4, atol=1e-7,
                                       err_msg=f"{label}: {k}")
    before = TripletSegmentationSolver(case["cfg"], device="cpu").build_modules(seed=1)
    for name, want_sd in ref["state"].items():
        ours, theirs = [], []
        for key, want in want_sd.items():
            for r in ranks:  # every rank holds the same state
                assert torch.equal(r["state"][name][key], ranks[0]["state"][name][key]), key
            got = ranks[0]["state"][name][key]
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=f"{label}: {name}.{key}")
                continue
            if key.endswith(("num_batches_tracked", ".u", ".v")):
                continue
            diff = float((got - want).abs().max())
            assert diff <= 2.1 * lr + 1e-6, f"{label}: {name}.{key} diff {diff:.2e}"
            w0 = before[name].state_dict()[key]
            ours.append((got - w0).double().flatten())
            theirs.append((want - w0).double().flatten())
        a, b = torch.cat(ours), torch.cat(theirs)
        cos = float(a @ b / (a.norm() * b.norm() + 1e-12))
        assert cos > cos_bar, f"{label}: {name} update cosine {cos:.5f}"
    if not ref["style"]:
        return
    params0 = case["overrides"]["style_init"][0]
    bar = 2.1 * case["cfg"].max_style.lr * case["cfg"].max_style.n_iter + 1e-6
    for idx, want in ref["style"].items():
        for j, w in enumerate(want):
            got = torch.cat([r["style"][idx][j] for r in ranks])
            inv = np.argsort(sigma)
            got = got[torch.as_tensor(inv)]  # back to the single process's order
            diff = float((got - w).abs().max())
            assert diff <= bar, f"{label}: style {idx}[{j}] diff {diff:.2e}"
            w0 = params0[idx].tensors()[j]
            a, b = (got - w0).double().flatten(), (w - w0).double().flatten()
            if float(b.norm()) > 0:
                cos = float(a @ b / (a.norm() * b.norm()))
                assert cos > 0.95, f"{label}: style {idx}[{j}] update cosine {cos:.5f}"


@pytest.fixture(scope="module")
def cases():
    out = {"maxstyle": fused_case(config()),
           "grouped": grouped_case(), "grouped_n0": grouped_case(n_iter=0)}
    for name, flag in BRANCHES.items():
        out[name] = fused_case(config(max_style=False, **{flag: True}), flag)
    return out


@pytest.fixture(scope="module")
def single(cases):
    torch.set_num_threads(2)
    return {name: run_case(case) for name, case in cases.items()}


@pytest.fixture(scope="module")
def jax_standard():
    """tests/test_sharding.py:57-81's standard step, sharded over JAX's 8
    virtual devices, with its noisy input pinned: the batch, the port's
    weights of JAX's seed-0 init and the sharded step's metrics."""
    import jax
    import jax.numpy as jnp

    from maxstyle_tpu.parallel import mesh as pmesh
    from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
    from maxstyle_tpu.train_step import make_train_step as j_make_train_step
    from maxstyle_tpu_torch import convert
    from tests.test_train_step import small_config

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jcfg = small_config()
    solver = JSolver(jcfg)
    image = jnp.clip(jax.random.normal(jax.random.key(1), (8, 32, 32, 1)), 0, 1)
    label = jax.random.randint(jax.random.key(2), (8, 32, 32), 0, 4)
    noise = 0.05 * np.random.RandomState(2).randn(8, 32, 32, 1).astype(np.float32)
    img = np.asarray(image)
    image_n = np.clip(img + noise, img.min(), img.max()).astype(np.float32)
    state = solver.init_state(jax.random.key(0), (32, 32), batch_size=8)
    weights = convert.convert_train_state(jax.tree_util.tree_map(np.asarray, state.params),
                                          jax.tree_util.tree_map(np.asarray,
                                                                 state.batch_stats))
    raw = j_make_train_step(solver, jit_compile=False)

    def pinned(st, b, rng):
        return raw(st, b, rng, overrides={"image_n": jnp.asarray(image_n)})

    m = pmesh.make_mesh(8)
    step = pmesh.shard_train_step(pinned, m)
    _, metrics = step(pmesh.replicate(state, m),
                      pmesh.shard_batch({"image": image, "label": label}, m),
                      pmesh.replicate(jax.random.key(3), m))
    pcfg = tconfig.ExperimentConfig.from_dict(dataclasses.asdict(jcfg))
    case = {"kind": "base", "cfg": pcfg, "weights": weights,
            "batch": {"image": torch.from_numpy(img.copy()),
                      "label": torch.from_numpy(np.asarray(label))},
            "overrides": {"image_n": torch.from_numpy(image_n)}}
    return case, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def world2(cases, jax_standard, tmp_path_factory):
    todo = {k: for_world(cases[k], 2) for k in ("maxstyle",) + tuple(BRANCHES)}
    todo["standard"] = jax_standard[0]
    todo["predict"] = "predict"
    return run_world(tmp_path_factory.mktemp("dp"), 2, todo)


@pytest.fixture(scope="module")
def world4(cases, tmp_path_factory):
    todo = {"maxstyle": for_world(cases["maxstyle"], 4), "grouped": cases["grouped"],
            "grouped_n0": cases["grouped_n0"]}
    return run_world(tmp_path_factory.mktemp("dp"), 4, todo)


@pytest.mark.parametrize("name", ["maxstyle"] + list(BRANCHES))
def test_world_of_two_fused_step_matches_one_process(cases, single, world2, name):
    assert_matches([r[name] for r in world2], single[name], cases[name], fused_order(2),
                   f"world 2 {name}")


@pytest.mark.parametrize("name", ["maxstyle", "grouped", "grouped_n0"])
def test_world_of_four_matches_one_process(cases, single, world4, name):
    sigma = fused_order(4) if cases[name]["kind"] == "fused" else np.arange(2 * RAW)
    assert_matches([r[name] for r in world4], single[name], cases[name], sigma,
                   f"world 4 {name}")


def test_world_of_two_standard_step_matches_jax_sharded_step(world2, jax_standard):
    case, jax_metrics = jax_standard
    for r in world2:
        m = r["standard"]["metrics"]
        for k in ("loss/standard/total", "loss/standard/seg", "loss/standard/image",
                  "loss/total"):
            np.testing.assert_allclose(m[k], jax_metrics[k], rtol=2e-4, err_msg=k)


def test_sharded_predict_matches_one_process(world2):
    want = predict_case()
    for r in world2:
        assert r["predict"]["chunk"] == 6  # 5 rounded up to a multiple of 2
        assert r["predict"]["labels"].shape == (10, CROP, CROP)
        np.testing.assert_array_equal(r["predict"]["labels"], want["labels"])


def test_world_of_one_is_the_single_device_step(cases, single, tmp_path):
    """A data group of one rank runs the plain step, bit for bit."""
    import torch.distributed as dist

    from maxstyle_tpu_torch.train_step import make_train_step

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        grid = mesh.make_mesh()
        assert mesh.shard_of(grid) is None
        plain = make_train_step(TripletSegmentationSolver(config(), device="cpu"))
        assert mesh.shard_train_step(plain, grid) is plain
        got = run_case(cases["maxstyle"], grid)
    finally:
        dist.destroy_process_group()
    want = single["maxstyle"]
    assert got["metrics"] == want["metrics"]
    for name, sd in want["state"].items():
        for key, v in sd.items():
            assert torch.equal(got["state"][name][key], v), f"{name}.{key}"
    for idx, ts in want["style"].items():
        assert all(torch.equal(a, b) for a, b in zip(got["style"][idx], ts))


# ---------------------------------------------------------------------------
# the CLIs under --data_parallel
# ---------------------------------------------------------------------------


def _cli_worker(rank, world, port, argvs):
    """One rank of a ``torch.distributed.run`` launch: its environment, then
    the training and inference CLIs."""
    from maxstyle_tpu_torch import infer, train

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    import torch.distributed as dist
    try:
        train.main(argvs["train"])
        infer.main(argvs["infer"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_train_and_infer_clis_under_data_parallel_at_world_two(tmp_path):
    """``--data_parallel --device cpu`` over 2 gloo ranks on the synthetic
    prostate site of test_torch_port_train_cli.py: one epoch of 3 global
    batches of 4 raw slices (2 a rank), then inference with a chunk of 3
    rounded up to 4, and ``--auto_test`` sharded the same way; rank 0 alone
    writes the run directory, the event file, the checkpoints, the report
    and the predictions, which equal the single process's inference from
    the same checkpoint."""
    import socket

    from maxstyle_tpu_torch import infer
    from maxstyle_tpu_torch.data import medio
    from tests.test_torch_port_train_cli import make_prostate_site, write_config

    root = make_prostate_site(str(tmp_path / "prostate"), n_patients=4)
    site = make_prostate_site(str(tmp_path / "site"), n_patients=1, shape=(5, 32, 32),
                              names=("img.nii.gz", "seg.nii.gz"))
    make_prostate_site(str(tmp_path / "ood" / "G-MedicalDecathlon"), n_patients=1,
                       names=("img.nii.gz", "seg.nii.gz"))
    cfg = write_config(tmp_path, root, max_iteration=2)
    save_dir = str(tmp_path / "saved")
    model_dir = os.path.join(save_dir, "train_Prostate_all_n_cls_2", "config", "0", "model")
    common = ["--input_dir", site, "--crop", "32", "32", "--json_config_path", cfg,
              "--ckpt_dir", model_dir, "--ckpt", "epoch_0", "--device", "cpu"]
    argvs = {"train": ["--json_config_path", cfg, "--save_dir", save_dir, "--data_setting",
                       "all", "--cval", "0", "--seed", "1", "--debug", "--data_parallel",
                       "--device", "cpu", "--auto_test", "--test_root_dir",
                       str(tmp_path / "ood"), "--test_batch_size", "3"],
             "infer": common + ["--out_dir", str(tmp_path / "dp"), "--chunk", "3",
                                "--data_parallel"]}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_cli_worker, args=(r, 2, port, argvs)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]

    run_dir = os.path.dirname(model_dir)
    assert sorted(os.listdir(model_dir)) == ["best", "epoch_0", "report"]
    with open(os.path.join(model_dir, "report", "dataset_summary.csv")) as f:
        assert f.read().splitlines()[1].startswith("G-MedicalDecathlon,config,")
    logs = os.listdir(os.path.join(run_dir, "log"))
    assert len([f for f in logs if f.startswith("events")]) == 1
    from maxstyle_tpu_torch.config import ExperimentConfig
    from maxstyle_tpu_torch.flagship import config_solver
    from maxstyle_tpu_torch.utils import checkpoint as ckpt
    state, _ = ckpt.load_checkpoint(model_dir, "epoch_0",
                                    config_solver(ExperimentConfig.from_json(cfg),
                                                  "cpu").init_state(0))
    assert state.step == 3  # 12 slices, 4 a global batch
    assert all(torch.isfinite(p).all() for p in state.modules.parameters())
    infer.main(common + ["--out_dir", str(tmp_path / "one"), "--chunk", "3"])
    got, _ = medio.read_nrrd(str(tmp_path / "dp" / "patient_0_pred.nrrd"))
    want, _ = medio.read_nrrd(str(tmp_path / "one" / "patient_0_pred.nrrd"))
    assert got.shape == (5, 32, 32)
    np.testing.assert_array_equal(got, want)
