"""The port's validation harness (maxstyle_tpu_torch/scripts/ab_randconv_bn.py
and ood_method_comparison.py) against the JAX scripts of scripts/.

* The phantom task, its Dice and every corruption kind equal the JAX
  scripts' arrays bit for bit from the same RandomState (3 seeds, 32^2,
  batch 4): the two packages train and test on the same data stream.
* The eval-only run (``--steps 0``) of standard and max_style from JAX's
  ``init_state(key(seed))`` weights, carried across by ``convert.py``:
  every domain's argmax labels agree with JAX's ``solver.predict`` on at
  least 99.99% of pixels, and where they agree fully the domain's Dice is
  the JAX script's within 1e-6.
* ``main`` trains each of the 9 methods 2 steps at 32^2, batch 4, on the
  CPU with finite losses and Dice, writes lines with the JAX script's keys
  (plus the card's name), skips recorded cells on a restart and stops
  before the next arm when the stop file exists.
"""

import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import ab_randconv_bn as j_ab  # noqa: E402
import ood_method_comparison as j_ood  # noqa: E402
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver  # noqa: E402
from maxstyle_tpu_torch import convert  # noqa: E402
from maxstyle_tpu_torch.flagship import config_solver  # noqa: E402
from maxstyle_tpu_torch.scripts import ab_randconv_bn as t_ab  # noqa: E402
from maxstyle_tpu_torch.scripts import ood_method_comparison as t_ood  # noqa: E402
from maxstyle_tpu_torch.utils import gpulock  # noqa: E402

torch.set_num_threads(2)
HW, BATCH = 32, 4
DOMAINS = ["iid", "gamma", "bias", "ghosting", "spike"]
KINDS = DOMAINS + ["gamma1.5", "gamma3.0", "gamma_raw"]
METHODS = ("standard", "max_style", "mix_style", "RSC", "adv_bias", "rand_conv", "DSU",
           "adv_noise", "latent_DA")


@pytest.fixture(autouse=True)
def _isolated_lock(tmp_path, monkeypatch):
    monkeypatch.setattr(gpulock, "LOCK_PATH", str(tmp_path / "chip.lock"))
    monkeypatch.setattr(gpulock, "BENCH_FLAG", str(tmp_path / "bench.flag"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_phantom_dice_and_corruptions_equal_the_jax_scripts(seed):
    ji, jl = j_ab.phantom_batch(np.random.RandomState(seed), BATCH, HW)
    ti, tl = t_ab.phantom_batch(np.random.RandomState(seed), BATCH, HW)
    assert (ti.dtype, tl.dtype, ti.shape, tl.shape) == (ji.dtype, jl.dtype, ji.shape, jl.shape)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)

    preds = [np.random.RandomState(seed + 10).randint(0, 4, (BATCH, HW, HW)),
             np.zeros((BATCH, HW, HW), np.int64)]  # the second leaves classes out: NaN
    for pred in preds:
        for j in range(BATCH):
            np.testing.assert_array_equal(t_ab.dice_per_class(pred[j], tl[j]),
                                          j_ab.dice_per_class(pred[j], jl[j]))
    for kind in KINDS:
        want = j_ood.corrupt(kind, ji, np.random.RandomState(seed + 20))
        got = t_ood.corrupt(kind, ti, np.random.RandomState(seed + 20))
        assert got.dtype == want.dtype and got.shape == want.shape, kind
        np.testing.assert_array_equal(got, want, err_msg=kind)


@pytest.fixture(scope="module")
def jax_init():
    """JAX's seed-1 weights (the JAX script's ``init_state(key(seed))``; both
    methods train the same network), its labels function, and the weights
    as the port's state dicts."""
    jsolver = JSolver(j_ood.make_config("standard", HW, BATCH))
    jstate = jsolver.init_state(jax.random.key(1), (HW, HW), batch_size=BATCH)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    labels = jax.jit(lambda im: jnp.argmax(jsolver.predict(
        jstate.params, jstate.batch_stats, im, softmax=False, normalize_input=False), axis=-1))
    return labels, convert.convert_train_state(to_np(jstate.params), to_np(jstate.batch_stats))


@pytest.mark.parametrize("method", ["standard", "max_style"])
def test_eval_only_run_matches_the_jax_script(method, jax_init):
    seed = 1
    j_labels, sds = jax_init
    want, jloss, _ = j_ood.train_and_eval(method, 0, HW, BATCH, seed, DOMAINS)
    got, loss, _ = t_ood.train_and_eval(method, 0, HW, BATCH, seed, DOMAINS, device="cpu",
                                        state_dicts=sds)
    assert math.isnan(loss) and math.isnan(jloss) and set(got) == set(want)

    tsolver = config_solver(t_ood.make_config(method, HW, BATCH), "cpu")
    nets = tsolver.init_state(seed, state_dicts=sds).modules
    for kind in DOMAINS:
        val_rng, cor_rng = np.random.RandomState(999), np.random.RandomState(777)
        agree = total = 0
        for _ in range(6):
            imgs, _ = t_ab.phantom_batch(val_rng, BATCH, HW)
            x = t_ood.corrupt(kind, imgs, cor_rng)
            jl = np.asarray(j_labels(jnp.asarray(x)))
            tl = t_ood.predict_labels(tsolver, nets, x)
            agree += int((jl == tl).sum())
            total += tl.size
        assert agree >= 0.9999 * total, (kind, total - agree)
        if agree == total:
            assert abs(got[kind] - want[kind]) <= 1e-6, (kind, got[kind], want[kind])


def test_main_trains_every_method_records_resumes_and_stops(tmp_path, capsys):
    out, stop = tmp_path / "ood.jsonl", tmp_path / "stop"
    args = ["--device", "cpu", "--steps", "2", "--hw", str(HW), "--batch", str(BATCH),
            "--methods", ",".join(METHODS), "--out", str(out), "--stop_file", str(stop)]
    t_ood.main(args + ["--seeds", "1"])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    with open(ROOT / "benchmarks" / "ood_multiseed_r4.jsonl") as f:
        jax_keys = set(json.loads(f.readline()))
    assert [r["method"] for r in recs] == list(METHODS)
    for r in recs:
        assert set(r) == jax_keys | {"device"}, r["method"]
        assert (r["seed"], r["steps"], r["batch"], r["hw"], r["style_group_size"],
                r["platform"], r["device"]) == (1, 2, BATCH, HW, None, "cpu", "cpu")
        assert math.isfinite(r["final_loss"]) and r["final_loss"] > 0, r["method"]
        assert list(r["dice"]) == DOMAINS and all(0 <= v <= 1 for v in r["dice"].values())

    capsys.readouterr()
    t_ood.main(args + ["--seeds", "1"])
    text = capsys.readouterr().out
    assert text.count("cached from") == len(METHODS) and "== training" not in text
    assert "OOD Dice summary" in text and text.count("\n") >= len(METHODS) + 3

    stop.write_text("")
    t_ood.main(args + ["--seeds", "1,2"])
    text = capsys.readouterr().out
    assert "stop file" in text and "== training" not in text
    assert len(out.read_text().splitlines()) == len(METHODS)


def test_randconv_view_bn_ab_runs_on_the_cpu(capsys):
    t_ab.main(["--device", "cpu", "--steps", "1", "--hw", str(HW), "--batch", str(BATCH)])
    text = capsys.readouterr().out
    assert "== arm: randconv_view_bn=frozen" in text and "== arm: randconv_view_bn=train" in text
    assert "delta (train - frozen)" in text
