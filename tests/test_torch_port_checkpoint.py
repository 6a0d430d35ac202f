"""The port's checkpoints: a save/load round trip restores the modules (weights
and BatchNorm buffers), the optimizers (moments and step counts) and the
step bit for bit, a resumed state trains on exactly as the saved one, and
meta.json carries what the JAX package's orbax checkpoint writes beside it.
"""

import json
import os

import jax.numpy as jnp
import pytest
import torch

from maxstyle_tpu.utils import checkpoint as jckpt
from maxstyle_tpu_torch.config import (DataConfig, ExperimentConfig, LearningConfig,
                                       SegmentationModelConfig)
from maxstyle_tpu_torch.solver import TripletSegmentationSolver
from maxstyle_tpu_torch.train_step import make_train_step
from maxstyle_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)
HW, N = 32, 4


def solver(optimizer="AdamW"):
    cfg = ExperimentConfig(
        data=DataConfig(crop_size=(HW, HW, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(network_type="FCN_16_standard_no_STN",
                                                   num_classes=4),
        learning=LearningConfig(lr=1e-3, batch_size=N, optimizer_type=optimizer))
    return TripletSegmentationSolver(cfg, device="cpu")


def batch(seed):
    g = torch.Generator().manual_seed(seed)
    return {"image": torch.rand((N, HW, HW, 1), generator=g),
            "label": torch.randint(0, 4, (N, HW, HW), generator=g)}


def trained(s, steps=2):
    state = s.init_state(1)
    step = make_train_step(s)
    gen = torch.Generator().manual_seed(2)
    for i in range(steps):
        state, _ = step(state, batch(i), gen)
    return state


def assert_same_tree(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_tree(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW"])
def test_round_trip_is_bit_equal_and_resumes_exactly(tmp_path, optimizer):
    s = solver(optimizer)
    state = trained(s)
    path = tckpt.save_checkpoint(str(tmp_path), "best", state, epoch=3, best_score=0.25,
                                 network_type=s.spec.network_type)
    assert sorted(os.listdir(path)) == ["meta.json", "state.pt"]
    loaded, meta = tckpt.load_checkpoint(str(tmp_path), "best", s.init_state(7))
    assert meta == {"epoch": 3, "best_score": 0.25, "network_type": "FCN_16_standard_no_STN"}
    assert loaded.step == state.step == 2
    for name in state.modules:
        assert_same_tree(state.modules[name].state_dict(), loaded.modules[name].state_dict())
        assert any("running_mean" in k for k in state.modules[name].state_dict())
        assert_same_tree(state.optimizers[name].state_dict(),
                         loaded.optimizers[name].state_dict())
        moments = state.optimizers[name].state_dict()["state"]
        assert moments and all(v["exp_avg"].abs().sum() > 0 for v in moments.values())
    # both go on with the same step and stay bit-equal
    step = make_train_step(s)
    for st in (state, loaded):
        step(st, batch(9), torch.Generator().manual_seed(4))
    for name in state.modules:
        assert_same_tree(state.modules[name].state_dict(), loaded.modules[name].state_dict())


def test_saving_again_replaces_the_checkpoint_and_other_networks_are_refused(tmp_path):
    s = solver()
    state = s.init_state(0)
    tckpt.save_checkpoint(str(tmp_path), "epoch_0", state)
    state = trained(s, steps=1)
    tckpt.save_checkpoint(str(tmp_path), "epoch_0", state)
    loaded, _ = tckpt.load_checkpoint(str(tmp_path), "epoch_0", s.init_state(0))
    assert loaded.step == 1
    other = s.init_state(0)
    other.modules.pop("image_decoder")
    other.optimizers.pop("image_decoder")
    with pytest.raises(ValueError, match="do not match"):
        tckpt.load_checkpoint(str(tmp_path), "epoch_0", other)


def test_meta_json_and_latest_epoch_match_the_jax_package(tmp_path):
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    for epoch in (0, 2, 10):
        jckpt.save_checkpoint(str(jdir), f"epoch_{epoch}", {"w": jnp.zeros(3)}, epoch, 0.5,
                              "FCN_16_standard_no_STN")
        tckpt.save_checkpoint(str(tdir), f"epoch_{epoch}", solver().init_state(0), epoch, 0.5,
                              "FCN_16_standard_no_STN")
    os.makedirs(jdir / "epoch_x")
    os.makedirs(tdir / "epoch_x")
    for d in ("epoch_10", "epoch_2"):
        with open(jdir / d / "meta.json") as f, open(tdir / d / "meta.json") as g:
            assert json.load(f) == json.load(g)
    assert (jckpt.latest_epoch_checkpoint(str(jdir)) == tckpt.latest_epoch_checkpoint(str(tdir))
            == "epoch_10")
    assert tckpt.latest_epoch_checkpoint(str(tmp_path / "none")) is None
