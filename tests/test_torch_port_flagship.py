"""The port's config-driven entry points (maxstyle_tpu_torch/flagship.py):
configs read as the JAX package reads them, the headline workload unchanged,
and the Prostate-cubic workload built from its config file."""

import dataclasses

import numpy as np
import pytest
import torch

from maxstyle_tpu.config import ExperimentConfig as JConfig
from maxstyle_tpu_torch.data import augment as TA
from maxstyle_tpu_torch.flagship import (BRANCH_CONFIGS, CONFIGS, PROSTATE_MAXSTYLE, WORKLOADS,
                                         config_solver, flagship_solver, load_config,
                                         make_raw_batches, measure_throughput,
                                         prostate_cubic_solver, workload_policy)

torch.set_num_threads(2)


@pytest.mark.parametrize("path,interp", [
    (PROSTATE_MAXSTYLE, "cubic"), (PROSTATE_MAXSTYLE, None),
    (CONFIGS / "ACDC" / "1500_epoch" / "MICCAI2022_MaxStyle.json", None)])
def test_load_config_matches_jax(path, interp):
    want = JConfig.from_json(str(path))
    if interp:
        want = dataclasses.replace(want, data=dataclasses.replace(want.data, image_interp=interp))
    assert dataclasses.asdict(load_config(path, image_interp=interp)) == dataclasses.asdict(want)


def test_headline_workload_is_unchanged():
    cfg = flagship_solver(device="cpu").config
    assert workload_policy(cfg) == TA.get_policy("ACDC_affine_elastic_intensity",
                                                 (224, 224), (192, 192))
    assert cfg.train_batch_size == 10 and cfg.segmentation_model.num_classes == 4
    assert cfg.data.keep_orig_image_label_pair_for_training


def test_prostate_cubic_workload():
    cfg = prostate_cubic_solver(device="cpu").config
    assert workload_policy(cfg) == TA.get_policy("Prostate_affine_elastic_intensity",
                                                 (288, 288), (224, 224), image_interp="cubic")
    assert cfg.segmentation_model.network_type == "FCN_16_standard_no_STN"
    assert cfg.segmentation_model.num_classes == 2 and cfg.train_batch_size == 10
    assert cfg.learning.optimizer_type == "AdamW" and cfg.learning.lr == 1e-4
    assert cfg.max_style.n_iter == 5 and cfg.max_style.decoder_layers_indexes == (3, 4, 5)


def test_raw_batches_draw_labels_of_the_class_count():
    raw = make_raw_batches(2, 3, 16, 0, "cpu", num_classes=2)
    assert raw["image"].shape == (2, 3, 16, 16) and raw["label"].dtype == torch.int32
    assert set(raw["label"].unique().tolist()) == {0, 1}
    assert float(raw["image"].min()) >= 0.0 and float(raw["image"].max()) <= 1.0


def test_measure_throughput_runs_the_config_workload_on_cpu():
    cfg = load_config(PROSTATE_MAXSTYLE, image_interp="cubic")
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, pad_size=(40, 40, 1), crop_size=(32, 32, 1)),
        learning=dataclasses.replace(cfg.learning, batch_size=4),
        max_style=dataclasses.replace(cfg.max_style, n_iter=1))
    rate, state, metrics = measure_throughput(config_solver(cfg, device="cpu"), k_inner=1,
                                              n_calls=1, n_repeats=1)
    assert rate > 0 and state.step == 2
    assert all(np.isfinite(float(v)) for v in metrics.values())


@pytest.mark.parametrize("name", sorted(BRANCH_CONFIGS))
def test_branch_workloads_are_the_shipped_configs(name):
    path = BRANCH_CONFIGS[name]
    want = JConfig.from_json(str(path))
    cfg = WORKLOADS[name](device="cpu").config
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.learning.batch_size == 20 and cfg.data.image_interp == "bilinear"
    crop = 192 if name.startswith("acdc") else 224
    assert workload_policy(cfg).crop_hw == (crop, crop)
