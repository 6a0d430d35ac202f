"""The port's training and inference CLIs end to end on the CPU
(``--device cpu``), on a synthetic prostate-format site: the port's
versions of ``tests/test_train_cli.py``'s smoke run (with a max_iteration
cap and ``--debug``, here also with ``--auto_test`` on an OOD site and with
``--inner_steps 2``) and its interrupt-and-resume run, and of
``tests/test_infer_cli.py``."""

import json
import os

import numpy as np
import pytest
import torch

from maxstyle_tpu_torch import infer, train
from maxstyle_tpu_torch.config import ExperimentConfig
from maxstyle_tpu_torch.data import medio
from maxstyle_tpu_torch.flagship import config_solver
from maxstyle_tpu_torch.utils import checkpoint as ckpt
from maxstyle_tpu_torch.utils.tb_events import read_events

torch.set_num_threads(2)


def make_prostate_site(root, n_patients=8, shape=(3, 40, 40), seed=0,
                       names=("t2_img_clipped.nii.gz", "label_clipped.nii.gz")):
    rng = np.random.RandomState(seed)
    for i in range(n_patients):
        pid = f"patient_{i}"
        os.makedirs(os.path.join(root, pid), exist_ok=True)
        img = rng.rand(*shape).astype(np.float32)
        lab = np.zeros(shape, np.int16)
        lab[:, 10:30, 10:30] = 1
        medio.write_nifti(os.path.join(root, pid, names[0]), img, spacing=(1.0, 1.0, 3.6))
        medio.write_nifti(os.path.join(root, pid, names[1]), lab, spacing=(1.0, 1.0, 3.6))
    return root


def write_config(tmp_path, root, **learning):
    config = {
        "name": "cli smoke",
        "data": {
            "dataset_name": "Prostate", "root_dir": root,
            "pad_size": [40, 40, 1], "crop_size": [32, 32, 1],
            "data_aug_policy": "Prostate_affine_elastic_intensity",
            "image_format_name": "{pid}/t2_img_clipped.nii.gz",
            "label_format_name": "{pid}/label_clipped.nii.gz",
            "num_classes": 2, "intensity_norm_type": "min_max",
            "keep_orig_image_label_pair_for_training": True,
        },
        "segmentation_model": {"network_type": "FCN_16_standard_no_STN", "num_classes": 2},
        "learning": {"lr": 1e-3, "n_epochs": 1, "batch_size": 4, "optimizer_type": "Adam",
                     **learning},
        "output": {"save_epoch_every_num_epochs": 1},
    }
    path = str(tmp_path / "config.json")
    with open(path, "w") as f:
        json.dump(config, f)
    return path


@pytest.mark.parametrize("inner_steps", [1, 2])
def test_cli_train_smoke_with_auto_test(tmp_path, inner_steps):
    root = make_prostate_site(str(tmp_path / "prostate"))
    make_prostate_site(str(tmp_path / "ood" / "G-MedicalDecathlon"), n_patients=2,
                       names=("img.nii.gz", "seg.nii.gz"))
    cfg_path = write_config(tmp_path, root, max_iteration=3)
    save_dir = str(tmp_path / "saved")
    train.main(["--json_config_path", cfg_path, "--save_dir", save_dir,
                "--data_setting", "all", "--cval", "0", "--seed", "1", "--debug",
                "--device", "cpu", "--inner_steps", str(inner_steps), "--auto_test",
                "--test_root_dir", str(tmp_path / "ood"), "--test_batch_size", "2"])
    run_dir = os.path.join(save_dir, "train_Prostate_all_n_cls_2", "config", "0")
    model_dir = os.path.join(run_dir, "model")
    for name in ("best", "epoch_0"):
        assert sorted(os.listdir(os.path.join(model_dir, name))) == ["meta.json", "state.pt"]
    assert os.path.exists(os.path.join(run_dir, "config.json"))
    with open(os.path.join(run_dir, "log", "config_0.json")) as f:
        history = json.load(f)
    assert [h["epoch"] for h in history] == [0] and np.isfinite(history[0]["val_iou"])
    assert np.isfinite(history[0]["loss/total"])
    (events,) = [f for f in os.listdir(os.path.join(run_dir, "log")) if f.startswith("events")]
    scalars = read_events(os.path.join(run_dir, "log", events))[1]["scalars"]
    assert scalars["iou/val_iou"] == pytest.approx(history[0]["val_iou"])
    with open(os.path.join(model_dir, "report", "dataset_summary.csv")) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("dataset,method,Prostate_Dice (mean)")
    assert lines[1].startswith("G-MedicalDecathlon,config,")
    state, meta = ckpt.load_checkpoint(model_dir, "epoch_0",
                                       config_solver(ExperimentConfig.from_json(cfg_path),
                                                     "cpu").init_state(0))
    assert meta["epoch"] == 0 and state.step == 6  # 12 slices, 2 a loader batch


def test_cli_interrupt_and_resume(tmp_path, monkeypatch):
    """A crash mid-training saves the 'interrupted' snapshot and
    --resume_ckpt_path restores epoch + state and continues to completion."""
    root = make_prostate_site(str(tmp_path / "prostate"))
    cfg_path = write_config(tmp_path, root, n_epochs=3)
    save_dir = str(tmp_path / "saved")
    args = ["--json_config_path", cfg_path, "--save_dir", save_dir,
            "--data_setting", "all", "--cval", "0", "--seed", "1", "--device", "cpu"]
    model_dir = os.path.join(save_dir, "train_Prostate_all_n_cls_2", "config", "0", "model")

    # crash during epoch 1's validation (epoch 0 completes cleanly)
    real_eval = train.eval_model
    calls = {"n": 0}

    def dying_eval(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("synthetic crash")
        return real_eval(*a, **kw)

    monkeypatch.setattr(train, "eval_model", dying_eval)
    with pytest.raises(RuntimeError, match="synthetic crash"):
        train.main(args)
    monkeypatch.setattr(train, "eval_model", real_eval)

    assert os.path.isdir(os.path.join(model_dir, "interrupted"))
    solver = config_solver(ExperimentConfig.from_json(cfg_path), "cpu")
    snap, meta = ckpt.load_checkpoint(model_dir, "interrupted", solver.init_state(0))
    assert meta["epoch"] == 1  # crashed during epoch 1
    steps_at_crash = snap.step
    assert steps_at_crash == 12

    # resume: restarts from epoch 1 and completes epochs 1..2
    train.main(args + ["--resume_ckpt_path", model_dir])
    final, meta2 = ckpt.load_checkpoint(model_dir, "epoch_2", solver.init_state(0))
    assert meta2["epoch"] == 2
    # step counter continued from the snapshot (epoch 1 re-run + epoch 2)
    assert final.step == steps_at_crash + 12


def test_infer_cli(tmp_path):
    root = make_prostate_site(str(tmp_path / "site"), n_patients=2, shape=(3, 32, 32),
                              names=("img.nii.gz", "seg.nii.gz"))
    out_dir = str(tmp_path / "preds")
    infer.main(["--input_dir", root, "--image_format", "{pid}/img.nii.gz",
                "--label_format", "{pid}/seg.nii.gz", "--out_dir", out_dir, "--chunk", "2",
                "--crop", "32", "32", "--uncertainty", "--keep_largest_cc", "--device", "cpu"])
    files = sorted(os.listdir(out_dir))
    assert files == ["patient_0_entropy.nrrd", "patient_0_pred.nrrd",
                     "patient_1_entropy.nrrd", "patient_1_pred.nrrd"]
    pred, _ = medio.read_nrrd(os.path.join(out_dir, "patient_0_pred.nrrd"))
    ent, _ = medio.read_nrrd(os.path.join(out_dir, "patient_0_entropy.nrrd"))
    assert pred.shape == ent.shape == (3, 32, 32) and pred.dtype == np.uint8
    assert set(np.unique(pred)) <= {0, 1, 2, 3}
    assert ent.dtype == np.float32 and (ent >= -1e-6).all() and (ent <= 1 + 1e-6).all()


@pytest.mark.parametrize("cli,flag,item", [(train, "--torch_ckpt_dir", 7),
                                           (train, "--data_parallel", 8),
                                           (infer, "--torch_ckpt_dir", 7),
                                           (infer, "--data_parallel", 8)])
def test_unported_flags_raise_and_name_their_roadmap_item(tmp_path, cli, flag, item):
    """Flags of once-unported items run. --data_parallel outside a
    ``torch.distributed.run`` launch is the single-device run (item 8; the
    worlds of 2 are in test_torch_port_data_parallel.py); --torch_ckpt_dir
    imports (here a domain-specific encoder into a DS_FCN run), and raises
    for a UNETR run: a reference UNETR checkpoint has no importer, in the
    JAX package either (ROADMAP item 7.1 ported the model and its ViT
    importer)."""
    if flag == "--data_parallel":
        assert "WORLD_SIZE" not in os.environ
        if cli is train:
            root = make_prostate_site(str(tmp_path / "prostate"), n_patients=4)
            save_dir = str(tmp_path / "saved")
            train.main(["--json_config_path", write_config(tmp_path, root, max_iteration=1),
                        "--save_dir", save_dir, "--data_setting", "all", "--cval", "0",
                        "--seed", "1", "--debug", flag, "--device", "cpu"])
            model_dir = os.path.join(save_dir, "train_Prostate_all_n_cls_2", "config", "0",
                                     "model")
            assert sorted(os.listdir(model_dir)) == ["best", "epoch_0"]
        else:
            root = make_prostate_site(str(tmp_path / "site"), n_patients=1, shape=(3, 32, 32),
                                      names=("img.nii.gz", "seg.nii.gz"))
            infer.main(["--input_dir", root, "--out_dir", str(tmp_path / "o"), "--chunk", "2",
                        "--crop", "32", "32", flag, "--device", "cpu"])
            assert os.listdir(tmp_path / "o") == ["patient_0_pred.nrrd"]
        return
    if flag == "--torch_ckpt_dir":
        from tests.test_torch_port_torch_import import make_ds_encoder_sd
        ref = tmp_path / "ref"
        ref.mkdir()
        torch.save(make_ds_encoder_sd(np.random.RandomState(0)), str(ref / "image_encoder.pth"))
        config = write_config(tmp_path, str(tmp_path / "site"))

        def run(network_type):
            with open(config) as f:
                cfg = json.load(f)
            cfg["segmentation_model"]["network_type"] = network_type
            with open(config, "w") as f:
                json.dump(cfg, f)
            empty = tmp_path / "empty"
            empty.mkdir(exist_ok=True)
            cli.main({train: ["--json_config_path", config, "--save_dir", str(tmp_path / "s"),
                              "--no_train"],
                      infer: ["--input_dir", str(empty), "--out_dir", str(tmp_path / "o"),
                              "--json_config_path", config]}[cli]
                     + [flag, str(ref), "--device", "cpu"])

        run("DS_FCN_16_standard")
        with pytest.raises(ValueError, match="no importer for a reference UNETR checkpoint"):
            run("UnetTransformer_enable_code_filter_16")
