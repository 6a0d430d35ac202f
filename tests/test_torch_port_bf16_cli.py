"""The training and inference CLIs under ``compute_dtype="bfloat16"`` on
the CPU: ``train.main`` runs one epoch (3 iterations, MaxStyle n_iter=1) of
tests/test_torch_port_train_cli.py's synthetic prostate site, with
``--auto_test`` on an OOD site; the checkpoints it writes hold float32
weights and statistics, which a fresh bf16 solver reloads bit for bit and
whose prediction is bf16; ``infer.main`` segments a site from that
checkpoint."""

import json
import os

import numpy as np
import torch

from maxstyle_tpu_torch import infer, train
from maxstyle_tpu_torch.config import ExperimentConfig
from maxstyle_tpu_torch.data import medio
from maxstyle_tpu_torch.flagship import config_solver
from maxstyle_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_port_train_cli import make_prostate_site, write_config

torch.set_num_threads(2)


def test_bf16_train_writes_a_float32_checkpoint_that_infer_reloads(tmp_path):
    root = make_prostate_site(str(tmp_path / "prostate"))
    make_prostate_site(str(tmp_path / "ood" / "G-MedicalDecathlon"), n_patients=2,
                       names=("img.nii.gz", "seg.nii.gz"))
    cfg_path = write_config(tmp_path, root, max_iteration=3, compute_dtype="bfloat16",
                            max_style=True)
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["max_style"] = {"n_iter": 1}
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    save_dir = str(tmp_path / "saved")
    train.main(["--json_config_path", cfg_path, "--save_dir", save_dir,
                "--data_setting", "all", "--cval", "0", "--seed", "1", "--debug",
                "--device", "cpu", "--auto_test", "--test_root_dir", str(tmp_path / "ood"),
                "--test_batch_size", "2"])
    run_dir = os.path.join(save_dir, "train_Prostate_all_n_cls_2", "config", "0")
    model_dir = os.path.join(run_dir, "model")
    with open(os.path.join(run_dir, "log", "config_0.json")) as f:
        history = json.load(f)
    assert np.isfinite(history[0]["val_iou"]) and np.isfinite(history[0]["loss/total"])
    assert history[0]["loss/hard/total"] > 0

    solver = config_solver(ExperimentConfig.from_json(cfg_path), "cpu")
    assert solver.compute_dtype == torch.bfloat16
    saved = torch.load(os.path.join(model_dir, "best", "state.pt"), map_location="cpu")
    floats = [t for t in _tensors(saved) if t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)
    state, _ = ckpt.load_checkpoint(model_dir, "best", solver.init_state(0))
    for t in list(state.modules.parameters()) + list(state.modules.buffers()):
        assert t.dtype == torch.float32
    x = torch.rand((2, 32, 32, 1), generator=torch.Generator().manual_seed(0))
    pred = solver.predict(state.modules, x)
    assert pred.dtype == torch.bfloat16 and torch.isfinite(pred.float()).all()
    again, _ = ckpt.load_checkpoint(model_dir, "best", solver.init_state(1))
    assert torch.equal(solver.predict(again.modules, x), pred)

    site = make_prostate_site(str(tmp_path / "site"), n_patients=1, shape=(3, 32, 32),
                              names=("img.nii.gz", "seg.nii.gz"))
    out_dir = str(tmp_path / "preds")
    infer.main(["--json_config_path", cfg_path, "--ckpt_dir", model_dir, "--ckpt", "best",
                "--input_dir", site, "--out_dir", out_dir, "--chunk", "2",
                "--crop", "32", "32", "--uncertainty", "--device", "cpu"])
    pred_vol, _ = medio.read_nrrd(os.path.join(out_dir, "patient_0_pred.nrrd"))
    ent, _ = medio.read_nrrd(os.path.join(out_dir, "patient_0_entropy.nrrd"))
    assert pred_vol.shape == ent.shape == (3, 32, 32) and set(np.unique(pred_vol)) <= {0, 1}
    assert ent.dtype == np.float32 and np.isfinite(ent).all()


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
