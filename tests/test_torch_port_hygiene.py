"""Boundaries of the port: it never imports JAX or the JAX package, and its
entry points never fall back to the CPU on their own."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from maxstyle_tpu_torch.config import ExperimentConfig, MaxStyleConfig
from maxstyle_tpu_torch.flagship import flagship_solver
from maxstyle_tpu_torch.ops import maxstyle_kernels as mk
from maxstyle_tpu_torch.solver import TripletSegmentationSolver

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "maxstyle_tpu_torch"
FORBIDDEN = re.compile(r"import jax|from jax|maxstyle_tpu(\.|\s|$)", re.MULTILINE)


def test_import_leaves_jax_and_the_jax_package_out():
    code = ("import sys, importlib, pkgutil, maxstyle_tpu_torch\n"
            "for m in pkgutil.walk_packages(maxstyle_tpu_torch.__path__, 'maxstyle_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
            "             or n == 'maxstyle_tpu' or n.startswith('maxstyle_tpu.'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_package_file_names_jax():
    files = sorted(p for p in PACKAGE.rglob("*") if p.suffix in (".py", ".cu", ".cuh"))
    assert len(files) >= 15
    for p in files + [ROOT / "chip_smoke.py"]:
        for i, line in enumerate(p.read_text().splitlines(), 1):
            assert not FORBIDDEN.search(line), f"{p.relative_to(ROOT)}:{i}: {line.strip()}"


def test_entry_points_raise_without_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship_solver(hw=32, batch=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TripletSegmentationSolver(ExperimentConfig())
    assert flagship_solver(hw=32, batch=4, device="cpu").device.type == "cpu"


def test_kernel_wrappers_take_the_plain_path_only_for_cpu_tensors():
    x = torch.empty((2, 3, 4, 4), device="meta")
    s = torch.empty((2, 3), device="meta")
    one = torch.empty((2, 1), device="meta")
    perm = torch.tensor([1, 0])
    for call in (lambda: mk.channel_moments(x, 1e-6),
                 lambda: mk.style_apply(MaxStyleConfig(), x, one, s, s, s, s, perm, s, s, one),
                 lambda: mk.plane_affine_bwd(x, x, s)):
        with pytest.raises(ValueError):
            call()
    cpu = torch.randn(2, 3, 4, 4)
    torch.testing.assert_close(mk.channel_moments(cpu, 1e-6),
                               mk.channel_moments_plain(cpu, 1e-6))


def test_slice_two_modules_are_walked_and_their_wrappers_refuse_meta_tensors():
    import pkgutil

    import maxstyle_tpu_torch
    from maxstyle_tpu_torch import kernels
    from maxstyle_tpu_torch import proto_conv_bn_fusion as P
    from maxstyle_tpu_torch.ops import warp_kernels as wk
    names = {m.name for m in pkgutil.walk_packages(maxstyle_tpu_torch.__path__,
                                                   "maxstyle_tpu_torch.")}
    assert {"maxstyle_tpu_torch.ops.spline", "maxstyle_tpu_torch.proto_conv_bn_fusion",
            "maxstyle_tpu_torch.timing"} <= names
    assert {"warp_cubic", "conv_bn_stats"} <= set(kernels.SOURCES)
    assert {"warp_cubic_nearest", "conv3x3_bn_stats"} <= set(kernels.LAUNCHES)
    img = torch.empty((1, 6, 6), device="meta")
    lab = torch.empty((1, 6, 6), device="meta", dtype=torch.int32)
    crd = torch.empty((1, 4, 4), device="meta")
    for call in (lambda: wk.warp_cubic_nearest(img, lab, crd, crd),
                 lambda: wk.sample_cubic_nearest(img, lab, crd, crd),
                 lambda: P.conv3x3_bn_stats(torch.empty((1, 2, 4, 4), device="meta"),
                                            torch.empty((2, 2, 3, 3), device="meta"),
                                            torch.empty((2,), device="meta"))):
        with pytest.raises(ValueError):
            call()
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_branch_modules_are_walked_and_branch_workloads_need_a_gpu_or_cpu_asked():
    import pkgutil

    import maxstyle_tpu_torch
    from maxstyle_tpu_torch.flagship import BRANCH_CONFIGS, WORKLOADS
    names = {m.name for m in pkgutil.walk_packages(maxstyle_tpu_torch.__path__,
                                                   "maxstyle_tpu_torch.")}
    assert {"maxstyle_tpu_torch.train_step_branches", "maxstyle_tpu_torch.ops.latent_masking",
            "maxstyle_tpu_torch.ops.randconv", "maxstyle_tpu_torch.ops.advchain"} <= names
    assert set(BRANCH_CONFIGS) <= set(WORKLOADS)
    for name in BRANCH_CONFIGS:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                WORKLOADS[name]()
        assert WORKLOADS[name](device="cpu").device.type == "cpu"


# libraries the JAX package's host layer imports and the GPU machine lacks
ABSENT_ON_THE_GPU_MACHINE = ("sklearn", "pandas", "orbax", "matplotlib")
ABSENT_IMPORT = re.compile(r"^\s*(import|from)\s+(sklearn|pandas|orbax|matplotlib)\b",
                           re.MULTILINE)


def test_no_package_file_imports_sklearn_pandas_or_orbax():
    for p in sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for i, line in enumerate(p.read_text().splitlines(), 1):
            assert not ABSENT_IMPORT.search(line), f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
    code = ("import sys, importlib, pkgutil, maxstyle_tpu_torch\n"
            "for m in pkgutil.walk_packages(maxstyle_tpu_torch.__path__, 'maxstyle_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {ABSENT_ON_THE_GPU_MACHINE!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_and_host_data_modules_are_walked():
    import pkgutil

    import maxstyle_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(maxstyle_tpu_torch.__path__,
                                                   "maxstyle_tpu_torch.")}
    assert {"maxstyle_tpu_torch.train", "maxstyle_tpu_torch.evaluate", "maxstyle_tpu_torch.infer",
            "maxstyle_tpu_torch.metrics", "maxstyle_tpu_torch.native",
            "maxstyle_tpu_torch.data.medio", "maxstyle_tpu_torch.data.splits",
            "maxstyle_tpu_torch.data.datasets", "maxstyle_tpu_torch.data.prefetch",
            "maxstyle_tpu_torch.utils.checkpoint", "maxstyle_tpu_torch.utils.tb_events",
            "maxstyle_tpu_torch.utils.postprocess",
            "maxstyle_tpu_torch.utils.uncertainty"} <= names


def test_train_and_infer_clis_raise_without_a_gpu_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CLIs run on it")
    from maxstyle_tpu_torch import infer, train
    config = str(ROOT / "configs" / "ACDC" / "1500_epoch" / "MICCAI2022_MaxStyle.json")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--json_config_path", config, "--save_dir", str(tmp_path / "saved"),
                    "--no_train"])
    assert not (tmp_path / "saved").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.main(["--json_config_path", config, "--input_dir", str(tmp_path),
                    "--out_dir", str(tmp_path / "out")])
    # asked for the CPU, --no_train without --auto_test builds the run directory only
    train.main(["--json_config_path", config, "--save_dir", str(tmp_path / "saved"),
                "--no_train", "--device", "cpu"])
    assert (tmp_path / "saved" / "train_ACDC_10_n_cls_4" / "MICCAI2022_MaxStyle" / "0"
            / "config.json").exists()


def test_slice_nine_modules_are_walked_and_their_entry_points_need_a_gpu_or_cpu_asked(tmp_path):
    import pkgutil

    import maxstyle_tpu_torch
    from maxstyle_tpu_torch import demo_generate_styles
    from maxstyle_tpu_torch.data.device_data import DeviceDataset
    names = {m.name for m in pkgutil.walk_packages(maxstyle_tpu_torch.__path__,
                                                   "maxstyle_tpu_torch.")}
    assert {"maxstyle_tpu_torch.utils.torch_import", "maxstyle_tpu_torch.utils.ema",
            "maxstyle_tpu_torch.utils.visualize", "maxstyle_tpu_torch.demo_generate_styles",
            "maxstyle_tpu_torch.utils.profiling", "maxstyle_tpu_torch.utils.features",
            "maxstyle_tpu_torch.data.device_data", "maxstyle_tpu_torch.data.preprocess",
            "maxstyle_tpu_torch.data.clahe", "maxstyle_tpu_torch.data.artefacts",
            "maxstyle_tpu_torch.utils.pairwise_measures",
            "maxstyle_tpu_torch.ops.morphology"} <= names
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run on it")
    out = str(tmp_path / "samples.png")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo_generate_styles.main(["--image", "none", "--torch_ckpt_dir", "none", "--crop",
                                   "32", "--n_samples", "1", "--out", out])
    ds = type("D", (), {"__len__": lambda self: 1,
                        "get_raw_slice": lambda self, i: (np.zeros((4, 4), np.float32),
                                                          np.zeros((4, 4), np.int32), "p")})()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceDataset.from_slice_dataset(ds)
    assert not os.path.exists(out)
    assert DeviceDataset.from_slice_dataset(ds, device="cpu").images.device.type == "cpu"


def test_slice_twelve_modules_are_walked_and_their_workloads_need_a_gpu_or_cpu_asked():
    """The loss library's new modules import neither JAX, the JAX package
    nor the host-layer libraries; the bf16 and NGF workloads run on the GPU
    unless the CPU is asked for."""
    import pkgutil

    import maxstyle_tpu_torch
    from maxstyle_tpu_torch.flagship import WORKLOADS
    new = ("maxstyle_tpu_torch.losses_extra", "maxstyle_tpu_torch.ops.mixup",
           "maxstyle_tpu_torch.ops.perceptual")
    names = {m.name for m in pkgutil.walk_packages(maxstyle_tpu_torch.__path__,
                                                   "maxstyle_tpu_torch.")}
    assert set(new) <= names
    code = (f"import sys, importlib\nfor m in {new!r}:\n    importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            f"('jax', 'maxstyle_tpu') + {ABSENT_ON_THE_GPU_MACHINE!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    for name in ("headline_bf16", "headline_ngf"):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                WORKLOADS[name]()
        assert WORKLOADS[name](device="cpu").device.type == "cpu"
    assert WORKLOADS["headline_bf16"](device="cpu").compute_dtype == torch.bfloat16
    assert WORKLOADS["headline_ngf"](device="cpu").rec_loss_type == "ngf"
