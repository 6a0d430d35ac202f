"""The port's throughput tools on the CPU: the batch sweep
(maxstyle_tpu_torch/scripts/bench_scaling.py), the shipped b80 grouped
config as ``flagship.WORKLOADS["acdc_b80_grouped"]``, the BatchNorm
running-update knob of scripts/exp_bn_residual (``layers._BN_UPDATE_MODE``)
against the JAX package's, the augmentation bench and the history summary.

* The sweep at effective batch 8 and 16 (style groups of 4) at 32^2 with
  K=1 prints well-formed lines, and its convolution and matrix-product
  FLOP count at 16 is twice the count at 8 within 1%.
* ``load_config`` of configs/TPU/ACDC_MaxStyle_b80_grouped.json equals the
  JAX loader's config field for field.
* Each update mode, and the shipped route (the knob unset, JAX's "torch"),
  gives JAX's running statistics after one "train" call, by the cuDNN route
  and by the live route, and the same output (the test sets the JAX
  module's variable and restores it).
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.config import ExperimentConfig as JConfig
from maxstyle_tpu.models import layers as jlayers
from maxstyle_tpu_torch.flagship import ACDC_B80_GROUPED, WORKLOADS, load_config, workload_policy
from maxstyle_tpu_torch.models import layers as tlayers
from maxstyle_tpu_torch.scripts import bench_aug_interp, bench_scaling, bench_summary
from maxstyle_tpu_torch.utils import gpulock

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _isolated_lock(tmp_path, monkeypatch):
    monkeypatch.setattr(gpulock, "LOCK_PATH", str(tmp_path / "chip.lock"))
    monkeypatch.setattr(gpulock, "BENCH_FLAG", str(tmp_path / "bench.flag"))


def test_sweep_lines_and_flops_scale_with_the_batch():
    lines = list(bench_scaling.sweep(batches=(8, 16), group=4, hw=32, k_inner=1, rounds=1,
                                     device="cpu"))
    keys = {"effective_batch", "steps_per_sec", "slices_per_sec", "sec_per_step",
            "style_group_size", "peak_memory_gib", "conv_mm_gflop_per_step",
            "conv_mm_tflop_per_s", "conv_mm_share_of_fp32_peak"}
    for line, b in zip(lines, (8, 16)):
        assert set(json.loads(json.dumps(line))) == keys
        assert line["effective_batch"] == b and line["style_group_size"] == 4
        assert line["peak_memory_gib"] is None  # no card, no device memory
        rate = line["steps_per_sec"]
        assert rate > 0 and math.isclose(line["slices_per_sec"], rate * b)
        assert math.isclose(line["sec_per_step"], 1 / rate)
        assert math.isclose(line["conv_mm_tflop_per_s"],
                            rate * line["conv_mm_gflop_per_step"] / 1e3)
        assert math.isclose(line["conv_mm_share_of_fp32_peak"],
                            line["conv_mm_tflop_per_s"] * 1e12 / 67e12)
    ratio = lines[1]["conv_mm_gflop_per_step"] / lines[0]["conv_mm_gflop_per_step"]
    assert abs(ratio - 2.0) <= 0.02, ratio


def test_b80_grouped_config_and_workload():
    cfg = load_config(ACDC_B80_GROUPED)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JConfig.from_json(str(ACDC_B80_GROUPED)))
    solver = WORKLOADS["acdc_b80_grouped"](device="cpu")
    cfg = solver.config
    assert cfg.learning.batch_size == 80 and cfg.train_batch_size == 40
    assert cfg.max_style.style_group_size == 20 and cfg.learning.optimizer_type == "AdamW"
    assert workload_policy(cfg).pad_hw == (224, 224) and cfg.crop_hw == (192, 192)


@pytest.mark.parametrize("live", [False, True], ids=["cudnn_route", "live_route"])
@pytest.mark.parametrize("mode", [None, "torch", "biased", "off"],
                         ids=["shipped", "torch", "biased", "off"])
def test_bn_update_mode_gives_the_jax_running_statistics(mode, live, monkeypatch):
    x = (np.random.RandomState(0).randn(4, 8, 8, 3) * 2 + 1).astype(np.float32)
    saved = jlayers._BN_UPDATE_MODE
    try:
        jlayers._BN_UPDATE_MODE = mode or "torch"
        bn = jlayers.BatchNorm(use_running_average=False)
        v = bn.init(jax.random.key(1), jnp.asarray(x))
        y, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    finally:
        jlayers._BN_UPDATE_MODE = saved

    monkeypatch.setattr(tlayers, "_BN_UPDATE_MODE", mode)
    tbn = tlayers.BatchNorm(3)
    with torch.no_grad():
        tbn.weight.fill_(1.0)  # JAX's BatchNorm scale starts at one
    tbn.track_live = live
    out = tbn(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), "train")
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    if mode == "off":
        assert torch.equal(tbn.running_mean, torch.zeros(3))
        assert torch.equal(tbn.running_var, torch.ones(3))


def test_bench_aug_interp_times_both_warps_on_the_cpu(capsys):
    bench_aug_interp.main(["--device", "cpu", "--batch", "2", "--iters", "1", "--pad", "40",
                           "--crop", "32"])
    text = capsys.readouterr().out
    assert "bilinear: " in text and "cubic: " in text and "slices/s" in text


def test_bench_summary_headline_is_the_median_of_clean_rows(tmp_path, monkeypatch, capsys):
    def row(v, ts, workload="headline", contended=False, acquired=True):
        return {"workload": workload, "steps_per_s": v, "ts": ts, "card": "c",
                "chip_lock": {"waited_s": 0.0, "contended": contended, "acquired": acquired}}

    rows = [row(1.0, 1), row(5.0, 2), row(9.0, 3, contended=True), row(3.0, 4),
            row(4.0, 5, acquired=False), row(7.0, 6), row(2.0, 7, "acdc_b80_grouped")]
    assert bench_summary.headline(rows, "headline")["steps_per_sec"] == 5.0  # of 5, 3, 7
    assert bench_summary.headline(rows, "headline", k=2)["steps_per_sec"] == 7.0
    assert bench_summary.headline(rows, "other") is None
    history = tmp_path / "history.jsonl"
    history.write_text("".join(json.dumps(r) + "\n" for r in rows))
    monkeypatch.setattr(bench_summary, "HISTORY", history)
    bench_summary.main([])
    text = capsys.readouterr().out
    assert text.count("CONTENDED") == 2
    assert '"workload": "acdc_b80_grouped", "headline_steps_per_sec": 2.0' in text
    assert '"workload": "headline", "headline_steps_per_sec": 5.0' in text


@pytest.mark.parametrize("module", ["ood_method_comparison", "ab_randconv_bn", "bench_scaling",
                                    "exp_bn_residual", "bench_aug_interp"])
def test_script_entry_points_raise_without_a_gpu_unless_cpu_is_asked(module):
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run on it")
    main = importlib.import_module(f"maxstyle_tpu_torch.scripts.{module}").main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([])
