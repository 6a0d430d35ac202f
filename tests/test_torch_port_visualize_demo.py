"""The port's figures, top-k panels and MaxStyle demo against the JAX package.

* ``utils/visualize.py`` writes its PNGs itself (the port's machines have no
  matplotlib): the files decode — by the port's ``read_png`` and by PIL —
  to the expected panel pixels (gray scaled to each image's min..max, label
  colors blended at alpha 0.5), exactly; the titles are tEXt chunks.
* ``TestSegmentationNetwork.top_k`` ranks like the JAX package's pandas
  ``sort_values`` on the same scores, ties and NaNs included: equal lists.
* ``evaluate(save_top_k=2)`` writes the four panel directories and the CSV
  files, under the names the JAX package's evaluate gives them when the two
  packages' metrics are equal.
* ``fit_latent_code`` at crop 32 for 20 iterations: the losses at rtol 1e-4
  of JAX's (the first Adam update is lr*sign(g), so a gradient component
  at rounding size may step the other way; measured 1.1e-6).
* ``demo_generate_styles.main(["--device", "cpu", ...])`` at crop 32, with
  decoder inversion and with an imported reference encoder (the
  adversarial loop): a decodable 4-column grid.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from maxstyle_tpu import demo_generate_styles as jdemo
from maxstyle_tpu import evaluate as jeval
from maxstyle_tpu.config import (DataConfig, ExperimentConfig, LearningConfig,
                                 SegmentationModelConfig)
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch import demo_generate_styles as tdemo
from maxstyle_tpu_torch import evaluate as teval
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver
from maxstyle_tpu_torch.utils import visualize as vis
from tests.test_torch_port_evaluate import NEW_SPACING, write_suite
from tests.test_torch_port_torch_import import reference_files

torch.set_num_threads(2)
HW = 32


def test_panels_decode_to_the_expected_pixels(tmp_path):
    rng = np.random.RandomState(0)
    images = rng.rand(3, 8, 6).astype(np.float32) * 3 - 1
    gts = rng.randint(0, 4, (3, 8, 6))
    preds = rng.randint(0, 4, (3, 8, 6))
    path = vis.save_segmentation_panels(images, gts, preds, str(tmp_path), tag="top1_p0",
                                        max_slices=2)
    assert path == os.path.join(str(tmp_path), "top1_p0", "Seg_plots.png")
    pix, text = vis.read_png(path)
    assert pix.shape == (2 * 8, 3 * 6, 3)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), pix)
    for i in range(2):
        img = images[i].astype(np.float64)
        gray = (img - img.min()) / (img.max() - img.min()) * 255.0
        for j, lab in enumerate((None, gts[i], preds[i])):
            want = np.repeat(gray[..., None], 3, axis=-1)
            if lab is not None:
                on = lab != 0
                want[on] = 0.5 * want[on] + 0.5 * vis.PALETTE[lab[on] - 1]
            got = pix[8 * i:8 * (i + 1), 6 * j:6 * (j + 1)]
            np.testing.assert_array_equal(got, np.clip(np.rint(want), 0, 255).astype(np.uint8))
    assert text["Title 1,2"] == "prediction" and text["Title 0,0"] == "image"
    assert vis.save_segmentation_panels(images[:0], gts[:0], preds[:0], str(tmp_path)) is None


def test_image_grid_layout(tmp_path):
    rng = np.random.RandomState(1)
    images = [rng.rand(5, 7) for _ in range(5)]
    path = vis.save_image_grid(images, str(tmp_path / "g" / "grid.png"),
                               titles=[f"t{i}" for i in range(5)], cols=4)
    pix, text = vis.read_png(path)
    assert pix.shape == (2 * 5, 4 * 7, 3)
    assert not pix[5:, 7:].any()  # the three empty cells are black
    assert np.array_equal(pix[5:, :7], pix[5:, :7, :1].repeat(3, -1))
    assert text["Title 1,0"] == "t4" and text["Title 0,3"] == "t3"
    Image.open(path).verify()


def test_top_k_ranks_as_the_jax_package():
    rng = np.random.RandomState(2)
    records = []
    for i in range(37):
        dice = [rng.choice([0.0, 0.25, 0.5, 0.9]), rng.rand(), np.nan if i % 7 == 3 else 0.5]
        records.append({"patient_id": f"p{i}", "LV_Dice": dice[0], "MYO_Dice": dice[1],
                        "RV_Dice": dice[2]})
    stub = type("S", (), {"num_classes": 4})()
    jnet = jeval.TestSegmentationNetwork(stub, None, None)
    tnet = teval.TestSegmentationNetwork(stub, None, None)
    jnet.score.records = [dict(r) for r in records]
    tnet.score.records = [dict(r) for r in records]
    for k in (1, 3, 37):
        for col in range(3):
            for worst in (False, True):
                assert tnet.top_k(k, col, worst) == jnet.top_k(k, col, worst), (k, col, worst)


@pytest.fixture(scope="module")
def pair():
    cfg = ExperimentConfig(
        data=DataConfig(crop_size=(HW, HW, 1), pad_size=(HW, HW, 1), num_classes=4,
                        new_spacing=NEW_SPACING),
        segmentation_model=SegmentationModelConfig(
            network_type="FCN_16_standard_no_STN", num_classes=4),
        learning=LearningConfig(lr=1e-4, batch_size=4, optimizer_type="AdamW"))
    js = JSolver(cfg)
    jstate = js.init_state(jax.random.key(0), (HW, HW), batch_size=4)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    tstate = ts.init_state(state_dicts=convert.convert_train_state(params, stats))
    return js, jstate, params, stats, ts, tstate


def test_evaluate_with_top_k_writes_panels_and_reports(pair, tmp_path):
    js, jstate, _, _, ts, tstate = pair
    root = os.path.dirname(write_suite(str(tmp_path / "ood" / "ACDC"), n=5))
    kw = dict(crop_hw=(HW, HW), new_spacing=NEW_SPACING, maximum_batch_size=2, save_top_k=2)
    _, _, jdf = jeval.evaluate(js, jstate, "ACDC", root, save_report_dir=str(tmp_path / "j"),
                               **kw)
    _, _, trows = teval.evaluate(ts, tstate, "ACDC", root, save_report_dir=str(tmp_path / "t"),
                                 **kw)

    def panels(d):
        return sorted(e for e in os.listdir(d) if os.path.isdir(os.path.join(d, e)))

    tdirs = panels(tmp_path / "t")
    assert [d.split("_")[0] for d in tdirs] == ["top1", "top2", "worst1", "worst2"]
    for d in tdirs:
        pix, _ = vis.read_png(str(tmp_path / "t" / d / "Seg_plots.png"))
        assert pix.shape == (3 * HW, 3 * HW, 3)  # 3 slices a volume
    assert {"iter_1_detailed.csv", "iter_1_summary.csv"} <= set(os.listdir(tmp_path / "t"))
    if jdf.to_dict("records") == trows:
        assert tdirs == panels(tmp_path / "j")


def test_fit_latent_code_losses_match_jax(pair):
    js, _, params, stats, ts, tstate = pair
    image = np.random.RandomState(3).rand(2, HW, HW, 1).astype(np.float32)
    z_shape = (2, HW // 16, HW // 16, 128)
    jz, jl = jdemo.fit_latent_code(js, jax.tree_util.tree_map(jnp.asarray, params),
                                   jax.tree_util.tree_map(jnp.asarray, stats),
                                   jnp.asarray(image), z_shape, iters=20)
    tz, tl = tdemo.fit_latent_code(ts, tstate.modules,
                                   torch.from_numpy(image.transpose(0, 3, 1, 2).copy()),
                                   (2, 128, HW // 16, HW // 16), iters=20)
    assert tl.shape == (20,)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-4)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz).transpose(0, 3, 1, 2),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("encoder", [False, True])
def test_demo_main_on_the_cpu(tmp_path, encoder, capsys):
    args = ["--device", "cpu", "--image", "none", "--crop", str(HW), "--n_samples", "2",
            "--n_iter", "1", "--fit_iters", "3", "--out", str(tmp_path / "samples.png")]
    if encoder:
        ref = tmp_path / "ref"
        ref.mkdir()
        for name, sd in reference_files(seed=5).items():
            torch.save(sd, str(ref / f"{name}.pth"))
        args += ["--torch_ckpt_dir", str(ref)]
    else:
        args += ["--torch_ckpt_dir", "none"]
    path = tdemo.main(args)
    out = capsys.readouterr().out
    assert ("imported reference torch weights for image_encoder" in out) == encoder
    assert ("decoder inversion" in out) != encoder
    pix, text = vis.read_png(path)
    assert pix.shape == (2 * HW, 4 * HW, 3)
    suffix = "adv n_iter=1" if encoder else "sampled"
    assert text["Title 1,2"] == f"styled #1 ({suffix})"
