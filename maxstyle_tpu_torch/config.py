"""Experiment configuration: frozen dataclasses over the reference JSON
schema, so the files under ``configs/`` load verbatim.

The port's own copy of ``maxstyle_tpu/config.py``: the same classes, fields,
defaults and JSON reads, so both packages parse every config file to equal
field values. Schema source: the reference's config JSON files,
common_utils/load_args.py:8-54 (``Params``, ``get_value_from_dict``
defaults) and the option reads in
train_adv_supervised_segmentation_triplet.py:134-141, 651-658, 823-850.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


def _get(d: dict, key: str, default=None):
    return d[key] if key in d and d[key] is not None else default


def _tup(x) -> Optional[tuple]:
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset_name: str = "ACDC"
    root_dir: str = ""
    frame: Tuple[str, ...] = ("ED", "ES")
    image_size: Tuple[int, ...] = (224, 224, 1)
    label_size: Tuple[int, ...] = (224, 224)
    pad_size: Tuple[int, ...] = (224, 224, 1)
    crop_size: Tuple[int, ...] = (192, 192, 1)
    new_spacing: Optional[Tuple[float, ...]] = None
    data_aug_policy: str = "ACDC_affine_elastic_intensity"
    # image warp interpolation: 'bilinear' (default) or 'cubic' (the
    # reference's order-3 spline semantics, ops/spline.py)
    image_interp: str = "bilinear"
    image_format_name: str = "{pid}_img.nrrd"
    label_format_name: str = "{pid}_seg.nrrd"
    num_classes: int = 4
    use_cache: bool = True
    intensity_norm_type: str = "min_max"
    keep_orig_image_label_pair_for_training: bool = True
    myocardium_only: bool = False
    right_ventricle_only: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "DataConfig":
        return cls(
            dataset_name=_get(d, "dataset_name", "ACDC"),
            root_dir=_get(d, "root_dir", ""),
            frame=_tup(_get(d, "frame", ("ED", "ES"))),
            image_size=_tup(_get(d, "image_size", (224, 224, 1))),
            label_size=_tup(_get(d, "label_size", (224, 224))),
            pad_size=_tup(_get(d, "pad_size", (224, 224, 1))),
            crop_size=_tup(_get(d, "crop_size", (192, 192, 1))),
            new_spacing=_tup(_get(d, "new_spacing")),
            data_aug_policy=_get(d, "data_aug_policy", "ACDC_affine_elastic_intensity"),
            image_interp=_get(d, "image_interp", "bilinear"),
            image_format_name=_get(d, "image_format_name", "{pid}_img.nrrd"),
            label_format_name=_get(d, "label_format_name", "{pid}_seg.nrrd"),
            num_classes=_get(d, "num_classes", 4),
            use_cache=_get(d, "use_cache", True),
            intensity_norm_type=_get(d, "intensity_norm_type", "min_max"),
            keep_orig_image_label_pair_for_training=_get(
                d, "keep_orig_image_label_pair_for_training", True),
            myocardium_only=_get(d, "myocardium_only", False),
            right_ventricle_only=_get(d, "right_ventricle_only", False),
        )


@dataclasses.dataclass(frozen=True)
class LearningConfig:
    """`learning` block (train_adv…:134-141, 823-850)."""

    lr: float = 1e-4
    n_epochs: int = 600
    max_iteration: int = 50000
    batch_size: int = 20
    optimizer_type: str = "Adam"  # Adam | AdamW | SGD
    use_gpu: bool = True  # accepted for config parity; devices are chosen by the caller
    encoder_dropout: Optional[float] = None
    decoder_dropout: Optional[float] = None
    rec_loss_type: str = "l2"
    class_weights: Optional[Tuple[float, ...]] = None
    separate_training: bool = False
    # activation/compute dtype; the port computes in float32 for every value
    # ('auto' included). Params, optimizer state and BN stats are float32.
    compute_dtype: str = "auto"  # auto | bfloat16 | float32
    # method flags
    max_style: bool = False
    latent_DA: bool = False
    rand_conv: bool = False
    RSC: bool = False
    mix_style: bool = False
    DSU: bool = False
    adv_noise: bool = False
    adv_bias: bool = False
    # RandConv view BN choreography: 'frozen' (default; batch stats used,
    # running stats not written) or 'train' (reference-exact stat updates,
    # train_adv…:289-326). Measured A/B in docs/VALIDATION.md.
    randconv_view_bn: str = "frozen"

    @classmethod
    def from_dict(cls, d: dict) -> "LearningConfig":
        return cls(
            lr=_get(d, "lr", 1e-4),
            n_epochs=_get(d, "n_epochs", 600),
            max_iteration=_get(d, "max_iteration", 50000),
            batch_size=_get(d, "batch_size", 20),
            optimizer_type=_get(d, "optimizer_type", "Adam"),
            use_gpu=_get(d, "use_gpu", True),
            encoder_dropout=_get(d, "encoder_dropout"),
            decoder_dropout=_get(d, "decoder_dropout"),
            rec_loss_type=_get(d, "rec_loss_type", "l2"),
            class_weights=_tup(_get(d, "class_weights")),
            separate_training=_get(d, "separate_training", False),
            compute_dtype=_get(d, "compute_dtype", "auto"),
            max_style=_get(d, "max_style", False),
            latent_DA=_get(d, "latent_DA", False),
            rand_conv=_get(d, "rand_conv", False),
            RSC=_get(d, "RSC", False),
            mix_style=_get(d, "mix_style", False),
            DSU=_get(d, "DSU", False),
            adv_noise=_get(d, "adv_noise", False),
            adv_bias=_get(d, "adv_bias", False),
            randconv_view_bn=_get(d, "randconv_view_bn", "frozen"),
        )


@dataclasses.dataclass(frozen=True)
class MaxStyleConfig:
    """`max_style` block (config/ACDC/1500_epoch/MICCAI2022_MaxStyle.json:56-76)
    + the fixed p=0.5 / channel plan applied at the call site
    (train_adv…:251-277)."""

    mix_style: bool = True
    no_noise: bool = False
    lr: float = 0.1
    n_iter: int = 5
    mix_learnable: bool = True
    noise_learnable: bool = True
    decoder_layers_indexes: Tuple[int, ...] = (3, 4, 5)
    loss_types: Tuple[str, ...] = ("seg",)
    loss_weights: Tuple[float, ...] = (1.0,)
    always_use_beta: bool = False
    p: float = 0.5
    alpha: float = 0.1
    eps: float = 1e-6
    # Style-stat group size for large-batch training. The reference tunes
    # MaxStyle at effective batch 20 (train_adv…:46-77); its style mixing
    # partner and stat spreads are batch-level, so scaling the batch changes
    # the method's semantics. With style_group_size=G, the permutation is
    # drawn within disjoint G-sample groups and gamma/beta spreads are
    # per-group — a B=80/G=20 batch behaves like 4 independent reference
    # batches (one shared Bernoulli gate per step is the only deviation).
    # None (default) = batch-level, the reference behavior.
    style_group_size: Optional[int] = None
    # unroll factor of the JAX package's inner-loop scan; parsed for config
    # parity, and without effect in the port's eager Python loop
    inner_unroll: int = 1

    @classmethod
    def from_dict(cls, d: dict) -> "MaxStyleConfig":
        return cls(
            mix_style=_get(d, "mix_style", True),
            no_noise=_get(d, "no_noise", False),
            lr=_get(d, "lr", 0.1),
            n_iter=_get(d, "n_iter", 5),
            mix_learnable=_get(d, "mix_learnable", True),
            noise_learnable=_get(d, "noise_learnable", True),
            decoder_layers_indexes=_tup(_get(d, "decoder_layers_indexes", (3, 4, 5))),
            loss_types=_tup(_get(d, "loss_types", ("seg",))),
            loss_weights=_tup(_get(d, "loss_weights", (1.0,))),
            always_use_beta=_get(d, "always_use_beta", False),
            style_group_size=_get(d, "style_group_size", None),
            inner_unroll=_get(d, "inner_unroll", 1),
        )


@dataclasses.dataclass(frozen=True)
class CodeMaskConfig:
    """Per-code masking config inside `latent_DA`
    (config/ACDC/1500_epoch/MICCAI2021_LSM.json:62-81)."""

    loss_name: str = "mse"
    mask_type: str = "random"
    max_threshold: float = 0.5
    random_threshold: bool = True
    if_soft: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "CodeMaskConfig":
        return cls(
            loss_name=_get(d, "loss_name", "mse"),
            mask_type=_get(d, "mask_type", "random"),
            max_threshold=_get(d, "max_threshold", 0.5),
            random_threshold=_get(d, "random_threshold", True),
            if_soft=_get(d, "if_soft", True),
        )


@dataclasses.dataclass(frozen=True)
class LatentDAConfig:
    mask_image_code: bool = True
    mask_shape_code: bool = True
    image_code: CodeMaskConfig = CodeMaskConfig()
    shape_code: CodeMaskConfig = CodeMaskConfig(loss_name="ce")

    @classmethod
    def from_dict(cls, d: dict) -> "LatentDAConfig":
        scope = _get(d, "mask_scope", ("image code", "shape code"))
        return cls(
            mask_image_code="image code" in scope,
            mask_shape_code="shape code" in scope,
            image_code=CodeMaskConfig.from_dict(_get(d, "image code", {}) or {}),
            shape_code=CodeMaskConfig.from_dict(_get(d, "shape code", {}) or {}),
        )


@dataclasses.dataclass(frozen=True)
class OutputConfig:
    save_epoch_every_num_epochs: int = 100

    @classmethod
    def from_dict(cls, d: dict) -> "OutputConfig":
        return cls(save_epoch_every_num_epochs=_get(d, "save_epoch_every_num_epochs", 100))


@dataclasses.dataclass(frozen=True)
class SegmentationModelConfig:
    network_type: str = "FCN_16_standard_no_STN"
    num_classes: int = 4

    @classmethod
    def from_dict(cls, d: dict) -> "SegmentationModelConfig":
        return cls(network_type=_get(d, "network_type", "FCN_16_standard_no_STN"),
                   num_classes=_get(d, "num_classes", 4))


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = ""
    data: DataConfig = DataConfig()
    segmentation_model: SegmentationModelConfig = SegmentationModelConfig()
    learning: LearningConfig = LearningConfig()
    max_style: MaxStyleConfig = MaxStyleConfig()
    latent_DA: LatentDAConfig = LatentDAConfig()
    output: OutputConfig = OutputConfig()

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        return cls(
            name=_get(d, "name", ""),
            data=DataConfig.from_dict(_get(d, "data", {}) or {}),
            segmentation_model=SegmentationModelConfig.from_dict(
                _get(d, "segmentation_model", {}) or {}),
            learning=LearningConfig.from_dict(_get(d, "learning", {}) or {}),
            max_style=MaxStyleConfig.from_dict(_get(d, "max_style", {}) or {}),
            latent_DA=LatentDAConfig.from_dict(_get(d, "latent_DA", {}) or {}),
            output=OutputConfig.from_dict(_get(d, "output", {}) or {}),
        )

    @classmethod
    def from_json(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @property
    def crop_hw(self) -> Tuple[int, int]:
        return (self.data.crop_size[0], self.data.crop_size[1])

    @property
    def train_batch_size(self) -> int:
        """Half batch when the loader emits aug+orig pairs (train_adv…:113-117)."""
        if self.data.keep_orig_image_label_pair_for_training:
            return self.learning.batch_size // 2
        return self.learning.batch_size
