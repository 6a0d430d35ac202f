"""The port's own copy of the config module parses every JSON file under
configs/ to exactly the field values the JAX package parses."""

import dataclasses
from pathlib import Path

import pytest

from maxstyle_tpu import config as jconfig
from maxstyle_tpu_torch import config as tconfig

CONFIGS = sorted(str(p.relative_to(Path(__file__).resolve().parents[1]))
                 for p in (Path(__file__).resolve().parents[1] / "configs").rglob("*.json"))
ROOT = Path(__file__).resolve().parents[1]


def test_configs_are_found():
    assert len(CONFIGS) >= 10


@pytest.mark.parametrize("path", CONFIGS)
def test_config_parses_to_equal_fields(path):
    ours = tconfig.ExperimentConfig.from_json(str(ROOT / path))
    theirs = jconfig.ExperimentConfig.from_json(str(ROOT / path))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.crop_hw == theirs.crop_hw
    assert ours.train_batch_size == theirs.train_batch_size


def test_defaults_are_equal():
    assert dataclasses.asdict(tconfig.ExperimentConfig()) == \
        dataclasses.asdict(jconfig.ExperimentConfig())
    assert dataclasses.asdict(tconfig.ExperimentConfig.from_dict({})) == \
        dataclasses.asdict(jconfig.ExperimentConfig.from_dict({}))
