"""deepim_tpu_torch.config against deepim_tpu's (CPU).

Every experiment YAML of the repo loads into both packages as the same
dataclass tree; unknown keys and bad values raise the same errors; the
port's copy of the flow pyramid's weights equals the reference's.
"""

import dataclasses
from pathlib import Path

import pytest
import yaml

from deepim_tpu.config import config as cfg_j
from deepim_tpu.losses.losses import FLOW_LEVEL_WEIGHTS
from deepim_tpu_torch.config import config as cfg_t

ROOT = Path(__file__).resolve().parents[1]
YAMLS = sorted((ROOT / "experiments" / "cfgs").rglob("*.yaml"))


def test_every_yaml_is_found():
    assert len(YAMLS) >= 30
    assert any(p.parent.name == "lm6d" for p in YAMLS)


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: str(p.relative_to(ROOT / "experiments")))
def test_yaml_loads_alike(path):
    got = dataclasses.asdict(cfg_t.update_config(str(path)))
    assert got == dataclasses.asdict(cfg_j.update_config(str(path)))
    with open(path) as f:
        overrides = yaml.safe_load(f)
    assert dataclasses.asdict(cfg_t.config_from_dict(overrides)) == got


@pytest.mark.parametrize("overrides,error", [
    ({"network": {"no_such_key": 1}}, KeyError),
    ({"no_such_section": {}}, KeyError),
    ({"network": {"quant": "int4"}}, ValueError),
    ({"train": {"flow_occ_stride": 0}}, ValueError),
    ({"train": {"flow_occ_stride": 8}}, ValueError),
])
def test_bad_values_raise_alike(overrides, error):
    with pytest.raises(error) as e_t:
        cfg_t.config_from_dict(overrides)
    with pytest.raises(error) as e_j:
        cfg_j.config_from_dict(overrides)
    assert str(e_t.value) == str(e_j.value)


def test_flow_level_weights_equal():
    assert cfg_t.FLOW_LEVEL_WEIGHTS == FLOW_LEVEL_WEIGHTS
    assert cfg_t.QUANT_MODES == cfg_j.QUANT_MODES


def test_save_config_round_trips(tmp_path):
    cfg = cfg_t.config_from_dict({"experiment": "x", "test": {"batch_size": 128},
                                  "train": {"lr_decay_steps": [5, 9]}})
    cfg_t.save_config(cfg, str(tmp_path / "x.yaml"))
    assert cfg_t.update_config(str(tmp_path / "x.yaml")) == cfg
    assert cfg_j.update_config(str(tmp_path / "x.yaml")) == cfg_j.config_from_dict(
        {"experiment": "x", "test": {"batch_size": 128}, "train": {"lr_decay_steps": [5, 9]}})
