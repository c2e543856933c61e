"""The YAML-subset reader of support/config.py against PyYAML's safe_load
on every profile in configs/, and its dump/parse round trip."""

import dataclasses
import glob
import os

import pytest

from srsran_project_tpu.support import config as cfg_mod

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                        "configs", "*.yml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_matches_safe_load(path):
    yaml = pytest.importorskip("yaml")
    text = open(path).read()
    assert cfg_mod.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("tok", [
    "3.5e9", "3.5e+9", "1_000", "0x1f", "yes", "Off", "~", "''", "'a''b'",
    '"x\\ty"', ".5", "-.inf", "1.", "[1, [2, 3]]", "{a: 1, b: [x, y]}", "text # comment",
])
def test_scalar_typing_matches_safe_load(tok):
    yaml = pytest.importorskip("yaml")
    assert cfg_mod.parse_yaml(f"k: {tok}\n") == yaml.safe_load(f"k: {tok}\n")


def test_dump_round_trip():
    cfg = cfg_mod.load_config(os.path.join(os.path.dirname(__file__), "..",
                                           "configs", "ntn_geo.yml"))
    text = cfg_mod.dump_config(cfg)
    assert cfg_mod.parse_yaml(text) == dataclasses.asdict(cfg)


def test_block_lists_and_errors():
    assert cfg_mod.parse_yaml("a:\n  - 1\n  - x: 2\n    y: 3\nb: []\n") == {
        "a": [1, {"x": 2, "y": 3}], "b": []}
    assert cfg_mod.parse_yaml("a:\n- 1\n- 2\n") == {"a": [1, 2]}
    with pytest.raises(ValueError):
        cfg_mod.parse_yaml("a: 1\n  b: 2\n")
