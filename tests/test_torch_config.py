"""The port's config system (tmdiff_tpu_torch/config) against the JAX
package's: every preset, parsed with debug on and off, gives the same tree
and the same printed form; the port's preset copies equal the JAX package's
files in every key and value but their `info` strings (and comments), which
name the port's entry points and no TPU figure. PORT_ONLY names the presets
of what the port serves and the JAX package does not (the ControlNet's
serving recipe); every preset, those too, parses as the JAX package's
parser reads it."""
import os
import re

import pytest
import torch

from tmdiff_tpu.config import config as jax_config
from tmdiff_tpu_torch.config import config

torch.set_num_threads(2)

PRESETS = sorted(n for n in os.listdir(config.PRESETS) if n.endswith(".json"))
PORT_ONLY = ["serve_controlnet.json"]


def test_presets_are_the_jax_packages():
    jax_dir = os.path.join(os.path.dirname(jax_config.__file__), "presets")
    shared = sorted(n for n in os.listdir(jax_dir) if n.endswith(".json"))
    assert PRESETS == sorted(shared + PORT_ONLY)
    for name in PORT_ONLY:
        with open(os.path.join(config.PRESETS, name)) as f:
            assert not re.search(r"tmdiff_tpu\.|BASELINE|orbax|/chip|TPU", f.read()), name
    for name in shared:
        ours = config.load_commented_json(os.path.join(config.PRESETS, name))
        ref = jax_config.load_commented_json(os.path.join(jax_dir, name))
        assert set(ours) == set(ref), name
        assert {k: v for k, v in ours.items() if k != "info"} == \
            {k: v for k, v in ref.items() if k != "info"}, name
        with open(os.path.join(config.PRESETS, name)) as f:
            text = f.read()
        # the port's entry points only, and no figure taken on a TPU
        assert not re.search(r"tmdiff_tpu\.|BASELINE|orbax|/chip|TPU", text), name


@pytest.mark.parametrize("debug", [False, True])
@pytest.mark.parametrize("name", PRESETS)
def test_parse_config_matches_jax(name, debug, tmp_path):
    path = os.path.join(config.PRESETS, name)
    kw = dict(phase="train", debug=debug, experiments_root=str(tmp_path / "exp"),
              make_dirs=False)
    ours = config.parse_config(path, **kw)
    ref = jax_config.parse_config(path, **kw)
    assert ours == ref
    assert config.dict2str(ours) == jax_config.dict2str(ref)
    assert ours["missing"] is None and ours["path"]["missing"] is None
    assert not os.path.exists(tmp_path / "exp")


def test_parse_config_makes_the_tree(tmp_path):
    path = os.path.join(config.PRESETS, "general_multi.json")
    opt = config.parse_config(path, phase="val", experiments_root=str(tmp_path / "exp"))
    assert opt["phase"] == "val" and opt["path"]["resume"] is None
    subdirs = {"log": "logs", "results": "results", "checkpoint": "checkpoint",
               "tb_logger": "tb_logger"}
    for key, sub in subdirs.items():
        assert opt["path"][key] == str(tmp_path / "exp" / sub)
        assert os.path.isdir(opt["path"][key])
