"""The port's sanity-check config (bdvcil_torch/configs/bgmix_debias_sanity_check.py)
against the JAX system's (configs/cil/bgmix_debias_sanity_check.py), on the CPU.

  * the two files' dicts are equal, whole (each loaded by its own package's
    ``Config.fromfile``), and loading them imports no JAX;
  * its one task holds every UCF-101 class in the order of seed 1000;
  * ``train_cil``'s own loading path reads it, and the model it configures
    has a 101-way head (a forward of one clip at 32² gives (1, 1, 101)
    finite scores).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bdvcil_torch.cil_tools import train_cil
from bdvcil_torch.config import Config as PortConfig
from bdvcil_torch.models import build_model, init_model_params
from bdvcil_torch.protocol import class_order
from bdvcil_tpu.config import Config as JaxConfig
from bdvcil_tpu.protocol import class_order as jax_class_order

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILE = ROOT / "bdvcil_torch" / "configs" / "bgmix_debias_sanity_check.py"
JAX_FILE = ROOT / "configs" / "cil" / "bgmix_debias_sanity_check.py"


@pytest.fixture(autouse=True)
def _no_data_root(monkeypatch):
    # make_cil_config reads the data root from the environment
    monkeypatch.delenv("VIDEO_CIL_ROOT", raising=False)


def test_port_config_equals_the_jax_config_whole():
    port = PortConfig.fromfile(str(PORT_FILE)).to_dict()
    jax_cfg = JaxConfig.fromfile(str(JAX_FILE)).to_dict()
    assert port == jax_cfg
    assert port["ending_task"] == 0 and port["adaptive_scale_factors"] == [1.0]
    assert port["work_dir"] == "work_dirs/bgmix_debias_sanity_check"
    head = port["model"]["cls_head"]
    assert head["num_classes"] == head["inc_head_config"]["out_features"] == 101


def test_task_splits_are_one_task_of_every_class():
    cfg = PortConfig.fromfile(str(PORT_FILE)).to_dict()
    assert cfg["task_splits"] == [class_order(1000, 101)] == [jax_class_order(1000, 101)]
    assert sorted(cfg["task_splits"][0]) == list(range(101))


def test_both_files_load_without_jax():
    code = (
        "import sys\n"
        "from bdvcil_torch.config import Config as P\n"
        "from bdvcil_tpu.config import Config as J\n"
        f"P.fromfile({str(PORT_FILE)!r}); J.fromfile({str(JAX_FILE)!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "VIDEO_CIL_ROOT")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_train_cil_loads_it_and_builds_a_101_way_head():
    args, cfg_dict = train_cil.parse_args([str(PORT_FILE), "--device", "cpu"])
    config = train_cil.load_config(args, cfg_dict)
    assert config.filename == str(PORT_FILE)
    assert config.to_dict() == PortConfig.fromfile(str(PORT_FILE)).to_dict()
    spec = build_model(config.model, device="cpu")
    model = init_model_params(spec, 0)
    assert model.cls_head.num_classes == 101
    clip = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, spec.num_segments, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        scores = model(clip, train=False)["cls_score"]
    assert scores.shape == (1, 1, 101) and bool(torch.isfinite(scores).all())
