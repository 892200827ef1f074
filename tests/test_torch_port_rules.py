"""Rules of the port that no numeric test shows.

  * bdvcil_torch and chip_smoke.py import neither JAX (nor flax/optax) nor
    anything of bdvcil_tpu;
  * entry points run on the card unless told otherwise: with no CUDA device
    and no ``device`` they raise;
  * switches and methods that are not ported yet raise NotImplementedError
    naming the ROADMAP item;
  * chip_smoke.py fails, and prints no result, without a GPU or without the
    rest of the repo.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from bdvcil_torch.models import build_model, init_model_params
from bdvcil_torch.optim import build_optimizer
from bdvcil_torch.runtime import make_train_step
from tests.torch_port_helpers import model_cfg

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "bdvcil_tpu")


def _port_sources():
    return sorted((ROOT / "bdvcil_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_nothing_of_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, bdvcil_torch\n"
        "for m in pkgutil.walk_packages(bdvcil_torch.__path__, 'bdvcil_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(model_cfg(18, "pad", "xla", 3, in_channels=512))


@pytest.mark.parametrize("backbone", [
    dict(shift_mode="fused"), dict(stem_mode="s2d"), dict(conv1x1_mode="pallas_gemm"),
    dict(bn_groups=2), dict(bn_stats_rows=4),
])
def test_unported_switches_raise_naming_the_roadmap(backbone):
    cfg = model_cfg(18, "pad", "xla", 3, in_channels=512)
    cfg["backbone"].update(backbone)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu").module()


def test_unported_options_raise():
    cfg = model_cfg(18, "pad", "xla", 3, in_channels=512)
    cfg["backbone"]["bn_groups"] = "per_device"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu")
    spec = build_model(model_cfg(18, "pad", "xla", 3, in_channels=512), device="cpu")
    model = init_model_params(spec, 0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer(model, dict(type="SGD", lr=0.1), accumulate_steps=2)
    tx = build_optimizer(model, dict(type="SGD", lr=0.1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(spec, tx, 3, method="icarl")


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_gpu():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
