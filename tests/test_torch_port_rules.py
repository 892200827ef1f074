"""Rules of the port that no numeric test shows.

  * bdvcil_torch and chip_smoke.py import neither JAX (nor flax/optax) nor
    anything of bdvcil_tpu;
  * entry points run on the card unless told otherwise: with no CUDA device
    and no ``device`` they raise;
  * switches, methods and options that are not ported raise
    NotImplementedError naming the ROADMAP item;
  * the package's layout docstrings name every module;
  * chip_smoke.py fails, and prints no result, without a GPU or without the
    rest of the repo, and on a failure its last line of stderr names the
    phase and the error without a C++ backtrace;
  * the port carries its own JPEG codec: no source includes ``jpeglib.h``,
    the host libraries are built without ``-ljpeg`` and need no libjpeg.
"""

import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

import importlib
import importlib.util

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


STUDY_SOURCES = ["bdvcil_torch/parity_study.py", "bdvcil_torch/bn_ablation.py",
                 "bdvcil_torch/reference_loop/__init__.py",
                 "bdvcil_torch/reference_loop/model.py",
                 "bdvcil_torch/reference_loop/mini_cil.py",
                 "bdvcil_torch/reference_loop/tree.py"]


@pytest.mark.parametrize("rel", STUDY_SOURCES)
def test_study_modules_import_nothing_of_jax_or_the_tests(rel):
    """The accuracy studies keep their own copies of the tests' harness: the
    card's machine has no JAX, and the repo's tests are not a package to ship."""
    tree = ast.parse((ROOT / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN + ("tests", "tools"), (
                f"{rel}: imports {name}")


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


@pytest.mark.parametrize("call", ["entry", "dryrun_multichip"])
def test_graft_entry_points_refuse_to_fall_back_to_the_cpu(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    from bdvcil_torch import graft_entry

    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry() if call == "entry" else graft_entry.dryrun_multichip(2)


@pytest.mark.parametrize("backbone", [dict(conv1x1_mode="pallas_gemm")])
def test_unported_switches_raise_naming_the_roadmap(backbone):
    cfg = model_cfg(18, "pad", "xla", 3, in_channels=512)
    cfg["backbone"].update(backbone)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu").module()


def test_unported_options_raise():
    spec = build_model(model_cfg(18, "pad", "xla", 3, in_channels=512), device="cpu")
    model = init_model_params(spec, 0)
    # gradient accumulation is ported (optim.py); 'finetune' and 'oracle' are
    # the trainer's names for 'base', not step methods
    assert build_optimizer(model, dict(type="SGD", lr=0.1), accumulate_steps=2).accumulate_steps == 2
    tx = build_optimizer(model, dict(type="SGD", lr=0.1))
    with pytest.raises(ValueError, match="trainer maps"):
        make_train_step(spec, tx, 3, method="finetune")


def test_train_cil_refuses_to_fall_back_to_the_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["VIDEO_CIL_ROOT"] = str(tmp_path)
    res = subprocess.run([sys.executable, "-m", "bdvcil_torch.cil_tools.train_cil", "--preset",
                          "hmdb51:1000:6", "--work_dir", str(tmp_path / "wd")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "device='cpu'" in res.stderr
    assert not (tmp_path / "wd").exists()


def _module_names(package: pathlib.Path):
    return sorted(p.stem if p.is_file() else p.name for p in package.iterdir()
                  if (p.suffix == ".py" and p.stem != "__init__")
                  or (p.is_dir() and (p / "__init__.py").exists()))


@pytest.mark.parametrize("package", ["bdvcil_torch", "bdvcil_torch/data",
                                     "bdvcil_torch/cil_tools", "bdvcil_torch/tools",
                                     "bdvcil_torch/parallel", "bdvcil_torch/reference_loop"])
def test_layout_docstrings_name_every_module(package):
    doc = importlib.import_module(package.replace("/", ".")).__doc__
    names = [n for n in _module_names(ROOT / package) if not n.startswith("_")]
    assert names
    missing = [n for n in names if n not in doc]
    assert not missing, f"{package}/__init__.py does not name {missing}"


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


def _smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke_rules", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cuda_error():
    lines = ["CUDA error: an illegal memory access was encountered",
             "Exception raised from c10_cuda_check_implementation at CUDAException.cpp:44 "
             "(most recent call first):"]
    lines += [f"frame #{i}: <unknown function> + 0x{i:x} (0x1 in libc10.so)" for i in range(30)]
    raise RuntimeError("\n".join(lines))


def _rank_log_error():
    log = [f"rank line {i}" for i in range(12)] + ["RuntimeError: CUDA error: out of memory"]
    log += [f"frame #{i}: <unknown function>" for i in range(30)]
    raise AssertionError("distributed (b): rank exit codes [0, 1]\n--- rank 1:\n" + "\n".join(log))


@pytest.mark.parametrize("case", ["gate", "cuda_error", "rank_log"])
def test_chip_smoke_failure_summary_names_the_phase_and_the_error(case):
    """The last line of stderr on a failure: where in the script, and the
    error's own lines without a C++ backtrace, so a log's tail shows why."""
    smoke = _smoke_module()
    calls = dict(gate=lambda: smoke._close("loss", 1.0, 2.0, 1e-3),
                 cuda_error=lambda: smoke.same_twice("y", _cuda_error),
                 rank_log=lambda: smoke.same_twice("ranks", _rank_log_error))
    with pytest.raises(Exception) as info:
        calls[case]()
    line = smoke.failure_summary(info.value)
    assert "\n" not in line and "frame #" not in line
    want = dict(gate=("_close:", "AssertionError: loss: 1.0 vs 2.0 (rtol 0.001)"),
                cuda_error=("same_twice:", "RuntimeError: CUDA error: an illegal memory access"),
                rank_log=("same_twice:", "RuntimeError: CUDA error: out of memory"))[case]
    assert line.startswith(f"chip_smoke failed in {want[0]}"), line
    assert want[1] in line, line


def _native_sources():
    return sorted(p for p in (ROOT / "bdvcil_torch").rglob("*")
                  if p.suffix in (".c", ".cc", ".cpp", ".h", ".hpp", ".cu", ".cuh")
                  and "_build" not in p.relative_to(ROOT).parts)


@pytest.mark.parametrize("path", _native_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_include_no_libjpeg(path):
    assert not re.search(r'#\s*include\s*[<"]jpeglib\.h[>"]', path.read_text()), path


def test_the_host_libraries_need_no_libjpeg():
    from bdvcil_torch.data import native

    assert not [flag for flag in native.LDLIBS if "jpeg" in flag], native.LDLIBS
    assert native.available(), native.build_error()
    libs = sorted(native.build_dir().glob("*.so"))
    assert [p.name for p in libs] == ["libdecoder.so", "libjpeg_write.so"]
    for lib in libs:
        dynamic = subprocess.run(["readelf", "-d", str(lib)], capture_output=True, text=True,
                                 check=True, timeout=60).stdout
        needed = re.findall(r"\(NEEDED\)\s+Shared library: \[([^\]]+)\]", dynamic)
        assert needed and not [n for n in needed if "jpeg" in n], (lib.name, needed)
