"""What a run may import: no JAX, no JAX package (top-level names compared
whole: the port's name begins with the JAX package's), and a reference that
takes nothing of the system under test."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "bdvcil_tpu"}


def _top_levels_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax():
    names = _top_levels_after(
        "from benchmark import harness, run, calibrate\n"
        "from bdvcil_torch.cil.trainer import CILTrainer\n"
        "from bdvcil_torch.runtime.loops import train_epochs\n"
        "from bdvcil_torch.data import loaders, native, device_pipeline\n"
        "from bdvcil_torch.ops import conv1x1_bn, tsm_shift, _build\n")
    assert "bdvcil_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "bdvcil_tpux", sys)
    monkeypatch.setitem(sys.modules, "jaxonomy.sub", sys)
    assert harness.forbidden_modules() == sorted(FORBIDDEN & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    names = _top_levels_after("from benchmark.reference import model, input_fn, step")
    assert not names & (FORBIDDEN | {"bdvcil_torch"}), names


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "reference").glob("*.py"))
                         + sorted((ROOT / "benchmark" / "families").glob("*.py")),
                         ids=lambda p: p.name if p.parent.name == "reference"
                         else f"{p.parent.name}/{p.name}")
def test_reference_sources_name_no_program_module(path):
    """The reference imports nothing outside itself; a family, the yardstick
    (``benchmark``) but nothing of the program."""
    own = {"benchmark"} if path.parent.name == "reference" else set()
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops = {(node.module or "").split(".")[0]} if node.level == 0 else set()
        else:
            continue
        assert not tops & (FORBIDDEN | {"bdvcil_torch"} | own), (path.name, tops)


def test_run_without_a_card_prints_no_result():
    """The harness's look for a chip: off the card it exits non-zero and
    prints nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "r50_hmdb51_train_task0", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
