"""Build and load the port's hand-written CUDA kernels.

Every ``bdvcil_torch/csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a``
into a shared library of its own with a plain C interface, and loaded with
``ctypes``. One ``nvcc`` process per source, all started together, so the
build takes as long as the slowest file. Libraries go to
``bdvcil_torch/_build/<hash>/``, where the hash covers every source and the
flags: a changed source builds anew, an unchanged one is reused.

Nothing is built when this module is imported, only at the first launch (or
when ``build_all`` is called), so the CPU tests import every module without a
compiler.

``sm_count`` is a card's SM count, which sizes the persistent kernels'
grids and their partials. ``LAUNCHES`` counts kernel launches by kernel
name. Each wrapper adds one where it launches its kernel and nowhere else,
so a run can show that its main path went through the kernels. A call
that can take more than one path counts there too, under the path it took
(``attention.<where>.<path>``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from functools import lru_cache
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

LAUNCHES: Counter = Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_all() -> Path:
    """Compile every source that has no library yet; return the library dir.

    Compiler output (``-Xptxas -v``: registers, shared memory, spills) is kept
    beside each library as ``<name>.log``.
    """
    out_dir = BUILD_ROOT / _digest()
    pending = [s for s in sources() if not (out_dir / f"lib{s.stem}.so").exists()]
    if not pending:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in pending:
        tmp = out_dir / f"lib{src.stem}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        (out_dir / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out_dir


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{stem}.so"))
            lib.bdv_cuda_error_string.argtypes = [ctypes.c_int]
            lib.bdv_cuda_error_string.restype = ctypes.c_char_p
            _libs[stem] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (its ``cudaGetLastError``)."""
    if code != 0:
        msg = lib.bdv_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


@lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device: the persistent kernels' grid
    has at most one CTA per SM, and their partials one row per CTA."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def dispatch(name: str, x, kernel, plain, *args):
    """``kernel(*args)`` when ``x`` is a CUDA tensor, ``plain(*args)`` when it
    lies on the CPU; any other device raises. No fallback: a kernel that fails
    to build or launch raises."""
    if x.is_cuda:
        return kernel(*args)
    if x.device.type == "cpu":
        return plain(*args)
    raise NotImplementedError(f"no {name} for device {x.device}")
