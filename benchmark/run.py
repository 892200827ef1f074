"""The benchmark of ``bdvcil_torch`` on an NVIDIA H100: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It needs as many CUDA devices as the cell
asks for and exits non-zero without a result otherwise; it exits 2 without
a result when the program cannot be imported, or when the cell's
configuration names a model family that ``benchmark/families`` does not
hold. The last line of standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, last,
``checks``: each number compared with its limit. The same numbers end
standard error. Build outputs (``bdvcil_torch/_build``), the corpus
(``benchmark/.corpus``) and any compiler caches (``benchmark/.cache``) stay
inside the checkout; the trainer's work directory is made under TMPDIR and
removed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _environment() -> None:
    """Fixed cache directories inside the checkout. The port builds its own
    kernels into ``bdvcil_torch/_build``; these cover torch's and Triton's."""
    cache = HERE / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    try:
        from benchmark import harness, manifest

        man = manifest.Manifest(ROOT)
        entry = man.workload(args.workload)
        chips = int(entry["chips"])
        man.config_family(entry["config"])  # an unknown family, or a configuration it refuses
        import bdvcil_torch  # noqa: F401  the system under test
    except (ImportError, OSError, KeyError, ValueError) as e:
        print(f"benchmark: cannot start: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  "cuda", T_START, man=man)
    except Exception:  # noqa: BLE001 -- no result line, the cause on stderr
        traceback.print_exc()
        print("benchmark: the run failed", file=sys.stderr)
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}, which no run may load", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
