"""Host decode throughput: the port's native decoder against the cv2 chain
(the port of ``bench.py``'s ``bench_input``, ``bench.py:232-281``).

``--frames`` synthetic 320 x 240 JPEGs (uniform noise from
``default_rng(0)``, written by cv2 at quality 90) in a temporary directory,
then the test-mode chain on each: decode, resize of the short side to 256,
centre crop 224. The cv2 chain (``imread``, BGR -> RGB, ``resize``, a slice)
runs frame by frame; the port's ``native.decode_resize_crop_batch`` takes
the whole list at once on its thread pool, after a warm call on 8 frames.

The line: ``native_decode_frames_per_sec``, its unit, ``vs_baseline`` =
native / cv2 frames/s, and the cv2 rate, the frame count and the host's CPU
count. Host code only: it needs no card.

    python -m bdvcil_torch.bench_input [--frames 256]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys
import tempfile
import time

import numpy as np

from . import bench_train
from .data import native

METRIC = "native_decode_frames_per_sec"
SHORT_SIDE, CROP = 256, 224


def write_frames(root: pathlib.Path, n: int):
    """``n`` 320 x 240 noise frames as quality-90 JPEGs under ``root``; their paths."""
    import cv2

    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        img = rng.integers(0, 255, size=(240, 320, 3)).astype(np.uint8)
        path = str(root / f"f{i:05d}.jpg")
        if not cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 90]):
            raise OSError(f"cv2 could not write {path}")
        paths.append(path)
    return paths


def cv2_chain(path: str) -> np.ndarray:
    """Decode, short side to 256, centre crop 224, as ``bench.py``'s cv2 chain."""
    import cv2

    img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    h, w = img.shape[:2]
    f = SHORT_SIDE / min(h, w)
    img = cv2.resize(img, (int(w * f + 0.5), int(h * f + 0.5)))
    hh, ww = img.shape[:2]
    y, x = (hh - CROP) // 2, (ww - CROP) // 2
    return np.ascontiguousarray(img[y:y + CROP, x:x + CROP])


def run(args) -> dict:
    if not native.available():
        raise RuntimeError(f"native decoder unavailable: {native.build_error()}")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bdvc_bench_input_"))
    try:
        paths = write_frames(tmp, args.frames)
        t0 = time.perf_counter()
        for p in paths:
            cv2_chain(p)
        cv2_rate = len(paths) / (time.perf_counter() - t0)
        native.decode_resize_crop_batch(paths[:8], SHORT_SIDE, CROP, CROP)  # warm
        t0 = time.perf_counter()
        native.decode_resize_crop_batch(paths, SHORT_SIDE, CROP, CROP)
        native_rate = len(paths) / (time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"metric": METRIC, "value": native_rate, "unit": "frames/s",
            "vs_baseline": native_rate / cv2_rate, "cv2_frames_per_sec": cv2_rate,
            "frames": len(paths), "host_cpus": bench_train.host_cpus()}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=256)
    return parser


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
