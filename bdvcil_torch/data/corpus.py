"""A UCF101-shaped synthetic rawframe corpus, written from a seed (the port's
counterpart of ``bench.py:284-330``).

``num_videos`` videos of ``frames_per_video`` frames at UCF101's stored 320 x
240, each frame a per-video base colour plus uniform noise (as the JAX bench's
corpus), written as JPEG (4:2:0, quality 95) by the port's own writer (the same bytes
on every machine), and one
background per video: the temporal median of the video's decoded frames,
truncated to uint8, as ``bg_extraction_tmf`` computes it
(``bdvcil_tpu/data/datasets.py:127-146``). Needs no cv2 or PIL and downloads
nothing. A finished corpus is marked and reused.

    rawframes/v0000/img_00001.jpg ...   bg/v0000.jpg ...
"""

from __future__ import annotations

import pathlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from . import native

UCF_STORED = (320, 240)  # (w, h) of UCF101's stored frames
FILENAME_TMPL = "img_{:05}.jpg"


def median_background(frames: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (H, W, 3) uint8: ``np.median`` over the frames,
    cast to uint8 (the mean of the middle pair, truncated, for even T)."""
    t = frames.shape[0]
    mid = sorted({(t - 1) // 2, t // 2})
    part = np.partition(frames, mid, axis=0)
    return ((part[mid[0]].astype(np.uint16) + part[mid[-1]]) // 2).astype(np.uint8)


def _write_video(info: Dict, bg: str, rng: np.random.Generator, size: Tuple[int, int]) -> None:
    w, h = size
    t = info["total_frames"]
    vdir = pathlib.Path(info["frame_dir"])
    vdir.mkdir(parents=True, exist_ok=True)
    base = rng.integers(0, 200, size=3).astype(np.uint8)
    # base < 200 and noise < 55: the sum stays below 255
    frames = base + rng.integers(0, 55, size=(t, h, w, 3), dtype=np.uint8)
    paths = [str(vdir / FILENAME_TMPL.format(i)) for i in range(1, t + 1)]
    native.write_jpeg_batch(paths, frames, num_threads=1)
    decoded = np.stack([native.decode_file(p) for p in paths])
    native.write_jpeg_batch([bg], median_background(decoded)[None], num_threads=1)


def write_corpus(root, num_videos: int, frames_per_video: int = 16, seed: int = 0,
                 num_classes: int = 51, size: Tuple[int, int] = UCF_STORED,
                 ) -> Tuple[List[Dict], List[str]]:
    """Write (or reuse) the corpus under ``root``; return ``(video_infos,
    bg_files)`` in the loaders' form (``frame_dir``, ``total_frames``,
    ``label`` = video index mod ``num_classes``)."""
    root = pathlib.Path(root)
    w, h = size
    infos = [dict(frame_dir=str(root / "rawframes" / f"v{v:04d}"),
                  total_frames=frames_per_video, label=v % num_classes)
             for v in range(num_videos)]
    bg_files = [str(root / "bg" / f"v{v:04d}.jpg") for v in range(num_videos)]
    marker = root / f".ok_{num_videos}x{frames_per_video}_{w}x{h}_seed{seed}"
    if marker.exists():
        return infos, bg_files
    (root / "bg").mkdir(parents=True, exist_ok=True)
    # one video per thread (the encoder, the decoder, numpy's generators and
    # np.partition release the GIL), each from its own generator
    with ThreadPoolExecutor(native.default_threads()) as pool:
        for done in [pool.submit(_write_video, info, bg, np.random.default_rng([seed, v]), size)
                     for v, (info, bg) in enumerate(zip(infos, bg_files))]:
            done.result()
    marker.touch()
    return infos, bg_files
