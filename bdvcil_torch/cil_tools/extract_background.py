"""Offline background bank builder (the counterpart of
``cil_tools/extract_background.py``; reference cil_tools/extract_background.py:17-163):
a temporal median (or mean) over the frames of each video, or the simulated
camera-motion nanmedian / nanmean, one JPEG per video, skipping videos whose
background exists.

    python -m bdvcil_torch.cil_tools.extract_background --video_dir DIR --output_dir DIR
        [--num_workers 4] [--method tmf|sim_cam] [--avg_method median|mean]
        [--device [cpu]]

Without ``--device`` the reduction runs on the host, split over
``--num_workers`` forked processes, as in the JAX tool; the median is
``np.median(...).astype(np.uint8)``, which truncates the mean of the two
middle values of an even count. With ``--device`` the ``tmf`` median runs on
the card (``--device cpu``: the same torch code on the CPU) through
``ops/augment.temporal_median``, which rounds that mean half to even, as the
JAX tool's device median does; it runs in this process, one video after
another, so no forked worker touches CUDA. ``--device`` without a CUDA device
raises.

Under a launcher the ranks split the sorted videos (rank r takes every W-th
from r). The host path reads the rank from the launcher's environment and
joins no process group, so its workers fork from a parent that has touched
neither CUDA nor a group; ``--device`` joins the group first
(``parallel.distributed.initialize``) and runs on the rank's card.
"""

from __future__ import annotations

import argparse
import math
import multiprocessing
import pathlib
from typing import List, Optional, Sequence

import cv2
import numpy as np

from .._device import resolve_device
from ..parallel import distributed


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Extract the background of every video")
    parser.add_argument("--video_dir", required=True)
    parser.add_argument("--glob_pattern", default="*")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--from_video", action="store_true",
                        help="read .avi/.mp4 instead of frame dirs")
    parser.add_argument("--image_suffix", default=".jpg")
    parser.add_argument("--interval", type=int, default=1)
    parser.add_argument("--max_frames", type=int, default=500)
    parser.add_argument("--method", default="tmf", choices=["tmf", "sim_cam"])
    parser.add_argument("--avg_method", default="median", choices=["median", "mean"])
    parser.add_argument("--device", nargs="?", const="",
                        help="run the median on the card (or on the named torch device)")
    return parser.parse_args(argv)


def _collect_frames(data_path: pathlib.Path, from_video: bool, interval: int, max_frames: int):
    frames = []
    if from_video:
        cap = cv2.VideoCapture(str(data_path))
        count = 0
        while cap.isOpened() and len(frames) <= max_frames:
            ret, frame = cap.read()
            if not ret:
                break
            if count % interval == 0:
                frames.append(frame)
            count += 1
        cap.release()
    else:
        for count, img_f in enumerate(sorted(data_path.glob("*"))):
            if len(frames) > max_frames:
                break
            if count % interval == 0:
                img = cv2.imread(str(img_f))
                if img is not None:
                    frames.append(img)
    return frames


def bg_extraction_tmf(data_path, dest, from_video, interval, max_frames, avg_method=0,
                      device=None):
    """Median (or mean) temporal filter background; ``device`` (a torch
    device) runs the median there."""
    frames = _collect_frames(data_path, from_video, interval, max_frames)
    if not frames:
        return None
    stack = np.stack(frames, axis=0)
    if device is not None:
        import torch

        from ..ops.augment import temporal_median

        bg = temporal_median(torch.from_numpy(stack).to(device)).cpu().numpy()
    elif avg_method == 0:
        bg = np.median(stack, axis=0).astype(np.uint8)
    else:
        bg = stack.mean(axis=0).astype(np.uint8)
    cv2.imwrite(str(dest), bg)
    return bg


def sim_cam_motion_bg_extract(data_path, dest, from_video, interval, max_frames, avg_method=0,
                              device=None):
    """Simulated-camera-motion variant: random-resized-crop each frame, mark
    vacated pixels NaN, then nanmedian/nanmean (reference :78-99); on the
    host always, as in the JAX tool."""
    rng = np.random.default_rng(0)
    image_files = sorted(data_path.glob("*"))
    transform_frames = []
    for i, frame_f in enumerate(image_files[:-1:interval]):
        if i == max_frames:
            break
        frame = cv2.imread(str(frame_f))
        if frame is None:
            continue
        h, w = frame.shape[:2]
        # random resized crop to a fixed canvas, out-of-crop pixels NaN
        scale = rng.uniform(0.3, 1.0)
        ch, cw = max(1, int(h * scale)), max(1, int(w * scale))
        top = int(rng.integers(0, h - ch + 1))
        left = int(rng.integers(0, w - cw + 1))
        crop = cv2.resize(frame[top : top + ch, left : left + cw], (100, 100)).astype(np.float64)
        crop[crop == 0] = np.nan
        transform_frames.append(crop)
    if not transform_frames:
        return None
    stack = np.stack(transform_frames, axis=0)
    if avg_method == 0:
        bg = np.nanmedian(stack, axis=0)
    else:
        bg = np.nanmean(stack, axis=0)
    bg = np.nan_to_num(bg).astype(np.uint8)
    cv2.imwrite(str(dest), bg)
    return bg


def bg_extract_multiple(paths: List[pathlib.Path], output_dir, from_video, interval, max_frames,
                        process_id, method, avg_method, device=None):
    for i, data_path in enumerate(paths):
        dest = (output_dir / data_path.name).with_suffix(".jpg")
        method(data_path, dest, from_video, interval, max_frames, avg_method, device)
        if i % 50 == 0:
            print(f"[worker {process_id}] {i}/{len(paths)}")


def main(argv: Optional[Sequence[str]] = None) -> List[pathlib.Path]:
    """Extract the missing backgrounds; returns the videos it extracted."""
    args = parse_args(argv)
    if args.device is not None:
        distributed.initialize()  # the process group under a launcher; a no-op alone
    # the card unless a device is named; raises without CUDA
    device = None if args.device is None else resolve_device(args.device or None)
    rank, world = distributed.launch_rank()
    output_dir = pathlib.Path(args.output_dir)
    output_dir.mkdir(exist_ok=True, parents=True)
    video_dir = pathlib.Path(args.video_dir)

    # skip-existing resume (reference :119-125); the ranks split the sorted
    # list before skipping, so the split does not depend on timing
    video_paths = set(sorted(video_dir.glob(args.glob_pattern))[rank::world])
    extracted = [
        p for p in video_paths if (output_dir / p.name).with_suffix(args.image_suffix).exists()
    ]
    video_paths = sorted(video_paths.difference(extracted))
    print(f"Found {len(extracted)} backgrounds")
    print(f"Extracting background from {len(video_paths)} videos")

    method = bg_extraction_tmf if args.method == "tmf" else sim_cam_motion_bg_extract
    avg_method = 0 if args.avg_method == "median" else 1
    if device is not None:
        bg_extract_multiple(video_paths, output_dir, args.from_video, args.interval,
                            args.max_frames, 0, method, avg_method, device)
        return video_paths

    per = math.ceil(len(video_paths) / args.num_workers) if video_paths else 0
    processes = []
    for i in range(args.num_workers):
        chunk = video_paths[i * per : (i + 1) * per]
        if not chunk:
            continue
        p = multiprocessing.Process(
            target=bg_extract_multiple,
            args=(chunk, output_dir, args.from_video, args.interval, args.max_frames,
                  i, method, avg_method),
        )
        processes.append(p)
        p.start()
    for p in processes:
        p.join()
    failed = [p.exitcode for p in processes if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"extract_background: {len(failed)} worker(s) failed, exit codes "
                           f"{failed}")
    return video_paths


if __name__ == "__main__":
    main()
