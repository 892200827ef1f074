"""The traffic generator: a rawframe corpus in the layout the CIL trainer
reads, from a traffic file's parameters alone.

Each video is ``frames`` JPEG frames at ``width`` x ``height`` (UCF101's and
HMDB51's stored 320 x 240), 4:2:0 at ``quality``, written with cv2. A frame
is structured like video rather than noise: a two-colour gradient, a few
textured shapes moving along straight paths, and mild noise. Beside each
video its background, the temporal median of its decoded frames (as the
reference's temporal-median extraction computes it), under ``bg_extract/``.

The train split holds ``train_videos_per_class`` videos of each class of the
base task (the classes ``make_cil_config`` puts in task 0 for the
configuration's split seed); the val split one video of every class, which
the trainer's data module needs to build its per-task sets. The annotation
files carry the names the dataset preset gives them.

The corpus depends only on the traffic file (its ``corpus_seed``), never on a
run's seed, and is written once into a fixed directory and reused while the
marker that records its parameters matches.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import pathlib
import shutil
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Sequence

import numpy as np

FILENAME_TMPL = "img_{:05}.jpg"


def video_frames(rng: np.random.Generator, frames: int, width: int, height: int) -> np.ndarray:
    """(frames, height, width, 3) uint8 frames of one video."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    c0, c1 = rng.uniform(20, 235, size=(2, 3)).astype(np.float32)
    angle = rng.uniform(0, 2 * np.pi)
    ramp = (np.cos(angle) * xs / width + np.sin(angle) * ys / height + 1.0) / 2.0
    base = c0 + (c1 - c0) * ramp[..., None]
    shapes = []
    for _ in range(int(rng.integers(2, 5))):
        shapes.append(dict(
            centre=rng.uniform([0, 0], [width, height]).astype(np.float32),
            velocity=rng.uniform(-6, 6, size=2).astype(np.float32),
            radii=rng.uniform([18, 14], [70, 55]).astype(np.float32),
            colour=rng.uniform(0, 255, size=3).astype(np.float32),
            freq=rng.uniform(0.05, 0.4, size=2).astype(np.float32),
        ))
    noise = rng.integers(-4, 5, size=(frames, height, width, 3), dtype=np.int8)
    out = np.empty((frames, height, width, 3), np.uint8)
    for t in range(frames):
        img = base.copy()
        for s in shapes:
            cx, cy = s["centre"] + t * s["velocity"]
            rx, ry = s["radii"]
            # the shape's bounding box only
            x0, x1 = max(int(cx - rx), 0), min(int(cx + rx) + 1, width)
            y0, y1 = max(int(cy - ry), 0), min(int(cy + ry) + 1, height)
            if x0 >= x1 or y0 >= y1:
                continue
            bx, by = xs[y0:y1, x0:x1], ys[y0:y1, x0:x1]
            inside = ((bx - cx) / rx) ** 2 + ((by - cy) / ry) ** 2 <= 1.0
            texture = 0.75 + 0.25 * np.sin(s["freq"][0] * bx + s["freq"][1] * by + t)
            box = img[y0:y1, x0:x1]
            box[inside] = (s["colour"] * texture[..., None])[inside]
        img += noise[t]
        out[t] = np.clip(img + 0.5, 0, 255).astype(np.uint8)
    return out


def median_background(frames: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (H, W, 3) uint8: the median over the frames,
    the mean of the middle pair truncated for even T."""
    t = frames.shape[0]
    mid = sorted({(t - 1) // 2, t // 2})
    part = np.partition(frames, mid, axis=0)
    return ((part[mid[0]].astype(np.uint16) + part[mid[-1]]) // 2).astype(np.uint8)


def _write_video(root: pathlib.Path, name: str, seed: Sequence[int], traffic: Dict) -> None:
    import cv2  # the card's machine and the test machine have it

    rng = np.random.default_rng(list(seed))
    frames = video_frames(rng, traffic["frames"], traffic["width"], traffic["height"])
    vdir = root / "rawframes" / name
    vdir.mkdir(parents=True, exist_ok=True)
    params = [cv2.IMWRITE_JPEG_QUALITY, int(traffic["quality"])]
    if hasattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR"):
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
    decoded = []
    for t, frame in enumerate(frames, 1):
        ok, buf = cv2.imencode(".jpg", frame[..., ::-1], params)
        if not ok:
            raise RuntimeError(f"cv2 could not encode {name} frame {t}")
        (vdir / FILENAME_TMPL.format(t)).write_bytes(buf.tobytes())
        decoded.append(cv2.imdecode(buf, cv2.IMREAD_COLOR))
    bg = median_background(np.stack(decoded))
    ok, buf = cv2.imencode(".jpg", bg, params)
    if not ok:
        raise RuntimeError(f"cv2 could not encode the background of {name}")
    (root / "bg_extract" / f"{name}.jpg").write_bytes(buf.tobytes())


def plan(traffic: Dict, splits: List[List[int]]) -> Dict[str, List]:
    """The corpus's videos: {'train': [(name, label)], 'val': [...]}."""
    train = [(f"c{label:03d}_v{k:04d}", label)
             for k in range(traffic["train_videos_per_class"]) for label in splits[0]]
    val = [(f"val_c{label:03d}", label) for task in splits for label in task]
    return {"train": train, "val": val}


def write_corpus(root, traffic: Dict, splits: List[List[int]], train_ann: str, val_ann: str,
                 threads: int = 8) -> pathlib.Path:
    """Write the corpus under ``root`` unless its marker matches; return
    ``root``. ``train_ann`` / ``val_ann`` are the annotation file names the
    dataset preset reads (``<root>/<name>``)."""
    root = pathlib.Path(root)
    spec = dict(traffic=traffic, splits=splits, train_ann=train_ann, val_ann=val_ann)
    marker = root / "corpus.json"
    if marker.exists() and json.loads(marker.read_text()) == spec:
        return root
    if root.exists():
        shutil.rmtree(root)
    (root / "bg_extract").mkdir(parents=True)
    videos = plan(traffic, splits)
    names = [(n, i) for i, (n, _) in enumerate(videos["train"] + videos["val"])]
    # one process a core (the frames are numpy work that holds the GIL), each
    # started fresh: the caller may hold threads and a device
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max(1, threads), mp_context=ctx) as pool:
        jobs = [pool.submit(_write_video, root, n, (traffic["corpus_seed"], i), traffic)
                for n, i in names]
        for job in jobs:
            job.result()
    for split, fname in (("train", train_ann), ("val", val_ann)):
        lines = [f"{name} {traffic['frames']} {label}\n" for name, label in videos[split]]
        (root / fname).write_text("".join(lines))
    marker.write_text(json.dumps(spec))
    return root


def default_threads() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1
