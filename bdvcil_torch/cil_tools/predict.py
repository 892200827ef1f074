"""Batch inference on unlabeled rawframe videos, the serving surface (the
counterpart of ``cil_tools/predict.py``): classify one video's frame
directory, or a directory of them, with a trained checkpoint and write
per-video top-k predictions as JSON.

    python -m bdvcil_torch.cil_tools.predict CONFIG.py CKPT.pt FRAMES_DIR
        [--output preds.json] [--topk 5] [--batch_size 8] [--device cpu]

Frame directories are found by probing the filename template, so stray
images neither count as frames nor shift the sampler, and 0-based layouts
(``img_00000.jpg`` first) keep frame 0. The config's test pipeline runs on a
plain ``RawframeDataset`` (no augmentation); the classifier width is the
checkpoint's. When the config's directory holds
``class_indices_mapping.json`` (``create_annotation_files``), each class is
also reported by its original label. The model is float32 whatever the
config's ``compute_dtype``, as in the JAX tool, and runs on the card unless
``--device`` names another device; without a CUDA device and without ``--device`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..config import Config
from ..models.recognizer import average_clips
from ..parallel import distributed
from . import load_model


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Classify rawframe videos")
    parser.add_argument("config", help="config file (for model + test pipeline)")
    parser.add_argument("checkpoint", help="port checkpoint (.pt)")
    parser.add_argument("frames_dir", help="video frame dir, or a dir of them")
    parser.add_argument("--output", default=None, help="write JSON here (default stdout)")
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--filename_tmpl", default="img_{:05}.jpg")
    parser.add_argument("--device", help="the torch device (default: the CUDA card)")
    return parser.parse_args(argv)


def discover_videos(root: pathlib.Path, tmpl: str):
    """(name, dir, num_frames, start_index) for every frame directory under
    root: ``root`` itself when it holds frames, else its subdirectories that
    do. Frames are counted by probing the template from the first index (0
    or 1, whichever exists) until one is missing."""
    probes = [tmpl.format(0), tmpl.format(1)]

    def _start(d: pathlib.Path):
        for start, probe in zip((0, 1), probes):
            if (d / probe).exists():
                return start
        return None

    if _start(root) is not None:
        dirs = [root]
    else:
        dirs = sorted(d for d in root.iterdir() if d.is_dir() and _start(d) is not None)
    out = []
    for d in dirs:
        start = _start(d)
        n = 0
        while (d / tmpl.format(start + n)).exists():
            n += 1
        if n:
            out.append((d.name, d, n, start))
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Classify; returns the predictions (also written as JSON)."""
    distributed.initialize()  # the process group under a launcher; a no-op alone
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)

    from ..data.datasets import build_dataset
    from ..data.host_loader import DataLoader
    from ..runtime import make_eval_step
    from ..runtime.loops import run_inference

    videos = discover_videos(pathlib.Path(args.frames_dir), args.filename_tmpl)
    if not videos:
        sys.exit(f"no rawframe videos found under {args.frames_dir}")

    spec, module, num_classes, _ = load_model(cfg, args.checkpoint, device)

    # placeholder ann file (label 0) + the config's test pipeline; the real
    # frame dirs go in as video_infos afterwards, so paths with whitespace
    # never pass through the space-delimited annotation format
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        for i, (name, d, n, start) in enumerate(videos):
            f.write(f"v{i} {n} 0\n")
        ann = f.name
    try:
        ds_cfg = dict(cfg.data.test)
        ds_cfg.update(ann_file=ann, data_prefix="", test_mode=True)
        ds_cfg.pop("bg_dir", None)
        ds_cfg["type"] = "RawframeDataset"  # no augmentation at predict time
        dataset = build_dataset(ds_cfg)
    finally:
        os.unlink(ann)
    # each video keeps its own start index (mixed 0- and 1-based layouts)
    dataset.video_infos = [
        dict(frame_dir=str(d), total_frames=n, label=0, start_index=start)
        for name, d, n, start in videos
    ]
    # the global batch: --batch_size a rank
    loader = DataLoader(dataset, batch_size=args.batch_size * distributed.process_count(),
                        shuffle=False, num_workers=2)

    eval_step = make_eval_step(spec, num_classes)
    pred = run_inference(eval_step, module, loader, device=device,
                         pad_batch_to=loader.batch_size)
    mode = cfg.model.get("test_cfg", {}).get("average_clips", "prob") or "score"
    scores = average_clips(torch.from_numpy(pred["cls_score"]), mode).numpy()  # (N, nc)

    inv_map = None
    mapping_path = pathlib.Path(args.config).parent / "class_indices_mapping.json"
    if mapping_path.exists():
        mapping = json.loads(mapping_path.read_text())  # original -> incremental
        inv_map = {int(v): k for k, v in mapping.items()}

    topk = min(args.topk, num_classes)
    results = []
    for i, (name, d, n, start) in enumerate(videos):
        order = np.argsort(scores[i])[::-1][:topk]
        results.append({
            "video": name,
            "num_frames": n,
            "topk": [
                {
                    "class_index": int(c),
                    "score": float(scores[i, c]),
                    **({"original_label": inv_map[int(c)]}
                       if inv_map and int(c) in inv_map else {}),
                }
                for c in order
            ],
        })

    payload = {"predictions": results}
    # every rank holds the gathered scores; rank 0 reports
    if distributed.is_primary():
        if args.output:
            pathlib.Path(args.output).write_text(json.dumps(payload, indent=2))
            print(f"wrote {len(results)} predictions to {args.output}")
        else:
            print(json.dumps(payload, indent=2))
    distributed.sync_processes("predict_write")
    return payload


if __name__ == "__main__":
    main()
