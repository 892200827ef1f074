"""Per-sample feature dump (the counterpart of ``cil_tools/extract_features.py``;
reference cil_tools/extract_features.py:16-96): run a checkpoint over the
config's train split through the (deterministic) validation pipeline, keep
only the correctly classified samples, and write their ``cls_score`` and
``repr_consensus`` by class, with the classifier's weights, to JSON (the
input of ``cil_tools/memory_selection.py``).

    python -m bdvcil_torch.cil_tools.extract_features ROOT_DIR [--config_file config.py]
        [--ckpt_file latest.pt] [--dst features/out.json] [--batch_size 8] [--device cpu]

``ROOT_DIR`` holds the config and a port checkpoint (``runtime/checkpoint.py``:
a ``torch.save`` file and its ``.json`` sidecar; a JAX checkpoint comes over
through ``models/convert.py``). The model is float32 whatever the config's
``compute_dtype``, as in the JAX tool, and runs on the card unless
``--device`` names another device; without a CUDA device and without ``--device`` it raises.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Optional, Sequence

import numpy as np

from .._device import resolve_device
from ..config import Config
from ..parallel import distributed
from . import load_model


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Dump per-sample features")
    parser.add_argument("root_dir", help="directory containing config + checkpoint")
    parser.add_argument("--config_file", default="config.py")
    parser.add_argument("--ckpt_file", default="latest.pt")
    parser.add_argument("--dst", default="features/out.json")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--device", help="the torch device (default: the CUDA card)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> pathlib.Path:
    """Write the features; returns the JSON file's path."""
    distributed.initialize()  # the process group under a launcher; a no-op alone
    args = parse_args(argv)
    device = resolve_device(args.device)
    root_dir = pathlib.Path(args.root_dir)
    dst = root_dir / args.dst
    dst.parent.mkdir(exist_ok=True, parents=True)

    cfg = Config.fromfile(str(root_dir / args.config_file))

    from ..data.datasets import build_dataset
    from ..data.host_loader import DataLoader
    from ..models.heads import head_param_path
    from ..runtime import make_eval_step
    from ..runtime.loops import run_inference

    spec, module, num_classes, _ = load_model(cfg, root_dir / args.ckpt_file, device)

    # the train split through the (deterministic) validation pipeline
    train_cfg = dict(cfg.data.train)
    train_cfg["pipeline"] = cfg.data.val.pipeline
    train_cfg["test_mode"] = True
    dataset = build_dataset(train_cfg)
    # the global batch: --batch_size a rank
    loader = DataLoader(dataset, batch_size=args.batch_size * distributed.process_count(),
                        shuffle=False, num_workers=2)

    eval_step = make_eval_step(spec, num_classes)
    pred = run_inference(eval_step, module, loader, device=device, extract_repr=True,
                         pad_batch_to=loader.batch_size)
    cls_score = pred["cls_score"].mean(axis=1)  # (N, nc)
    repr_consensus = pred["repr"].mean(axis=1)  # (N, C)

    features_by_class = {}
    for i, info in enumerate(dataset.video_infos):
        if int(np.argmax(cls_score[i])) != info["label"]:
            continue  # keep correctly-classified samples only
        entry = dict(info)
        entry.pop("all_detections", None)
        entry["cls_score"] = cls_score[i].tolist()
        entry["repr_consensus"] = repr_consensus[i].tolist()
        features_by_class.setdefault(int(info["label"]), []).append(entry)

    head = head_param_path(module)
    fc = head.fc_weights if hasattr(head, "fc_weights") else head.fc_weight
    data = {
        "features_by_class": features_by_class,
        "model_weights": fc.detach().float().cpu().numpy().tolist(),
    }
    if distributed.is_primary():  # every rank holds the gathered scores; rank 0 writes
        dst.write_text(json.dumps(data))
        print("Saved features at:", dst)
    distributed.sync_processes("extract_features_write")
    return dst


if __name__ == "__main__":
    main()
