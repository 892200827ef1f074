"""Per-task and oracle annotation files with the label remap (the counterpart
of ``cil_tools/create_annotation_files.py``; reference
cil_tools/create_annotation_files.py:1-61), and ``class_indices_mapping.json``
(original label -> incremental index, which ``predict`` reads).

    python -m bdvcil_torch.cil_tools.create_annotation_files --train_ann_file F
        --val_ann_file F --destination DIR --task_splits_config CONFIG.py

The task splits come from any python config defining ``task_splits``. It
runs on the host only.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List, Optional, Sequence

from ..config import Config
from ..data.annotations import build_label_remap, generate_task_annotation_files
from ..parallel import distributed


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Write per-task annotation files")
    parser.add_argument("--train_ann_file", required=True)
    parser.add_argument("--val_ann_file", required=True)
    parser.add_argument("--destination", required=True)
    parser.add_argument(
        "--task_splits_config",
        required=True,
        help="python file defining task_splits = [[...], ...] (any experiment config works)",
    )
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[pathlib.Path]]:
    """Write the files; returns them by split, as ``generate_task_annotation_files``."""
    # a host tool: under a launcher its ranks meet over gloo, and rank 0 writes
    distributed.initialize(device="cpu")
    args = parse_args(argv)
    task_splits = Config.fromfile(args.task_splits_config).task_splits

    destination = pathlib.Path(args.destination)
    out: Dict[str, List[pathlib.Path]] = {}
    if distributed.is_primary():
        out = generate_task_annotation_files(
            args.train_ann_file,
            args.val_ann_file,
            task_splits,
            destination,
            write_oracle=True,
        )
        for split, files in out.items():
            for f in files:
                print("create file at:", f)

        mapping = build_label_remap(task_splits)
        mapping_file = destination / "class_indices_mapping.json"
        mapping_file.write_text(json.dumps({str(k): v for k, v in mapping.items()}))
        print("create indice mapping file at:", mapping_file)
    distributed.sync_processes("annotation_files")
    return out


if __name__ == "__main__":
    main()
