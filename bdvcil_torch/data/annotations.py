"""Rawframe annotation files and CIL task splitting (the port's copy of
``bdvcil_tpu/data/annotations.py``).

On-disk contract (reference: libs/cil/cil.py:98-100): one line per video,
``"<rel_frame_dir> <total_frames> <label>"``. Task splitting remaps original
class indices to incremental indices in first-seen task order (reference:
libs/cil/cil.py:45-49 for the remap, 87-119 for the per-task file writer).
"""

from __future__ import annotations

import dataclasses
import os.path as osp
import pathlib
from typing import Dict, Iterable, List, Sequence


@dataclasses.dataclass(frozen=True)
class VideoRecord:
    frame_dir: str  # relative or absolute directory of extracted frames
    total_frames: int
    label: int


def read_annotation_file(path: str | pathlib.Path) -> List[VideoRecord]:
    records = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            frame_dir, total_frames, label = line.split()
            records.append(VideoRecord(frame_dir, int(total_frames), int(label)))
    return records


def write_annotation_file(path: str | pathlib.Path, records: Iterable[VideoRecord]) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for r in records:
            f.write(f"{r.frame_dir} {r.total_frames} {r.label}\n")


def build_label_remap(task_splits: Sequence[Sequence[int]]) -> Dict[int, int]:
    """original class index -> incremental index, in first-seen task order."""
    remap: Dict[int, int] = {}
    for task in task_splits:
        for ori in task:
            if ori not in remap:
                remap[ori] = len(remap)
    return remap


def accumulate_task_sizes(task_splits: Sequence[Sequence[int]]) -> List[int]:
    """Cumulative number of classes after each task (cil.py:39-43)."""
    sizes = []
    total = 0
    for task in task_splits:
        total += len(task)
        sizes.append(total)
    return sizes


def split_annotations_by_task(
    records: Sequence[VideoRecord],
    task_splits: Sequence[Sequence[int]],
    remap: Dict[int, int] | None = None,
) -> List[List[VideoRecord]]:
    """Partition records into per-task lists with remapped labels.

    Matches cil.py:103-116: a record lands in task i iff its *original* label
    is in ``task_splits[i]``; the stored label becomes the incremental index.
    """
    if remap is None:
        remap = build_label_remap(task_splits)
    out: List[List[VideoRecord]] = []
    for class_indices in task_splits:
        class_set = set(class_indices)
        task_records = [
            VideoRecord(r.frame_dir, r.total_frames, remap[r.label])
            for r in records
            if r.label in class_set
        ]
        out.append(task_records)
    return out


def generate_task_annotation_files(
    train_ann_file: str,
    val_ann_file: str,
    task_splits: Sequence[Sequence[int]],
    destination: str | pathlib.Path,
    filename_template: str = "{}_task_{}.txt",
    write_oracle: bool = False,
) -> Dict[str, List[pathlib.Path]]:
    """Write per-task (and optionally cumulative 'oracle') annotation files.

    Reference: CILDataModule.generate_annotation_file (cil.py:87-119) and the
    standalone cil_tools/create_annotation_files.py. Returns the file paths
    keyed by 'train'/'val' (and 'train_oracle'/'val_oracle' when requested).
    """
    destination = pathlib.Path(destination)
    destination.mkdir(parents=True, exist_ok=True)
    remap = build_label_remap(task_splits)

    out: Dict[str, List[pathlib.Path]] = {"train": [], "val": []}
    if write_oracle:
        out["train_oracle"] = []
        out["val_oracle"] = []

    for split_name, file_path in (("train", train_ann_file), ("val", val_ann_file)):
        records = read_annotation_file(file_path)
        per_task = split_annotations_by_task(records, task_splits, remap)
        oracle_so_far: List[VideoRecord] = []
        for task_i, task_records in enumerate(per_task):
            if task_records:
                task_path = destination / filename_template.format(split_name, task_i)
                write_annotation_file(task_path, task_records)
                out[split_name].append(task_path)
            if write_oracle:
                oracle_so_far = oracle_so_far + task_records
                oracle_path = destination / filename_template.format(
                    split_name + "_oracle", task_i
                )
                write_annotation_file(oracle_path, oracle_so_far)
                out[split_name + "_oracle"].append(oracle_path)
    return out


def relative_frame_dir(frame_dir: str, data_root: str) -> str:
    """Path of ``frame_dir`` relative to realpath(data_root).

    The reference resolves symlinks before relativizing exemplar entries
    (cil.py:348-361) so exemplar files stay valid across symlinked roots.
    """
    root = pathlib.Path(osp.realpath(data_root)).absolute()
    return str(pathlib.Path(frame_dir).relative_to(root))
