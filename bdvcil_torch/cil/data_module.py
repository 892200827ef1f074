"""Per-task dataset factory for class-incremental training (the port of
``bdvcil_tpu/cil/data_module.py``).

``CILDataModule`` semantics (reference libs/cil/cil.py:29-405) on the port's
dataset and loader stack:

  * global->incremental label remap built in first-seen task order
    (cil.py:45-49) and per-task annotation files written under
    ``work_dir/task_splits`` (cil.py:87-119)
  * exemplar annotation files under ``work_dir/exemplar`` with paths relative
    to realpath(data_root) (cil.py:344-363)
  * train dataset reload per task with exemplar replay merged in
    (cil.py:174-195); merging extends video_infos and (for
    BackgroundMixDataset with merge_bg_files) bg_files, and reloads an
    ActorCutMixDataset's detections (cil.py:386-402)
  * background-pool policies ``keep_all_backgrounds`` / ``cbf_full_bg`` for
    the class-balanced fine-tuning dataset (cil.py:146-172)
  * merged multi-task eval datasets preserving task order — accuracy
    segmentation depends on it (cil.py:213-240, 938-943)
  * eval loaders: ``FastEvalLoader`` when the config asks for the fast input
    path, the pipeline is a standard test chain and the native decoder
    built, else the host pipeline's ``DataLoader`` (the JAX choice); each
    choice and its reason is appended to ``loader_notes``

Under a process group every rank keeps the same bookkeeping, rank 0 writes
the annotation and exemplar files, and a barrier follows each write
(``parallel/distributed.py``), as in the JAX package. The loaders take the
global batch, ``videos_per_gpu`` times the ranks.
"""

from __future__ import annotations

import copy
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..config import Config
from ..data import native
from ..data.annotations import accumulate_task_sizes, build_label_remap
from ..data.datasets import (ActorCutMixDataset, BackgroundMixDataset, RawframeDataset,
                             build_dataset)
from ..data.host_loader import DataLoader
from ..data.loaders import FastEvalLoader
from ..parallel import distributed
from ..utils import get_logger

logger = get_logger("bdvcil.cil")


class CILDataModule:
    def __init__(self, config: Config):
        self.config = config
        self.batch_size = config.videos_per_gpu
        self.test_batch_size = config.testing_videos_per_gpu
        self.task_splits = config.task_splits
        self.work_dir = pathlib.Path(config.work_dir)

        self.accumulate_task_size_list = accumulate_task_sizes(self.task_splits)
        self.ori_idx_to_inc_idx = build_label_remap(self.task_splits)

        self.work_dir.mkdir(exist_ok=True, parents=True)
        self.exemplar_dir = self.work_dir / "exemplar"
        self.exemplar_dir.mkdir(exist_ok=True, parents=True)

        self.controller = None  # CILTrainer
        self.task_splits_ann_files: Dict[str, List[pathlib.Path]] = {"train": [], "val": []}
        self.train_dataset = None
        self.val_datasets: List[RawframeDataset] = []
        self.test_datasets: List[RawframeDataset] = []
        self.features_extraction_dataset = None
        self.exemplar_datasets: List[RawframeDataset] = []
        self._all_bg_files = set()
        # which loader each phase took and why (fast or host), for logs and reports
        self.loader_notes: List[str] = []

    # -- properties --------------------------------------------------------
    @property
    def current_task(self) -> int:
        return self.controller.current_task

    @property
    def num_tasks(self) -> int:
        return self.controller.num_tasks

    @property
    def exemplar_size(self) -> int:
        return sum(len(ex) for ex in self.exemplar_datasets)

    @property
    def all_bg_files(self):
        return self._all_bg_files

    @property
    def world_size(self) -> int:
        """GPUs in the run, one a rank. The reference's videos_per_gpu is a
        per-device batch; the global batch scales with the GPUs."""
        return distributed.process_count()

    # -- annotation files --------------------------------------------------
    def generate_annotation_file(self) -> None:
        """Split the global train/val annotation files per task (cil.py:87-119)."""
        destination = self.work_dir / "task_splits"
        destination.mkdir(exist_ok=True, parents=True)

        for train_val, file_path in zip(
            ["train", "val"], [self.config.train_ann_file, self.config.val_ann_file]
        ):
            with open(file_path, "r") as f:
                lines = [l.strip() for l in f if l.strip()]
            annotation = {}
            for l in lines:
                video_path, total_frames, label = l.split()
                annotation[video_path] = (total_frames, int(label))

            for task_i, class_indices in enumerate(self.task_splits):
                class_set = set(class_indices)
                task_data = [
                    (vp, tf, self.ori_idx_to_inc_idx[lab])
                    for vp, (tf, lab) in annotation.items()
                    if lab in class_set
                ]
                if task_data:
                    task_file = destination / self.config.cil_ann_file_template.format(
                        train_val, task_i
                    )
                    if distributed.is_primary():  # every rank bookkeeps, rank 0 writes
                        with open(task_file, "w") as f:
                            f.writelines("{} {} {}\n".format(*row) for row in task_data)
                        logger.info("create file at: %s", task_file)
                    self.task_splits_ann_files[train_val].append(task_file)
        distributed.sync_processes("ann_files")

    def collect_ann_files_from_work_dir(self) -> None:
        ann_dir = self.work_dir / "task_splits"
        for task_i in range(self.num_tasks):
            self.task_splits_ann_files["train"].append(
                ann_dir / self.config.cil_ann_file_template.format("train", task_i)
            )
            self.task_splits_ann_files["val"].append(
                ann_dir / self.config.cil_ann_file_template.format("val", task_i)
            )

    def collect_exemplar_from_work_dir(self) -> None:
        for task_idx in range(self.current_task):
            ann_file = self.exemplar_dir / f"exemplar_task_{task_idx}.txt"
            if not ann_file.exists():
                raise FileNotFoundError(str(ann_file))
            self.exemplar_datasets.append(self.build_exemplar_dataset(str(ann_file)))

    # -- dataset builders --------------------------------------------------
    def _build(self, data_cfg, ann_file: Optional[str] = None, test_mode=None):
        cfg = copy.deepcopy(dict(data_cfg))
        if ann_file is not None:
            cfg["ann_file"] = str(ann_file)
        ds = build_dataset(cfg)
        if test_mode is not None:
            ds.test_mode = test_mode
        return ds

    def build_validation_datasets(self) -> None:
        for i in range(self.num_tasks):
            ds = self._build(
                self.config.data.val, self.task_splits_ann_files["val"][i], test_mode=True
            )
            self.val_datasets.append(ds)

    def reload_train_dataset(self, exemplar=None, use_internal_exemplar: bool = True) -> None:
        """Rebuild the train set for ``current_task`` with replay merged in
        (cil.py:174-195). Call after advancing current_task."""
        self.train_dataset = self._build(
            self.config.data.train, self.task_splits_ann_files["train"][self.current_task]
        )
        if use_internal_exemplar:
            self.train_dataset = self.merge_dataset(self.train_dataset, self.exemplar_datasets)
        elif exemplar is not None:
            self.train_dataset = self.merge_dataset(self.train_dataset, exemplar)

        if isinstance(self.train_dataset, BackgroundMixDataset) and self.config.get(
            "keep_all_backgrounds", False
        ):
            self._all_bg_files.update(self.train_dataset.bg_files)
            self.train_dataset.bg_files = list(self._all_bg_files)

    def get_training_set_at_task_i(self, task_idx: int):
        return self._build(self.config.data.train, self.task_splits_ann_files["train"][task_idx])

    def build_cbf_dataset(self):
        """Class-balanced (exemplar-only) dataset with bg-pool policy
        (cil.py:146-172)."""
        dataset = self._build(self.config.data.train, ann_file="")
        dataset.video_infos = []

        if isinstance(dataset, BackgroundMixDataset):
            dataset.bg_files = []
            if self.config.get("keep_all_backgrounds", False):
                dataset = self.merge_dataset(dataset, self.exemplar_datasets)
                dataset.bg_files = list(self._all_bg_files)
            elif self.config.get("cbf_full_bg", False):
                dataset = self.merge_dataset(dataset, self.exemplar_datasets)
                all_bg = set(self.train_dataset.bg_files) | set(dataset.bg_files)
                dataset.bg_files = list(all_bg)
            else:
                dataset = self.merge_dataset(dataset, self.exemplar_datasets)
        elif isinstance(dataset, RawframeDataset):
            dataset = self.merge_dataset(dataset, self.exemplar_datasets)
        else:
            raise NotImplementedError

        if isinstance(dataset, BackgroundMixDataset):
            logger.info(
                "CBF dataset built (%d videos, %d background)",
                len(dataset),
                len(dataset.bg_files),
            )
        else:
            logger.info("CBF dataset built (%d videos)", len(dataset))
        return dataset

    # -- dataloaders -------------------------------------------------------
    def train_dataloader(self) -> DataLoader:
        return DataLoader(
            self.train_dataset,
            batch_size=self.batch_size * self.world_size,
            shuffle=True,
            num_workers=self.config.workers_per_gpu,
            drop_last=False,
            pad_to_batch=True,  # a whole last batch, its pad rows weighted 0
            seed=self.config.get("seed", 0),
        )

    def get_test_dataset(self, task_indices: Union[int, Sequence[int]], val_test: str):
        """Single or merged [start..end] eval dataset preserving task order
        (cil.py:213-240)."""
        assert val_test in ("val", "test")
        dataset_list = self.val_datasets if val_test == "val" else self.test_datasets

        if isinstance(task_indices, int):
            return dataset_list[task_indices]

        assert len(task_indices) == 2
        starting_task, ending_task = task_indices  # inclusive
        selected = dataset_list[starting_task : ending_task + 1]

        cfg = self.config.data.val if val_test == "val" else self.config.data.test
        dataset = self._build(
            cfg, self.task_splits_ann_files["val"][starting_task], test_mode=True
        )
        if len(selected) > 1:
            # rebuild from scratch so the base dataset is not mutated
            dataset.video_infos = list(selected[0].video_infos)
            if isinstance(dataset, BackgroundMixDataset):
                dataset.bg_files = list(getattr(selected[0], "bg_files", []))
            for ds_ in selected[1:]:
                dataset = self.merge_dataset(dataset, ds_)
        return dataset

    @staticmethod
    def _fast_eval_params(pipeline_cfg) -> Optional[Tuple[int, int, int, bool]]:
        """(num_segments, short_side, crop, tencrop) when the pipeline is a
        standard test-mode chain — SampleFrames -> Resize(-1, S) ->
        CenterCrop(c) | TenCrop(c) -> Normalize; else None."""
        num_segments = short_side = crop = None
        tencrop = False
        for op in pipeline_cfg:
            t = op.get("type")
            if t == "SampleFrames":
                if not op.get("test_mode", False) or op.get("clip_len", 1) != 1:
                    return None
                num_segments = op.get("num_clips", 1)
            elif t == "Resize":
                scale = op.get("scale")
                if isinstance(scale, (tuple, list)) and -1 in scale:
                    short_side = max(scale)
            elif t in ("CenterCrop", "TenCrop"):
                crop = op.get("crop_size")
                crop = crop[0] if isinstance(crop, (tuple, list)) else crop
                tencrop = t == "TenCrop"
            elif t in ("ThreeCrop", "FiveCrop", "MultiScaleCrop", "RandAugment", "Flip"):
                return None
        if None in (num_segments, short_side, crop):
            return None
        return num_segments, short_side, crop, tencrop

    def _eval_loader(self, dataset, pipeline_cfg=None, what: str = "eval"):
        """``FastEvalLoader`` when the config asks for the fast path, the
        pipeline is a standard test chain and the decoder built; else the
        host pipeline's DataLoader. The choice and its reason go to
        ``loader_notes``."""
        params = None if pipeline_cfg is None else self._fast_eval_params(pipeline_cfg)
        if not self.config.get("use_fast_input_pipeline", False):
            why = "use_fast_input_pipeline is off"
        elif params is None:
            why = "not a standard test pipeline"
        elif not native.available():
            why = f"native decoder unavailable: {native.build_error()}"
        elif len(dataset) == 0:
            why = "empty dataset"
        else:
            num_segments, short_side, crop, tencrop = params
            loader = FastEvalLoader(
                dataset.video_infos,
                # *_videos_per_gpu is a per-device batch (reference config
                # :8); the global batch scales with the GPUs
                batch_size=self.test_batch_size * self.world_size,
                num_workers=int(self.config.get("fast_input_workers", 1)),
                num_segments=num_segments,
                crop_size=crop,
                short_side=short_side,
                filename_tmpl=dataset.filename_tmpl,
                start_index=dataset.start_index,
                tencrop=tencrop,
                # 'auto': the full-frame yuv420 wire for TenCrop (each frame
                # ships once; crops, flips and YCbCr -> RGB on the device),
                # else rgb; 'rgb' keeps the host crops
                wire_format=str(self.config.get("fast_eval_wire_format", "auto")),
            )
            # the wire is part of any eval-accuracy evidence: the logs say
            # which wire produced a number (ADVICE round 4)
            get_logger().info("fast eval loader: wire=%s tencrop=%s crop=%d batch=%d",
                              loader.wire_format, tencrop, crop, loader.batch_size)
            self.loader_notes.append(f"{what}: fast ({loader.wire_format})")
            return loader
        self.loader_notes.append(f"{what}: host ({why})")
        return DataLoader(
            dataset,
            batch_size=self.test_batch_size * self.world_size,
            shuffle=False,
            num_workers=self.config.testing_workers_per_gpu,
            drop_last=False,
        )

    def get_val_dataloader(self, task_indices) -> DataLoader:
        return self._eval_loader(
            self.get_test_dataset(task_indices, "val"), self.config.data.val.get("pipeline"),
            "val"
        )

    def get_test_dataloader(self, task_indices) -> DataLoader:
        return self._eval_loader(
            self.get_test_dataset(task_indices, "test"), self.config.data.test.get("pipeline"),
            "test"
        )

    def features_extraction_dataloader_on_train_dataset(self, task_idx: int):
        self.features_extraction_dataset = self._build(
            self.config.data.features_extraction,
            self.task_splits_ann_files["train"][task_idx],
        )
        fast = self._eval_loader(
            self.features_extraction_dataset,
            self.config.data.features_extraction.get("pipeline"),
            "features",
        )
        if not isinstance(fast, DataLoader):
            return fast
        return DataLoader(
            self.features_extraction_dataset,
            batch_size=self.batch_size * self.world_size,
            shuffle=False,
            num_workers=self.config.workers_per_gpu,
        )

    def combine_all_exemplar_ann_files(self, task_idx: int) -> pathlib.Path:
        tmp = self.exemplar_dir / "tmp_exemplars.txt"
        if distributed.is_primary():
            parts = []
            for i in range(task_idx + 1):
                parts.append((self.exemplar_dir / f"exemplar_task_{i}.txt").read_text().strip())
            tmp.write_text("\n".join(parts))
        distributed.sync_processes("exemplar_tmp")
        return tmp

    def features_extraction_dataloader_on_exemplar(self, task_idx: int) -> DataLoader:
        tmp = self.exemplar_dir / "tmp_exemplars.txt"
        ds = self._build(self.config.data.features_extraction, str(tmp), test_mode=True)
        return self._eval_loader(ds, self.config.data.features_extraction.get("pipeline"),
                                 "exemplar features")

    # -- exemplar management -----------------------------------------------
    def create_exemplar_ann_file(self, exemplar_meta: Dict, task_idx: int = -1) -> str:
        """Write the selected exemplars relative to realpath(data_root)
        (cil.py:344-363)."""
        import os.path as osp

        if task_idx == -1:
            task_idx = self.current_task
        root_dir = pathlib.Path(osp.realpath(self.config.data_root)).absolute()
        ann_file = self.exemplar_dir / f"exemplar_task_{task_idx}.txt"
        if distributed.is_primary():
            with open(ann_file, "w") as f:
                for class_idx, meta in exemplar_meta.items():
                    for frame_dir, total_frames in zip(meta["frame_dir"], meta["total_frames"]):
                        rel = pathlib.Path(frame_dir).relative_to(root_dir)
                        f.write(f"{rel} {int(total_frames)} {class_idx}\n")
        distributed.sync_processes("exemplar_ann")
        return str(ann_file)

    def build_exemplar_dataset(self, ann_file: str):
        return self._build(self.config.data.exemplar, ann_file)

    def build_exemplar_from_current_task(self, exemplar_meta: Dict) -> None:
        ann_file = self.create_exemplar_ann_file(exemplar_meta)
        self.exemplar_datasets.append(self.build_exemplar_dataset(ann_file))

    # -- merging -----------------------------------------------------------
    def merge_dataset(self, source, targets):
        if isinstance(targets, list):
            for t in targets:
                source = self._merge_dataset(source, t)
        else:
            source = self._merge_dataset(source, targets)
        return source

    def _merge_dataset(self, source, target):
        """Extend video_infos (and bg pools / detections) — cil.py:386-402."""
        if isinstance(source, BackgroundMixDataset):
            source.video_infos.extend(target.video_infos)
            if source.merge_bg_files:
                source.bg_files.extend(getattr(target, "bg_files", []))
        elif isinstance(source, ActorCutMixDataset):
            source.video_infos.extend(target.video_infos)
            # the reference reads the top-level config key (cil.py:396); fall
            # back to the dataset's own det_file when a config omits it
            source.load_detections(self.config.get("det_file", source.det_file))
        elif isinstance(source, RawframeDataset):
            source.video_infos.extend(target.video_infos)
        else:
            raise TypeError(type(source))
        return source

    def store_bg_files(self, bg_files) -> None:
        self._all_bg_files.update(bg_files)
