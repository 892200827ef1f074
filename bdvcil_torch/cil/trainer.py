"""CIL orchestration: the per-task outer loop (the port of
``bdvcil_tpu/cil/trainer.py``).

Per task t: train -> herding exemplars -> class-balanced fine-tuning (CBF,
from task 1 on) -> checkpoint -> NME class means -> test tasks 0..t by CNN
and NME -> grow the classifier, previous model <- current, reload the train
set with replay (reference cil.py:800-860).

Where the port differs from the JAX trainer, on purpose:
  * the model is an ``nn.Module`` updated in place; the previous model is a
    deep copy of it, grown with it;
  * random draws come from (seed, task, phase) instead of one chained JAX
    key: a phase's train steps from ``step_generator(phase seed, step)``
    (``runtime/loops.py``), the classifier's new rows from ``growth_generator``.
    A run resumed at task t therefore draws what the straight run drew;
  * per-task checkpoints are ``ckpt_task_{t}.pt`` (``runtime/checkpoint.py``).

Under a process group (``parallel/distributed.py``, one rank a card) every
rank runs the same loop on its rows of each global batch: rank 0 writes the
config, the metrics, checkpoints, snapshots, class means and result tables,
then a barrier; every rank reads them back. Inference gathers every rank's
rows, so herding, NME and the tables see the whole set on every rank.

``task_stats`` keeps, per task, the seconds of each stage, the eval rows per
second, the exemplar count and the loaders each phase took.
"""

from __future__ import annotations

import copy
import hashlib
import json
import pathlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..config import Config
from ..data import native
from ..data.datasets import ActorCutMixDataset, BackgroundMixDataset, RawframeDataset
from ..data.device_pipeline import make_fast_acm_input_fn, make_fast_input_fn
from ..data.host_loader import DataLoader
from ..data.loaders import (FastACMLoader, FastBGMixLoader, fast_pipeline_mismatch,
                            resolve_wire_format)
from ..models import build_model, init_model_params
from ..models.builder import ModelSpec
from ..models.heads import head_param_path, update_fc
from ..models.pretrained import apply_backbone_weights, load_checkpoint_file, load_torch_resnet_backbone
from ..optim import build_optimizer
from ..parallel import distributed
from ..parallel.mesh import replicate
from ..runtime import (
    TrainState,
    make_eval_step,
    make_multi_eval_step,
    make_multi_train_step,
    make_train_step,
)
from ..runtime.checkpoint import (
    clear_train_snapshot,
    load_checkpoint,
    load_train_snapshot,
    peek_train_snapshot_meta,
    save_checkpoint,
    save_train_snapshot,
    snapshot_matches,
)
from ..runtime.loops import run_inference, train_epochs
from ..utils import AverageMeter, MetricLogger, get_logger, print_mean_accuracy
from .data_module import CILDataModule
from .herding import Herding

logger = get_logger("bdvcil.cil")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PHASES = ("inc_step", "cbf_step")


def _seed_of(*entropy: int) -> int:
    return int(np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)[0] >> 1)


def phase_seed(seed: int, task: int, phase: str) -> int:
    """The run seed of ``train_epochs`` for one task's phase."""
    return _seed_of(seed, task, PHASES.index(phase))


def growth_generator(seed: int, task: int, which: int) -> torch.Generator:
    """The CPU generator of the classifier rows task ``task`` adds, for the
    current model (``which`` 0) or the previous one (1)."""
    return torch.Generator().manual_seed(_seed_of(seed, task, 2 + which))


class CILTrainer:
    def __init__(self, config: Config, dump_config: bool = True, device=None):
        self.config = config
        self.work_dir = pathlib.Path(config.work_dir)
        self.device = resolve_device(device)

        self.starting_task = config.get("starting_task", 0)
        self._current_task = self.starting_task
        self.num_epoch_per_task = config.num_epochs_per_task
        self.task_splits = config.task_splits
        self.ending_task = config.get("ending_task", len(config.task_splits) - 1)
        self.num_tasks = min(len(config.task_splits), self.ending_task + 1)

        self.method = config.get("methods", "base")
        assert self.method in ("base", "icarl", "icarl_video_mix", "oracle", "finetune")
        if self.method in ("oracle", "finetune"):
            self.method = "base"

        dtype = _DTYPES[config.get("compute_dtype", "float32")]
        self.spec: ModelSpec = build_model(config.model, dtype=dtype, device=self.device)
        if self.method in ("icarl", "icarl_video_mix"):
            # raw-score averaging before the soft-target CE (reference icarl.py:34)
            self.spec.test_cfg["average_clips"] = "score"

        self.use_kd = self.method == "base" and "kd_modules_names" in config
        self.seed = config.get("seed", 0)
        # lineage identity of mid-task snapshots, as in the JAX trainer: a
        # snapshot of another seed / split / method / model is never restored
        ident = json.dumps(
            {
                "seed": self.seed,
                "splits": config.task_splits,
                "method": self.method,
                "model": sorted((str(k), str(v)) for k, v in dict(config.model).items()),
            },
            default=str,
        )
        self._run_token = hashlib.sha1(ident.encode()).hexdigest()[:12]

        self.data_module = CILDataModule(config)
        self.data_module.controller = self

        self.ckpt_dir = self.work_dir / "ckpt"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)

        self.model = self._init_model(self.num_classes(self._current_task))
        self.prev_model = None
        self.task_stats: List[Dict] = []
        self._stats: Dict = {}

        self.data_module.generate_annotation_file()
        if self.starting_task == 0:
            self.data_module.reload_train_dataset(exemplar=None, use_internal_exemplar=False)
        else:
            self._resume()

        self.data_module.build_validation_datasets()

        if dump_config and distributed.is_primary():
            config.dump(str(self.work_dir / "config.py"))

        # the other ranks keep a logger that writes nothing, to a file or to wandb
        primary = distributed.is_primary()
        self.metric_logger = MetricLogger(str(self.work_dir) if primary else None,
                                          use_wandb=config.get("use_wandb", False) and primary)
        self.training_phase: Optional[str] = None  # 'inc_step' or 'cbf_step'
        self.current_best: Optional[float] = 0.0 if config.get("save_best", False) else None
        # per-task accuracy rows recorded by _finish_task
        self.cnn_matrix: List[List[float]] = []
        self.nme_matrix: List[List[float]] = []

    # -- init helpers ------------------------------------------------------
    def _init_model(self, num_classes: int):
        model = init_model_params(self.spec, self.seed, num_classes)
        pretrained = self.spec.backbone_kwargs.get("pretrained")
        if pretrained and pathlib.Path(str(pretrained)).exists():
            logger.info("loading pretrained backbone from %s", pretrained)
            apply_backbone_weights(model, load_torch_resnet_backbone(
                load_checkpoint_file(str(pretrained))))
        elif pretrained:
            logger.info("pretrained=%r not found locally; training from scratch", pretrained)
        return replicate(model)

    def _grow(self, task: int) -> None:
        """Grow the current and the previous model to task ``task``'s width."""
        nc = self.num_classes(task)
        update_fc(self.model, nc, growth_generator(self.seed, task, 0))
        update_fc(self.prev_model, nc, growth_generator(self.seed, task, 1))

    # -- properties --------------------------------------------------------
    @property
    def current_task(self) -> int:
        return self._current_task

    @property
    def train_dataset(self):
        return self.data_module.train_dataset

    def num_classes(self, task_idx: int) -> int:
        return self.data_module.accumulate_task_size_list[task_idx]

    # -- checkpoint paths --------------------------------------------------
    def _ckpt_path(self, task_idx: int) -> pathlib.Path:
        return self.ckpt_dir / f"ckpt_task_{task_idx}.pt"

    def _save_task_ckpt(self, task_idx: int) -> None:
        if distributed.is_primary():
            save_checkpoint(self._ckpt_path(task_idx), self.model,
                            meta={"task": task_idx, "num_classes": self.num_classes(task_idx)})
            logger.info("save_model at: %s", self._ckpt_path(task_idx))
        # the other ranks may read it back (save-best, resume, cil_testing)
        distributed.sync_processes("ckpt_save")

    def _load_task_ckpt(self, task_idx: int):
        """A new module holding task ``task_idx``'s checkpoint, on the device."""
        state, meta = load_checkpoint(self._ckpt_path(task_idx))
        nc = int(meta["num_classes"]) if meta else self.num_classes(task_idx)
        model = self.spec.module(nc)
        model.load_state_dict(state)
        return model

    # -- resume ------------------------------------------------------------
    def _resume(self) -> None:
        """Resume at starting_task > 0 (reference cil.py:655-695): exemplars
        that are missing are rebuilt with each task's own checkpoint."""
        dm = self.data_module
        dm.collect_ann_files_from_work_dir()
        try:
            dm.collect_exemplar_from_work_dir()
        except FileNotFoundError:
            for i in range(len(dm.exemplar_datasets), self.starting_task):
                self._current_task = i
                logger.info("Create exemplar for task %d", i)
                if self._ckpt_path(i).exists():
                    self.model = self._load_task_ckpt(i)
                exemplar_meta = self._build_exemplar_for_current_task()
                dm.build_exemplar_from_current_task(exemplar_meta)
            self._current_task = self.starting_task

        self.model = self._load_task_ckpt(self._current_task - 1)
        self.prev_model = copy.deepcopy(self.model)
        self._grow(self._current_task)

        if self.config.get("keep_all_backgrounds", False):
            for i in range(self._current_task):
                dataset = dm.get_training_set_at_task_i(i)
                dm.store_bg_files(getattr(dataset, "bg_files", []))
            logger.info("%d background stored", len(dm.all_bg_files))
        dm.reload_train_dataset(use_internal_exemplar=True)

    # -- inference helpers ------------------------------------------------
    def _eval_steps(self, num_classes: int):
        """(single step, K-step form or None, K); the eval K is
        ``eval_steps_per_dispatch``, else the train ``steps_per_dispatch``, as
        in the JAX trainer (results are the same for every K)."""
        spd = max(1, int(self.config.get("eval_steps_per_dispatch",
                                         self.config.get("steps_per_dispatch", 1))))
        multi = make_multi_eval_step(self.spec, num_classes, spd) if spd > 1 else None
        return make_eval_step(self.spec, num_classes), multi, spd

    def _predict(self, loader, num_classes: int, extract_repr: bool = False) -> Dict[str, np.ndarray]:
        eval_step, multi, spd = self._eval_steps(num_classes)
        t0 = time.perf_counter()
        pred = run_inference(eval_step, self.model, loader, device=self.device,
                             extract_repr=extract_repr, pad_batch_to=loader.batch_size,
                             steps_per_dispatch=spd, multi_eval_step=multi)
        self._stats["eval_s"] = self._stats.get("eval_s", 0.0) + time.perf_counter() - t0
        self._stats["eval_clips"] = self._stats.get("eval_clips", 0) + len(pred["labels"])
        return pred

    def _averaged_scores(self, cls_score: np.ndarray) -> np.ndarray:
        if self.spec.average_clips == "prob":
            e = np.exp(cls_score - cls_score.max(axis=-1, keepdims=True))
            probs = e / e.sum(axis=-1, keepdims=True)
            return probs.mean(axis=1)
        return cls_score.mean(axis=1)  # 'score' / None

    # -- training ----------------------------------------------------------
    def _make_optimizer(self, phase: str, num_batches: int):
        cfg = self.config
        if phase == "cbf":
            opt_cfg = cfg.cbf_optimizer
            sched_cfg = cfg.get("cbf_lr_scheduler")
            freeze = not cfg.get("cbf_train_backbone", False)
        else:
            opt_cfg = cfg.optimizer
            sched_cfg = cfg.get("lr_scheduler")
            freeze = False
        accumulate = cfg.get("accumulate_grad_batches", 1)
        steps_per_epoch = max(1, -(-num_batches // accumulate))
        grad_clip = None if self._current_task == 0 else 1.0  # cil.py:743
        return build_optimizer(self.model, opt_cfg, sched_cfg, steps_per_epoch=steps_per_epoch,
                               grad_clip=grad_clip, accumulate_steps=accumulate,
                               freeze_backbone=freeze)

    def _kd_config(self) -> Optional[Dict]:
        if not (self.use_kd and self._current_task > 0):
            return None
        cfg = self.config
        return dict(
            module_names=list(cfg.kd_modules_names),
            module_weights=list(cfg.kd_weight_by_module),
            scale_factor=float(cfg.adaptive_scale_factors[self._current_task]),
            exemplar_only=bool(cfg.get("kd_exemplar_only", False)),
        )

    def _video_mix_cfg(self) -> Optional[Dict]:
        if self.method != "icarl_video_mix":
            return None
        return dict(
            prob=float(self.config.get("video_mix_prob", 0.5)),
            alpha=float(self.config.get("video_mix_alpha", 1.0)),
        )

    def _fit(self, loader, num_epochs: int, phase: str, input_fn=None) -> None:
        t = self._current_task
        nc = self.num_classes(t)
        num_batches = len(loader)
        tx = self._make_optimizer(phase, num_batches)
        step_kwargs = dict(
            spec=self.spec,
            tx=tx,
            num_classes=nc,
            method=self.method,
            task_idx=t,
            prev_num_classes=self.num_classes(t - 1) if t > 0 else 0,
            # KD applies during CBF too (cil.py:512-556, 788-795)
            kd_config=self._kd_config(),
            video_mix=self._video_mix_cfg(),
            input_fn=input_fn,
        )
        step_fn = make_train_step(**step_kwargs)
        # K batches per call, when an epoch has at least K (chunks never cross epochs)
        spd = max(1, int(self.config.get("steps_per_dispatch", 1)))
        multi_fn = make_multi_train_step(step_kwargs, spd) if spd > 1 and num_batches >= spd else None
        state = TrainState.create(self.model, tx)

        save_best = bool(self.config.get("save_best", False))
        validate = save_best and (t == 0 if phase == "inc_step" else True)
        phase_name = "inc_step" if phase != "cbf" else "cbf_step"

        # mid-task snapshots: one file per phase, so a CBF snapshot survives
        # the inc_step rerun that precedes train_cbf after a restart
        use_snap = bool(self.config.get("mid_task_checkpointing", False))
        snap_every = max(1, int(self.config.get("mid_task_ckpt_every", 1)))
        snap_path = self.ckpt_dir / f"mid_task_snapshot_{phase_name}.pt"
        start_epoch = 0
        run_seed = phase_seed(self.seed, t, phase_name)
        resumed = False
        if use_snap:
            meta = peek_train_snapshot_meta(snap_path)
            if snapshot_matches(meta, t, phase_name, nc, self._run_token):
                state, run_seed, meta = load_train_snapshot(snap_path, state)
                resumed = True
                start_epoch = int(meta["epoch"]) + 1
                if meta.get("current_best") is not None:
                    # keep save-best monotone across the preemption
                    self.current_best = float(meta["current_best"])
                logger.info("mid-task resume: task %d %s continuing at epoch %d (step %d)",
                            t, phase_name, start_epoch, int(state.step))

        def snapshot_hook(epoch, state_now, seed_now):
            if (epoch + 1) % snap_every != 0 or epoch + 1 >= num_epochs:
                return
            if distributed.is_primary():
                save_train_snapshot(
                    snap_path, state_now, seed_now,
                    meta=dict(task=t, phase=phase_name, epoch=epoch, num_classes=nc,
                              current_best=self.current_best, run_token=self._run_token))
            distributed.sync_processes("mid_task_snapshot")

        def epoch_hook(epoch, state_now):
            if not validate:
                return
            self.model = state_now.module
            acc = self._validate()
            if self.current_best is None or self.current_best < acc:
                logger.info("Accuracy improve from %s to %s", self.current_best, acc)
                self.current_best = acc
                self._save_task_ckpt(t)

        if validate and not resumed:
            # a mid-task resume restored the best so far; resetting it would
            # let a worse epoch overwrite the saved best checkpoint
            self.current_best = 0.0

        state, _ = train_epochs(
            step_fn,
            state,
            self.prev_model,
            loader,
            num_epochs,
            run_seed,
            device=self.device,
            metric_logger=self.metric_logger,
            log_every_n_steps=self.config.get("log_every_n_steps", 10),
            phase=phase_name,
            task_idx=t,
            epoch_hook=epoch_hook,
            start_epoch=start_epoch,
            snapshot_hook=snapshot_hook if use_snap else None,
            multi_step_fn=multi_fn,
            steps_per_dispatch=spd if multi_fn is not None else 1,
        )
        if use_snap:
            # the phase completed: a later rerun of this task must not restore it
            if distributed.is_primary():
                clear_train_snapshot(snap_path)
            distributed.sync_processes("mid_task_snapshot_clear")
        self.model = state.module

    def _validate(self) -> float:
        """CNN accuracy averaged over tasks [0..t] (cil.py:588-610)."""
        loader = self.data_module.get_val_dataloader([0, self._current_task])
        pred = self._predict(loader, self.num_classes(self._current_task))
        preds = np.argmax(self._averaged_scores(pred["cls_score"]), axis=-1)
        labels = pred["labels"]
        meter = AverageMeter()
        start = 0
        for task_idx in range(self._current_task + 1):
            n = len(self.data_module.val_datasets[task_idx])
            correct = (preds[start : start + n] == labels[start : start + n]).mean()
            meter.update(float(correct) * 100, n)
            start += n
        return meter.avg

    def _note_loader(self, what: str, note: str) -> None:
        logger.info("%s loader: %s", what, note)
        self.data_module.loader_notes.append(f"{what}: {note}")

    def _try_fast_loader(self, dataset=None, what: str = "train"):
        """The fast input path (native decode, then RandAugment, normalize
        and BGMix on the device) when the config asks for it and it applies,
        else (None, None) and the caller takes the host pipeline. ``dataset``
        defaults to the train set; CBF passes its exemplar set. Both wrap-pad
        the last batch with sample_weight=0 rows, as the reference's
        drop_last=False loader keeps every sample."""
        if not self.config.get("use_fast_input_pipeline", False):
            self._note_loader(what, "host (use_fast_input_pipeline is off)")
            return None, None
        ds = self.data_module.train_dataset if dataset is None else dataset
        if not native.available():
            self._note_loader(what, f"host (native decoder unavailable: {native.build_error()})")
            return None, None
        if len(ds) == 0:
            self._note_loader(what, "host (empty dataset)")
            return None, None
        if isinstance(ds, ActorCutMixDataset):
            return self._fast_acm_loader(ds, what)
        # a plain RawframeDataset is the BGMix path without backgrounds; an
        # unknown subclass may carry augmentation the fast path lacks
        if not isinstance(ds, BackgroundMixDataset) and type(ds) is not RawframeDataset:
            self._note_loader(what, f"host (no fast path for {type(ds).__name__})")
            return None, None

        randaug_prob = float(self.config.get("randAug_prob", 0.75))
        mismatch = fast_pipeline_mismatch(self.config.data.train.get("pipeline", []),
                                          num_segments=self.spec.num_segments,
                                          randaug_prob=randaug_prob)
        if mismatch is not None:
            self._note_loader(what, f"host (fast input pipeline declined: {mismatch})")
            return None, None

        # crop geometry and normalization from the configured train pipeline
        crop_size = 224
        short_side = None
        msc_scales = None  # the gate above guarantees a MultiScaleCrop op
        norm_mean = (123.675, 116.28, 103.53)
        norm_std = (58.395, 57.12, 57.375)
        for op in self.config.data.train.get("pipeline", []):
            if op.get("type") == "MultiScaleCrop":
                size = op.get("input_size", 224)
                crop_size = size[0] if isinstance(size, (tuple, list)) else size
                msc_scales = tuple(op.get("scales", (1,)))
            elif op.get("type") == "Resize":
                scale = op.get("scale")
                if op.get("keep_ratio", True):
                    if isinstance(scale, (tuple, list)) and scale[0] == -1:
                        short_side = int(scale[1])
                elif isinstance(scale, (tuple, list)):
                    crop_size = int(scale[0])
            elif op.get("type") == "Normalize":
                norm_mean = tuple(op.get("mean", norm_mean))
                norm_std = tuple(op.get("std", norm_std))

        wire_format = resolve_wire_format(str(self.config.get("fast_input_wire_format", "auto")),
                                          crop_size)
        loader = FastBGMixLoader(
            ds.video_infos,
            getattr(ds, "bg_files", []),
            batch_size=self.config.videos_per_gpu * self.data_module.world_size,
            num_segments=self.spec.num_segments,
            crop_size=crop_size,
            short_side=short_side,
            msc_scales=msc_scales,
            bg_short_side=int(getattr(ds, "bg_resize", 256)),
            filename_tmpl=ds.filename_tmpl,
            start_index=ds.start_index,
            randaug_prob=randaug_prob,
            with_randaug_mutex=bool(getattr(ds, "with_randAug", True)),
            bgmix_prob=float(getattr(ds, "prob", 0.25)),
            seed=self.seed,
            drop_last=False,
            pad_to_batch=True,
            num_workers=int(self.config.get("fast_input_workers", 1)),
            wire_format=wire_format,
        )
        input_fn = make_fast_input_fn(
            alpha=float(getattr(ds, "alpha", 0.5)),
            mean=norm_mean,
            std=norm_std,
            with_randaug=randaug_prob >= 0,
            with_bgmix=bool(getattr(ds, "bg_files", [])),
            dtype=self.spec.dtype,
            wire_format=loader.wire_format,
        )
        self._note_loader(what, f"fast ({loader.wire_format} wire)")
        return loader, input_fn

    def _fast_acm_loader(self, ds, what: str = "train"):
        """The fast path of the ActorCutMix family: native decode of the
        action and scene clips, boxes carried on the host, mask, cut-out and
        composite on the device (``FastACMLoader`` + ``make_fast_acm_input_fn``;
        reference actor_cut_mix_loader.py:117-152). The dataset hardcodes its
        geometry (256 short side, 224 crops, the MultiScaleCrop scales, flip
        0.5, box threshold 0.4, ``NUM_CLIPS`` clips) and drops the config's
        pipeline, so there is no pipeline to gate; the model's num_segments
        against ``NUM_CLIPS`` is the one setting that can differ, and then
        the host pipeline keeps the dataset's own sampling."""
        if int(self.spec.num_segments) != type(ds).NUM_CLIPS:
            self._note_loader(what, f"host (fast ACM input pipeline declined: model "
                                    f"num_segments {self.spec.num_segments} != the dataset's "
                                    f"hardcoded num_clips {type(ds).NUM_CLIPS})")
            return None, None
        wire_format = resolve_wire_format(str(self.config.get("fast_input_wire_format", "auto")),
                                          224)
        loader = FastACMLoader(
            ds.video_infos,
            batch_size=self.config.videos_per_gpu * self.data_module.world_size,
            num_segments=self.spec.num_segments,
            acm_prob=float(ds.acm_prob),
            filename_tmpl=ds.filename_tmpl,
            start_index=ds.start_index,
            seed=self.seed,
            drop_last=False,
            pad_to_batch=True,
            num_workers=int(self.config.get("fast_input_workers", 1)),
            wire_format=wire_format,
        )
        # the device normalize takes the dataset's hardcoded constants
        input_fn = make_fast_acm_input_fn(mean=tuple(ds.IMG_NORM["mean"]),
                                          std=tuple(ds.IMG_NORM["std"]), dtype=self.spec.dtype,
                                          wire_format=loader.wire_format)
        self._note_loader(what, f"fast ACM ({loader.wire_format} wire)")
        return loader, input_fn

    def train_task(self) -> None:
        self.training_phase = "inc_step"
        loader, input_fn = self._try_fast_loader()
        if loader is None:
            loader = self.data_module.train_dataloader()
        self._fit(loader, self.config.num_epochs_per_task, phase="inc_step", input_fn=input_fn)

    def train_cbf(self) -> None:
        """Class-balanced fine-tuning on the exemplar set (cil.py:759-795)."""
        self.training_phase = "cbf_step"
        logger.info("Class Balance Fine-tuning. Freeze backbone: %s",
                    not self.config.get("cbf_train_backbone", False))
        cbf_dataset = self.data_module.build_cbf_dataset()
        loader, input_fn = self._try_fast_loader(cbf_dataset, what="cbf")
        if loader is None:
            loader = DataLoader(
                cbf_dataset,
                batch_size=self.config.videos_per_gpu * self.data_module.world_size,
                shuffle=True,
                num_workers=self.config.workers_per_gpu,
                drop_last=False,
                pad_to_batch=True,
                seed=self.seed,
            )
        self._fit(loader, self.config.get("cbf_num_epochs_per_task", self.num_epoch_per_task),
                  phase="cbf", input_fn=input_fn)

    # -- exemplar construction ---------------------------------------------
    def _extract_features_for_constructing_exemplar(self) -> Dict:
        """Features and metadata over the current task's train split
        (cil.py:872-908), test-mode pipeline, unshuffled."""
        dm = self.data_module
        loader = dm.features_extraction_dataloader_on_train_dataset(self._current_task)
        nc = self.num_classes(self._current_task)

        # features_extraction_epochs > 1 runs the pipeline several times per sample
        epochs = int(self.config.data.get("features_extraction_epochs", 1))
        repr_passes, score_passes = [], []
        for epoch in range(epochs):
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(epoch)
            pred = self._predict(loader, nc, extract_repr=True)
            repr_passes.append(pred["repr"].mean(axis=1))  # (N, C) normalized rows
            score_passes.append(self._averaged_scores(pred["cls_score"]))
        infos = dm.features_extraction_dataset.video_infos
        return {
            "frame_dir": [info["frame_dir"] for info in infos],
            "total_frames": np.array([info["total_frames"] for info in infos]),
            "label": np.array([info["label"] for info in infos]),
            "repr_": np.stack(repr_passes, axis=1),  # (N, epochs, C)
            "cls_score": np.stack(score_passes, axis=1),
        }

    def _build_exemplar_for_current_task(self) -> Dict:
        class_indices = [self.data_module.ori_idx_to_inc_idx[idx]
                         for idx in self.task_splits[self._current_task]]
        manager = Herding(
            budget_size=self.config.budget_size,
            class_indices=class_indices,
            cosine_distance=True,
            storing_methods=self.config.get("storing_methods", "videos"),
            budget_type=self.config.get("budget_type", "class"),
        )
        return manager.construct_exemplar(self._extract_features_for_constructing_exemplar())

    # -- NME class means ----------------------------------------------------
    def _get_exemplar_class_means(self, task_idx: int, override_class_mean_ckpt=False) -> np.ndarray:
        """Per-class mean of the normalized exemplar representations, cached
        (cil.py:1059-1090)."""
        cache = self.ckpt_dir / f"exemplar_class_mean_task_{task_idx}.npz"
        if not override_class_mean_ckpt and cache.exists():
            logger.info("Load class means (exemplar) from: %s", cache)
            return np.load(cache)["class_means"]

        logger.info("Begin extract class mean from exemplar")
        dm = self.data_module
        dm.combine_all_exemplar_ann_files(task_idx)
        loader = dm.features_extraction_dataloader_on_exemplar(task_idx)
        pred = self._predict(loader, self.num_classes(self._current_task), extract_repr=True)
        repr_ = pred["repr"].mean(axis=1)  # (N, C)
        labels = pred["labels"]
        class_means = np.stack([repr_[labels == c].mean(axis=0)
                                for c in range(self.num_classes(task_idx))], axis=0)
        if distributed.is_primary():
            np.savez(cache, class_means=class_means)
        distributed.sync_processes("class_means")
        return class_means

    # -- testing -------------------------------------------------------------
    def _testing(self, task_indices: Sequence[int], val_test: str = "test",
                 exemplar_class_means: Optional[np.ndarray] = None):
        """CNN (and NME) accuracies over the merged tasks [start..end],
        segmented by the per-task dataset sizes (cil.py:910-983)."""
        assert len(task_indices) == 2
        logger.info("Begin testing")
        dm = self.data_module
        loader = (dm.get_val_dataloader(list(task_indices)) if val_test == "val"
                  else dm.get_test_dataloader(list(task_indices)))
        pred = self._predict(loader, self.num_classes(task_indices[-1]),
                             extract_repr=exemplar_class_means is not None)
        preds = np.argmax(self._averaged_scores(pred["cls_score"]), axis=-1)
        labels = pred["labels"]

        ds_list = dm.val_datasets  # segmentation always by val sizes (cil.py:933-936)
        cnn = AverageMeter()
        start = 0
        for task_idx in range(self._current_task + 1):
            n = len(ds_list[task_idx])
            acc = (preds[start : start + n] == labels[start : start + n]).mean()
            cnn.update(float(acc) * 100, n)
            start += n
        logger.info("Task %d Accuracies (CNN): %s | Avg: %.3f", self._current_task, cnn.values,
                    cnn.avg)
        if exemplar_class_means is None:
            return cnn

        # NME: cosine similarity to the class means, averaged over crops
        repr_ = pred["repr"]  # (N, G, C) normalized
        means = exemplar_class_means / np.maximum(
            np.linalg.norm(exemplar_class_means, axis=-1, keepdims=True), 1e-12)
        sims = np.einsum("ngc,kc->ngk", repr_, means).mean(axis=1)  # (N, K)
        preds_nme = np.argmax(sims, axis=-1)

        nme = AverageMeter()
        start = 0
        for task_idx in range(self._current_task + 1):
            n = len(ds_list[task_idx])
            acc = (preds_nme[start : start + n] == labels[start : start + n]).mean()
            nme.update(float(acc) * 100, n)
            start += n
        logger.info("Task %d Accuracies (NME): %s | Avg: %.3f", self._current_task, nme.values,
                    nme.avg)
        return cnn, nme

    # -- the outer loop ------------------------------------------------------
    def _cbf_resume_ready(self) -> bool:
        """A CBF snapshot of the current (resumed) task and its exemplar file
        exist: the interrupted run finished inc_step and the exemplars, so
        CBF resumes without retraining inc_step. Mirrors every condition of
        the in-phase restore (``snapshot_matches``)."""
        if not (self.config.get("mid_task_checkpointing", False)
                and self._current_task == self.starting_task
                and self._current_task > 0
                and self.config.get("use_cbf", False)):
            return False
        meta = peek_train_snapshot_meta(self.ckpt_dir / "mid_task_snapshot_cbf_step.pt")
        ex_file = self.data_module.exemplar_dir / f"exemplar_task_{self._current_task}.txt"
        if meta is None or not ex_file.exists():
            return False
        ok = snapshot_matches(meta, self._current_task, "cbf_step",
                              self.num_classes(self._current_task), self._run_token)
        if not ok:
            logger.warning("cbf-phase snapshot for task %d rejected (meta %s); running the full "
                           "task instead", self._current_task,
                           {k: meta.get(k) for k in ("task", "phase", "num_classes", "run_token")})
        return ok

    def _timed(self, key: str, fn) -> None:
        t0 = time.perf_counter()
        fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._stats[key] = self._stats.get(key, 0.0) + time.perf_counter() - t0

    def train(self) -> None:
        while self._current_task < self.num_tasks:
            self.print_task_info()
            self._stats = {"task": self._current_task}
            if self._cbf_resume_ready():
                logger.info("cbf-phase snapshot found for task %d: skipping inc_step retrain "
                            "and the exemplar rebuild, resuming CBF", self._current_task)
                ex_file = self.data_module.exemplar_dir / f"exemplar_task_{self._current_task}.txt"
                self.data_module.exemplar_datasets.append(
                    self.data_module.build_exemplar_dataset(str(ex_file)))
                self._timed("cbf_s", self.train_cbf)
                self._finish_task()
                continue
            logger.info("Start training for task %d", self._current_task)
            self._timed("train_s", self.train_task)

            if self.config.get("save_best", False) and self._current_task == 0:
                logger.info("Load from best ckpt")
                self.model = self._load_task_ckpt(self._current_task)

            logger.info("Create exemplar")

            def exemplar():
                meta = self._build_exemplar_for_current_task()
                self.data_module.build_exemplar_from_current_task(meta)

            self._timed("exemplar_s", exemplar)
            if self._current_task > 0 and self.config.get("use_cbf", False):
                self._timed("cbf_s", self.train_cbf)
            self._finish_task()

    def _finish_task(self) -> None:
        """Checkpoint, NME/CNN testing, and the advance to the next task."""
        t0 = time.perf_counter()
        if self.config.get("save_best", False) and self._ckpt_path(self._current_task).exists():
            logger.info("Load from best ckpt")
            self.model = self._load_task_ckpt(self._current_task)
        else:
            logger.info("Save last ckpt")
            self._save_task_ckpt(self._current_task)

        exemplar_class_means = self._get_exemplar_class_means(self._current_task,
                                                              override_class_mean_ckpt=True)
        cnn, nme = self._testing(val_test="val", exemplar_class_means=exemplar_class_means,
                                 task_indices=[0, self._current_task])
        self.cnn_matrix.append(list(cnn.values))
        self.nme_matrix.append(list(nme.values))
        self._stats["test_s"] = time.perf_counter() - t0
        self._stats["exemplars"] = self.data_module.exemplar_size
        self._stats["loaders"] = list(self.data_module.loader_notes)
        self.data_module.loader_notes.clear()
        self.task_stats.append(self._stats)
        self._stats = {}

        # advance to the next task
        self._current_task += 1
        if self._current_task < self.num_tasks:
            self.prev_model = copy.deepcopy(self.model)
            self._grow(self._current_task)
            self.data_module.reload_train_dataset(use_internal_exemplar=True)
        logger.info("#" * 80)

    def print_task_info(self) -> None:
        logger.info("Task %d, current heads: %d | Training set size: %d (including %d from "
                    "exemplar)", self._current_task, self.num_classes(self._current_task),
                    len(self.data_module.train_dataset), self.data_module.exemplar_size)
        if hasattr(self.data_module.train_dataset, "bg_files"):
            logger.info("Number of backgrounds: %d", len(self.data_module.train_dataset.bg_files))

    # -- full-protocol / single-ckpt testing ----------------------------------
    def cil_testing(self, test_nme: bool = False) -> None:
        """Evaluate every saved per-task checkpoint on tasks [0..t]
        (cil.py:985-1028); writes cnn_result.txt (and nme_result.txt)."""
        tmp = self._current_task
        cnn_accuracies: List[AverageMeter] = []
        nme_accuracies: List[AverageMeter] = []

        logger.info("Build test dataset")
        for task_idx in range(self.num_tasks):
            ds = self.data_module._build(self.config.data.test,
                                         self.data_module.task_splits_ann_files["val"][task_idx],
                                         test_mode=True)
            self.data_module.test_datasets.append(ds)

        for task_idx in range(self.num_tasks):
            self._current_task = task_idx
            self.model = self._load_task_ckpt(task_idx)
            if test_nme:
                means = self._get_exemplar_class_means(task_idx, override_class_mean_ckpt=False)
                cnn_i, nme_i = self._testing(exemplar_class_means=means,
                                             task_indices=[0, task_idx])
                cnn_accuracies.append(cnn_i)
                nme_accuracies.append(nme_i)
            else:
                cnn_accuracies.append(self._testing(task_indices=[0, task_idx]))

        sizes = [len(ci) for ci in self.task_splits[self.starting_task : self.ending_task + 1]]
        logger.info("CNN accuracies")
        cnn_table = print_mean_accuracy(cnn_accuracies, sizes)
        print(cnn_table)
        if distributed.is_primary():
            (self.work_dir / "cnn_result.txt").write_text("CNN Accuracies" + cnn_table + "\n")
        if test_nme:
            logger.info("NME accuracies")
            nme_table = print_mean_accuracy(nme_accuracies, sizes)
            print(nme_table)
            if distributed.is_primary():
                (self.work_dir / "nme_result.txt").write_text("NME Accuracies" + nme_table + "\n")
        self._current_task = tmp

    def single_ckpt_testing(self, ckpt_file: str, test_nme: bool = True):
        """Evaluate one checkpoint at the configured ending task (cil.py:1030-1057);
        returns ``_testing``'s accuracies."""
        logger.info("Load ckpt from %s", ckpt_file)
        state, meta = load_checkpoint(ckpt_file)
        nc = int(meta["num_classes"]) if meta else head_param_path(self.model).num_classes
        self.model = self.spec.module(nc)
        self.model.load_state_dict(state)

        exemplar_class_means = None
        if test_nme:
            logger.info("Create exemplar")
            exemplar_meta = self._build_exemplar_for_current_task()
            exemplar_class_means = np.stack(
                [np.asarray(exemplar_meta[c]["class_mean"]).reshape(-1)
                 for c in sorted(exemplar_meta.keys())], axis=0)

        for task_idx in range(len(self.config.task_splits)):
            ds = self.data_module._build(self.config.data.test,
                                         self.data_module.task_splits_ann_files["val"][task_idx],
                                         test_mode=True)
            self.data_module.test_datasets.append(ds)
        self._current_task = self.ending_task
        return self._testing(val_test="test", exemplar_class_means=exemplar_class_means,
                             task_indices=[0, self._current_task])
