"""Plain single-task (non-CIL) trainer (the counterpart of ``tools/train.py``;
reference tools/train.py:87-220, the vendored mmaction2 path used for
single-stage baselines): build the model and the datasets from a config,
train ``total_epochs`` with the configured optimizer and schedule, validate
after every epoch and checkpoint to ``work_dir`` (``latest.pt`` after each
epoch, ``final.pt`` at the end; ``runtime/checkpoint.py``'s format).

    python -m bdvcil_torch.tools.train CONFIG.py [--work_dir DIR] [--resume-from CKPT.pt]
        [--seed N] [--cfg-options key=value ...] [--device cpu]

The initial weights and the step draws come from the config's ``seed``
(``init_model_params``, ``runtime/loops.step_generator``), not from a JAX key.
The model is float32 whatever the config's ``compute_dtype``, as in the JAX
tool, and runs on the card unless ``--device`` names another device; without a CUDA device and
without ``--device`` it raises. ``--launcher`` is accepted for the reference's
command line; under ``python -m torch.distributed.run --nproc_per_node N`` each
rank trains on its ``videos_per_gpu`` rows of the global batch and rank 0
writes the checkpoints.
"""

from __future__ import annotations

import argparse
import ast
import pathlib
from typing import Optional, Sequence

import numpy as np

from .._device import resolve_device
from ..parallel import distributed
from ..config import Config


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Train a recognizer (single task)")
    parser.add_argument("config", help="config file path")
    parser.add_argument("--work_dir", help="dir to save logs and models")
    parser.add_argument("--resume-from", help="checkpoint to resume from")
    parser.add_argument("--validate", action="store_true", default=True)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm", "mpi"],
                        default="none", help="accepted for the reference's command line")
    parser.add_argument("--cfg-options", nargs="+", default=[], help="key=value overrides")
    parser.add_argument("--device", help="the torch device (default: the CUDA card)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Train; returns the final train state."""
    distributed.initialize()  # the process group under a launcher; a no-op alone
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    overrides = {}
    for kv in args.cfg_options:
        key, value = kv.split("=", 1)
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
        overrides[key] = value
    if overrides:
        cfg.merge_from_dict(overrides)
    if args.work_dir:
        cfg.work_dir = args.work_dir
    if args.seed is not None:
        cfg.seed = args.seed

    from ..data.datasets import build_dataset
    from ..data.host_loader import DataLoader
    from ..models import build_model, init_model_params
    from ..optim import build_optimizer
    from ..runtime import TrainState, make_eval_step, make_train_step
    from ..runtime.checkpoint import load_checkpoint, save_checkpoint
    from ..runtime.loops import run_inference, train_epochs
    from ..utils import MetricLogger, get_logger

    logger = get_logger("bdvcil.tools.train")
    work_dir = pathlib.Path(cfg.get("work_dir", "work_dirs/train"))
    work_dir.mkdir(parents=True, exist_ok=True)
    primary = distributed.is_primary()
    world = distributed.process_count()
    if primary:
        cfg.dump(str(work_dir / "config.py"))

    seed = cfg.get("seed", 0)
    spec = build_model(dict(cfg.model), device=device)
    num_classes = spec.num_classes
    model = init_model_params(spec, seed)
    if args.resume_from:
        state_dict, _ = load_checkpoint(args.resume_from)
        model.load_state_dict(state_dict)

    train_ds = build_dataset(dict(cfg.data.train))
    val_ds = build_dataset(dict(cfg.data.val)) if "val" in cfg.data else None
    loader = DataLoader(
        train_ds,
        batch_size=cfg.videos_per_gpu * world,
        shuffle=True,
        num_workers=cfg.get("workers_per_gpu", 4),
        drop_last=False,
        pad_to_batch=True,
        seed=seed,
    )

    total_epochs = cfg.get("total_epochs", 1)
    accumulate = cfg.get("accumulate_grad_batches", 1)
    grad_clip = (cfg.get("optimizer_config") or {}).get("grad_clip", {}).get("max_norm")
    tx = build_optimizer(
        model,
        cfg.optimizer,
        cfg.get("lr_scheduler"),
        steps_per_epoch=max(1, len(loader) // accumulate),
        grad_clip=grad_clip,
        accumulate_steps=accumulate,
    )
    step_fn = make_train_step(spec, tx, num_classes=num_classes, method="base", task_idx=0)
    state = TrainState.create(model, tx)
    metric_logger = MetricLogger(str(work_dir) if primary else None)
    meta = {"num_classes": num_classes}

    def epoch_hook(epoch, state_now):
        if primary:
            save_checkpoint(work_dir / "latest.pt", state_now.module,
                            meta=dict(meta, epoch=epoch))
        distributed.sync_processes("latest_ckpt")
        if val_ds is not None and args.validate:
            val_loader = DataLoader(
                val_ds, batch_size=cfg.get("testing_videos_per_gpu", cfg.videos_per_gpu) * world,
                shuffle=False)
            pred = run_inference(make_eval_step(spec, num_classes), state_now.module, val_loader,
                                 device=device, pad_batch_to=val_loader.batch_size)
            score = pred["cls_score"].mean(axis=1)
            acc = float((np.argmax(score, -1) == pred["labels"]).mean())
            logger.info("epoch %d val top1=%.4f", epoch, acc)
            metric_logger.log({"val_top1": acc})

    state, _ = train_epochs(
        step_fn,
        state,
        None,
        loader,
        total_epochs,
        seed,
        device=device,
        metric_logger=metric_logger,
        log_every_n_steps=cfg.get("log_every_n_steps", 20),
        phase="train",
        epoch_hook=epoch_hook,
    )
    if primary:
        save_checkpoint(work_dir / "final.pt", state.module,
                        meta=dict(meta, epochs=total_epochs))
    distributed.sync_processes("final_ckpt")
    logger.info("done; checkpoints in %s", work_dir)
    return state


if __name__ == "__main__":
    main()
