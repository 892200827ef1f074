"""The CIL training entry point of the port (the counterpart of
``cil_tools/train_cil.py``): load a config, apply the command-line overrides
and run the per-task loop on the card.

    python -m bdvcil_torch.cil_tools.train_cil CONFIG.py [--work_dir DIR] ...
    python -m bdvcil_torch.cil_tools.train_cil --preset hmdb51:1000:6[:VARIANT] ...

A config file is written against ``bdvcil_torch.config_templates`` (the
files under ``configs/`` import the JAX package); ``--preset`` builds one with
``make_cil_config`` (data under ``$VIDEO_CIL_ROOT``, else ``data/<dataset>``).
The flags are those of the JAX entry point; boolean flags and ``--alpha`` /
``--log_every_n_steps`` override the config only when given. It runs on the
card unless ``--device`` names another device (``--device cpu``); without a
CUDA device and without ``--device`` it raises. Under a launcher each rank
trains on its rows of every global batch (``videos_per_gpu`` a rank):

    python -m torch.distributed.run --nproc_per_node N \
        -m bdvcil_torch.cil_tools.train_cil CONFIG.py
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .._device import resolve_device
from ..config import Config
from ..config_templates import parse_preset
from ..parallel import distributed


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Train a CIL video recognizer")
    parser.add_argument("config", nargs="?", help="train config file path")
    parser.add_argument("--preset", help="dataset:seed:stages[:variant], instead of a config")
    parser.add_argument("--device", help="the torch device (default: the CUDA card)")

    parser.add_argument("--work_dir", help="the dir to save logs and models")
    parser.add_argument("--videos_per_gpu", type=int)
    parser.add_argument("--workers_per_gpu", type=int)
    parser.add_argument("--accumulate_grad_batches", type=int)
    parser.add_argument("--testing_videos_per_gpu", type=int)
    parser.add_argument("--testing_workers_per_gpu", type=int)
    parser.add_argument("--starting_task", default=0, type=int,
                        help="resume from task i; checkpoints/exemplars are reloaded from work_dir")
    parser.add_argument("--ending_task", type=int, help="stop after this task")
    parser.add_argument("--use_cbf", action="store_true", default=None,
                        help="class-balanced fine-tuning")
    parser.add_argument("--cbf_train_backbone", action="store_true", default=None)
    parser.add_argument("--keep_all_backgrounds", action="store_true", default=None)
    parser.add_argument("--cbf_full_bg", action="store_true", default=None)
    parser.add_argument("--budget_size", type=int)
    parser.add_argument("--alpha", type=float)
    parser.add_argument("--num_epochs_per_task", type=int)
    parser.add_argument("--cbf_num_epochs_per_task", type=int)
    parser.add_argument("--kd_exemplar_only", action="store_true", default=None)
    parser.add_argument("--log_every_n_steps", type=int)
    parser.add_argument("--save_best", action="store_true", default=None,
                        help="validate every epoch, keep best")
    parser.add_argument("--mid_task_checkpointing", action="store_true", default=None,
                        help="epoch-boundary train snapshots: rerunning with --starting_task t "
                             "resumes from the last completed epoch, bit for bit")
    parser.add_argument("--mid_task_ckpt_every", type=int,
                        help="epochs between snapshots (default 1)")
    parser.add_argument("--seed", type=int)
    parser.add_argument("--compute_dtype", choices=["float32", "bfloat16"])
    parser.add_argument("--gpu_ids", type=int, nargs="*",
                        help="ignored (kept for the reference's launch scripts)")
    args = parser.parse_args(argv)
    if (args.config is None) == (args.preset is None):
        parser.error("give a config file or --preset, not both")
    cfg_dict = {k: v for k, v in vars(args).items()
                if v is not None and k not in ("config", "preset", "device", "gpu_ids")}
    return args, cfg_dict


def load_config(args, cfg_dict) -> Config:
    config = (Config.fromfile(args.config) if args.config is not None
              else Config.fromdict(parse_preset(args.preset)))
    config.merge_from_dict(cfg_dict)
    if "train" in config.data and "alpha" in config.data.train and "alpha" in config:
        config.data.train.alpha = config.alpha
    return config


def main(argv: Optional[Sequence[str]] = None):
    """Train; returns the trainer (its accuracy matrices and ``task_stats``)."""
    distributed.initialize()  # the process group under a launcher; a no-op alone
    args, cfg_dict = parse_args(argv)
    device = resolve_device(args.device)
    config = load_config(args, cfg_dict)

    from ..cil import CILTrainer

    trainer = CILTrainer(config, device=device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
