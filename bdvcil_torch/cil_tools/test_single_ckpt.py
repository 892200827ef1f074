"""Evaluate one checkpoint at a chosen task index (the counterpart of
``cil_tools/test_single_ckpt.py``; reference cil_tools/test_single_ckpt.py:31-44):
the trainer resumes at ``--starting_task`` from the run's ``work_dir``, loads
``--ckpt``, rebuilds that task's exemplars for NME and tests tasks [0..t].

    python -m bdvcil_torch.cil_tools.test_single_ckpt CONFIG.py --ckpt CKPT.pt
        --starting_task T [--work_dir DIR] [--no_nme] [--device cpu]

It runs on the card unless ``--device`` names another device; without a
CUDA device and without ``--device`` it raises.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .._device import resolve_device
from ..config import Config
from ..parallel import distributed


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Test a single checkpoint")
    parser.add_argument("config", help="config file path")
    parser.add_argument("--work_dir")
    parser.add_argument("--ckpt", required=True, help="path to checkpoint")
    parser.add_argument("--starting_task", required=True, type=int, help="task index to test at")
    parser.add_argument("--testing_videos_per_gpu", type=int)
    parser.add_argument("--testing_workers_per_gpu", type=int)
    parser.add_argument("--no_nme", action="store_true")
    parser.add_argument("--device", help="the torch device (default: the CUDA card)")
    parser.add_argument("--gpu_ids", type=int, nargs="*",
                        help="ignored (kept for the reference's launch scripts)")
    args = parser.parse_args(argv)
    cfg_dict = {k: v for k, v in vars(args).items()
                if v is not None and k not in ("config", "no_nme", "gpu_ids", "device")}
    return args, cfg_dict


def main(argv: Optional[Sequence[str]] = None):
    """Test the checkpoint; returns the CNN accuracies (and NME ones unless
    ``--no_nme``), as ``CILTrainer.single_ckpt_testing`` does."""
    distributed.initialize()  # the process group under a launcher; a no-op alone
    args, cfg_dict = parse_args(argv)
    device = resolve_device(args.device)
    config = Config.fromfile(args.config)
    config.merge_from_dict(cfg_dict)
    config.ending_task = config.starting_task

    from ..cil import CILTrainer

    trainer = CILTrainer(config, dump_config=False, device=device)
    return trainer.single_ckpt_testing(ckpt_file=config.ckpt, test_nme=not args.no_nme)


if __name__ == "__main__":
    main()
