"""Full-protocol CIL evaluation (the counterpart of ``cil_tools/test_cil.py``;
reference cil_tools/test_cil.py:29-42): load each per-task checkpoint of a
run's ``work_dir``, test it on tasks [0..t], print the CNN (and NME) accuracy
tables and write ``cnn_result.txt`` / ``nme_result.txt``.

    python -m bdvcil_torch.cil_tools.test_cil CONFIG.py [--work_dir DIR] [--no_nme]
        [--device cpu]

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
    parser = argparse.ArgumentParser(description="Test a CIL run")
    parser.add_argument("config", help="config file path")
    parser.add_argument("--work_dir")
    parser.add_argument("--testing_videos_per_gpu", type=int)
    parser.add_argument("--testing_workers_per_gpu", type=int)
    parser.add_argument("--no_nme", action="store_true", help="skip the NME classifier")
    parser.add_argument("--device", help="the torch device (default: the CUDA card)")
    parser.add_argument("--gpu_ids", type=int, nargs="*",
                        help="ignored (kept for the reference's launch scripts)")
    args = parser.parse_args(argv)
    cfg_dict = {k: v for k, v in vars(args).items()
                if v is not None and k not in ("config", "no_nme", "gpu_ids", "device")}
    return args, cfg_dict


def main(argv: Optional[Sequence[str]] = None):
    """Test every checkpoint; returns the trainer (its work_dir holds the tables)."""
    distributed.initialize()  # the process group under a launcher; a no-op alone
    args, cfg_dict = parse_args(argv)
    device = resolve_device(args.device)
    config = Config.fromfile(args.config)
    config.merge_from_dict(cfg_dict)
    config.starting_task = 0

    from ..cil import CILTrainer

    trainer = CILTrainer(config, dump_config=False, device=device)
    trainer.cil_testing(test_nme=not args.no_nme)
    return trainer


if __name__ == "__main__":
    main()
