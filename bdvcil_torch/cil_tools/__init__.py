"""Command-line tools of the port (``python -m bdvcil_torch.cil_tools.<tool>``),
one per JAX tool in ``cil_tools/``:

  train_cil                the CIL training entry point
  test_cil                 every per-task checkpoint of a run on tasks [0..t]
  test_single_ckpt         one checkpoint at a chosen task
  predict                  top-k classes of unlabeled rawframe videos
  extract_features         per-sample scores and representations of a split
  extract_background       the temporal-median background bank
  create_annotation_files  per-task and oracle annotation files, the label map

Each runs on the card unless ``--device`` names another device (the model
tools) or the reduction runs on the host (``extract_background`` without
``--device``, ``create_annotation_files``). Under a launcher
(``python -m torch.distributed.run --nproc_per_node N -m
bdvcil_torch.cil_tools.<tool> ...``) each ``main`` first joins the process
group (``parallel.distributed.initialize``), one rank a card; rank 0 writes
the files. ``extract_background``'s host path splits the videos by the
launcher's rank and joins no group, so its workers fork from a parent that
has touched neither CUDA nor a process group.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def load_model(config, ckpt_path, device) -> Tuple[object, torch.nn.Module, int, Optional[Dict]]:
    """(spec, module on ``device``, classifier width, sidecar meta) of a port
    checkpoint (``runtime/checkpoint.py``): the width is the checkpoint's
    classifier rows. The model is float32 whatever the config's
    ``compute_dtype``, as the JAX tools build it."""
    from ..models.builder import build_model
    from ..runtime.checkpoint import load_checkpoint

    state, meta = load_checkpoint(ckpt_path)
    fc = state.get("cls_head.fc_weights", state.get("cls_head.fc_weight"))
    if fc is None:
        raise KeyError(f"{ckpt_path}: no classifier (cls_head.fc_weights / fc_weight)")
    num_classes = int(fc.shape[0])
    spec = build_model(dict(config.model), device=device)
    module = spec.module(num_classes)
    module.load_state_dict(state)
    return spec, module, num_classes, meta
