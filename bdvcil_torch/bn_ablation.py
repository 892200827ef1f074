"""How the BatchNorm statistics semantics move training (the port of
``tools/bn_ablation.py``).

The reference trains with torch DDP and no SyncBN: every GPU normalizes with
its own shard's statistics (reference cil.py:703-709). The port's default
takes the global batch's statistics. This tool trains one small task three
ways and reports each mode's accuracy:

  global_batch   one BatchNorm over the batch (the default)
  per_device_8   ``bn_groups=8``: eight groups of rows, each with its own
                 statistics, as the reference's eight GPUs
  ghost_quarter  ``bn_stats_rows=16``: statistics over the first 16 rows

Protocol (the JAX tool's, draw for draw in numpy): R18-TSM (T=2, 32x32),
8 classes x 24 train clips, class signal = per-class colour mean + per-clip
jitter + noise, val clips at a larger jitter so accuracy has an error
floor; ``BN_EPOCHS`` epochs (24) of the CIL train step (labeled SGD, CE),
the same data order and init in every mode, over ``BN_SEEDS`` (0,1,2).
Accuracy is the argmax of the mean over clips of the eval step's scores.

    python -m bdvcil_torch.bn_ablation [--device cpu]

One JSON line a mode and seed, then the summary line. The head's dropout is
drawn from a torch generator, so a run matches the JAX tool's in
distribution, not draw for draw.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .models import build_model, init_model_params
from .optim import build_optimizer
from .runtime import TrainState, make_eval_step, make_train_step

MODES: List[Tuple[str, Dict]] = [
    ("global_batch (SPMD default)", {}),
    ("per_device_8 (reference DDP semantics, bn_groups=8)", {"bn_groups": 8}),
    ("ghost_quarter (bn_stats_rows = rows/4)", {"bn_stats_rows": 16}),
]
OPTIMIZER = dict(type="SGD", lr=0.02, momentum=0.9, weight_decay=1e-4)
SEEDS, EPOCHS = "0,1,2", 24  # BN_SEEDS, BN_EPOCHS unless set


def make_data(rng, means, per_class=24, t=2, hw=32, jitter=0.0, noise=1.0):
    """Class-separable clips: per-class channel means + per-CLIP jitter +
    per-pixel noise. ``jitter`` moves whole clips toward neighboring classes
    (larger on the val split -> irreducible error floor)."""
    xs, ys = [], []
    for c in range(len(means)):
        jit = rng.normal(size=(per_class, 1, 1, 1, 3)) * jitter
        clips = means[c][None, None, None, None, :] + jit + rng.normal(
            size=(per_class, t, hw, hw, 3)
        ) * noise
        xs.append(clips)
        ys.append(np.full((per_class,), c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int64)
    order = rng.permutation(len(y))
    return x[order], y[order]


def mode_config(backbone_extra: Dict, t: int, num_classes: int,
                dropout_ratio: float = 0.5) -> Dict:
    """The recognizer of one mode: R18-TSM, a SimpleLinear head, CE loss."""
    return dict(
        type="CILRecognizer2D",
        backbone=dict(
            type="ResNetTSM", depth=18, num_segments=t, shift_div=8, **backbone_extra
        ),
        cls_head=dict(
            type="IncrementalTSMHead",
            num_classes=num_classes,
            in_channels=512,
            inc_head_config=dict(type="SimpleLinear", out_features=num_classes),
            num_segments=t,
            loss_cls=dict(type="CrossEntropyLoss"),
            dropout_ratio=dropout_ratio,
        ),
        test_cfg=dict(average_clips="prob"),
    )


def build_mode(backbone_extra: Dict, t: int, num_classes: int, seed: int = 0, device=None,
               dropout_ratio: float = 0.5, init_state: Optional[Dict] = None):
    """(spec, module) of one mode, the weights drawn from ``seed`` or, given,
    ``init_state`` (a state_dict)."""
    spec = build_model(mode_config(backbone_extra, t, num_classes, dropout_ratio),
                       device=device)
    module = init_model_params(spec, seed, num_classes)
    if init_state is not None:
        module.load_state_dict(init_state)
    return spec, module


def run_mode(name, backbone_extra, x, y, x_val, y_val, epochs=20, batch=32, seed=0,
             device=None, dropout_ratio: float = 0.5, init_state: Optional[Dict] = None):
    """Train one mode for ``epochs`` on (x, y) and report its final train loss
    and its train and val accuracy; prints the record as a JSON line."""
    device = resolve_device(device)
    t = x.shape[1]
    num_classes = int(y.max()) + 1
    spec, module = build_mode(backbone_extra, t, num_classes, seed, device, dropout_ratio,
                              init_state)
    tx = build_optimizer(module, OPTIMIZER)
    state = TrainState.create(module, tx)
    step = make_train_step(spec, tx, num_classes=num_classes, method="base", task_idx=0)
    eval_step = make_eval_step(spec, num_classes)

    generator = torch.Generator(device=device).manual_seed(seed + 1)  # dropout
    x_dev = torch.from_numpy(x).to(device)
    y_dev = torch.from_numpy(y).to(device)
    n = len(y)
    order_rng = np.random.default_rng(seed + 2)
    loss = float("nan")
    for _ in range(epochs):
        order = order_rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            idx = torch.from_numpy(order[i : i + batch]).to(device)
            state, metrics = step(state, None, x_dev[idx], y_dev[idx][:, None], {}, generator)
        loss = float(metrics["loss"])

    def acc(xa, ya):
        correct = 0
        for i in range(0, len(ya), batch):
            out = eval_step(state.module, torch.from_numpy(xa[i : i + batch]).to(device))
            scores = out["cls_score"].mean(dim=1).cpu().numpy()  # (B, nc)
            correct += int((np.argmax(scores, -1) == ya[i : i + batch]).sum())
        return correct / len(ya)

    rec = {
        "mode": name,
        "final_train_loss": round(loss, 4),
        "train_acc": round(acc(x, y), 4),
        "val_acc": round(acc(x_val, y_val), 4),
    }
    print(json.dumps(rec), flush=True)
    return rec


def seed_data(seed: int):
    """(x, y, x_val, y_val) of one seed."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(8, 3)) * 0.8
    x, y = make_data(rng, means, jitter=0.5, noise=1.0)
    x_val, y_val = make_data(np.random.default_rng(seed + 100), means, per_class=8,
                             jitter=0.7, noise=1.0)
    return x, y, x_val, y_val


def ablate(seeds: Sequence[int], epochs: int, device=None) -> Dict:
    """Every mode at every seed: {'records': [...], 'summary': the summary line}."""
    device = resolve_device(device)
    summary = {name: [] for name, _ in MODES}
    records = []
    for seed in seeds:
        x, y, x_val, y_val = seed_data(seed)
        for name, extra in MODES:
            rec = run_mode(name, extra, x, y, x_val, y_val, epochs=epochs, seed=seed,
                           device=device)
            records.append(dict(rec, seed=seed))
            summary[name].append(rec["val_acc"])
    agg = {
        name: {
            "val_accs": accs,
            "mean": round(float(np.mean(accs)), 4),
            "spread": round(float(np.max(accs) - np.min(accs)), 4),
        }
        for name, accs in summary.items()
    }
    return dict(records=records,
                summary={"ablation": "bn_semantics", "seeds": list(seeds), "summary": agg})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the card unless told otherwise ('cpu' to run there)")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in os.environ.get("BN_SEEDS", SEEDS).split(",")]
    epochs = int(os.environ.get("BN_EPOCHS", EPOCHS))
    t0 = time.perf_counter()
    out = ablate(seeds, epochs, args.device)
    print(json.dumps(out["summary"]), flush=True)
    print(f"[bn_ablation] {len(out['records'])} runs in {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
