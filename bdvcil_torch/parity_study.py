"""Multi-seed accuracy study of the port against the reference's loop (the
port of ``tools/parity_study.py``).

N paired full-protocol CIL runs on one synthetic tree: each pair starts from
one init (the reference loop's R18 weights copied into the port's model) and
sees one data order, and the study reports the per-stage mean of the paired
deltas (port - reference) with its standard error, which shrinks ~1/sqrt(N).
A systematic bias near zero with a tight SE is the accuracy-parity evidence
a run without the real datasets can give.

  reference  ``reference_loop.TorchMiniCIL``: the reference's loop semantics
             (cil.py:621-860) in plain torch
  port       ``cil.CILTrainer`` with its model, steps and kernels

Both sides run on ``--device`` (the card unless told otherwise). The port's
side takes ``videos_per_gpu=8`` and ``testing_videos_per_gpu=64`` on one
process, the reference loop 1 and 8 on its fixed world of 8, so the global
batches are equal.

    python -m bdvcil_torch.parity_study --seeds 8 --method base \\
        --out work_dirs/parity_study_base.json [--stages 6] [--device cpu] \\
        [--set num_epochs_per_task=2]

The tree goes to a fresh temporary directory unless ``--data_root`` names
one; each pair's work dirs (configs, checkpoints, exemplar files) are
removed after the pair. The JSON holds every run and the summary and is
written again after each seed.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ._device import resolve_device
from .cil import CILTrainer
from .models.heads import head_param_path
from .models.pretrained import apply_backbone_weights, load_torch_resnet_backbone
from .reference_loop import TorchMiniCIL
from .reference_loop.tree import (DEPTH_TREE_PARAMS, TREE_PARAMS, build_parity_tree,
                                  depth_overrides, make_parity_config, method_overrides)

# the port's side on one process: the reference loop's global batches (1 x 8
# to train, 8 x 8 to test) from per-device sizes alone
PORT_OVERRIDES = dict(videos_per_gpu=8, testing_videos_per_gpu=64)

# A pair evidences bias only when BOTH sides trained: a side whose
# final-stage accuracy lands at chance fell off the from-scratch convergence
# cliff of the synthetic protocol, and its delta is "trained vs untrained".
# Collapses are left out of the bias statistics and counted per side: an
# asymmetric collapse rate would itself be a difference between the two.
COLLAPSE_FLOOR_PTS = 20.0

SIDES = ("reference", "port")


@torch.no_grad()
def load_reference_init(port_model: torch.nn.Module, ref_model: torch.nn.Module) -> None:
    """The reference loop's weights into the port's recognizer: the backbone
    through ``load_torch_resnet_backbone`` / ``apply_backbone_weights``, the
    head's ``fc_weights``/``eta`` (LSC) or ``fc_weight``/``fc_bias`` (linear)."""
    sd = {"backbone." + k: v for k, v in ref_model.backbone.state_dict().items()}
    apply_backbone_weights(port_model, load_torch_resnet_backbone(sd))
    head = head_param_path(port_model)
    if ref_model.head_type == "linear":
        pairs = [(head.fc_weight, ref_model.fc_weights), (head.fc_bias, ref_model.fc_bias)]
    else:
        pairs = [(head.fc_weights, ref_model.fc_weights), (head.eta, ref_model.eta)]
    for dst, src in pairs:
        dst.copy_(src.reshape(dst.shape))


def make_pair(tree, work_ref: pathlib.Path, work_port: pathlib.Path, method: str = "base",
              device=None, **extra_overrides):
    """The two sides of one pair, built and sharing the reference loop's init:
    (TorchMiniCIL, CILTrainer). ``extra_overrides`` apply to both configs;
    ``PORT_OVERRIDES`` to the port's alone."""
    device = resolve_device(device)
    root, frames_root, train_ann, val_ann = tree
    overrides = dict(method_overrides(method), **extra_overrides)
    cfg_ref = make_parity_config(root, frames_root, train_ann, val_ann, work_ref, **overrides)
    cfg_port = make_parity_config(root, frames_root, train_ann, val_ann, work_port,
                                  **dict(overrides, **PORT_OVERRIDES))
    if method != "base":
        cfg_ref.optimizer["lr"] = cfg_port.optimizer["lr"] = 0.01
    mini = TorchMiniCIL(cfg_ref, device=device)
    if method != "base":
        assert mini.head_type == "linear" and mini.average_clips == "score"
    trainer = CILTrainer(cfg_port, device=device)
    load_reference_init(trainer.model, mini.model)
    return mini, trainer


def _stage_means(matrix) -> List[float]:
    return [float(np.mean(row)) for row in matrix]


def _tolist(matrix) -> List[List[float]]:
    return [[float(v) for v in row] for row in matrix]


def run_pair(tree, work_root: pathlib.Path, method: str, seed: int,
             extra_overrides: Optional[Dict] = None, device=None) -> Dict:
    """One paired run at ``seed`` (the config's seed: the reference loop's
    init and both sides' data order). Returns per-stage mean CNN/NME of both
    sides, both matrices, both walls in seconds and the device."""
    device = resolve_device(device)
    work_ref = pathlib.Path(work_root) / f"reference_s{seed}"
    work_port = pathlib.Path(work_root) / f"port_s{seed}"
    try:
        mini, trainer = make_pair(tree, work_ref, work_port, method, device,
                                  seed=seed, **(extra_overrides or {}))
        t0 = time.perf_counter()
        mini.train()
        t1 = time.perf_counter()
        trainer.train()
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(work_ref, ignore_errors=True)
        shutil.rmtree(work_port, ignore_errors=True)
    return dict(
        seed=seed,
        device=str(device),
        cnn_reference=_stage_means(mini.cnn_matrix),
        cnn_port=_stage_means(trainer.cnn_matrix),
        nme_reference=_stage_means(mini.nme_matrix),
        nme_port=_stage_means(trainer.nme_matrix),
        cnn_matrix_reference=_tolist(mini.cnn_matrix),
        cnn_matrix_port=_tolist(trainer.cnn_matrix),
        nme_matrix_reference=_tolist(mini.nme_matrix),
        nme_matrix_port=_tolist(trainer.nme_matrix),
        wall_reference_s=t1 - t0,
        wall_port_s=t2 - t1,
    )


def _converged(r, metric) -> bool:
    return all(r[f"{metric}_{side}"][-1] >= COLLAPSE_FLOOR_PTS for side in SIDES)


def summarize(results: Sequence[Dict]) -> Dict:
    """Per-stage mean and SE of the paired deltas (port - reference) over the
    converged pairs, the final stage alone (the north star is the final
    average accuracy) and the collapses of each side."""
    n_stages = len(results[0]["cnn_reference"])
    out = {}
    for metric in ("cnn", "nme"):
        conv = [r for r in results if _converged(r, metric)]
        collapsed = {side: int(sum(r[f"{metric}_{side}"][-1] < COLLAPSE_FLOOR_PTS
                                   for r in results)) for side in SIDES}
        counts = dict(n_converged=len(conv),
                      n_collapsed_reference=collapsed["reference"],
                      n_collapsed_port=collapsed["port"],
                      converged_seeds=[r["seed"] for r in conv])
        if not conv:
            # statistics over no converged pair would measure trained against
            # untrained: explicit nulls instead
            out[metric] = dict(counts, no_converged_pairs=True, per_stage_mean_delta=None,
                               per_stage_se=None, final_stage_mean_delta=None,
                               final_stage_se=None, per_seed_final_delta=[])
            continue
        deltas = np.array([[r[f"{metric}_port"][s] - r[f"{metric}_reference"][s]
                            for s in range(n_stages)] for r in conv])  # (pairs, stages)
        many = len(deltas) > 1
        se = deltas.std(axis=0, ddof=1) / np.sqrt(len(deltas)) if many else None
        out[metric] = dict(
            counts,
            per_stage_mean_delta=[round(float(m), 2) for m in deltas.mean(axis=0)],
            per_stage_se=[round(float(s), 2) for s in se] if many else None,
            final_stage_mean_delta=round(float(deltas[:, -1].mean()), 2),
            final_stage_se=round(float(se[-1]), 2) if many else None,
            per_seed_final_delta=[round(float(d), 2) for d in deltas[:, -1]],
        )
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=5, help="number of paired runs")
    ap.add_argument("--first_seed", type=int, default=0)
    ap.add_argument("--method", default="base", choices=["base", "icarl", "icarl_video_mix"])
    ap.add_argument("--out", default="work_dirs/parity_study.json")
    ap.add_argument("--data_root", default=None,
                    help="reuse an existing study tree (default: a fresh temporary directory)")
    ap.add_argument("--resume", action="store_true",
                    help="load the runs in --out (same method, stages, extra_val and "
                         "overrides) and run only the seeds not present")
    ap.add_argument("--stages", type=int, default=3,
                    help="protocol depth: 3 = the tuned base tree; other values build the "
                         "2-classes-per-task depth tree")
    ap.add_argument("--device", default=None,
                    help="device of both sides (default: the card; 'cpu' to run there)")
    ap.add_argument("--extra_val", type=int, default=None,
                    help="override extra_val_videos_per_class (another val set: a "
                         "different study, not to be mixed with the default in one --out)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override applied to BOTH sides (python-literal values, "
                         "repeatable); a different study, recorded in the output and "
                         "checked on --resume")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    cli_overrides = {}
    for item in args.set:
        key, sep, val = item.partition("=")
        if not sep:
            ap.error(f"--set needs KEY=VALUE, got {item!r}")
        try:
            cli_overrides[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            cli_overrides[key] = val
    if args.seeds < 1:
        ap.error("--seeds must be >= 1")
    if not (2 <= args.stages <= 13):
        # 2 classes a task over the synthetic 27-colour palette caps depth at 13
        ap.error("--stages must be in [2, 13] (palette has 27 class colors)")
    device = resolve_device(args.device)

    results = []
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            prior = json.load(f)
        if (prior.get("method"), prior.get("stages", 3), prior.get("extra_val"),
                prior.get("overrides") or {}) != (args.method, args.stages, args.extra_val,
                                                  cli_overrides):
            ap.error(f"--resume: {args.out} holds method {prior.get('method')!r} at "
                     f"{prior.get('stages', 3)} stages / extra_val {prior.get('extra_val')} / "
                     f"overrides {prior.get('overrides')}, not {args.method!r} at "
                     f"{args.stages} / {args.extra_val} / {cli_overrides}")
        results = list(prior["runs"])
        print(f"[parity_study] resumed {len(results)} runs "
              f"(seeds {[r['seed'] for r in results]})", flush=True)

    extra_overrides = {}
    if args.stages != 3:
        tree_params = dict(DEPTH_TREE_PARAMS, num_classes=2 * args.stages)
        extra_overrides.update(depth_overrides(args.stages))
    else:
        tree_params = dict(TREE_PARAMS)
    if args.extra_val is not None:
        tree_params["extra_val_videos_per_class"] = args.extra_val
    extra_overrides.update(cli_overrides)

    made_root = args.data_root is None
    data_root = pathlib.Path(args.data_root or tempfile.mkdtemp(prefix="parity_study_"))
    data_root.mkdir(parents=True, exist_ok=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    def dump():
        payload = dict(method=args.method, stages=args.stages, extra_val=args.extra_val,
                       device=str(device), n_seeds=len(results), runs=results,
                       summary=summarize(results))
        if cli_overrides:
            payload["overrides"] = cli_overrides
        out.write_text(json.dumps(payload, indent=1))
        return payload

    try:
        tree = build_parity_tree(data_root, tree_params)
        done = {r["seed"] for r in results}
        for i in range(args.seeds):
            seed = args.first_seed + i
            if seed in done:
                continue
            print(f"[parity_study] seed {seed} ({i + 1}/{args.seeds}) ...", flush=True)
            r = run_pair(tree, data_root / "work", args.method, seed, extra_overrides, device)
            results.append(r)
            print(f"[parity_study] seed {seed}: CNN reference={r['cnn_reference']} "
                  f"port={r['cnn_port']} | NME reference={r['nme_reference']} "
                  f"port={r['nme_port']} ({r['wall_reference_s']:.2f}s reference, "
                  f"{r['wall_port_s']:.2f}s port, {device})", flush=True)
            dump()  # after each seed, so a killed run still leaves its evidence
    finally:
        if made_root:
            shutil.rmtree(data_root, ignore_errors=True)
    payload = dump()
    print(json.dumps(payload["summary"], indent=1))
    print(f"[parity_study] wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
