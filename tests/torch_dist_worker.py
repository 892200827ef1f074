"""The port's multi-rank workloads, and the rank process that runs them.

``tests/test_torch_port_distributed.py`` starts this file as W processes
(``--rank r --world W --port P``), each joining one gloo process group on the
CPU, and runs the same functions in its own process with no group for the
one-process reference. A rank imports torch and the port only, never JAX.

Workloads (each returns plain tensors and floats):
  * ``train_steps``  ``tests/mp_worker.py``'s: R18, 2 frames at 32², 4
    classes, LSC, dropout 0.5, 20 samples at a global batch of 8 with a padded
    tail (its 4 pad rows all fall on the last rank), one epoch of steps from
    given weights; per-step global losses and the weights after
  * ``kd_steps``     a task-0 step, growth, and a task-1 step with
    exemplar-only feature-KD and the clip on the padded tail batch
  * ``inference``    ``run_inference`` over 10 samples at a global batch of 8,
                     and of 4 with K = 2 batches a dispatch
  * ``resume``       3 epochs of ``train_epochs`` straight, against 1 epoch, a
    snapshot (rank 0 writes, every rank reads) and 2 more; accumulation 2
  * ``train_cil``    a 2-task ``CILTrainer`` run on a rawframe corpus

    python tests/torch_dist_worker.py --rank R --world W --port P --inputs IN.pt --out OUT.pt
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tests.mp_worker import ArrDataset  # noqa: E402

T, NC, SEED = 2, 4, 11
OPT = dict(type="SGD", constructor="CILTSMOptimizerConstructorImprovised",
           paramwise_cfg=dict(fc_lr_scale_factor=5.0), lr=0.01, momentum=0.9, weight_decay=1e-4)


def model_cfg(depth=18, dropout=0.5, **backbone):
    in_channels = 512 if depth < 50 else 2048
    return dict(
        type="CILRecognizer2D",
        backbone=dict(type="ResNetTSM", depth=depth, num_segments=T, shift_div=8, **backbone),
        cls_head=dict(type="IncrementalTSMHead", num_classes=NC, in_channels=in_channels,
                      inc_head_config=dict(type="LocalSimilarityClassifier", out_features=NC,
                                           nb_proxies=1),
                      num_segments=T, loss_cls=dict(type="LSCLoss"), dropout_ratio=dropout),
        test_cfg=dict(average_clips="prob"),
    )


def train_loader(n=20, batch=8, seed=7):
    from bdvcil_torch.data.host_loader import DataLoader

    return DataLoader(ArrDataset(n, t=T, nc=NC), batch_size=batch, shuffle=True, seed=seed,
                      num_workers=2, drop_last=False, pad_to_batch=True)


@contextlib.contextmanager
def float64_casts(dtype):
    """With ``dtype`` float64, the port's ``.float()`` casts (BatchNorm
    statistics, losses, the head) leave float64 tensors as they are, so a
    float64 model computes in float64 throughout."""
    if dtype != torch.float64:
        yield
        return
    cast32 = torch.Tensor.float
    torch.Tensor.float = lambda x, *a, **k: x if x.dtype == torch.float64 else cast32(x, *a, **k)
    try:
        yield
    finally:
        torch.Tensor.float = cast32


def _model(cfg, state_dict, dtype=torch.float32):
    from bdvcil_torch.models import build_model

    spec = build_model(cfg, dtype=dtype, device="cpu")
    model = spec.module()
    model.load_state_dict(state_dict)
    return spec, model.to(dtype)


def _tensors(batch, dtype=torch.float32):
    imgs = torch.from_numpy(np.asarray(batch["imgs"])).to(dtype)
    labels = torch.from_numpy(np.asarray(batch["label"]))
    extra = {"sample_weight": torch.from_numpy(np.asarray(batch["sample_weight"]))}
    return imgs, labels, extra


def train_steps(cfg, state_dict, n=20, batch=8, max_steps=None, dtype=torch.float32):
    """One epoch of the train step from ``state_dict`` (in ``dtype``); returns
    the global loss of each step, the weights (and running statistics) after,
    and each step's local sample weights."""
    with float64_casts(dtype):
        return _train_steps(cfg, state_dict, n, batch, max_steps, dtype)


def _train_steps(cfg, state_dict, n, batch, max_steps, dtype):
    from bdvcil_torch.optim import build_optimizer
    from bdvcil_torch.runtime import TrainState, make_train_step
    from bdvcil_torch.runtime.loops import step_generator

    spec, model = _model(cfg, state_dict, dtype)
    tx = build_optimizer(model, OPT)
    state = TrainState.create(model, tx)
    step = make_train_step(spec, tx, num_classes=NC)
    loader = train_loader(n, batch)
    loader.set_epoch(0)
    losses, weights = [], []
    for s, b in enumerate(loader):
        if max_steps is not None and s == max_steps:
            break
        imgs, labels, extra = _tensors(b, dtype)
        state, metrics = step(state, None, imgs, labels, extra, step_generator(SEED, s, "cpu"))
        losses.append(float(metrics["loss"]))
        weights.append(extra["sample_weight"].clone())
    return {"losses": losses, "state": copy.deepcopy(model.state_dict()),
            "sample_weights": weights}


def kd_steps(cfg, state_dict, dtype=torch.float32):
    """A task-0 step on the first global batch, growth 4 -> 6 classes (the
    new rows from a seeded CPU generator), then a task-1 step with
    exemplar-only feature-KD against the previous model, the global-norm
    clip at 1.0, on the padded tail batch relabelled 2..5 (classes 2 and 3
    are the exemplars)."""
    with float64_casts(dtype):
        return _kd_steps(cfg, state_dict, dtype)


def _kd_steps(cfg, state_dict, dtype):
    from bdvcil_torch.models import KD_TAPS, update_fc
    from bdvcil_torch.optim import build_optimizer
    from bdvcil_torch.runtime import TrainState, make_train_step
    from bdvcil_torch.runtime.loops import step_generator

    spec, model = _model(cfg, state_dict, dtype)
    tx = build_optimizer(model, OPT)
    loader = train_loader()
    loader.set_epoch(0)
    batches = list(loader)
    imgs, labels, extra = _tensors(batches[0], dtype)
    state, m0 = make_train_step(spec, tx, num_classes=NC)(
        TrainState.create(model, tx), None, imgs, labels, extra, step_generator(SEED, 0, "cpu"))
    prev = copy.deepcopy(model)
    update_fc(model, NC + 2, torch.Generator().manual_seed(5))
    update_fc(prev, NC + 2, torch.Generator().manual_seed(6))
    tx1 = build_optimizer(model, OPT, grad_clip=1.0)
    kd = dict(module_names=list(KD_TAPS), module_weights=[3.0, 3.0, 3.0, 3.0, 0.1],
              scale_factor=1.5, exemplar_only=True)
    step1 = make_train_step(spec, tx1, NC + 2, task_idx=1, prev_num_classes=NC, kd_config=kd)
    imgs, labels, extra = _tensors(batches[2], dtype)
    state, m1 = step1(TrainState.create(model, tx1), prev, imgs, labels + 2, extra,
                      step_generator(SEED, 1, "cpu"))
    return {"losses": [float(m0["loss"]), float(m1["loss"]), float(m1["kd_loss"])],
            "state": copy.deepcopy(model.state_dict())}


def inference(cfg, state_dict, batch=8, k=1):
    """``run_inference`` over 10 samples at a global batch of ``batch``, ``k``
    batches a dispatch."""
    from bdvcil_torch.data.host_loader import DataLoader
    from bdvcil_torch.runtime import make_eval_step, make_multi_eval_step
    from bdvcil_torch.runtime.loops import run_inference

    spec, model = _model(cfg, state_dict)
    loader = DataLoader(ArrDataset(10, t=T, nc=NC), batch_size=batch, shuffle=False,
                        num_workers=2)
    out = run_inference(make_eval_step(spec, NC), model, loader, device="cpu",
                        extract_repr=True, pad_batch_to=batch, steps_per_dispatch=k,
                        multi_eval_step=make_multi_eval_step(spec, NC, k) if k > 1 else None)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


def resume(cfg, state_dict, snap_dir):
    """3 epochs straight, and 1 epoch + snapshot + a fresh state restored from
    it + 2 epochs; both with gradient accumulation 2 (the snapshot falls
    inside a window)."""
    from bdvcil_torch.optim import build_optimizer
    from bdvcil_torch.parallel import distributed
    from bdvcil_torch.runtime import TrainState, make_train_step
    from bdvcil_torch.runtime import checkpoint as ckpt
    from bdvcil_torch.runtime.loops import train_epochs

    def fresh(weights):
        spec, model = _model(cfg, weights)
        tx = build_optimizer(model, OPT, dict(type="MultiStepLR", params=dict(milestones=[2])),
                             steps_per_epoch=2, accumulate_steps=2)
        return spec, tx, TrainState.create(model, tx)

    def run(spec, tx, state, epochs, start_epoch=0, hook=None):
        step = make_train_step(spec, tx, num_classes=NC)
        return train_epochs(step, state, None, train_loader(12, 4), epochs, SEED, device="cpu",
                            start_epoch=start_epoch, snapshot_hook=hook,
                            log_every_n_steps=100)[0]

    straight = run(*fresh(state_dict), 3)
    path = os.path.join(snap_dir, "mid_task_snapshot_inc_step.pt")

    def hook(epoch, st, seed):
        if distributed.is_primary():
            ckpt.save_train_snapshot(path, st, seed, dict(task=0, phase="inc_step", epoch=epoch,
                                                           num_classes=NC, run_token="t"))
        distributed.sync_processes("snapshot")

    run(*fresh(state_dict), 1, hook=hook)
    other = {k: v + 1 if v.is_floating_point() else v for k, v in state_dict.items()}
    spec, tx, target = fresh(other)  # other weights: the load must set them all
    restored, seed, meta = ckpt.load_train_snapshot(path, target)
    resumed = run(spec, tx, restored, 3, start_epoch=meta["epoch"] + 1)
    return {"straight": copy.deepcopy(straight.module.state_dict()),
            "resumed": copy.deepcopy(resumed.module.state_dict()),
            "steps": (straight.step, resumed.step)}


def train_cil(cfg_dict):
    """A ``CILTrainer`` run; its accuracy matrices and last checkpoint."""
    from bdvcil_torch.cil import CILTrainer
    from bdvcil_torch.config import Config
    from bdvcil_torch.runtime.checkpoint import load_checkpoint

    trainer = CILTrainer(Config.fromdict(copy.deepcopy(cfg_dict)), device="cpu")
    trainer.train()
    last = trainer._ckpt_path(trainer.num_tasks - 1)
    return {"cnn": trainer.cnn_matrix, "nme": trainer.nme_matrix,
            "ckpt": load_checkpoint(last)[0]}


def run_all(inputs):
    """Every workload of ``inputs`` (see ``tests/test_torch_port_distributed.py``)."""
    out = {
        "mp_train": train_steps(model_cfg(), inputs["r18"]),
        "mp_f64": train_steps(model_cfg(), inputs["r18"], dtype=torch.float64),
        "kd": kd_steps(model_cfg(), inputs["r18"]),
        "kd_f64": kd_steps(model_cfg(), inputs["r18"], dtype=torch.float64),
        "mp_infer": inference(model_cfg(), inputs["r18"]),
        # 3 batches of 4 (the last padded), K = 2: one 2-batch dispatch, one single
        "mp_infer_k2": inference(model_cfg(), inputs["r18"], batch=4, k=2),
        "per_device": train_steps(model_cfg(bn_groups="per_device"), inputs["r18"], max_steps=2),
        # one group of ghost statistics over the ranks: 10 prefix rows of 16,
        # 8 on rank 0 and 2 on rank 1
        "ghost_f64": train_steps(model_cfg(bn_stats_rows=10), inputs["r18"], max_steps=1,
                                 dtype=torch.float64),
        "config_a": train_steps(model_cfg(50, 0.0, conv1x1_mode="pallas_stats"), inputs["r50"],
                                n=8, batch=4, max_steps=1),
        "config_a_f64": train_steps(model_cfg(50, 0.0, conv1x1_mode="pallas_stats"),
                                    inputs["r50"], n=8, batch=4, dtype=torch.float64),
        "resume": resume(model_cfg(), inputs["r18"], inputs["snap_dir"]),
    }
    if "cil" in inputs:
        out["train_cil"] = train_cil(inputs["cil"])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)

    from bdvcil_torch.parallel import distributed

    distributed.initialize(backend="gloo", device="cpu",
                           init_method=f"tcp://127.0.0.1:{args.port}", world_size=args.world,
                           rank=args.rank, timeout_s=100)
    try:
        out = run_all(torch.load(args.inputs, weights_only=False))
        out["rank"] = distributed.process_index()
        torch.save(out, args.out)
    finally:
        distributed.shutdown()
    assert not any(m.split(".")[0] in ("jax", "flax", "bdvcil_tpu") for m in sys.modules)


if __name__ == "__main__":
    main()
