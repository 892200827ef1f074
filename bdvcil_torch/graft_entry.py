"""The driver's entry points in the port's terms (the counterpart of
``__graft_entry__.py``).

``entry(device=None)``  the eval forward of the flagship model (TSM-R50, 8
    segments at 224², LSC head, bf16) and its example arguments.
``dryrun_multichip(n, device=None, ...)``  one data-parallel step of each part
    of the JAX dry run over ``n`` ranks, each rank holding one row of the
    ``n``-row global batch (as each JAX device does), at its tiny shapes
    (TSM-R18, 2 segments at 16², 5 classes, dropout 0.5, the labeled SGD with
    ``fc_lr_scale_factor=5.0``, the clip at 1.0, milestones [20, 30]):

      a  the base step with feature-KD at task 1 (3 previous classes)
      b  the K = 2 ``make_multi_train_step``
      c  the eval step on the ``yuv420_full`` wire: cls_score (n, 10, 5)
      d  ``make_fast_input_fn`` (RandAugment on) on the wire that
         ``resolve_wire_format("auto", 16)`` gives
      e  the ``planes`` wire, where the port's decoder has planes and yuv420
      f  ``make_fast_acm_input_fn`` on the wire of (d)
      g  ActorCutMix on ``planes``, as (e)

Each function runs on the card unless the caller names another device; with
no CUDA device and no ``device`` it raises. ``dryrun_multichip`` starts its
``n`` rank processes itself (``python -m bdvcil_torch.graft_entry --rank r``):
gloo ranks on the CPU; on the card one NCCL rank a card, a one-rank NCCL group
for ``n == 1``, and gloo ranks sharing the one card when there are fewer cards
than ranks (NCCL refuses two ranks on one device). Rank 0 prints one line a
part, in the JAX dry run's words, and the function returns every part's
metrics (losses, the eval scores, the input functions' outputs over the whole
batch).

What a test fixes: the initial weights (``weights``, a state dict, e.g. from
``models/convert.from_jax_variables``), the dropout masks (drawn on the CPU
from ``seed``, so a card run drops what a CPU run drops; ``dropout_masks``
gives them) and the RandAugment draws (``randaug_draws``, else drawn from
``seed``).

Not carried: the JAX dry run's hybrid ``('dcn', 'data')`` part
(``__graft_entry__.py:365-379``). That mesh is a topology hint to XLA's SPMD
partitioner; NCCL picks its own rings and trees (ROADMAP, "Deliberately not
carried").

    python -m bdvcil_torch.graft_entry [--n 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from ._device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the dry run's shapes (__graft_entry__.py:59-363)
T, SIZE, NC, PREV_NC, K = 2, 16, 5, 3, 2
FEATURES = 512  # TSM-R18's pooled features: the dropout mask's width
OPT = dict(type="SGD", constructor="CILTSMOptimizerConstructorImprovised",
           paramwise_cfg=dict(fc_lr_scale_factor=5.0), lr=0.01, momentum=0.9, weight_decay=1e-4)
LR = dict(type="MultiStepLR", params=dict(milestones=[20, 30], gamma=0.1))
KD = dict(module_names=["backbone.layer1", "backbone.layer4", "cls_head.avg_pool"],
          module_weights=[0.01, 0.01, 0.01], scale_factor=3.3, exemplar_only=False)
# the train steps of each part, in order: each draws its dropout mask from its
# own CPU generator, runtime.loops.step_generator(seed, step)
DROPOUT_STEPS = {"a": (0,), "b": (1, 2), "d": (3,), "e": (4,), "f": (5,), "g": (6,)}
RANK_TIMEOUT_S = 600


def _model_cfg(num_classes: int, depth: int, num_segments: int):
    return dict(
        type="CILRecognizer2D",
        backbone=dict(
            type="ResNetTSM", depth=depth, num_segments=num_segments, shift_div=8, norm_eval=False
        ),
        cls_head=dict(
            type="IncrementalTSMHead",
            num_classes=num_classes,
            in_channels=512 * (4 if depth >= 50 else 1),
            inc_head_config=dict(
                type="LocalSimilarityClassifier", out_features=num_classes, nb_proxies=1
            ),
            num_segments=num_segments,
            loss_cls=dict(type="LSCLoss"),
            dropout_ratio=0.5,
        ),
        test_cfg=dict(average_clips="prob"),
    )


def entry(device: Optional[Union[str, torch.device]] = None):
    """The eval forward of the flagship model: TSM-R50, 8 segments, 224x224,
    51 classes, LSC head, bf16 compute, weights from generator 0.

    Returns ``(fn, (model, imgs))``: ``fn(model, imgs)`` is the eval forward
    and returns ``cls_score`` (8, 1, 51); ``imgs`` are ones (8, 8, 224, 224,
    3) f32 on the device, in the JAX layout."""
    from .models import build_model, init_model_params

    dev = resolve_device(device)
    num_segments = 8
    spec = build_model(_model_cfg(num_classes=51, depth=50, num_segments=num_segments),
                       dtype=torch.bfloat16, device=dev)
    model = init_model_params(spec, torch.Generator().manual_seed(0))

    def fn(model, imgs):
        with torch.no_grad():
            return model(imgs, train=False)["cls_score"]

    imgs = torch.ones((8, num_segments, 224, 224, 3), dtype=torch.float32, device=dev)
    return fn, (model, imgs)


# -- the rank side --------------------------------------------------------------


def dropout_masks(n_devices: int, seed: int = 0) -> Dict[str, List[np.ndarray]]:
    """The keep masks each part's train steps draw over the global batch,
    {part: [(n * T, 512) bool a step]}: ``models/heads.dropout`` at rate 0.5
    on the CPU generator of the step."""
    from .runtime.loops import step_generator

    return {part: [(torch.rand((n_devices * T, FEATURES),
                               generator=step_generator(seed, s, "cpu")) < 0.5).numpy()
                   for s in steps]
            for part, steps in DROPOUT_STEPS.items()}


def _full(shape, value, dtype=np.uint8):
    return np.full(shape, value, dtype)


def _boxes(n, box):
    return np.tile(np.array(box, np.float32), (n, T, 1, 1))


def _part_batches(n: int, wire: str, draws: Mapping[str, np.ndarray]):
    """The global batches of parts (d)-(g), the JAX dry run's pixels and masks,
    with the RandAugment draws in place of its ``randaug_key``."""
    from .data.device_pipeline import identity_plane_taps, plane_resize_taps

    masks = dict(flip=np.zeros(n, bool), label=np.zeros((n, 1), np.int64), **draws)
    if wire == "yuv420":
        pix = dict(imgs_y=_full((n, T, 16, 16), 128), imgs_c=_full((n, T, 8, 8, 2), 128),
                   bg_y=_full((n, 16, 16), 64), bg_c=_full((n, 8, 8, 2), 128))
        apix = dict(imgs_y=_full((n, T, 16, 16), 128), imgs_c=_full((n, T, 8, 8, 2), 128),
                    scene_y=_full((n, T, 16, 16), 64), scene_c=_full((n, T, 8, 8, 2), 128))
    else:
        pix = dict(imgs_u8=_full((n, T, 16, 16, 3), 128), bg_u8=_full((n, 16, 16, 3), 64))
        apix = dict(imgs_u8=_full((n, T, 16, 16, 3), 128),
                    scene_u8=_full((n, T, 16, 16, 3), 64))
    d = dict(pix, apply_bgmix=np.zeros(n, bool), apply_randaug=np.ones(n, bool), **masks)
    taps = np.tile(plane_resize_taps(32, 24, 40, 30, 4, 2, 16), (n, 1, 1))
    ctaps = np.tile(plane_resize_taps(16, 12, 20, 15, 2, 1, 8), (n, 1, 1))
    e = dict(imgs_y=_full((n, T, 24, 32), 128), imgs_c=_full((n, T, 12, 16, 2), 128),
             bg_y=_full((n, 24, 32), 64), bg_c=_full((n, 12, 16, 2), 128),
             imgs_taps_y=taps, imgs_taps_c=ctaps, bg_taps_y=taps, bg_taps_c=ctaps,
             apply_bgmix=np.ones(n, bool), apply_randaug=np.zeros(n, bool), **masks)
    acm = dict(actor_boxes=_boxes(n, [2.0, 2.0, 10.0, 12.0]),
               scene_boxes=_boxes(n, [1.0, 1.0, 8.0, 8.0]),
               actor_full_mask=np.zeros(n, bool), apply_acm=np.ones(n, bool),
               apply_randaug=np.zeros(n, bool), actor_flip=np.zeros(n, bool),
               scene_flip=np.zeros(n, bool), label=masks["label"], **draws)
    f = dict(apix, **acm)
    ty = np.tile(identity_plane_taps(16)[None], (n, 1, 1))
    tc = np.tile(identity_plane_taps(8)[None], (n, 1, 1))
    g = dict(imgs_y=_full((n, T, 32, 32), 128), imgs_c=_full((n, T, 16, 16, 2), 128),
             scene_y=_full((n, T, 32, 32), 64), scene_c=_full((n, T, 16, 16, 2), 128),
             imgs_taps_y=ty, imgs_taps_c=tc, scene_taps_y=ty, scene_taps_c=tc, **acm)
    return dict(d=d, e=e, f=f, g=g)


def _run_parts(inputs: Mapping, dev: torch.device) -> Dict:
    """Every part on this rank's row of each global batch; the global metrics
    (and rank 0's lines)."""
    from .data.device_pipeline import (batch_to_device, make_fast_acm_input_fn,
                                       make_fast_input_fn)
    from .models import build_model, init_model_params
    from .ops import _build
    from .optim import build_optimizer
    from .parallel import distributed, mesh
    from .runtime import TrainState, make_eval_step, make_multi_train_step, make_train_step
    from .runtime.loops import step_generator

    n, wire, seed = inputs["n"], inputs["wire"], inputs["seed"]
    # the dry run's f32; a float64 witness computes in float64 (with the
    # port's ``.float()`` casts made no-ops by its caller) on float64 weights
    dtype = inputs.get("dtype", torch.float32)
    param_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    lo, hi = mesh.local_rows(n)
    spec = build_model(_model_cfg(num_classes=NC, depth=18, num_segments=T), dtype=dtype,
                       device=dev)
    weights = inputs["weights"]
    if weights is None:
        weights = init_model_params(spec, torch.Generator().manual_seed(0)).state_dict()
    weights = {k: torch.as_tensor(v).cpu() for k, v in weights.items()}

    def fresh():
        model = spec.module()
        model.load_state_dict(weights)
        return model.to(param_dtype)

    def gens(part):
        return [step_generator(seed, s, "cpu") for s in DROPOUT_STEPS[part]]

    def rows(a, axis=0):
        return torch.from_numpy(np.ascontiguousarray(a[(slice(None),) * axis + (slice(lo, hi),)]))

    def state_of(model):
        tx = build_optimizer(model, OPT, LR, steps_per_epoch=4, grad_clip=1.0,
                             accumulate_steps=1)
        return tx, TrainState.create(model, tx)

    out: Dict = dict(n=n, wire=wire, planes=inputs["planes"], device=str(dev),
                     backend=distributed.backend(), lines=[])
    say = out["lines"].append

    # (a) the base step with feature-KD at task 1
    model, prev = fresh(), fresh()
    tx, state = state_of(model)
    step = make_train_step(spec, tx, num_classes=NC, method="base", task_idx=1,
                           prev_num_classes=PREV_NC, kd_config=KD)
    imgs = np.ones((n, T, SIZE, SIZE, 3), np.float32)
    labels = np.zeros((n, 1), np.int64)
    _, m = step(state, prev, rows(imgs).to(dev), rows(labels).to(dev), {}, gens("a")[0])
    out["a"] = dict(loss=float(m["loss"]), kd_loss=float(m["kd_loss"]))
    say(f"dryrun_multichip({n}) ok: loss={out['a']['loss']:.4f} kd={out['a']['kd_loss']:.4f}")

    # (b) K = 2 steps a call, the K axis leading and the batch axis second
    model = fresh()
    tx, state = state_of(model)
    mstep = make_multi_train_step(dict(spec=spec, tx=tx, num_classes=NC, method="base",
                                       task_idx=1, prev_num_classes=PREV_NC, kd_config=KD), K)
    kimgs = np.ones((K, n, T, SIZE, SIZE, 3), np.float32)
    klabels = np.zeros((K, n, 1), np.int64)
    _, m = mstep(state, prev, rows(kimgs, 1).to(dev), rows(klabels, 1).to(dev), {}, gens("b"))
    out["b"] = dict(loss=float(m["loss"]))
    say(f"dryrun_multichip K-dispatch (K={K}) ok: loss={out['b']['loss']:.4f}")

    # (c) the full-frame yuv420 eval wire: 5 crops x 2 flips a video
    ebatch = dict(imgs_y=_full((n, T, 32, 32), 128), imgs_c=_full((n, T, 16, 16, 2), 128),
                  crop_yx_16=np.zeros((n, 5, 2), np.int32))
    eout = make_eval_step(spec, NC)(fresh(), {k: rows(v).to(dev) for k, v in ebatch.items()})
    scores = mesh.all_gather_rows(eout["cls_score"])
    if tuple(scores.shape) != (n, 10, NC):
        raise AssertionError(f"eval cls_score {tuple(scores.shape)}, expected {(n, 10, NC)}")
    out["c"] = dict(cls_score=scores.float().cpu().numpy())
    say(f"dryrun_multichip eval yuv-full wire ok: {tuple(scores.shape)}")

    # (d)-(g) the fast input functions inside the step
    batches = _part_batches(n, wire, inputs["draws"])
    fns = dict(d=(wire, make_fast_input_fn(alpha=0.5, with_randaug=True, wire_format=wire)),
               e=("planes", make_fast_input_fn(alpha=0.5, with_randaug=True,
                                               wire_format="planes")),
               f=(wire, make_fast_acm_input_fn(wire_format=wire)),
               g=("planes", make_fast_acm_input_fn(wire_format="planes")))
    for part, (part_wire, input_fn) in fns.items():
        if part_wire == "planes" and not inputs["planes"]:
            out[part] = None
            continue
        local = {k: rows(v) for k, v in batches[part].items()}
        label = local.pop("label").to(dev)
        batch = batch_to_device(local, dev)
        with torch.no_grad():
            clips = mesh.all_gather_rows(input_fn(batch))
        model = fresh()
        tx, state = state_of(model)
        fstep = make_train_step(spec, tx, num_classes=NC, method="base", task_idx=0,
                                input_fn=input_fn)
        _, m = fstep(state, None, batch, label, {}, gens(part)[0])
        out[part] = dict(loss=float(m["loss"]), input=clips.float().cpu().numpy())
        what = "fast-input" if part in "de" else "fast-acm"
        say(f"dryrun_multichip {what} ({part_wire}) ok: loss={out[part]['loss']:.4f}")
    # the hand-written kernels launched (at the default modes train-mode
    # BatchNorm's alone, on a card): rank 0's by kernel, and every rank's count
    out["launches"] = {k: v for k, v in _build.LAUNCHES.items() if v}
    out["rank_launches"] = np.atleast_1d(
        distributed.all_gather_host(sum(_build.LAUNCHES.values()))).tolist()
    return out


def _rank_main(args) -> int:
    from .parallel import distributed

    inputs = torch.load(args.inputs, weights_only=False)
    dev = torch.device(inputs["devices"][args.rank])
    if dev.type == "cpu":
        torch.set_num_threads(1)  # n ranks share the host's cores
    else:
        # f32 as the CPU computes it: no TF32 in cuDNN's convolutions
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = distributed.initialize(backend=inputs["backend"], device=dev,
                                 init_method=f"tcp://127.0.0.1:{args.port}",
                                 world_size=args.world, rank=args.rank, timeout_s=RANK_TIMEOUT_S)
    try:
        out = _run_parts(inputs, dev)
        if distributed.is_primary():
            for line in out["lines"]:
                print(line, flush=True)
            torch.save(out, args.out)
        distributed.sync_processes("dryrun done")
    finally:
        distributed.shutdown()
    return 0


# -- the caller's side ----------------------------------------------------------


def _rank_layout(n_devices: int, dev: torch.device):
    """(backend, the device of each rank): gloo on the CPU; on the card one
    NCCL rank a card, or gloo ranks sharing ``dev`` when the machine has
    fewer cards than ranks."""
    if dev.type != "cuda":
        return "gloo", [str(dev)] * n_devices
    if n_devices == 1:
        return "nccl", [str(dev)]
    if torch.cuda.device_count() >= n_devices:
        return "nccl", [f"cuda:{r}" for r in range(n_devices)]
    return "gloo", [str(dev)] * n_devices


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device: Optional[Union[str, torch.device]] = None,
                     weights: Optional[Mapping] = None,
                     randaug_draws: Optional[Mapping[str, np.ndarray]] = None, seed: int = 0,
                     echo: bool = True) -> Dict:
    """One data-parallel step of each part (see the module docstring) over
    ``n_devices`` rank processes; returns rank 0's metrics:

        {'a': {'loss', 'kd_loss'}, 'b': {'loss'}, 'c': {'cls_score' (n, 10, 5)},
         'd'..'g': {'loss', 'input' (the input function's output, n rows)} or
         None for a planes part without the planes wire,
         'wire', 'planes', 'device', 'backend', 'n', 'lines', 'launches',
         'rank_launches'}

    ``weights``: the initial state dict (default: generator 0);
    ``randaug_draws``: the draws of the n clips (default: from ``seed``); the
    dropout masks come from ``seed`` (``dropout_masks``). Rank 0's lines are
    printed here too unless ``echo`` is False (they are in 'lines' either
    way). On the card the ranks compute f32 without TF32."""
    from .data import native
    from .data.loaders import resolve_wire_format
    from .ops.rand_augment_dev import draw_randaug

    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    dev = resolve_device(device)
    backend, devices = _rank_layout(n_devices, dev)
    # the decoder decides the wires once, here, and the ranks never build it
    wire = resolve_wire_format("auto", SIZE)
    planes = bool(native.has_fetch_planes() and native.has_yuv420())
    if randaug_draws is None:  # 2 ops a clip
        randaug_draws = {k: v.numpy() for k, v in draw_randaug(
            torch.Generator().manual_seed(seed), n_devices, 2, SIZE, SIZE).items()}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory(prefix="graft_dryrun_") as tmp:
        tmp = pathlib.Path(tmp)
        torch.save(dict(n=n_devices, wire=wire, planes=planes, seed=seed, backend=backend,
                        devices=devices, draws=dict(randaug_draws),
                        weights=None if weights is None else dict(weights)),
                   tmp / "inputs.pt")
        port = _free_port()
        logs = [open(tmp / f"rank{r}.log", "w+") for r in range(n_devices)]
        procs = []
        try:
            t0 = time.monotonic()
            procs = [subprocess.Popen(
                [sys.executable, "-m", "bdvcil_torch.graft_entry", "--rank", str(r), "--world",
                 str(n_devices), "--port", str(port), "--inputs", str(tmp / "inputs.pt"),
                 "--out", str(tmp / "out.pt")], cwd=ROOT, env=env, stdout=logs[r],
                stderr=subprocess.STDOUT) for r in range(n_devices)]
            codes = []
            for p in procs:
                try:
                    codes.append(p.wait(
                        timeout=max(1.0, RANK_TIMEOUT_S - (time.monotonic() - t0))))
                except subprocess.TimeoutExpired:
                    codes.append("timeout")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        tails = []
        for f in logs:
            f.seek(0)
            tails.append(f.read()[-3000:])
            f.close()
        if codes != [0] * n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank exit codes {codes}\n"
                               + "\n".join(f"--- rank {r} ---\n{t}" for r, t in enumerate(tails)))
        out = torch.load(tmp / "out.pt", weights_only=False)
    if echo:
        for line in out["lines"]:
            print(line, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8, help="ranks (the JAX dry run's 8 devices)")
    ap.add_argument("--device", default=None,
                    help="the ranks' device (default: the card; 'cpu' to run there)")
    ap.add_argument("--seed", type=int, default=0)
    # a rank process: dryrun_multichip starts this module with these
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    dryrun_multichip(args.n, device=args.device, seed=args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
