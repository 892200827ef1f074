#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

The main path is the ``base``-method CIL train step: TSM-ResNet-50, 8 frames
at 224x224, batch 16, bf16 compute, LSC head (nb_proxies=1) with LSCLoss, the
labeled 6-group SGD; from task 1 on, feature-KD against the previous model and
the global-norm clip at 1.0. It runs in the two configurations that reach the
hand-written kernels (the defaults reach none):

  A  shift_mode='pad' + conv1x1_mode='pallas_stats'  -> conv1x1_with_stats
  B  shift_mode='fused_block'                        -> fused_residual_relu_shift
                                                        forward and backward

Phases (any failure exits non-zero; no phase swallows an exception):
  1. build every kernel from bdvcil_torch/csrc (nvcc, sm_90a);
  2. kernels: each against its plain PyTorch version at every ResNet-50 shape
     of the path, forward and backward, with CUDA-event times of the kernel,
     the plain version and, where one exists, the library call;
  3. reference: one small train step per configuration on the card against
     the same step on the CPU, where the port runs the plain versions;
  4. train A and B at full width: 3 task-0 steps (26 classes), growth to 31,
     3 task-1 KD steps; launch counts, finite losses, moved parameters and
     updated running statistics; step times.

Output: the card's name and power limit, a ``{"kernels": [...]}`` line, and
as the last line ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. Without a CUDA device it prints no result
and exits 1.

    python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import torch

# published peaks of one H100 SXM (dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

NT = 128  # 16 clips x 8 frames
BATCH, SEGMENTS, SIZE = 16, 8, 224
KERNEL_CONFIGS = ("A", "B")  # bdvcil_torch.config_templates.SWITCHES
FWD, BWD, CONV = ("fused_residual_relu_shift_fwd", "fused_residual_relu_shift_bwd",
                  "conv1x1_with_stats")
KERNEL_META = {
    FWD: ("bdvcil_torch/csrc/tsm_shift.cu", "bdvcil_tpu/ops/tsm_shift.py:131"),
    BWD: ("bdvcil_torch/csrc/tsm_shift.cu", "bdvcil_tpu/ops/tsm_shift.py:140"),
    CONV: ("bdvcil_torch/csrc/conv1x1_stats.cu", "bdvcil_tpu/ops/conv1x1_bn.py:164"),
}


def r50_shapes():
    """Per train forward: the fused epilogue's (N*T, H, W, C) shapes and the
    1x1 GEMMs' (M, K, N) shapes of configuration A, each with its count."""
    fused, gemm = collections.Counter(), collections.Counter()
    inplanes, planes, size = 64, 64, SIZE // 4
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            gemm[(NT * size * size, inplanes, planes)] += 1  # conv1, input resolution
            size //= stride
            gemm[(NT * size * size, planes, 4 * planes)] += 1  # conv3
            fused[(NT, size, size, 4 * planes)] += 1
            inplanes = 4 * planes
        planes *= 2
    return fused, gemm


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x|, |x| floored at 1/256 of the tensor's rms (near zero
    the f32 accumulation order, not the rounding, sets the error)."""
    floor = max(float(x.float().pow(2).mean().sqrt()) / 256, 1e-30)
    return torch.exp2(torch.floor(torch.log2(torch.clamp(x.abs(), min=floor))) - 7)


def kernel_phase(dev, gen, fused_shapes, gemm_shapes, tsm, conv):
    """Each kernel against its plain version at every shape of the path."""
    rows = []
    bf16 = torch.bfloat16
    for shape, per_fwd in sorted(fused_shapes.items()):
        h, idt, g_out, g_sh = (torch.randn(shape, generator=gen, device=dev).to(bf16)
                               for _ in range(4))
        out, sh = tsm.fused_fwd(h, idt, SEGMENTS, 8)
        r_out, r_sh = tsm.fused_residual_relu_shift_plain(h, idt, SEGMENTS, 8)
        g_in = tsm.fused_bwd(out, g_out, g_sh, SEGMENTS, 8)
        r_g = tsm.fused_residual_relu_shift_bwd_plain(r_out, g_out, g_sh, SEGMENTS, 8)
        torch.cuda.synchronize()
        if not (torch.equal(out, r_out) and torch.equal(sh, r_sh) and torch.equal(g_in, r_g)):
            raise AssertionError(f"fused_residual_relu_shift differs from its plain version at "
                                 f"{shape}")
        nbytes = 4 * h.numel() * h.element_size()  # two tensors in, two out
        for name, fn, plain in (
            (FWD, lambda: tsm.fused_fwd(h, idt, SEGMENTS, 8),
             lambda: tsm.fused_residual_relu_shift_plain(h, idt, SEGMENTS, 8)),
            (BWD, lambda: tsm.fused_bwd(out, g_out, g_sh, SEGMENTS, 8),
             lambda: tsm.fused_residual_relu_shift_bwd_plain(out, g_out, g_sh, SEGMENTS, 8)),
        ):
            b_ms, b_by = bound_ms(nbytes, 0.0)
            rows.append(dict(kernel=name, shape=list(shape), per_step=per_fwd,
                             ms=cuda_ms(fn), plain_ms=cuda_ms(plain), library_ms=None,
                             bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
                             bytes=nbytes, flops=0))
        del h, idt, g_out, g_sh, out, sh, r_out, r_sh, g_in, r_g

    for (m, k, n), per_fwd in sorted(gemm_shapes.items()):
        x = torch.randn((m, 1, 1, k), generator=gen, device=dev).to(bf16)
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(bf16)
        y, s1, s2 = conv.conv1x1_with_stats_fwd(x, w)
        ry, rs1, rs2 = conv.conv1x1_with_stats_plain(x, w)
        torch.cuda.synchronize()
        err = (y.float() - ry.float()).abs()
        if not bool((err <= bf16_ulp(ry.float())).all()):
            raise AssertionError(f"conv1x1_with_stats y is off by more than one bf16 ulp at "
                                 f"{(m, k, n)}")
        for got, ref, what in ((s1, rs1, "s1"), (s2, rs2, "s2")):
            torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3 * float(ref.abs().max()),
                                       msg=lambda s: f"conv1x1_with_stats {what} {(m, k, n)}: {s}")
        x2 = x.reshape(m, k)

        def library():
            yl = torch.matmul(x2, w)
            yf = yl.float()
            return yf.sum(0), (yf * yf).sum(0)

        nbytes = 2 * (m * k + m * n + k * n) + 2 * 4 * n
        flops = 2 * m * k * n
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append(dict(kernel=CONV, shape=[m, k, n], per_step=per_fwd,
                         ms=cuda_ms(lambda: conv.conv1x1_with_stats_fwd(x, w)),
                         plain_ms=cuda_ms(lambda: conv.conv1x1_with_stats_plain(x, w)),
                         library_ms=cuda_ms(library), bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=float(err.max()), bytes=nbytes, flops=flops))
        # the autograd backward on the card against the JAX rule (_bwd4) in f32
        # on the kernel's own y: dy = bf16(gy + gs1 + 2 gs2 y), then dy @ w.T
        # and x.T @ dy. (Autograd through the plain version is no reference
        # here: it rounds gs1 + 2 gs2 y to bf16 before adding gy, which drops
        # the small gs2 term systematically over M rows.)
        gy = torch.randn((m, 1, 1, n), generator=gen, device=dev).to(bf16)
        gs1 = torch.randn((n,), generator=gen, device=dev)
        gs2 = torch.randn((n,), generator=gen, device=dev) * 1e-3
        xi, wi = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        yk, s1k, s2k = conv.conv1x1_with_stats(xi, wi)
        torch.autograd.backward([yk, s1k, s2k], [gy, gs1, gs2])
        dy = (gy.float() + gs1 + 2.0 * gs2 * yk.detach().float()).to(bf16).float().reshape(m, n)
        for got, ref, what in ((xi.grad, (dy @ w.float().t()).reshape(x.shape), "dx"),
                               (wi.grad, x2.float().t() @ dy, "dw")):
            torch.testing.assert_close(got.float(), ref, rtol=1e-2,
                                       atol=1e-2 * float(ref.abs().max()),
                                       msg=lambda s: f"conv1x1_with_stats {what} {(m, k, n)}: {s}")
        del x, w, y, ry, x2, gy, xi, wi, yk, dy

    return rows


def reference_phase(dev, seed):
    """One small train step per configuration on the card against the CPU."""
    from bdvcil_torch import config_templates as presets
    from bdvcil_torch import optim, runtime
    from bdvcil_torch.models import builder

    out = {}
    x = torch.randn((2, SEGMENTS, 64, 64, 3), generator=torch.Generator().manual_seed(seed))
    y = torch.tensor([1, 3])
    for name in KERNEL_CONFIGS:
        cfg = presets.hmdb51_r50_cfg(5, SEGMENTS, dropout_ratio=0.0, **presets.SWITCHES[name])
        losses = {}
        for where in ("cpu", dev):
            spec = builder.build_model(cfg, dtype=torch.bfloat16, device=where)
            model = builder.init_model_params(spec, seed)
            tx = optim.build_optimizer(model, presets.OPTIMIZER)
            state, m = runtime.make_train_step(spec, tx, 5)(
                runtime.TrainState.create(model, tx), None, x.to(where), y.to(where), {})
            losses[str(torch.device(where).type)] = float(m["loss"])
        rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        # bf16 activations through 50 layers, two conv libraries: a few % apart
        if not math.isfinite(losses["cuda"]) or rel > 3e-2:
            raise AssertionError(f"config {name}: card loss {losses['cuda']} vs CPU "
                                 f"{losses['cpu']} (rel {rel})")
        out[name] = dict(losses, rel_diff=rel)
        print(f"reference {name}: loss card {losses['cuda']} cpu {losses['cpu']} rel {rel}",
              flush=True)
    return out


def train_phase(name, dev, seed, smi):
    from bdvcil_torch import config_templates as presets
    from bdvcil_torch.models import build_model, init_model_params, update_fc
    from bdvcil_torch.ops import _build
    from bdvcil_torch.optim import build_optimizer
    from bdvcil_torch.runtime import TrainState, make_train_step

    backbone = presets.SWITCHES[name]
    nc0 = presets.HMDB51_BASE_CLASSES
    nc1 = nc0 + presets.HMDB51_CLASSES_PER_TASK
    spec = build_model(presets.hmdb51_r50_cfg(nc0, SEGMENTS, **backbone), dtype=torch.bfloat16,
                       device=dev)
    model = init_model_params(spec, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    imgs = torch.randn((BATCH, SEGMENTS, SIZE, SIZE, 3), generator=gen, device=dev)
    labels0 = torch.randint(0, nc0, (BATCH,), generator=gen, device=dev)
    labels1 = torch.randint(0, nc1, (BATCH,), generator=gen, device=dev)
    drop = torch.Generator(device=dev).manual_seed(seed + 1)
    watch = ["backbone.conv1.weight", "backbone.layer4.2.conv3.weight", "cls_head.eta"]
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}

    tx = build_optimizer(model, presets.OPTIMIZER, presets.LR_SCHEDULER, steps_per_epoch=100)
    state = TrainState.create(model, tx)
    step0 = make_train_step(spec, tx, nc0)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.LAUNCHES.clear()
    records = []

    def run(tag, step, prev, labels):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, prev, imgs, labels, {}, drop)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        rec = dict(task=tag, ms=dt, **{k: float(v) for k, v in m.items()})
        records.append(rec)
        if not all(math.isfinite(v) for v in rec.values() if isinstance(v, float)):
            raise AssertionError(f"config {name}: non-finite metrics {rec}")

    for _ in range(3):
        run("task0", step0, None, labels0)
    # task 1: the previous model is a copy before growth; both grow 26 -> 31
    prev = copy.deepcopy(state.module)
    grow = torch.Generator().manual_seed(seed + 2)
    update_fc(state.module, nc1, grow)
    update_fc(prev, nc1, grow)
    tx1 = build_optimizer(state.module, presets.OPTIMIZER, presets.LR_SCHEDULER,
                          steps_per_epoch=100, grad_clip=presets.GRAD_CLIP)
    state = TrainState.create(state.module, tx1)
    kd = presets.kd_config(nc1, nc1 - nc0)
    step1 = make_train_step(spec, tx1, nc1, task_idx=1,
                            prev_num_classes=nc0, kd_config=kd)
    for _ in range(3):
        run("task1", step1, prev, labels1)
    launches = dict(_build.LAUNCHES)

    if not all(r["kd_loss"] > 0 for r in records[3:]):
        raise AssertionError(f"config {name}: KD did not contribute at task 1")
    after = state.module.state_dict()
    for key in watch:
        if torch.equal(after[key][: before[key].shape[0]], before[key]):
            raise AssertionError(f"config {name}: {key} did not move")
    stats = [k for k in before if k.endswith("running_mean") or k.endswith("running_var")]
    unchanged = [k for k in stats if torch.equal(after[k], before[k])]
    if unchanged:
        raise AssertionError(f"config {name}: running stats not updated: {unchanged[:3]}")

    t0 = statistics.median(r["ms"] for r in records[1:3])
    t1 = statistics.median(r["ms"] for r in records[4:6])
    result = dict(
        config=name, backbone=backbone, launches=launches, steps=records,
        task0_step_ms=t0, task1_step_ms=t1,
        task0_clips_per_s=BATCH / (t0 / 1e3), task1_clips_per_s=BATCH / (t1 / 1e3),
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
    )
    print(f"train {name} {backbone}: task-0 step {t0:.2f} ms ({result['task0_clips_per_s']:.2f} "
          f"clips/s), task-1 KD step {t1:.2f} ms ({result['task1_clips_per_s']:.2f} clips/s), "
          f"peak {result['peak_mem_gib']:.1f} GiB, launches {launches} [{smi}]", flush=True)
    del state, prev, model
    torch.cuda.empty_cache()
    return result


def expected_launches(config: str, blocks: int = 16, gemms: int = 32):
    """Per config, over 3 task-0 and 3 task-1 steps."""
    if config == "A":  # conv1/conv3 of every bottleneck, train mode only
        return {CONV: gemms * 6}
    # every block's epilogue: the current model, plus the previous one at task 1
    return {FWD: blocks * 3 + 2 * blocks * 3, BWD: blocks * 6}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU only", file=sys.stderr)
        return 1
    from bdvcil_torch.ops import _build
    from bdvcil_torch.ops import conv1x1_bn as conv
    from bdvcil_torch.ops import tsm_shift as tsm

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s (nvcc, sm_90a, one process per source)", flush=True)

    fused_shapes, gemm_shapes = r50_shapes()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = kernel_phase(dev, gen, fused_shapes, gemm_shapes, tsm, conv)
    for r in rows:
        print(f"kernel {r['kernel']} {r['shape']} x{r['per_step']}/fwd: {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']}",
              flush=True)
    torch.cuda.empty_cache()

    reference = reference_phase(dev, args.seed)

    trains = {}
    for name in KERNEL_CONFIGS:
        trains[name] = train_phase(name, dev, args.seed, smi)
        want = expected_launches(name, sum(fused_shapes.values()), sum(gemm_shapes.values()))
        got = {k: v for k, v in trains[name]["launches"].items() if v}
        if got != want:
            raise AssertionError(f"config {name}: kernel launches {got}, expected {want}")

    launches = {**trains["A"]["launches"], **trains["B"]["launches"]}
    kernels = []
    for kname, (source, replaces) in KERNEL_META.items():
        mine = [r for r in rows if r["kernel"] == kname]
        per_step = lambda key: sum(r[key] * r["per_step"] for r in mine)  # noqa: E731
        t_bytes = sum(r["bytes"] * r["per_step"] for r in mine) / PEAK_HBM_BYTES * 1e3
        t_ops = sum(r["flops"] * r["per_step"] for r in mine) / PEAK_BF16_FLOPS * 1e3
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches[kname], max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=per_step("ms"), plain_ms=per_step("plain_ms"), bound_ms=per_step("bound_ms"),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None if mine[0]["library_ms"] is None else per_step("library_ms"),
        ))

    outdir = pathlib.Path("chiprun_out")
    outdir.mkdir(exist_ok=True)
    detail = dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build_s, kernel_rows=rows, reference=reference, train=trains,
                  kernels=kernels,
                  note="kernel ms/plain_ms/bound_ms/library_ms: per train step (task 0) at the "
                       "main path's shapes, summed over its launches; per-shape rows per launch")
    (outdir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
