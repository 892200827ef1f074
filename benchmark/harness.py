"""One run of one cell: set-up, the measured window, the trace, the check.

The system under test is ``bdvcil_torch`` as ``cil_tools/train_cil`` runs
it for task 0: ``CILTrainer`` built from ``make_cil_config`` on a rawframe
corpus the benchmark writes (``corpus.py``), its fast loader
(``FastBGMixLoader`` and the device input function), its optimizer and its
train step, driven by ``runtime.loops.train_epochs``. The benchmark passes
its own meter, wraps the step in host-clock spans and the loader in a stream
it can end, and edits nothing of the program.

A run:

  1. set-up: the corpus (written once a checkout), the trainer, the
     weights (made on the device from the seed by the configuration's
     family, ``families/<family>.py``, and loaded into the trainer's
     model), the loader, the step; then the first
     ``warmup_steps`` steps of the one ``train_epochs`` call. The first
     ``followed_steps`` of them are recorded for the check: their batches,
     their dropout seeds, their losses, the gradient norms the first update
     took and the parameters' change after them;
  2. the window: from a synchronize after the warm-up until the first step
     boundary ``--seconds`` later; the loader's stream then ends, the steps
     already fed finish, and a synchronize closes the window. Every clip of
     every step in it counts;
  3. with ``--trace 1`` a slice of the window (``trace_steps`` steps past its
     middle) runs under ``torch.profiler``; the per-layer readers take their
     numbers from the window's spans and counters and from that trace;
  4. the check, once the peak memory is read and the program's state freed:
     the family's plain reference (``reference/``) runs the followed steps
     again in float32 from the same weights and batches, and the family's
     numbers are held to the cell's limits (``compare.verdict``).
"""

from __future__ import annotations

import gc
import math
import os
import pathlib
import shutil
import sys
import tempfile
import threading
import time
from types import ModuleType
from typing import Callable, Dict, List, Mapping, Optional

import torch

from . import compare, corpus, manifest, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "bdvcil_tpu")
CORPUS_ROOT = manifest.HERE / ".corpus"


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that no run may load, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- the configuration -------------------------------------------------------


def trainer_config(cfg: Mapping, family: ModuleType, seed: int, data_dir: str,
                   work_dir: str) -> Dict:
    """The trainer's config: ``make_cil_config`` of the configuration's
    dataset preset, with the configuration's switches and sizes set on it
    (the model's by its family). For the committed configurations the sizes
    are the preset's own."""
    from bdvcil_torch.config_templates import make_cil_config

    c = make_cil_config(cfg["dataset"], cfg["split_seed"], cfg["num_stages"], cfg["variant"],
                        data_dir=data_dir, work_dir=work_dir)
    c["seed"] = int(seed)
    c["compute_dtype"] = cfg["compute_dtype"]
    c["use_fast_input_pipeline"] = True
    c["fast_input_workers"] = cfg["workers_per_gpu"]
    c["workers_per_gpu"] = cfg["workers_per_gpu"]
    c["steps_per_dispatch"] = cfg["steps_per_dispatch"]
    c["videos_per_gpu"] = cfg["videos_per_gpu"]
    c["accumulate_grad_batches"] = cfg["accumulate_grad_batches"]
    family.model_config(cfg, c["model"])
    for key in ("train", "val", "test", "features_extraction", "exemplar"):
        for op in c["data"][key].get("pipeline", []):
            if op["type"] == "SampleFrames":
                op["num_clips"] = cfg["num_segments"]
            elif op["type"] == "MultiScaleCrop":
                op["input_size"] = cfg["crop_size"]
            elif op["type"] == "Resize" and op.get("keep_ratio", True):
                op["scale"] = (-1, cfg["short_side"])
            elif op["type"] == "Resize":
                op["scale"] = (cfg["crop_size"], cfg["crop_size"])
            elif op["type"] in ("CenterCrop", "TenCrop"):
                op["crop_size"] = min(op["crop_size"], cfg["short_side"])
    for opt in ("optimizer", "cbf_optimizer"):
        c[opt].update(lr=cfg["lr"], momentum=cfg["momentum"], weight_decay=cfg["weight_decay"])
        c[opt]["paramwise_cfg"]["fc_lr_scale_factor"] = cfg["fc_lr_scale_factor"]
    return c


# -- the loader's stream, which the benchmark can end -----------------------


class EndableLoader:
    """The trainer's loader, its stream cut at the first batch asked for
    once ``stop`` is set."""

    def __init__(self, loader, stop: threading.Event):
        self.loader, self.stop = loader, stop

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def _cut(self, stream):
        try:
            for batch in stream:
                if self.stop.is_set():
                    return
                yield batch
        finally:
            close = getattr(stream, "close", None)
            if close is not None:
                close()

    def iter_epochs(self, first_epoch, num_epochs):
        return self._cut(self.loader.iter_epochs(first_epoch, num_epochs))

    def __iter__(self):
        return self._cut(iter(self.loader))


def _window_meter():
    from bdvcil_torch.utils import Throughput

    class WindowMeter(Throughput):
        """Clips and input waits since the run began (no warm-up excluded)."""

        def __init__(self):
            super().__init__(warmup=0)
            self.clips = 0

        def tick(self, n_items):
            super().tick(n_items)
            self.clips += n_items

    return WindowMeter()


# -- the driver of one run ---------------------------------------------------


class Driver:
    """Wraps the program's step: records the followed steps, opens and
    closes the window, times each dispatch, and runs the traced slice."""

    def __init__(self, cellp: Mapping, seconds: float, trace: bool, device: torch.device,
                 weights0: Mapping[str, torch.Tensor], family: ModuleType, ref_cfg: Mapping,
                 meter, stats_fn: Callable[[], Dict]):
        self.warmup = int(cellp["warmup_steps"])
        self.followed = int(cellp["followed_steps"])
        self.trace_steps = int(cellp["trace_steps"]) if trace else 0
        self.seconds = float(seconds)
        self.device = device
        self.w0 = weights0
        self.family = family
        self.ref_cfg = ref_cfg
        self.meter = meter
        self.stats_fn = stats_fn
        self.stop = threading.Event()
        self.i = 0
        self.batches: List[Dict] = []
        self.dropout_seeds: List[int] = []
        self.losses: List[torch.Tensor] = []
        self.grad_norms: Optional[Dict[str, float]] = None
        self.first_readings: Optional[Dict] = None
        self.change_norms: Optional[Dict[str, float]] = None
        self.window: Dict = {}
        self.dispatch_s: List[float] = []
        self.step_starts: List[float] = []
        self.slice: Optional[Dict] = None
        self.profiler = None
        self.pre: Optional[Dict] = None

    def _open_window(self):
        sync(self.device)
        self.window = dict(t0=time.perf_counter(), clips0=self.meter.clips,
                           wait0=self.meter.wait_s, step0=self.i, stats0=self.stats_fn())

    def _slice_edge(self):
        sync(self.device)
        now = time.perf_counter()
        if self.profiler is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            # the window up to here ran untraced: the rate the trace does not disturb
            self.pre = dict(seconds=now - self.window["t0"],
                            clips=self.meter.clips - self.window["clips0"])
            self.profiler = profile(activities=acts)
            self.profiler.start()  # the first start sets up CUPTI: outside the slice
            sync(self.device)
            self.slice = dict(t0=time.perf_counter(), clips0=self.meter.clips, step0=self.i)
        else:
            self.profiler.stop()
            self.slice.update(t1=now, clips1=self.meter.clips, step1=self.i)

    def _record_in(self, imgs, labels, extra, gen):
        keep = {**imgs, "label": labels, **extra}
        self.batches.append({k: torch.as_tensor(v).detach().to("cpu", copy=True)
                             for k, v in keep.items()})
        self.dropout_seeds.append(int(gen.initial_seed()))

    def _record_out(self, state, metrics):
        self.losses.append(metrics["loss"].detach().float().reshape(()))
        params = dict(state.module.named_parameters())
        if self.first_readings is None:
            self.first_readings = self.family.first_forward_readings(state.module, self.ref_cfg)
        if self.grad_norms is None and state.opt_state["count"] == 1:
            # the first update's buffer holds g + wd w0 (the reference's decay groups)
            norms = []
            for name in params:
                wd = self.family.decay(name, self.ref_cfg)
                g = state.opt_state["momentum"][name].float() - wd * self.w0[name]
                norms.append(torch.linalg.vector_norm(g))
            self.grad_norms = dict(zip(params, torch.stack(norms).tolist()))
        if len(self.losses) == self.followed:
            norms = [torch.linalg.vector_norm(p.detach().float() - self.w0[n])
                     for n, p in params.items()]
            self.change_norms = dict(zip(params, torch.stack(norms).tolist()))

    def wrap(self, step_fn: Callable) -> Callable:
        def step(state, prev_model, imgs, labels, extra, gen):
            i = self.i
            if i == self.warmup:
                self._open_window()
            in_window = i >= self.warmup
            if self.trace_steps and in_window:
                elapsed = time.perf_counter() - self.window["t0"]
                if self.profiler is None and elapsed >= self.seconds / 2:
                    self._slice_edge()
                elif self.slice is not None and "t1" not in self.slice \
                        and i - self.slice["step0"] >= self.trace_steps:
                    self._slice_edge()
            if i < self.followed:
                self._record_in(imgs, labels, extra, gen)
            t0 = time.perf_counter()
            if in_window:
                self.step_starts.append(t0)
            with torch.profiler.record_function("bench.step"):
                state, metrics = step_fn(state, prev_model, imgs, labels, extra, gen)
            if in_window:
                self.dispatch_s.append(time.perf_counter() - t0)
            if i < self.followed:
                self._record_out(state, metrics)
            self.i += 1
            if in_window and time.perf_counter() - self.window["t0"] >= self.seconds and (
                    not self.trace_steps or (self.slice is not None and "t1" in self.slice)):
                self.stop.set()
            return state, metrics

        step.needs_prev = getattr(step_fn, "needs_prev", False)
        return step

    def close_window(self):
        sync(self.device)
        w = self.window
        w.update(t1=time.perf_counter(), clips1=self.meter.clips, wait1=self.meter.wait_s,
                 step1=self.i, stats1=self.stats_fn())


# -- faults, for the benchmark's own tests -----------------------------------


def broken_step(step_fn: Callable, fault: str) -> Callable:
    """The program's step broken underneath: 'unchanged' returns the state
    with its weights as they were; 'half' trains on the first half of each
    batch's rows only."""

    def half(tree):
        if isinstance(tree, dict):
            return {k: half(v) for k, v in tree.items()}
        return tree[: tree.shape[0] // 2]

    def step(state, prev_model, imgs, labels, extra, gen):
        if fault == "half":
            return step_fn(state, prev_model, half(imgs), half(labels), half(extra), gen)
        before = {n: p.detach().clone() for n, p in state.module.named_parameters()}
        state, metrics = step_fn(state, prev_model, imgs, labels, extra, gen)
        with torch.no_grad():
            for n, p in state.module.named_parameters():
                p.copy_(before[n])
        return state, metrics

    step.needs_prev = getattr(step_fn, "needs_prev", False)
    return step


# -- the run -----------------------------------------------------------------


def producer_stats() -> Dict[str, float]:
    """The loader's producer counters and the decoded-plane cache's."""
    from bdvcil_torch.data import native
    from bdvcil_torch.data.loaders import PRODUCER_STATS

    cache = {f"cache_{k}": float(v) for k, v in native.decode_cache_stats().items()}
    return {**PRODUCER_STATS, **cache}


def _trace_numbers(driver: Driver) -> Dict:
    """The slice's kernels, busy time and breakdown from the profiler."""
    s = driver.slice
    events = driver.profiler.events()
    kernels, host = [], []
    for e in events:
        if e.name.startswith("bench.") or getattr(e, "is_user_annotation", False):
            if e.device_type == torch.autograd.DeviceType.CUDA:
                continue  # the annotation's span on the device timeline
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name, e.time_range.start, e.time_range.end))
        else:
            host.append((e.name, e.time_range.start, e.time_range.end, e.thread))
    # the launching thread: the one that ran the benchmark's step spans
    main = {t for n, _, _, t in host if n == "bench.step"}
    host_ops = [(n, a, b) for n, a, b, t in host if not main or t in main]
    intervals = [(a, b) for _, a, b in kernels]
    busy = tracing.busy_us(intervals) / 1e6
    out = dict(seconds=s["t1"] - s["t0"], steps=s["step1"] - s["step0"],
               clips=s["clips1"] - s["clips0"], kernels=kernels, busy_s=busy)
    if kernels:
        start = min(a for a, _ in intervals)
        stop = start + out["seconds"] * 1e6
        out["breakdown"] = dict(
            device_ops=tracing.top_device_ops(kernels),
            idle_gaps=tracing.named_gaps(tracing.idle_gaps(intervals, start, stop), host_ops))
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             man: Optional[manifest.Manifest] = None, corpus_root=None,
             fault: Optional[str] = None, variants=(), detail: bool = False,
             readings: bool = False, log=None) -> Dict:
    """One run of ``cell``; returns the result object (the last line).
    ``fault``, ``variants``, ``detail`` and ``readings`` serve the
    benchmark's own tests and ``calibrate.py``."""
    from bdvcil_torch.config_templates import DATASET_PRESETS, make_cil_config

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    man = man or manifest.Manifest()
    entry = man.workload(cell)
    cfg = man.config(entry["config"])
    if trace:
        os.environ["BDVC_PROFILE_PRODUCER"] = "1"
    preset = DATASET_PRESETS[cfg["dataset"]]
    splits = make_cil_config(cfg["dataset"], cfg["split_seed"], cfg["num_stages"],
                             cfg["variant"])["task_splits"]
    root = pathlib.Path(corpus_root or CORPUS_ROOT) / entry["traffic"]
    t = time.perf_counter()
    corpus.write_corpus(root, man.traffic(entry["traffic"]), splits,
                        preset["train_ann"].format(split=1), preset["val_ann"].format(split=1),
                        threads=corpus.default_threads())
    log(f"corpus: {root} ready in {time.perf_counter() - t:.2f} s")
    work_dir = tempfile.mkdtemp(prefix="bench-work-")
    try:
        return _run(cell, seed, seconds, trace, torch.device(device), t_start, man, root,
                    work_dir, fault, variants, detail, readings, log)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, t_start, man, root, work_dir, fault, variants,
         detail, want_readings, log) -> Dict:
    from bdvcil_torch.cil.trainer import CILTrainer, phase_seed
    from bdvcil_torch.config import Config
    from bdvcil_torch.ops import _build
    from bdvcil_torch.runtime import TrainState, make_train_step
    from bdvcil_torch.runtime.loops import train_epochs

    entry = man.workload(cell)
    cfg, traffic, cellp = man.config(entry["config"]), man.traffic(entry["traffic"]), man.cell(cell)
    family = man.config_family(entry["config"])
    ref_cfg = family.reference_config(cfg)
    c = trainer_config(cfg, family, seed, str(root), work_dir)
    marks = {"start": time.perf_counter()}
    trainer = CILTrainer(Config(c), dump_config=False, device=device)
    marks["trainer"] = time.perf_counter()
    num_classes = trainer.num_classes(0)
    weights0 = family.make_weights(cfg, num_classes, seed, device)
    params = dict(trainer.model.named_parameters())
    if set(params) != set(weights0):
        raise RuntimeError(f"the program's parameters differ from the reference's: "
                           f"{sorted(set(params) ^ set(weights0))[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights0[name])
    family.reset_buffers(trainer.model)
    marks["weights"] = time.perf_counter()
    loader, input_fn = trainer._try_fast_loader()
    if loader is None:
        raise RuntimeError(f"the trainer declined the fast input path: "
                           f"{trainer.data_module.loader_notes}")
    log(f"loader: {trainer.data_module.loader_notes[-1]}, {len(loader)} batches an epoch of "
        f"{loader.batch_size}, {loader.num_workers} workers")

    tx = trainer._make_optimizer("inc_step", len(loader))
    step_fn = make_train_step(spec=trainer.spec, tx=tx, num_classes=num_classes,
                              method=trainer.method, task_idx=0, prev_num_classes=0,
                              kd_config=trainer._kd_config(), video_mix=trainer._video_mix_cfg(),
                              input_fn=input_fn)
    if fault is not None:
        step_fn = broken_step(step_fn, fault)
    state = TrainState.create(trainer.model, tx)
    meter = _window_meter()
    driver = Driver(cellp, seconds, trace, device, weights0, family, ref_cfg, meter,
                    producer_stats)
    feed = EndableLoader(loader, driver.stop)
    launches0 = dict(_build.LAUNCHES)
    marks["loader and step"] = time.perf_counter()
    state, last = train_epochs(
        driver.wrap(step_fn), state, trainer.prev_model, feed, trainer.num_epoch_per_task,
        phase_seed(trainer.seed, 0, "inc_step"), device=device,
        metric_logger=trainer.metric_logger, log_every_n_steps=c.get("log_every_n_steps", 10),
        phase="inc_step", task_idx=0, meter=meter)
    if not driver.window:
        raise RuntimeError(f"the run ended after {driver.i} steps, before the window opened")
    driver.close_window()
    w = driver.window
    window_s = w["t1"] - w["t0"]
    steps = w["step1"] - w["step0"]
    clips = w["clips1"] - w["clips0"]
    launches = {k: v - launches0.get(k, 0) for k, v in _build.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    marks["warm-up and followed steps"] = w["t0"]
    names = list(marks)
    log("set-up by phase: imports and corpus " f"{marks['start'] - t_start:.3f} s, " + ", ".join(
        f"{b} {marks[b] - marks[a]:.3f} s" for a, b in zip(names, names[1:])))
    starts = driver.step_starts + [w["t1"]]
    fifths = [round((len(starts) - 1) * i / 5) for i in range(6)]
    log("steps a second by fifth of the window (launch times): " + ", ".join(
        f"{(b - a) / (starts[b] - starts[a]):.3f}" for a, b in zip(fifths, fifths[1:]) if b > a))
    hits = w["stats1"].get("cache_hits", 0) - w["stats0"].get("cache_hits", 0)
    misses = w["stats1"].get("cache_misses", 0) - w["stats0"].get("cache_misses", 0)
    log(f"plane cache in the window: {hits:.0f} hits, {misses:.0f} misses, hit rate "
        f"{hits / max(hits + misses, 1):.4f}")
    log(f"window: {steps} steps, {clips} clips in {window_s:.3f} s; set-up "
        f"{w['t0'] - t_start:.3f} s; kernel launches {launches}")

    program = dict(losses=[float(x) for x in driver.losses], grad_norms=driver.grad_norms,
                   change_norms=driver.change_norms, **(driver.first_readings or {}))
    if program["grad_norms"] is None or program["change_norms"] is None:
        raise RuntimeError("the followed steps did not all run before the window")

    slice_ = _trace_numbers(driver) if driver.profiler is not None else None
    obs = dict(cell=cell, config=cfg, traffic=traffic, device=device.type,
               frames_per_step=cfg["videos_per_gpu"] * cfg["num_segments"],
               flops_per_clip=family.train_flops_per_clip(cfg),
               window=dict(seconds=window_s, steps=steps, clips=clips,
                           wait_s=w["wait1"] - w["wait0"], dispatch_s=driver.dispatch_s,
                           untraced=driver.pre or dict(seconds=window_s, clips=clips),
                           stats0=w["stats0"], stats1=w["stats1"]),
               slice=slice_)

    # the program's state goes before the reference runs
    batches, seeds = driver.batches, driver.dropout_seeds
    del state, trainer, loader, feed, step_fn, driver, params, weights0, tx, input_fn
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings, raw = check(family, cfg, ref_cfg, num_classes, seed, device, batches, seeds,
                          program, variants)
    values = readings["program"]
    limits = cellp["limits"]
    correct = compare.verdict(values, limits) and all(math.isfinite(x) for x in
                                                       program["losses"])
    metrics = {}
    if trace:
        for m in man.per_layer(cell):
            value = man.reader(m["name"])(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics["train_clips_per_s"] = {"value": clips / window_s, "unit": "clips/s"}
        metrics["setup_s"] = {"value": w["t0"] - t_start, "unit": "s"}
    # a step whose loss is not a number failed: the followed steps, and the
    # last step the loop read back
    failed = sum(not math.isfinite(x) for x in program["losses"])
    failed += int("loss" in last and not math.isfinite(float(last["loss"])))
    result = dict(correct=bool(correct), attempted=steps, failed=failed,
                  metrics=metrics, device=device_info(device, peak))
    if trace and slice_ is not None:
        result["device"].update(busy_s=slice_["busy_s"], window_s=slice_["seconds"])
        if "breakdown" in slice_:
            result["breakdown"] = slice_["breakdown"]
    if variants or want_readings or detail:
        result["readings"] = readings
    if detail:  # every leaf's norms and the family's readings, for the calibration
        result["detail"] = {k: plain(v) for k, v in dict(raw, program=program).items()}
    result["checks"] = compare.report(values, limits)
    return result


def check(family, cfg, ref_cfg, num_classes, seed, device, batches, seeds, program,
          variants=()):
    """The family's reference over the followed steps, and the family's
    numbers of the program against it; with ``variants`` also those of the
    reference put in the program's place: 'control' (fp8), 'bf16' and 'half'
    (half of each batch left out). Returns ({'program': numbers, <variant>: numbers}, the raw
    readings of the reference and of each variant)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        reference = reference_readings(family, cfg, ref_cfg, num_classes, seed, device, batches,
                                       seeds)
        out, raw = {"program": family.numbers(program, reference)}, {"reference": reference}
        for v in variants:
            rows = slice(0, batches[0]["label"].shape[0] // 2) if v == "half" else None
            raw[v] = reference_readings(family, cfg, ref_cfg, num_classes, seed, device, batches,
                                        seeds, precision=None if v == "half" else v, rows=rows)
            out[v] = family.numbers(raw[v], reference)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    return out, raw


def plain(readings: Mapping) -> Dict:
    """Readings with their tensors as lists, for JSON."""
    return {k: ({n: t.tolist() if isinstance(t, torch.Tensor) else t for n, t in v.items()}
                if isinstance(v, Mapping) else v)
            for k, v in readings.items()}


def reference_readings(family, cfg, ref_cfg, num_classes, seed, device, batches, seeds,
                       precision=None, rows=None) -> Dict:
    """The reference's losses, gradient and change norms, and the family's
    readings of its first forward."""
    w0 = family.make_weights(cfg, num_classes, seed, device)
    dev_batches = [{k: v.to(device) if k not in HOST_DRAWS else v for k, v in b.items()}
                   for b in batches]
    out = family.reference_train_steps(w0, dev_batches, seeds, ref_cfg, precision, rows)
    first_grad, params = out.pop("first_grad"), out.pop("params")
    grad = {n: float(torch.linalg.vector_norm(g)) for n, g in first_grad.items()}
    change = {n: float(torch.linalg.vector_norm(p - w0[n])) for n, p in params.items()}
    return dict(losses=out.pop("losses"), grad_norms=grad, change_norms=change, **out)


# the loader's RandAugment draws stay on the host, as the program keeps them
HOST_DRAWS = ("apply_randaug", "randaug_op_indices", "randaug_flip_sign", "randaug_x0",
              "randaug_y0")


def device_info(device: torch.device, peak: int) -> Dict:
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=1,
                    memory_peak_bytes=int(peak))
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
