"""The epoch loop of training and the inference loop (the port of
``prefetch_to_device``, ``train_epochs`` and ``run_inference``,
``bdvcil_tpu/runtime/loops.py:33-479``).

Input reaches the card off the critical path. A prefetch thread takes the
loader's batches (K of them at a time for the K-step form), copies them into
one pinned buffer per key and per item (``stage_batches``; torch copies
release the GIL while the decode pool runs, where ``np.stack`` would hold
it), issues one asynchronous copy per key on a side stream and records an
event (``copy_to_device``). The consumer makes the compute stream wait on
that event and marks each tensor as used there (``record_stream``), so the
allocator keeps its memory until the step's kernels are done
(``wait_copied``). ``HOST_KEYS`` (RandAugment's draws and mask) stay on the
host. On the CPU the same path runs without pinning, streams or events.

``run_inference`` runs an eval step over an unshuffled loader through the
same prefetch thread and copies, keeps one group's outputs pending while the
next group runs, and returns host arrays in dataset order; across ranks it
gathers every rank's rows in rank order.

Random draws in a step (dropout, tube-CutMix) come from a generator made from
(run seed, step) (``step_generator``): a resumed run needs only its seed and
step count, and K steps in one dispatch draw exactly what K single steps do.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..data.device_pipeline import HOST_KEYS
from ..parallel import distributed
from ..parallel.mesh import gather_to_host
from ..utils import Throughput, profiling

logger = logging.getLogger("bdvcil.runtime")

EXTRA_KEYS = ("foreground_ratio", "background_label", "sample_weight")


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step ``step`` of a run seeded ``seed``, on ``device``."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


def stage_batches(batches: Sequence[Mapping], pin: bool, stack: bool) -> Dict[str, torch.Tensor]:
    """Loader batches (dicts of arrays) as host tensors: with ``stack`` the K
    batches as one (K, ...) tensor per key, else the one batch. Every key
    but ``HOST_KEYS`` goes into a new pinned buffer when ``pin``; the copies
    are torch copies, which release the GIL."""
    out = {}
    for key in batches[0]:
        parts = [torch.as_tensor(b[key]) for b in batches]
        if len({p.shape for p in parts}) != 1:
            raise ValueError(
                f"a chunk of {len(parts)} batches has {key!r} of shapes "
                f"{sorted({tuple(p.shape) for p in parts})}: the K-step form needs uniform "
                f"batches (loader drop_last=True or pad_to_batch)")
        if key in HOST_KEYS or not pin:
            out[key] = torch.stack(parts) if stack else parts[0]
            continue
        shape = (len(parts), *parts[0].shape) if stack else parts[0].shape
        buf = torch.empty(shape, dtype=parts[0].dtype, pin_memory=True)
        for i, p in enumerate(parts):
            (buf[i] if stack else buf).copy_(p)
        out[key] = buf
    return out


def copy_to_device(tree: Mapping[str, torch.Tensor], device: torch.device,
                   stream: Optional["torch.cuda.Stream"]):
    """Every key but ``HOST_KEYS`` on ``device``: asynchronous copies on
    ``stream`` and an event recorded after them, or plain copies (event None)
    without a stream. The caller may drop the pinned sources at once:
    PyTorch's pinned-memory allocator records each asynchronous copy and
    hands the buffer out again only after it has finished."""
    if stream is None:
        return {k: v if k in HOST_KEYS else v.to(device) for k, v in tree.items()}, None
    with torch.cuda.stream(stream):
        out = {k: v if k in HOST_KEYS else v.to(device, non_blocking=True)
               for k, v in tree.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def wait_copied(tree: Mapping[str, torch.Tensor], event, device: torch.device):
    """The consumer's side of ``copy_to_device``: the current stream waits on
    the copies' event, and each copied tensor is marked as used on it."""
    if event is None:
        return dict(tree)
    current = torch.cuda.current_stream(device)
    current.wait_event(event)
    for v in tree.values():
        if v.is_cuda:
            v.record_stream(current)
    return dict(tree)


def side_stream(device: torch.device) -> Optional["torch.cuda.Stream"]:
    """The copy stream for ``device`` (None off the card)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def prefetch_to_device(iterable, size: int = 2, put_fn: Optional[Callable] = None,
                       meter: Optional[Throughput] = None):
    """Iterate ``iterable`` through a background thread that applies
    ``put_fn`` ahead of the consumer, at most ``size`` items ahead. Order is
    kept; an exception in the thread is raised in the consumer; a consumer
    that stops early stops the thread (and closes ``iterable``). ``put_fn``
    defaults to passing items as they are. The seconds the consumer waits for
    an item are added to ``meter`` (``Throughput.add_wait``)."""
    put_fn = put_fn or (lambda item: item)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    sentinel = object()
    stop = threading.Event()
    err: List[BaseException] = []

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not offer(put_fn(item)):
                    return
        except BaseException as e:  # noqa: BLE001 -- raised again in the consumer
            err.append(e)
        finally:
            close = getattr(iterable, "close", None)
            if stop.is_set() and close is not None:
                close()
            offer(sentinel)

    th = threading.Thread(target=worker, daemon=True, name="bdvc-device-prefetch")
    th.start()
    try:
        while True:
            t0 = time.perf_counter()
            while True:
                try:  # timed: signal handlers still run between waits
                    item = q.get(timeout=0.25)
                    break
                except queue.Empty:
                    continue
            if meter is not None:
                meter.add_wait(time.perf_counter() - t0)
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def split_batch(tree: Mapping[str, Any]):
    """(imgs, labels, extra) of a batch: a wire batch's pixel and mask keys
    (``data/device_pipeline.py``) or a plain ``imgs``, the labels, and the
    optional ``EXTRA_KEYS``."""
    if "imgs_u8" in tree or "imgs_y" in tree:
        imgs = {k: v for k, v in tree.items() if k != "label" and k not in EXTRA_KEYS}
    else:
        imgs = tree["imgs"]
    return imgs, tree["label"], {k: tree[k] for k in EXTRA_KEYS if k in tree}


def _valid_rows(batch: Mapping[str, Any]) -> int:
    """The valid rows of the global batch: this rank's, times the ranks (exact
    but for the pad-row skew of a padded tail, as in JAX)."""
    if "sample_weight" in batch:
        n = int(np.asarray(batch["sample_weight"]).sum())
    else:
        n = int(np.shape(batch["label"])[0])
    return n * distributed.process_count()


def train_epochs(
    step_fn: Callable,
    state,
    prev_model,
    loader,
    num_epochs: int,
    seed: int,
    device=None,
    metric_logger=None,
    log_every_n_steps: int = 10,
    phase: str = "inc_step",
    task_idx: int = 0,
    epoch_hook: Optional[Callable] = None,
    start_epoch: int = 0,
    snapshot_hook: Optional[Callable] = None,
    multi_step_fn: Optional[Callable] = None,
    steps_per_dispatch: int = 1,
    meter: Optional[Throughput] = None,
) -> Tuple[Any, Dict[str, float]]:
    """Run ``step_fn`` over epochs ``start_epoch .. num_epochs - 1`` of
    ``loader``; return (state, last_metrics).

    ``epoch_hook(epoch, state)`` runs after every epoch;
    ``snapshot_hook(epoch, state, seed)`` after it: with ``start_epoch``
    that gives a bit-exact resume (``runtime/checkpoint.py``). Step ``s`` of
    the run (counted from epoch 0, ``len(loader)`` steps an epoch) draws from
    ``step_generator(seed, s, device)``.

    With ``steps_per_dispatch`` K > 1 and ``multi_step_fn``
    (``make_multi_train_step``), K consecutive batches of an epoch go to the
    card as one staged chunk and one call; chunks never cross an epoch, and
    an epoch's remainder goes through ``step_fn``. A loader with
    ``iter_epochs`` feeds all epochs through one producer stream.

    Metrics are read on the host one log interval late, so logging never
    stalls the card; ``meter`` (else a new ``Throughput(warmup=2)``) counts
    clips (valid rows only) and the seconds spent waiting for input.
    Runs on the card unless ``device`` says otherwise.

    Each call is a new run of ``utils/profiling``'s spans; under a
    ``torch.profiler`` session the loop records ``loop.fetch`` (the next
    item from the prefetch queue), ``loop.feed`` (the consumer's side of the
    copies and the step's generators) and ``loop.log`` (the late readback),
    and each call into the step carries the number of its (first) step.
    """
    device = resolve_device(device)
    profiling.new_run()
    stream = side_stream(device)
    pin = device.type == "cuda"
    meter = meter if meter is not None else Throughput(warmup=2)
    step = start_epoch * len(loader) if start_epoch else 0
    last_metrics: Dict[str, float] = {}
    pending_metrics = None  # read one log interval later
    use_multi = steps_per_dispatch > 1 and multi_step_fn is not None
    batches_per_epoch = len(loader)

    def prepare(item):
        """Host side of one dispatch, in the prefetch thread."""
        batches = item if isinstance(item, list) else [item]
        host = stage_batches(batches, pin, stack=isinstance(item, list))
        tree, event = copy_to_device(host, device, stream)
        kind = "multi" if isinstance(item, list) else "single"
        return kind, tree, event, sum(_valid_rows(b) for b in batches)

    def grouped(src):
        """K-chunks that never cross an epoch; remainders pass as single batches."""
        chunk: List = []
        for pos, b in enumerate(src, 1):
            chunk.append(b)
            if len(chunk) == steps_per_dispatch:
                yield chunk
                chunk = []
            if pos % batches_per_epoch == 0 and chunk:
                yield from chunk
                chunk = []
        yield from chunk

    def items_per_epoch():
        if not use_multi:
            return batches_per_epoch
        return batches_per_epoch // steps_per_dispatch + batches_per_epoch % steps_per_dispatch

    span_stream = None
    if hasattr(loader, "iter_epochs") and num_epochs - start_epoch > 1:
        src = loader.iter_epochs(start_epoch, num_epochs - start_epoch)
        span_stream = iter(prefetch_to_device(grouped(src) if use_multi else src, size=2,
                                              put_fn=prepare, meter=meter))

    for epoch in range(start_epoch, num_epochs):
        loader.set_epoch(epoch)
        epoch_iter = (
            itertools.islice(span_stream, items_per_epoch()) if span_stream is not None
            else prefetch_to_device(grouped(iter(loader)) if use_multi else loader, size=2,
                                    put_fn=prepare, meter=meter))
        epoch_iter = iter(epoch_iter)
        while True:
            with profiling.annotate("loop.fetch"):
                item = next(epoch_iter, None)
            if item is None:
                break
            kind, tree, event, n_valid = item
            with profiling.annotate("loop.feed"):
                imgs, labels, extra = split_batch(wait_copied(tree, event, device))
                if kind == "multi":
                    gens = [step_generator(seed, step + k, device)
                            for k in range(steps_per_dispatch)]
                else:
                    gen = step_generator(seed, step, device)
            profiling.set_step(step)
            if kind == "multi":
                state, metrics = multi_step_fn(state, prev_model, imgs, labels, extra, gens)
                consumed = steps_per_dispatch
            else:
                state, metrics = step_fn(state, prev_model, imgs, labels, extra, gen)
                consumed = 1
            meter.tick(n_valid)
            prev_step, step = step, step + consumed
            if step // log_every_n_steps > prev_step // log_every_n_steps:
                if pending_metrics is not None:
                    with profiling.annotate("loop.log"):  # float() waits for the queued work
                        last_metrics = {k: float(v) for k, v in pending_metrics.items()}
                        payload = {f"[{phase}_Task_{task_idx}]{k}": v
                                   for k, v in last_metrics.items()}
                        payload["clips_per_sec"] = meter.rate
                        if metric_logger is not None:
                            metric_logger.log(payload, step=step)
                        logger.info("task %d %s epoch %d step %d loss=%.4f kd=%.4f "
                                    "clips/s=%.1f", task_idx, phase, epoch, step,
                                    last_metrics.get("loss", float("nan")),
                                    last_metrics.get("kd_loss", 0.0), meter.rate)
                pending_metrics = metrics
        if epoch_hook is not None:
            epoch_hook(epoch, state)
        if snapshot_hook is not None:
            snapshot_hook(epoch, state, seed)
    if pending_metrics is not None:
        with profiling.annotate("loop.log"):
            last_metrics = {k: float(v) for k, v in pending_metrics.items()}
    return state, last_metrics


def run_inference(
    eval_step: Callable,
    module,
    loader,
    device=None,
    extract_repr: bool = False,
    pad_batch_to: Optional[int] = None,
    steps_per_dispatch: int = 1,
    multi_eval_step: Optional[Callable] = None,
) -> Dict[str, np.ndarray]:
    """Unshuffled forward over a loader's dataset.

    Returns host arrays in dataset order: cls_score (N, G, nc) raw scores (as
    f32), labels (N,), and repr (N, G, C) when ``extract_repr`` (normalized
    by the eval step). A batch short of ``pad_batch_to`` rows is padded on the
    host by repeating its last row (edge padding), and its outputs trimmed.

    With ``steps_per_dispatch`` K > 1 and ``multi_eval_step``
    (``make_multi_eval_step``), K batches go to the card as one staged group
    and one call; a ragged last group, or a group whose batches differ in
    shape, goes batch by batch through ``eval_step``, so the results are the
    same for every K. The outputs of one group are read back only after the
    next group has been launched. Runs on the card unless ``device`` says
    otherwise.

    Under a process group each rank runs its rows of every global batch (the
    loaders pad the global order to whole batches and cut each rank's rows,
    the same count on every rank), ``pad_batch_to`` counts the global batch
    (a rank pads to its share), and each batch's outputs are gathered in rank
    order as they drain; the whole is trimmed to ``loader.num_valid`` rows
    (else the dataset's length) and every rank returns it (JAX
    ``_run_inference_multiprocess``). Every rank runs the same loop, so the
    gathers pair up.
    """
    device = resolve_device(device)
    stream = side_stream(device)
    pin = device.type == "cuda"
    spd = int(steps_per_dispatch) if multi_eval_step is not None else 1
    world = distributed.process_count()
    if world > 1 and pad_batch_to:
        pad_batch_to = -(-int(pad_batch_to) // world)

    scores: List[np.ndarray] = []
    labels_out: List[np.ndarray] = []
    reprs: List[np.ndarray] = []

    def prep_host(batch):
        """(pixel keys padded to the target rows, labels, valid rows)."""
        if "imgs" in batch:
            imgs = {"imgs": np.asarray(batch["imgs"])}
        else:
            imgs = {k: np.asarray(v) for k, v in batch.items()
                    if k not in ("label", "sample_weight")}
        labels = np.asarray(batch["label"]).reshape(-1)
        n_valid = next(iter(imgs.values())).shape[0]
        target = pad_batch_to or n_valid
        if target > n_valid:
            imgs = {k: np.pad(v, [(0, target - n_valid)] + [(0, 0)] * (v.ndim - 1), mode="edge")
                    for k, v in imgs.items()}
        return imgs, labels, n_valid

    def put(host_batches, stack: bool):
        tree, event = copy_to_device(stage_batches(host_batches, pin, stack=stack), device,
                                     stream)
        return tree, event

    def grouped(src):
        buf = []
        for b in src:
            buf.append(b)
            if len(buf) == spd:
                yield buf
                buf = []
        if buf:
            yield buf

    def prep_group(group):
        """Prefetch-thread work for one group: pad, stage and start the copies."""
        preps = [prep_host(b) for b in group]
        if spd > 1 and len(preps) == spd:
            first = preps[0][0]
            if all(p[0].keys() == first.keys()
                   and all(p[0][k].shape == first[k].shape for k in first) for p in preps[1:]):
                return ("multi", put([p[0] for p in preps], True), [p[1] for p in preps],
                        [p[2] for p in preps])
        return ("single", [(put([p[0]], False), p[1], p[2]) for p in preps])

    def imgs_of(tree):
        return tree["imgs"] if tuple(tree) == ("imgs",) else tree

    def host(x):
        """A dispatch's output as f32: on the host in one process; on the
        card under a group, for the gather."""
        x = x.float()
        return x if world > 1 else x.cpu()

    def rows(x, nv):
        """A batch's valid rows on the host, every rank's in rank order."""
        return gather_to_host(x[:nv]) if world > 1 else np.asarray(x[:nv])

    def drain(entry):
        if entry[0] == "multi":
            _, out, labels_list, n_valids = entry
            cls = host(out["cls_score"])
            rep = host(out["repr"]) if extract_repr else None
            batches = [(cls[k], rep[k] if extract_repr else None, lb, nv)
                       for k, (lb, nv) in enumerate(zip(labels_list, n_valids))]
        else:
            batches = [(host(out["cls_score"]), host(out["repr"]) if extract_repr else None,
                        lb, nv) for out, lb, nv in entry[1]]
        for cls, rep, lb, nv in batches:
            scores.append(rows(cls, nv))
            labels_out.append(rows(lb, nv))
            if extract_repr:
                reprs.append(rows(rep, nv))

    pending = None
    for entry in prefetch_to_device(grouped(loader), size=2, put_fn=prep_group):
        if entry[0] == "multi":
            (tree, event), labels_list, n_valids = entry[1], entry[2], entry[3]
            out = multi_eval_step(module, imgs_of(wait_copied(tree, event, device)))
            dispatched = ("multi", out, labels_list, n_valids)
        else:
            dispatched = ("single", [
                (eval_step(module, imgs_of(wait_copied(tree, event, device))), lb, nv)
                for (tree, event), lb, nv in entry[1]])
        if pending is not None:
            drain(pending)
        pending = dispatched
    if pending is not None:
        drain(pending)

    n_valid = None
    if world > 1:
        n_valid = getattr(loader, "num_valid", None)
        if n_valid is None:
            n_valid = len(loader.dataset)
    result = {"cls_score": np.concatenate(scores, axis=0)[:n_valid],
              "labels": np.concatenate(labels_out, axis=0)[:n_valid]}
    if extract_repr:
        result["repr"] = np.concatenate(reprs, axis=0)[:n_valid]
    return result
