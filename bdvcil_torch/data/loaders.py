"""Host half of the fast training input path: the loaders that decode JPEG
rawframes with the native decoder into uint8 wire batches (the port of the
host half of ``bdvcil_tpu/data/device_pipeline.py``).

Each function and class has the same name and contract as its counterpart
there:

  PRODUCER_STATS             device_pipeline.py:43-60 (with
                             _record_producer_phases)
  resolve_wire_format        :63
  fast_pipeline_mismatch     :102 (the trainer's gate of the fast path)
  resized_dims               :223
  plan_train_geometry        :230 (and _fixed_crop_offsets :494)
  plan_bg_crop               :284
  _pads_from_dims            :341
  _planes_wire_core          :353
  _parallel_ordered_iter     :423
  _EpochSpanMixin            :811-900 (iter_epochs, pad_to_batch with
                             sample_weight, process slicing)
  FastBGMixLoader            :903-1217
  transform_acm_boxes        :1219
  _rasterized_union_area     :1241
  FastACMLoader              :1251-1626
  FastEvalLoader             :595-810 (the eval batches: centre crop,
                             TenCrop, and the full-frame yuv420 wire)

A batch is a pure function of (seed, epoch, index): each row draws from its
own numpy generator, consumed exactly as the JAX loaders consume it, so every
key equals theirs bit for bit but one. In place of JAX's ``randaug_key``
(B, 2) uint32 the batch carries the RandAugment draws the port's input
functions take (``ops.rand_augment_dev.DRAW_KEYS``), derived on the host from
that uint32 pair alone (``randaug_draws_from_keys``). The batch layout is in
``data/device_pipeline.py``.

Every loader's ``batch_size`` is the global batch. Under a process group each
rank loads its contiguous rows of every global batch (``process_index`` /
``process_count`` default to the group's rank and size,
``parallel/distributed.py``), and a train loader pads the tail globally.
"""

from __future__ import annotations

import os
import os.path as osp
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.rand_augment_dev import DRAW_KEYS, draw_randaug
from ..parallel import distributed
from . import native
from .device_pipeline import identity_plane_taps, plane_resize_taps
from .sampling import SampleFrames

# MultiScaleCrop scales, realized through the short-side trick
MSC_SCALES = (1.0, 0.875, 0.75, 0.66)
# 'planes' wire: a source above this many pixels is resized on the host
# instead of shipped at stored resolution (the default of BDVC_PLANES_MAX_PX)
PLANES_MAX_PX = 512 * 512

# FastBGMixLoader's phase seconds and batch count, summed over its workers
# while BDVC_PROFILE_PRODUCER is set (read by profile_e2e and by the
# benchmark's producer_ms_per_batch.train, benchmark/metrics/)
PRODUCER_STATS: Dict[str, float] = {}
_PRODUCER_STATS_LOCK = threading.Lock()


def _producer_profiling_enabled() -> bool:
    return os.environ.get("BDVC_PROFILE_PRODUCER", "") not in ("", "0")


def _record_producer_phases(**seconds: float) -> None:
    with _PRODUCER_STATS_LOCK:
        for k, v in seconds.items():
            PRODUCER_STATS[k] = PRODUCER_STATS.get(k, 0.0) + v
        PRODUCER_STATS["batches"] = PRODUCER_STATS.get("batches", 0.0) + 1.0


def _require_native() -> None:
    if not native.available():
        raise RuntimeError(f"native decoder unavailable: {native.build_error()}")


def resolve_wire_format(wire_format: str, crop_size: int) -> str:
    """The host->device wire: 'rgb' (decoded uint8 RGB crops), 'yuv420' (the
    JPEG's stored luma/chroma at the crop, half the bytes; RGB is rebuilt on
    the device), 'planes' (stored-resolution planes plus resize taps; the
    resize runs on the device, bit-identical to 'yuv420'), or 'auto': yuv420
    when the decoder has it and the crop is even, else rgb."""
    if wire_format == "auto":
        return "yuv420" if native.has_yuv420() and crop_size % 2 == 0 else "rgb"
    if wire_format == "yuv420" and not (native.has_yuv420() and crop_size % 2 == 0):
        raise ValueError(
            f"wire_format='yuv420' needs the yuv420 native kernel and an even "
            f"crop size (got crop={crop_size}, has_yuv420={native.has_yuv420()})")
    if wire_format == "planes" and not (
            native.has_fetch_planes() and native.has_yuv420() and crop_size % 2 == 0):
        raise ValueError(f"wire_format='planes' needs the fetch_planes + yuv420 native "
                         f"kernels and an even crop size (got crop={crop_size})")
    if wire_format not in ("rgb", "yuv420", "planes"):
        raise ValueError(f"unknown wire_format {wire_format!r}")
    return wire_format


def fast_pipeline_mismatch(pipeline, *, num_segments: int, randaug_prob: float):
    """Why the fast input path cannot reproduce ``pipeline`` exactly, or
    None when it can.

    The fast path implements exactly the canonical reference train chain
    (config_templates._pipelines; reference config :124-163):
    SampleFrames(1x1xT) -> RawFrameDecode -> Resize(-1, S) ->
    RandAugment(n=2, m=10, prob=randAug_prob) -> MultiScaleCrop(13 fixed
    crops, gap 1) -> Resize(square, keep_ratio=False) -> Normalize(RGB) ->
    FormatShape(NHWC)/Collect/ToTensor. A pipeline containing anything else
    (Flip, ColorJitter, different RandAugment hyperparameters, ...) must
    fall back to the host pipeline rather than silently train on a
    different augmentation distribution — the trainer logs the returned
    reason and declines the fast path."""
    supported = {
        "SampleFrames",
        "RawFrameDecode",
        "Resize",
        "RandAugment",
        "MultiScaleCrop",
        "Normalize",
        "FormatShape",
        "Collect",
        "ToTensor",
    }
    # Omitted per-op params must be filled with the HOST op's defaults (the
    # behavior the fast path has to reproduce), never with the fast path's
    # own expectation — op.get('prob', randaug_prob) would wave through a
    # pipeline the host runs at prob=0.5 while the fast path runs it at the
    # config's randAug_prob.
    sig = []  # semantic op sequence, order-checked against the canonical chain
    msc_size = fixed_resize = None
    for op in pipeline:
        t = op.get("type")
        if t not in supported:
            return f"pipeline op {t!r} is not implemented by the fast path"
        if t == "SampleFrames":
            if op.get("clip_len", 1) != 1 or op.get("frame_interval", 1) != 1:
                return "fast path only implements SampleFrames(clip_len=1, frame_interval=1)"
            # host default num_clips=1 (data/sampling.py)
            if int(op.get("num_clips", 1)) != int(num_segments):
                return "SampleFrames num_clips differs from the model's num_segments"
            if op.get("test_mode", False):
                return "test-mode SampleFrames in a train pipeline"
        elif t == "Resize":
            scale = op.get("scale")
            if op.get("keep_ratio", True):
                if not (isinstance(scale, (tuple, list)) and scale[0] == -1):
                    return f"keep-ratio Resize with scale {scale!r} (only (-1, S) supported)"
            else:
                if not (isinstance(scale, (tuple, list)) and scale[0] == scale[1]):
                    return f"fixed Resize with non-square scale {scale!r}"
                fixed_resize = int(scale[0])
        elif t == "RandAugment":
            if int(op.get("n", 2)) != 2 or int(op.get("m", 10)) != 10:
                return "RandAugment n/m differ from the fast path's (2, 10)"
            # host default prob=0.5 (data/rand_augment.py); when the config
            # disables the loader's RandAugment entirely (randaug_prob < 0)
            # the presence check below gives the clearer reason
            if randaug_prob >= 0 and abs(
                float(op.get("prob", 0.5)) - float(randaug_prob)
            ) > 1e-9:
                return "RandAugment prob differs from config randAug_prob"
        elif t == "MultiScaleCrop":
            if op.get("random_crop", False):
                return "MultiScaleCrop(random_crop=True) is not implemented"
            if int(op.get("max_wh_scale_gap", 1)) != 1:
                return "MultiScaleCrop max_wh_scale_gap != 1 is not implemented"
            # host default num_fixed_crops=5 (data/transforms.py)
            if int(op.get("num_fixed_crops", 5)) != 13:
                return "MultiScaleCrop num_fixed_crops != 13 is not implemented"
            size = op.get("input_size")
            if isinstance(size, (tuple, list)):
                # a non-square input_size changes the host crop-box shape —
                # collapsing it to size[0] would wave a (224, 256) MSC
                # through the exactness gate
                if len(size) != 2 or int(size[0]) != int(size[1]):
                    return (f"MultiScaleCrop non-square input_size {tuple(size)!r} "
                            "is not implemented by the fast path")
                size = size[0]
            msc_size = size
        elif t == "Normalize":
            if op.get("to_bgr", False):
                return "Normalize(to_bgr=True) is not implemented"
        elif t == "FormatShape":
            # the fast path emits NHWC; the recognizer accepts NHWC and NCHW
            # identically (models/recognizer.py), so the reference configs'
            # NCHW is fine — only exotic layouts decline
            if op.get("input_format", "NHWC") not in ("NHWC", "NCHW"):
                return f"FormatShape {op.get('input_format')!r} (fast path emits NHWC)"
        if t == "Resize":
            sig.append("Resize(-1,S)" if op.get("keep_ratio", True) else "Resize(square)")
        elif t not in ("Collect", "ToTensor"):  # metadata-only ops
            sig.append(t)
    # exact chain: the fast path implements the canonical sequence as ONE
    # fused recipe, so the ops must all be present and in canonical order —
    # a reordered / partial pipeline (e.g. RandAugment after the crop, or a
    # missing Normalize) computes different pixels on the host
    canonical = ["SampleFrames", "RawFrameDecode", "Resize(-1,S)", "RandAugment",
                 "MultiScaleCrop", "Resize(square)", "Normalize", "FormatShape"]
    if randaug_prob < 0:
        canonical.remove("RandAugment")
        if "RandAugment" in sig:
            return "pipeline has RandAugment but config randAug_prob < 0"
    elif "RandAugment" not in sig:
        # the loader would apply RandAugment (config randAug_prob >= 0) that
        # the configured host pipeline does not contain
        return "config randAug_prob >= 0 but the pipeline has no RandAugment op"
    if sig != canonical:
        return f"pipeline op sequence {sig} != canonical fast-path chain {canonical}"
    # the fast path draws MSC crop boxes sized from the FINAL square size
    # (decode-to-output), which is only equivalent when the host's MSC
    # input_size equals the fixed Resize scale (true of every reference
    # config; a 224-crop-then-256-upscale pipeline is a different crop-box
    # distribution)
    if int(msc_size) != int(fixed_resize):
        return (f"MultiScaleCrop input_size {msc_size} != fixed Resize scale "
                f"{fixed_resize} (fast path decodes straight to the output square)")
    return None


def randaug_draws_from_keys(keys: np.ndarray, n: int, h: int, w: int) -> Dict[str, np.ndarray]:
    """The RandAugment draws of each clip from its uint32 key pair alone: a
    CPU ``torch.Generator`` seeded with ``k0 << 32 | k1`` makes the clip's
    ``draw_randaug`` (n ops, sign, cutout centre in [0, w) x [0, h))."""
    rows = [draw_randaug(torch.Generator().manual_seed((int(k0) << 32) | int(k1)), 1, n, h, w)
            for k0, k1 in np.asarray(keys, np.uint32).reshape(-1, 2)]
    return {k: torch.cat([r[k] for r in rows]).numpy() for k in DRAW_KEYS}


def resized_dims(w: int, h: int, short_side: int) -> tuple:
    """Dims after a short-side resize, as mmcv rescales
    (int(dim * factor + 0.5); the decoder's resize contract)."""
    factor = short_side / min(w, h)
    return int(w * factor + 0.5), int(h * factor + 0.5)


def _fixed_crop_offsets(rw: int, rh: int, crop_w: int, crop_h: int) -> List[Tuple[int, int]]:
    """The 13 MultiScaleCrop fixed offsets, in mmaction2's order."""
    ws = max((rw - crop_w) // 4, 0)
    hs = max((rh - crop_h) // 4, 0)
    return [(0, 0), (4 * ws, 0), (0, 4 * hs), (4 * ws, 4 * hs), (2 * ws, 2 * hs), (0, 2 * hs),
            (4 * ws, 2 * hs), (2 * ws, 4 * hs), (2 * ws, 0), (ws, hs), (3 * ws, hs), (ws, 3 * hs),
            (3 * ws, 3 * hs)]


def plan_train_geometry(rng, orig_w: int, orig_h: int, input_size: int = 224,
                        short_side: int = 256, scales=MSC_SCALES, max_wh_scale_gap: int = 1,
                        num_fixed_crops: int = 13) -> tuple:
    """One clip's MultiScaleCrop (mmaction2's crop-box distribution and draw
    order, on the true resized geometry) folded with the final square resize
    into one anisotropic resize and a fixed crop.

    Returns ((resize_w, resize_h), (crop_x, crop_y), (ox, oy, crop_w, crop_h))
    with the last in the reference's resized coordinates."""
    rw, rh = resized_dims(orig_w, orig_h, short_side)
    base = min(rw, rh)
    crop_sizes = [int(base * s) for s in scales]
    candidates = [[cw, ch] for i, ch in enumerate(crop_sizes) for j, cw in enumerate(crop_sizes)
                  if abs(i - j) <= max_wh_scale_gap]
    crop_size = list(candidates[rng.integers(len(candidates))])
    for i in range(2):
        if abs(crop_size[i] - input_size) < 3:
            crop_size[i] = input_size
    crop_w, crop_h = crop_size
    offsets = _fixed_crop_offsets(rw, rh, crop_w, crop_h)[:num_fixed_crops]
    ox, oy = offsets[int(rng.integers(len(offsets)))]
    fx, fy = input_size / crop_w, input_size / crop_h
    return ((int(round(rw * fx)), int(round(rh * fy))), (int(round(ox * fx)), int(round(oy * fy))),
            (int(ox), int(oy), crop_w, crop_h))


def plan_bg_crop(rng, orig_w: int, orig_h: int, short_side: int, crop: int) -> tuple:
    """Uniform RandomCrop offsets over the valid range of the resized
    background (Resize(short) -> RandomCrop(crop))."""
    rw, rh = resized_dims(orig_w, orig_h, short_side)
    bx = int(rng.integers(0, max(rw - crop, 0) + 1))
    by = int(rng.integers(0, max(rh - crop, 0) + 1))
    return bx, by


def _pads_from_dims(dims: np.ndarray, crop: int, max_px: int) -> Tuple[int, int]:
    """'planes' pad dims: the smallest 16-multiple rectangle holding every
    source within ``max_px`` pixels, never smaller than the crop."""
    served = dims[:, 0].astype(np.int64) * dims[:, 1] <= max_px
    w_need = int(dims[served, 0].max()) if served.any() else crop
    h_need = int(dims[served, 1].max()) if served.any() else crop
    return max(crop, -(-w_need // 16) * 16), max(crop, -(-h_need // 16) * 16)


def _planes_wire_core(loader, all_paths, all_dims, all_crops, src, groups, crop):
    """The 'planes' wire of a batch: stored-resolution planes in the loader's
    pads, one taps set per group of consecutive same-geometry slots
    (``groups``: (slot_start, slot_count)), and slots the stored form cannot
    serve (not 4:2:0, unreadable or oversized, squash geometry, dims unlike
    the clip's probed dims) resized on the host at the pad origin with
    identity taps. Returns (y_all, c_all, taps_y (G, 6, crop), taps_c (G, 6,
    crop // 2))."""
    half = crop // 2
    pw, ph = _pads_from_dims(src, crop, loader.planes_max_px)
    loader._pad_w = max(loader._pad_w, pw)
    loader._pad_h = max(loader._pad_h, ph)
    pw, ph = loader._pad_w, loader._pad_h
    y_all, c_all, fdims = native.fetch_planes_batch(all_paths, pw, ph,
                                                    num_threads=loader.num_threads)
    g = len(groups)
    taps_y = np.empty((g, 6, crop), np.int32)
    taps_c = np.empty((g, 6, half), np.int32)
    fb_slots: List[int] = []

    def slot_ok(i):
        return fdims[i, 0] == src[i, 0] and fdims[i, 1] == src[i, 1] and fdims[i, 0] > 0

    for gi, (start, count) in enumerate(groups):
        sw, sh = int(src[start, 0]), int(src[start, 1])
        dw, dh = int(all_dims[start, 0]), int(all_dims[start, 1])
        cx, cy = all_crops[start]
        ty = plane_resize_taps(sw, sh, dw, dh, int(cx), int(cy), crop)
        tc = plane_resize_taps((sw + 1) // 2, (sh + 1) // 2, (dw + 1) // 2, (dh + 1) // 2,
                               int(cx) // 2, int(cy) // 2, half)
        slots = range(start, start + count)
        if ty is None or tc is None or not all(slot_ok(i) for i in slots):
            fb_slots.extend(slots)
            taps_y[gi] = identity_plane_taps(crop)
            taps_c[gi] = identity_plane_taps(half)
        else:
            taps_y[gi], taps_c[gi] = ty, tc

    if fb_slots:
        fy, fc = native.decode_yuv420_batch([all_paths[i] for i in fb_slots],
                                            all_dims[np.array(fb_slots)], crop,
                                            [all_crops[i] for i in fb_slots],
                                            num_threads=loader.num_threads)
        for k, i in enumerate(fb_slots):
            y_all[i][:] = 0
            y_all[i][:crop, :crop] = fy[k]
            c_all[i][:] = 0
            c_all[i][:half, :half] = fc[k]
    return y_all, c_all, taps_y, taps_c


def _parallel_ordered_iter(batches, make, num_workers: int, prefetch: int):
    """``make(*batches[i])`` from a small thread pool, yielded in order.
    Batch content is a pure function of its index tuple, so which worker
    makes it changes nothing; the pool overlaps one batch's numpy planning
    (which holds the GIL) with another's decode (which releases it). At most
    ``prefetch + num_workers`` batches are outstanding. A worker's exception
    is raised in the consumer; a consumer that stops early releases the
    workers."""
    num_workers = max(1, num_workers)
    tasks = iter(enumerate(batches))
    task_lock = threading.Lock()
    sem = threading.BoundedSemaphore(max(1, prefetch) + num_workers)
    cond = threading.Condition()
    results: Dict[int, object] = {}
    error: List[BaseException] = []
    stopping = [False]

    def worker():
        try:
            while True:
                sem.acquire()
                if stopping[0]:
                    return
                with task_lock:
                    try:
                        i, args = next(tasks)
                    except StopIteration:
                        sem.release()
                        return
                batch = make(*args) if isinstance(args, tuple) else make(args)
                with cond:
                    results[i] = batch
                    cond.notify_all()
        except BaseException as e:  # noqa: BLE001 -- raised again in the consumer
            with cond:
                error.append(e)
                cond.notify_all()

    threads = [threading.Thread(target=worker, daemon=True, name="bdvc-loader")
               for _ in range(num_workers)]
    for th in threads:
        th.start()
    try:
        for i in range(len(batches)):
            with cond:
                while i not in results and not error:
                    cond.wait(timeout=0.25)  # timed: signal handlers still run
                if error:
                    raise error[0]
                batch = results.pop(i)
            sem.release()
            yield batch
        for th in threads:
            th.join()
        if error:
            raise error[0]
    finally:
        stopping[0] = True
        for _ in threads:
            try:
                sem.release()
            except ValueError:  # the semaphore is full already
                break


class _EpochSpanMixin:
    """Epoch scheduling shared by the fast train loaders. ``__iter__`` yields
    one epoch; ``iter_epochs`` chains several epochs' batch lists through ONE
    worker pool, so the producer stays warm across epoch boundaries. Each
    work item carries its (indices, sample_weight, epoch), so chaining gives
    the same batches as iterating epoch by epoch."""

    def _init_common(self, batch_size, process_index, process_count, drop_last, pad_to_batch,
                     seed, shuffle, num_threads, prefetch, num_workers):
        self.batch_size = batch_size  # the global batch
        # the process group's rank and size unless given
        self.process_count = max(1, process_count or distributed.process_count())
        self.process_index = (distributed.process_index() if process_index is None
                              else process_index)
        if self.process_count > 1:
            if batch_size % self.process_count:
                raise ValueError(f"batch_size {batch_size} is not a multiple of "
                                 f"process_count {self.process_count}")
            pad_to_batch = pad_to_batch or not drop_last
        self.drop_last = drop_last
        self.pad_to_batch = pad_to_batch
        self.seed = seed
        self.shuffle = shuffle
        # the loader's workers share one decode budget
        self.num_threads = (num_threads if num_threads > 0
                            else native.default_threads(share=max(1, int(num_workers))))
        self.prefetch = prefetch
        self.num_workers = max(1, int(num_workers))
        self.epoch = 0
        self.sampler = SampleFrames(clip_len=1, frame_interval=1, num_clips=self.num_segments)
        # original (w, h) per frame_dir or background file, from JPEG headers
        self._dims: Dict[str, tuple] = {}
        self._pad_w = self._pad_h = 0  # 'planes' pads, fixed from the whole corpus
        self.planes_max_px = int(os.environ.get("BDVC_PLANES_MAX_PX", str(PLANES_MAX_PX)))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.video_infos)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _get_dims(self, keys_and_paths: List) -> None:
        """Probe the original dims of every (cache_key, jpeg_path) not seen yet."""
        todo = [(k, p) for k, p in keys_and_paths if k not in self._dims]
        if not todo:
            return
        dims = native.probe_dims_batch([p for _, p in todo], num_threads=self.num_threads)
        for (key, _), (w, h) in zip(todo, dims):
            self._dims[key] = (int(w), int(h))

    def _epoch_batches(self, epoch: int) -> List[tuple]:
        n = len(self.video_infos)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            rng.shuffle(indices)
        batches = [(indices[i: i + self.batch_size], None) for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1][0]) < self.batch_size:
            batches.pop()
        elif self.pad_to_batch and batches and len(batches[-1][0]) < self.batch_size:
            # wrap-pad the short tail; pad rows get sample_weight 0
            short = batches[-1][0]
            pad = indices[: self.batch_size - len(short)]
            while len(short) + len(pad) < self.batch_size:  # a corpus smaller than a batch
                pad = np.concatenate([pad, pad])[: self.batch_size - len(short)]
            batches[-1] = (np.concatenate([short, pad]), len(short))
        if self.pad_to_batch:
            batches = [(idxs, np.where(np.arange(len(idxs)) < (len(idxs) if nv is None else nv),
                                       np.float32(1), np.float32(0)))
                       for idxs, nv in batches]
        if self.process_count > 1:
            per = self.batch_size // self.process_count
            lo = self.process_index * per
            batches = [(idxs[lo: lo + per], None if w is None else w[lo: lo + per])
                       for idxs, w in batches]
        return [(idxs, w, epoch) for idxs, w in batches]

    def _prepare_iteration(self) -> None:
        """Fix the 'planes' pads on the calling thread before the workers
        start, from the whole corpus (one header per video, frames share
        dims, plus ``_pad_extra_files``): the pads, and so the batch shapes,
        are a pure function of the dataset, whatever the worker count."""
        if self.wire_format != "planes" or self._pad_w:
            return
        probe = [(info["frame_dir"],
                  osp.join(info["frame_dir"], self.filename_tmpl.format(self.start_index)))
                 for info in self.video_infos] + [(p, p) for p in self._pad_extra_files()]
        self._get_dims(probe)
        dims = np.array([self._dims[k] for k, _ in probe], np.int64).reshape(-1, 2)
        self._pad_w, self._pad_h = _pads_from_dims(dims, self.crop_size, self.planes_max_px)

    def _pad_extra_files(self) -> Sequence[str]:
        return ()

    def _with_draws(self, out: Dict, keys: np.ndarray, weights) -> Dict[str, np.ndarray]:
        """The finished batch: RandAugment draws from the keys, sample_weight
        when padding."""
        out.update(randaug_draws_from_keys(keys, self.randaug_n, self.crop_size, self.crop_size))
        if weights is not None:
            out["sample_weight"] = weights
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._prepare_iteration()
        yield from _parallel_ordered_iter(self._epoch_batches(self.epoch), self._make_batch,
                                          self.num_workers, self.prefetch)

    def iter_epochs(self, first_epoch: int, num_epochs: int) -> Iterator[Dict[str, np.ndarray]]:
        """``num_epochs`` epochs from ``first_epoch`` through one producer
        stream; ``len(self)`` batches per epoch."""
        self._prepare_iteration()
        work = [item for e in range(first_epoch, first_epoch + num_epochs)
                for item in self._epoch_batches(e)]
        yield from _parallel_ordered_iter(work, self._make_batch, self.num_workers, self.prefetch)


class FastBGMixLoader(_EpochSpanMixin):
    """uint8 wire batches over a BackgroundMixDataset-shaped corpus: a clip of
    ``num_segments`` frames per video (MultiScaleCrop geometry, one decode
    call for frames and backgrounds), a background crop per clip, and the
    per-clip masks: RandAugment with probability ``randaug_prob`` and BGMix on
    the complement (the reference's mutex), whole-clip flip with
    ``flip_ratio``. With an empty ``bg_files`` no background is decoded or
    shipped (``make_fast_input_fn(with_bgmix=False)``)."""

    def __init__(
        self,
        video_infos: Sequence[dict],
        bg_files: Sequence[str],
        batch_size: int,
        num_segments: int = 8,
        crop_size: int = 224,
        short_side: int = None,  # the train Resize(-1, S); default crop / 0.875
        msc_scales=MSC_SCALES,
        bg_short_side: int = 256,
        filename_tmpl: str = "img_{:05}.jpg",
        start_index: int = 1,
        randaug_prob: float = 0.75,  # BGMix fires on the complement
        bgmix_prob: float = 0.25,  # used without the mutex
        with_randaug_mutex: bool = True,
        flip_ratio: float = 0.0,  # the reference train pipeline has no Flip
        shuffle: bool = True,
        seed: int = 0,
        num_threads: int = 0,
        drop_last: bool = True,
        pad_to_batch: bool = False,  # wrap-pad the tail; emits sample_weight
        prefetch: int = 2,
        num_workers: int = 1,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        wire_format: str = "rgb",  # 'rgb' | 'yuv420' | 'planes' | 'auto'
        randaug_n: int = 2,  # the input function's ops per clip
    ):
        _require_native()
        self.wire_format = resolve_wire_format(wire_format, crop_size)
        self.video_infos = list(video_infos)
        self.bg_files = list(bg_files)
        self.num_segments = num_segments
        self.crop_size = crop_size
        # reference configs pair MultiScaleCrop(input) with Resize(-1, S), input/S = 0.875
        self.short_side = short_side or int(round(crop_size / 0.875))
        self.msc_scales = tuple(msc_scales)
        self.bg_short_side = bg_short_side
        self.filename_tmpl = filename_tmpl
        self.start_index = start_index
        self.randaug_prob = randaug_prob
        self.bgmix_prob = bgmix_prob
        self.with_randaug_mutex = with_randaug_mutex
        self.flip_ratio = flip_ratio
        self.randaug_n = randaug_n
        self._init_common(batch_size, process_index, process_count, drop_last, pad_to_batch,
                          seed, shuffle, num_threads, prefetch, num_workers)

    def _pad_extra_files(self) -> Sequence[str]:
        return self.bg_files

    def _make_planes_wire(self, b, t, crop, indices, all_paths, all_dims, all_crops,
                          with_bg=True):
        """'planes' wire of the clips (and the backgrounds, one slot each)."""
        n = b * t + (b if with_bg else 0)
        src = np.empty((n, 2), np.int32)
        for row, idx in enumerate(indices):
            src[row * t: (row + 1) * t] = self._dims[self.video_infos[int(idx)]["frame_dir"]]
        groups = [(row * t, t) for row in range(b)]
        if with_bg:
            for row in range(b):
                src[b * t + row] = self._dims[all_paths[b * t + row]]
            groups += [(b * t + row, 1) for row in range(b)]
        y_all, c_all, taps_y, taps_c = _planes_wire_core(self, all_paths, all_dims, all_crops,
                                                         src, groups, crop)
        pw, ph = self._pad_w, self._pad_h
        pixels = {"imgs_y": y_all[: b * t].reshape(b, t, ph, pw),
                  "imgs_c": c_all[: b * t].reshape(b, t, ph // 2, pw // 2, 2),
                  "imgs_taps_y": taps_y[:b], "imgs_taps_c": taps_c[:b]}
        if with_bg:
            pixels.update(bg_y=y_all[b * t:], bg_c=c_all[b * t:], bg_taps_y=taps_y[b:],
                          bg_taps_c=taps_c[b:])
        return pixels

    def _make_batch(self, indices: np.ndarray, weights: np.ndarray = None,
                    epoch: int = None) -> Dict[str, np.ndarray]:
        epoch = self.epoch if epoch is None else int(epoch)
        profile = _producer_profiling_enabled()
        if profile:
            t_start = time.perf_counter()
        b, t, crop = len(indices), self.num_segments, self.crop_size
        no_bg = not self.bg_files
        frame_paths: List[str] = []
        crops: List = []
        resize_dims = np.empty((b * t, 2), np.int32)
        labels = np.empty((b, 1), np.int64)
        flip = np.empty(b, bool)
        apply_bgmix = np.empty(b, bool)
        apply_randaug = np.zeros(b, bool)
        randaug_keys = np.empty((b, 2), np.uint32)
        bg_paths: List[str] = []
        bg_crops: List = []

        # pass 1: per-clip decisions and frames; one header probe for all
        rngs, row_frame_inds, probe = [], [], []
        for row, idx in enumerate(indices):
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, int(idx), 7]))
            rngs.append(rng)
            info = self.video_infos[int(idx)]
            labels[row, 0] = info["label"]
            flip[row] = rng.random() < self.flip_ratio
            randaug_keys[row] = rng.integers(0, 2**32, size=2, dtype=np.uint32)
            if self.with_randaug_mutex:
                # randaug_prob < 0: RandAugment never, BGMix always; >= 1: the reverse
                fires = self.randaug_prob >= 0 and rng.random() < self.randaug_prob
                apply_randaug[row] = fires
                apply_bgmix[row] = not fires
            else:
                apply_randaug[row] = self.randaug_prob >= 0 and rng.random() < self.randaug_prob
                apply_bgmix[row] = rng.random() < self.bgmix_prob
            frame_inds = self.sampler.sample(info["total_frames"], rng) + self.start_index
            row_frame_inds.append(frame_inds)
            probe.append((info["frame_dir"],
                          osp.join(info["frame_dir"], self.filename_tmpl.format(int(frame_inds[0])))))
            if no_bg:
                apply_bgmix[row] = False
                continue
            if apply_bgmix[row]:
                bg_path = self.bg_files[int(rng.integers(len(self.bg_files)))]
            else:  # a placeholder, never blended: a frame of this clip keeps the shapes static
                bg_path = probe[-1][1]
            bg_paths.append(bg_path)
            probe.append((bg_path, bg_path))
        if profile:
            t_pass1 = time.perf_counter()
        self._get_dims(probe)
        if profile:
            t_probe = time.perf_counter()

        # pass 2: each clip's crop geometry on its true resized dims
        for row, idx in enumerate(indices):
            rng = rngs[row]
            info = self.video_infos[int(idx)]
            vw, vh = self._dims[info["frame_dir"]]
            (rw, rh), (ox, oy), _ = plan_train_geometry(
                rng, vw, vh, input_size=crop, short_side=self.short_side, scales=self.msc_scales)
            for k, fi in enumerate(row_frame_inds[row]):
                frame_paths.append(osp.join(info["frame_dir"], self.filename_tmpl.format(int(fi))))
                crops.append((ox, oy))
                resize_dims[row * t + k] = (rw, rh)
            if not no_bg:
                bw, bh = self._dims[bg_paths[row]]
                bg_crops.append(plan_bg_crop(rng, bw, bh, self.bg_short_side, crop))

        # one decode call for frames and backgrounds (the bg short-side resize
        # expressed as explicit dims)
        bg_dims = np.array([resized_dims(*self._dims[p], self.bg_short_side) for p in bg_paths],
                           np.int32).reshape(-1, 2)
        if profile:
            t_plan = time.perf_counter()
        all_paths = frame_paths + bg_paths
        all_dims = np.concatenate([resize_dims, bg_dims])
        all_crops = crops + bg_crops
        if self.wire_format == "planes":
            pixels = self._make_planes_wire(b, t, crop, indices, all_paths, all_dims, all_crops,
                                            with_bg=not no_bg)
        elif self.wire_format == "yuv420":
            y, c = native.decode_yuv420_batch(all_paths, all_dims, crop, all_crops,
                                              num_threads=self.num_threads)
            half = crop // 2
            pixels = {"imgs_y": y[: b * t].reshape(b, t, crop, crop),
                      "imgs_c": c[: b * t].reshape(b, t, half, half, 2)}
            if not no_bg:
                pixels.update(bg_y=y[b * t:], bg_c=c[b * t:])
        else:
            dec = native.decode_resize2_crop_batch(all_paths, all_dims, out_h=crop, out_w=crop,
                                                   crops=all_crops, num_threads=self.num_threads)
            pixels = {"imgs_u8": dec[: b * t].reshape(b, t, crop, crop, 3)}
            if not no_bg:
                pixels["bg_u8"] = dec[b * t:]
        if profile:
            _record_producer_phases(pass1=t_pass1 - t_start, probe=t_probe - t_pass1,
                                    pass2=t_plan - t_probe, decode=time.perf_counter() - t_plan)
        out = {**pixels, "apply_bgmix": apply_bgmix, "apply_randaug": apply_randaug,
               "flip": flip, "label": labels}
        return self._with_draws(out, randaug_keys, weights)


def transform_acm_boxes(dets: np.ndarray, orig_w: int, orig_h: int, short_side: int,
                        out_size: int, flip: bool) -> np.ndarray:
    """(N, 4) float boxes through the reference ActorCutMix geometry:
    ResizeWithBox(-1, short) -> FlipWithBox -> ResizeWithBox((out, out),
    keep_ratio=False), each stage a float32 multiply and clip."""
    cur = np.asarray(dets, dtype=np.float32).reshape(-1, 4).copy()
    rw, rh = resized_dims(orig_w, orig_h, short_side)
    s1 = np.array([rw / orig_w, rh / orig_h], dtype=np.float32)
    cur[:, 0::2] = np.clip(cur[:, 0::2] * s1[0], 0, rw)
    cur[:, 1::2] = np.clip(cur[:, 1::2] * s1[1], 0, rh)
    if flip:
        x0 = rw - cur[:, 2].copy()
        cur[:, 2] = rw - cur[:, 0]
        cur[:, 0] = x0
    s2 = np.array([out_size / rw, out_size / rh], dtype=np.float32)
    cur[:, 0::2] = np.clip(cur[:, 0::2] * s2[0], 0, out_size)
    cur[:, 1::2] = np.clip(cur[:, 1::2] * s2[1], 0, out_size)
    return cur


def _rasterized_union_area(boxes: np.ndarray, h: int, w: int) -> int:
    """Pixels in the union of int-truncated half-open boxes (the rasterization
    of ``ops.augment.boxes_union_mask``)."""
    mask = np.zeros((h, w), dtype=bool)
    for x0, y0, x1, y1 in boxes.astype(int):
        mask[y0:y1, x0:x1] = True
    return int(mask.sum())


class FastACMLoader(_EpochSpanMixin):
    """uint8 wire batches over an ActorCutMixDataset-shaped corpus. With
    probability ``acm_prob`` a row is the ActorCutMix composite of its clip
    (decoded straight to the output square, boxes carried through
    ``transform_acm_boxes``) with a random scene clip; otherwise the clip
    goes through the MultiScaleCrop plan and RandAugment. Scene-less rows
    ship zeros, masked out on the device (``make_fast_acm_input_fn``)."""

    def __init__(
        self,
        video_infos: Sequence[dict],
        batch_size: int,
        num_segments: int = 8,
        crop_size: int = 224,
        short_side: int = 256,
        msc_scales=MSC_SCALES,
        det_thres: float = 0.4,
        acm_prob: float = 1.0,
        flip_ratio: float = 0.5,
        max_boxes: int = None,  # None: the corpus's densest frame
        filename_tmpl: str = "img_{:05}.jpg",
        start_index: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        num_threads: int = 0,
        drop_last: bool = True,
        pad_to_batch: bool = False,
        prefetch: int = 2,
        num_workers: int = 1,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        wire_format: str = "rgb",  # 'rgb' | 'yuv420' | 'planes' | 'auto'
        randaug_n: int = 2,
    ):
        _require_native()
        self.wire_format = resolve_wire_format(wire_format, crop_size)
        self.video_infos = list(video_infos)
        self.num_segments = num_segments
        self.crop_size = crop_size
        self.short_side = short_side
        self.msc_scales = tuple(msc_scales)
        self.det_thres = det_thres
        self.acm_prob = acm_prob
        self.flip_ratio = flip_ratio
        if max_boxes is None:
            # a fixed K for the device mask that truncates no real detection
            max_boxes = 1
            for info in self.video_infos:
                all_dets = info.get("all_detections") or {}
                frames = all_dets.values() if hasattr(all_dets, "values") else all_dets
                for dets in frames:
                    if len(dets):
                        d = np.asarray(dets, np.float32).reshape(-1, 5)
                        max_boxes = max(max_boxes, int((d[:, -1] > det_thres).sum()))
        self.max_boxes = max_boxes
        self.filename_tmpl = filename_tmpl
        self.start_index = start_index
        self.randaug_n = randaug_n
        self._init_common(batch_size, process_index, process_count, drop_last, pad_to_batch,
                          seed, shuffle, num_threads, prefetch, num_workers)

    def _clip_dets(self, info: dict, frame_inds) -> List[np.ndarray]:
        """Thresholded (N, 4) boxes per sampled frame (DetectionLoad)."""
        out = []
        all_dets = info.get("all_detections")
        for fi in frame_inds:
            cur = all_dets[int(fi)] if all_dets is not None else []
            cur = (np.asarray(cur, dtype=np.float32).reshape(-1, 5) if len(cur)
                   else np.zeros((0, 5), np.float32))
            out.append(cur[cur[:, -1] > self.det_thres, :4].copy())
        return out

    def _clip_boxes(self, dets, w, h, flip) -> np.ndarray:
        """(T, K, 4) boxes of one clip in output coordinates, zero-padded."""
        t, k, crop = self.num_segments, self.max_boxes, self.crop_size
        out = np.zeros((t, k, 4), np.float32)
        for fi, d in enumerate(dets):
            boxes = transform_acm_boxes(d, w, h, self.short_side, crop, flip)
            m = min(len(boxes), k)
            out[fi, :m] = boxes[:m]
        return out

    def _make_batch(self, indices: np.ndarray, weights: np.ndarray = None,
                    epoch: int = None) -> Dict[str, np.ndarray]:
        epoch = self.epoch if epoch is None else int(epoch)
        b, t, crop = len(indices), self.num_segments, self.crop_size
        k = self.max_boxes
        labels = np.empty((b, 1), np.int64)
        bg_labels = np.full((b, 1), -1, np.int64)
        fg_ratio = np.ones(b, np.float32)
        apply_acm = np.zeros(b, bool)
        actor_flip = np.zeros(b, bool)
        scene_flip = np.zeros(b, bool)
        actor_full_mask = np.zeros(b, bool)
        randaug_keys = np.zeros((b, 2), np.uint32)
        actor_boxes = np.zeros((b, t, k, 4), np.float32)
        scene_boxes = np.zeros((b, t, k, 4), np.float32)

        rows = []  # (row, info, frame_inds, rng, scene_info | None, scene_frame_inds | None)
        probe: List = []
        for row, idx in enumerate(indices):
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, int(idx), 9]))
            info = self.video_infos[int(idx)]
            labels[row, 0] = info["label"]
            fire = rng.random() < self.acm_prob
            apply_acm[row] = fire
            frame_inds = self.sampler.sample(info["total_frames"], rng) + self.start_index
            probe.append((info["frame_dir"],
                          osp.join(info["frame_dir"], self.filename_tmpl.format(int(frame_inds[0])))))
            scene_info = scene_frame_inds = None
            if fire:
                actor_flip[row] = rng.random() < self.flip_ratio
                scene_info = self.video_infos[int(rng.integers(len(self.video_infos)))]
                scene_frame_inds = (self.sampler.sample(scene_info["total_frames"], rng)
                                    + self.start_index)
                scene_flip[row] = rng.random() < self.flip_ratio
                bg_labels[row, 0] = scene_info["label"]
                probe.append((scene_info["frame_dir"], osp.join(
                    scene_info["frame_dir"], self.filename_tmpl.format(int(scene_frame_inds[0])))))
            # drawn last, so the draws above keep their values
            randaug_keys[row] = rng.integers(0, 2**32, size=2, dtype=np.uint32)
            rows.append((row, info, frame_inds, rng, scene_info, scene_frame_inds))
        self._get_dims(probe)

        frame_paths: List[str] = []
        crops: List = []
        resize_dims = np.empty((b * t, 2), np.int32)
        scene_rows: List = []  # (row, paths) for the scene decode
        scene_src: List = []  # probed (w, h) per scene row ('planes' wire)
        for row, info, frame_inds, rng, scene_info, scene_frame_inds in rows:
            vw, vh = self._dims[info["frame_dir"]]
            if apply_acm[row]:
                # Resize(-1, S) -> Resize((crop, crop)) is one direct resize
                rdims, off = (crop, crop), (0, 0)
                dets = self._clip_dets(info, frame_inds)
                n_dets = sum(len(d) for d in dets)
                actor_full_mask[row] = n_dets == 0
                tb = self._clip_boxes(dets, vw, vh, bool(actor_flip[row]))
                actor_boxes[row] = tb
                if n_dets:  # else the all-ones mask: ratio 1
                    area = sum(_rasterized_union_area(tb[fi, : min(len(dets[fi]), k)], crop, crop)
                               for fi in range(t))
                    fg_ratio[row] = area / float(t * crop * crop)
                sw, sh = self._dims[scene_info["frame_dir"]]
                scene_boxes[row] = self._clip_boxes(self._clip_dets(scene_info, scene_frame_inds),
                                                    sw, sh, bool(scene_flip[row]))
                scene_rows.append((row, [
                    osp.join(scene_info["frame_dir"], self.filename_tmpl.format(int(fi)))
                    for fi in scene_frame_inds]))
                scene_src.append((sw, sh))
            else:
                rdims, off, _ = plan_train_geometry(rng, vw, vh, input_size=crop,
                                                    short_side=self.short_side,
                                                    scales=self.msc_scales)
            for j, fi in enumerate(frame_inds):
                frame_paths.append(osp.join(info["frame_dir"], self.filename_tmpl.format(int(fi))))
                crops.append(off)
                resize_dims[row * t + j] = rdims

        # one decode call for actor and scene frames (scenes after the b*t frames)
        spaths = [p for _, paths in scene_rows for p in paths]
        all_paths = frame_paths + spaths
        all_dims = np.concatenate(
            [resize_dims, np.tile(np.array([crop, crop], np.int32), (len(spaths), 1))])
        all_crops = crops + [(0, 0)] * len(spaths)
        half = crop // 2
        if self.wire_format == "planes":
            n_scene = len(scene_rows)
            src = np.empty((b * t + n_scene * t, 2), np.int32)
            for row, idx in enumerate(indices):
                src[row * t: (row + 1) * t] = self._dims[self.video_infos[int(idx)]["frame_dir"]]
            for i, (sw, sh) in enumerate(scene_src):
                src[b * t + i * t: b * t + (i + 1) * t] = (sw, sh)
            groups = ([(row * t, t) for row in range(b)]
                      + [(b * t + i * t, t) for i in range(n_scene)])
            y_all, c_all, taps_y, taps_c = _planes_wire_core(self, all_paths, all_dims, all_crops,
                                                             src, groups, crop)
            pw, ph = self._pad_w, self._pad_h
            scene_y = np.zeros((b, t, ph, pw), np.uint8)
            scene_c = np.zeros((b, t, ph // 2, pw // 2, 2), np.uint8)
            scene_ty = np.tile(identity_plane_taps(crop)[None], (b, 1, 1))
            scene_tc = np.tile(identity_plane_taps(half)[None], (b, 1, 1))
            if n_scene:
                sy = y_all[b * t:].reshape(n_scene, t, ph, pw)
                sc = c_all[b * t:].reshape(n_scene, t, ph // 2, pw // 2, 2)
                for i, (row, _) in enumerate(scene_rows):
                    scene_y[row], scene_c[row] = sy[i], sc[i]
                    scene_ty[row], scene_tc[row] = taps_y[b + i], taps_c[b + i]
            pixels = {"imgs_y": y_all[: b * t].reshape(b, t, ph, pw),
                      "imgs_c": c_all[: b * t].reshape(b, t, ph // 2, pw // 2, 2),
                      "imgs_taps_y": taps_y[:b], "imgs_taps_c": taps_c[:b],
                      "scene_y": scene_y, "scene_c": scene_c,
                      "scene_taps_y": scene_ty, "scene_taps_c": scene_tc}
        elif self.wire_format == "yuv420":
            y, c = native.decode_yuv420_batch(all_paths, all_dims, crop, all_crops,
                                              num_threads=self.num_threads)
            scene_y = np.zeros((b, t, crop, crop), np.uint8)
            scene_c = np.zeros((b, t, half, half, 2), np.uint8)
            if scene_rows:
                sy = y[b * t:].reshape(len(scene_rows), t, crop, crop)
                sc = c[b * t:].reshape(len(scene_rows), t, half, half, 2)
                for i, (row, _) in enumerate(scene_rows):
                    scene_y[row], scene_c[row] = sy[i], sc[i]
            pixels = {"imgs_y": y[: b * t].reshape(b, t, crop, crop),
                      "imgs_c": c[: b * t].reshape(b, t, half, half, 2),
                      "scene_y": scene_y, "scene_c": scene_c}
        else:
            dec = native.decode_resize2_crop_batch(all_paths, all_dims, out_h=crop, out_w=crop,
                                                   crops=all_crops, num_threads=self.num_threads)
            imgs = dec[: b * t].reshape(b, t, crop, crop, 3)
            scene = np.zeros_like(imgs)
            if scene_rows:
                sdec = dec[b * t:].reshape(len(scene_rows), t, crop, crop, 3)
                for i, (row, _) in enumerate(scene_rows):
                    scene[row] = sdec[i]
            pixels = {"imgs_u8": imgs, "scene_u8": scene}

        out = {**pixels, "actor_boxes": actor_boxes, "scene_boxes": scene_boxes,
               "actor_full_mask": actor_full_mask, "apply_acm": apply_acm,
               "apply_randaug": ~apply_acm, "actor_flip": actor_flip, "scene_flip": scene_flip,
               "label": labels, "foreground_ratio": fg_ratio, "background_label": bg_labels}
        return self._with_draws(out, randaug_keys, weights)


class FastEvalLoader:
    """Deterministic uint8 eval batches from the native decoder, in dataset
    order (the port of ``bdvcil_tpu/data/device_pipeline.py:595``).

    The test-mode chain SampleFrames -> decode -> Resize(-1, S) ->
    CenterCrop(c) | TenCrop(c) runs on the host into uint8; the eval step
    normalizes (and adds TenCrop's flips) on the device. Wire formats:

      'rgb'          {'imgs': (B, T, c, c, 3) u8, or (B, T, 5, c, c, 3) for
                     TenCrop, 'label': (B, 1)}
      'yuv420_full'  each frame resized once into padded planes, imgs_y (B, T,
                     ph, pw), imgs_c (B, T, ph/2, pw/2, 2), and the crop
                     offsets crop_yx_<c> (B, K, 2) (y, x), K = 1 or 5; the
                     crops, flips and YCbCr -> RGB run on the device
                     (``ops.augment.eval_yuv_full_crops``)
      'auto'         'yuv420_full' for TenCrop, else 'rgb' (the JAX choice)

    Raises when the native decoder is unavailable, as JAX's does: the caller
    takes the host pipeline then. Under a process group each rank decodes its
    rows of every global batch, the global order padded to whole batches
    (``num_valid`` rows are real).
    """

    def __init__(self, video_infos: Sequence[dict], batch_size: int, num_segments: int = 8,
                 crop_size: int = 224, short_side: int = 256,
                 filename_tmpl: str = "img_{:05}.jpg", start_index: int = 1,
                 num_threads: int = 0, prefetch: int = 2, num_workers: int = 1,
                 tencrop: bool = False, process_index: int = None, process_count: int = None,
                 wire_format: str = "rgb"):
        _require_native()
        if wire_format == "auto":
            wire_format = "yuv420_full" if (tencrop and native.has_yuv420_full()) else "rgb"
        if wire_format not in ("rgb", "yuv420_full"):
            raise ValueError(f"unknown eval wire_format {wire_format!r}")
        self.wire_format = wire_format
        self._dims: Dict[str, tuple] = {}
        self._pad_w = self._pad_h = 0
        self.video_infos = list(video_infos)
        self.batch_size = batch_size  # the global batch
        self.process_count = max(1, process_count or distributed.process_count())
        self.process_index = (distributed.process_index() if process_index is None
                              else process_index)
        if self.process_count > 1 and batch_size % self.process_count:
            raise ValueError(f"batch_size {batch_size} is not a multiple of "
                             f"process_count {self.process_count}")
        self.num_segments = num_segments
        self.crop_size = crop_size
        self.short_side = short_side
        self.filename_tmpl = filename_tmpl
        self.start_index = start_index
        self.num_threads = (num_threads if num_threads > 0
                            else native.default_threads(share=max(1, int(num_workers))))
        self.prefetch = prefetch
        self.num_workers = max(1, int(num_workers))
        self.tencrop = tencrop
        self.sampler = SampleFrames(clip_len=1, frame_interval=1, num_clips=num_segments,
                                    test_mode=True)

    def set_epoch(self, epoch: int) -> None:
        pass  # deterministic

    def __len__(self) -> int:
        return -(-len(self.video_infos) // self.batch_size)

    @property
    def num_valid(self) -> int:
        """The dataset-order rows that are real (multi-process batches pad)."""
        return len(self.video_infos)

    def _video_geometry(self, frame_dir: str) -> Tuple[int, int]:
        """(rw, rh), the short-side resized dims, at least the crop on both
        axes, as the decoder's TenCrop clamps them."""
        w, h = self._dims[frame_dir]
        rw, rh = resized_dims(w, h, self.short_side)
        return max(rw, self.crop_size), max(rh, self.crop_size)

    def _crop_offsets(self, rw: int, rh: int) -> np.ndarray:
        """(K, 2) int32 (y, x) luma offsets: the 5 FiveCrop positions or the centre."""
        crop = self.crop_size
        if self.tencrop:
            ws, hs = (rw - crop) // 4, (rh - crop) // 4
            return np.array([(0, 0), (0, 4 * ws), (4 * hs, 0), (4 * hs, 4 * ws),
                             (2 * hs, 2 * ws)], np.int32)
        return np.array([((rh - crop) // 2, (rw - crop) // 2)], np.int32)

    def _prepare_yuv_full(self) -> None:
        """Fix the padded plane dims from the whole corpus (one header probe
        per video) before the workers start, so every batch has one shape."""
        if self.wire_format != "yuv420_full" or self._pad_w:
            return
        todo = [(info["frame_dir"],
                 osp.join(info["frame_dir"], self.filename_tmpl.format(self.start_index)))
                for info in self.video_infos if info["frame_dir"] not in self._dims]
        if todo:
            dims = native.probe_dims_batch([p for _, p in todo], num_threads=self.num_threads)
            for (key, _), (w, h) in zip(todo, dims):
                self._dims[key] = (int(w), int(h))
        geo = np.array([self._video_geometry(info["frame_dir"]) for info in self.video_infos],
                       np.int64).reshape(-1, 2)
        self._pad_w = -(-int(geo[:, 0].max()) // 16) * 16
        self._pad_h = -(-int(geo[:, 1].max()) // 16) * 16

    def _make_batch(self, indices) -> Dict[str, np.ndarray]:
        t, crop = self.num_segments, self.crop_size
        frame_paths: List[str] = []
        labels = np.empty((len(indices), 1), np.int64)
        rows = []
        for row, idx in enumerate(indices):
            info = self.video_infos[int(idx)]
            rows.append(info)
            labels[row, 0] = info["label"]
            for fi in self.sampler.sample(info["total_frames"]) + self.start_index:
                frame_paths.append(osp.join(info["frame_dir"], self.filename_tmpl.format(int(fi))))
        b = len(indices)
        if self.wire_format == "yuv420_full":
            geos = [self._video_geometry(info["frame_dir"]) for info in rows]
            dims = np.repeat(np.array(geos, np.int32), t, axis=0)
            y, c = native.decode_yuv420_full_batch(frame_paths, dims, self._pad_w, self._pad_h,
                                                   num_threads=self.num_threads)
            return {
                "imgs_y": y.reshape(b, t, self._pad_h, self._pad_w),
                "imgs_c": c.reshape(b, t, self._pad_h // 2, self._pad_w // 2, 2),
                # the crop size rides in the key, as in the JAX wire
                f"crop_yx_{crop}": np.stack([self._crop_offsets(rw, rh) for rw, rh in geos]),
                "label": labels,
            }
        if self.tencrop:
            imgs = native.decode_tencrop_batch(frame_paths, short_side=self.short_side,
                                               crop=crop, num_threads=self.num_threads)
            return {"imgs": imgs.reshape(b, t, 5, crop, crop, 3), "label": labels}
        imgs = native.decode_resize_crop_batch(frame_paths, short_side=self.short_side,
                                               out_h=crop, out_w=crop, crops=None,
                                               num_threads=self.num_threads)
        return {"imgs": imgs.reshape(b, t, crop, crop, 3), "label": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._prepare_yuv_full()
        n = len(self.video_infos)
        if self.process_count > 1:
            # pad the global order to whole batches (run_inference trims by
            # num_valid) and take this process's rows of each
            total = -(-n // self.batch_size) * self.batch_size
            idx = np.concatenate([np.arange(n), np.full(total - n, n - 1, np.int64)])
            per = self.batch_size // self.process_count
            lo = self.process_index * per
            batches = [b[lo:lo + per] for b in idx.reshape(-1, self.batch_size)]
        else:
            batches = [np.arange(n)[i:i + self.batch_size] for i in range(0, n, self.batch_size)]
        yield from _parallel_ordered_iter(batches, self._make_batch, self.num_workers,
                                          self.prefetch)
