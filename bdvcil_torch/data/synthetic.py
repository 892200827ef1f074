"""Synthetic wire batches in the layout of ``device_pipeline`` (numpy, from a
seed), for the tests, ``chip_smoke.py`` and rehearsals without a corpus, and
``SyntheticWireLoader``, a loader of them.

Pixels are smooth-ish clips (a per-clip base colour plus bounded noise, so
AutoContrast and Equalize have real work). The 'planes' wire ships stored
planes of ``stored`` = (width, height) (default 320 x 240, UCF101's frames)
padded to multiples of 16, with taps at a MultiScaleCrop-like geometry per
clip: a square window of side short_side x scale, scale in (1, .875, .75,
.66), resized to the crop, at a random offset.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.rand_augment_dev import draw_randaug
from .device_pipeline import identity_plane_taps, plane_resize_taps

MSC_SCALES = (1.0, 0.875, 0.75, 0.66)


def _pixels(rng, shape) -> np.ndarray:
    """uint8 (B, ..., C or plane) with a per-row base level and noise of 64."""
    base = rng.integers(0, 192, size=(shape[0],) + (1,) * (len(shape) - 1))
    return (base + rng.integers(0, 64, size=shape)).astype(np.uint8)


def _msc_taps(rng, sw: int, sh: int, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(taps_y (6, size), taps_c (6, size/2)) of one clip's random crop."""
    half = size // 2
    side = int(min(sw, sh) * MSC_SCALES[int(rng.integers(len(MSC_SCALES)))])
    dw, dh = int(round(sw * size / side)), int(round(sh * size / side))
    cx, cy = int(rng.integers(0, dw - size + 1)), int(rng.integers(0, dh - size + 1))
    ty = plane_resize_taps(sw, sh, dw, dh, cx, cy, size)
    tc = plane_resize_taps((sw + 1) // 2, (sh + 1) // 2, (dw + 1) // 2, (dh + 1) // 2,
                           cx // 2, cy // 2, half)
    if ty is None or tc is None:
        return identity_plane_taps(size), identity_plane_taps(half)
    return ty, tc


def _stream(rng, prefix: str, wire_format: str, lead: Tuple[int, ...], size: int,
            stored: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """One pixel stream (imgs, bg or scene) of ``lead`` = (B, T) or (B,)."""
    half = size // 2
    if wire_format == "rgb":
        return {f"{prefix}_u8": _pixels(rng, lead + (size, size, 3))}
    if wire_format == "yuv420":
        return {f"{prefix}_y": _pixels(rng, lead + (size, size)),
                f"{prefix}_c": _pixels(rng, lead + (half, half, 2))}
    sw, sh = stored
    wp, hp = -(-sw // 16) * 16, -(-sh // 16) * 16
    taps = [_msc_taps(rng, sw, sh, size) for _ in range(lead[0])]
    return {f"{prefix}_y": _pixels(rng, lead + (hp, wp)),
            f"{prefix}_c": _pixels(rng, lead + (hp // 2, wp // 2, 2)),
            f"{prefix}_taps_y": np.stack([t[0] for t in taps]).astype(np.int32),
            f"{prefix}_taps_c": np.stack([t[1] for t in taps]).astype(np.int32)}


def _boxes(rng, b: int, t: int, size: int) -> np.ndarray:
    """(B, T, 3, 4) f32 boxes in output coordinates, the last one padding."""
    x0, y0 = rng.uniform(0, size * 0.8, size=(2, b, t, 3))
    w, h = rng.uniform(size * 0.05, size * 0.5, size=(2, b, t, 3))
    boxes = np.stack([x0, y0, np.minimum(x0 + w, size), np.minimum(y0 + h, size)], -1)
    boxes[:, :, -1] = 0.0
    return boxes.astype(np.float32)


def wire_batch(wire_format: str, b: int, t: int, size: int, seed: int = 0,
               stored: Tuple[int, int] = (320, 240), with_bg: bool = True,
               acm: bool = False) -> Dict[str, np.ndarray]:
    """A wire batch of ``b`` clips of ``t`` frames at crop ``size``.

    BGMix (``acm=False``): apply_randaug with probability 0.75 (the
    reference's p, bench.py:572) and apply_bgmix = ~apply_randaug, the
    loaders' mutex (none without ``with_bg``); flip with probability 1/2.
    ActorCutMix (``acm=True``): apply_acm with probability 1/2, apply_randaug
    = ~apply_acm, boxes, flips,
    background labels and foreground ratios. The RandAugment draws (n = 2
    ops per clip) come from a CPU generator seeded with ``seed``; the masks
    and the draws do not depend on the wire format.
    """
    rng = np.random.default_rng([seed, 0])  # pixels and taps
    out = _stream(rng, "imgs", wire_format, (b, t), size, stored)
    if acm:
        out.update(_stream(rng, "scene", wire_format, (b, t), size, stored))
    elif with_bg:
        out.update(_stream(rng, "bg", wire_format, (b,), size, stored))
    out.update(wire_masks(b, t, size, seed, with_bg, acm))
    return out


def wire_masks(b: int, t: int, size: int, seed: int = 0, with_bg: bool = True,
               acm: bool = False) -> Dict[str, np.ndarray]:
    """The keys of ``wire_batch`` other than the pixels: masks, labels (and
    the ActorCutMix fields), the RandAugment draws."""
    out: Dict[str, np.ndarray] = {}
    rng = np.random.default_rng([seed, 1])  # masks and labels: the same for every wire format
    if acm:
        apply_acm = rng.random(b) < 0.5
        out.update(
            actor_boxes=_boxes(rng, b, t, size),
            scene_boxes=_boxes(rng, b, t, size),
            actor_full_mask=rng.random(b) < 0.25, apply_acm=apply_acm,
            apply_randaug=~apply_acm, actor_flip=rng.random(b) < 0.5,
            scene_flip=rng.random(b) < 0.5,
            background_label=rng.integers(-1, 10, size=(b, 1)).astype(np.int64),
            foreground_ratio=rng.random(b).astype(np.float32),
        )
    else:
        apply_randaug = rng.random(b) < 0.75
        out.update(apply_randaug=apply_randaug, apply_bgmix=~apply_randaug & with_bg,
                   flip=rng.random(b) < 0.5)
    out["label"] = rng.integers(0, 10, size=(b, 1)).astype(np.int64)
    draws = draw_randaug(torch.Generator().manual_seed(seed), b, 2, size, size)
    out.update({k: v.numpy() for k, v in draws.items()})
    return out


class SyntheticWireLoader:
    """An in-memory loader with the fast train loaders' interface
    (``__len__``, ``set_epoch``, ``__iter__``, ``iter_epochs``,
    ``wire_format``) of BGMix wire batches, each a pure function of (seed,
    epoch, batch index). It stands in for ``loaders.FastBGMixLoader`` where
    the native decoder cannot be built. Making pixels costs more than the
    step on the card, so the pixels cycle through ``POOL`` batches made once;
    the masks, labels and RandAugment draws are drawn anew for every batch
    (``wire_masks``), so the device does the same work as on decoded
    frames."""

    POOL = 4

    def __init__(self, num_videos: int, batch_size: int, num_segments: int = 8,
                 crop_size: int = 224, seed: int = 0, wire_format: str = "yuv420"):
        self.num_videos, self.batch_size = num_videos, batch_size
        self.num_segments, self.crop_size = num_segments, crop_size
        self.seed, self.wire_format = seed, wire_format
        self.epoch = 0
        masks = set(wire_masks(1, 1, crop_size))
        self._pixels = [
            {k: v for k, v in wire_batch(wire_format, batch_size, num_segments, crop_size,
                                         seed=seed * self.POOL + j).items() if k not in masks}
            for j in range(self.POOL)]

    def __len__(self) -> int:
        return self.num_videos // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _batch(self, epoch: int, i: int) -> Dict[str, np.ndarray]:
        seed = int(np.random.SeedSequence([self.seed, epoch, i]).generate_state(1)[0])
        return {**self._pixels[(epoch * len(self) + i) % self.POOL],
                **wire_masks(self.batch_size, self.num_segments, self.crop_size, seed)}

    def __iter__(self):
        return (self._batch(self.epoch, i) for i in range(len(self)))

    def iter_epochs(self, first_epoch: int, num_epochs: int):
        return (self._batch(e, i) for e in range(first_epoch, first_epoch + num_epochs)
                for i in range(len(self)))
