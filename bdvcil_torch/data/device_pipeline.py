"""Device half of the fast training input path (port of the device half of
``bdvcil_tpu/data/device_pipeline.py``).

A loader ships a batch of uint8 pixels in one of three wire formats; the
input function turns it into normalized clips on the batch's device, as the
first thing the train step does (``make_train_step(input_fn=...)``).

Batch layout (the JAX loaders' layout; B clips of T frames, S = crop size):

  pixels, by wire format
    'rgb'     imgs_u8 (B, T, S, S, 3) u8;  bg_u8 (B, S, S, 3) u8
    'yuv420'  imgs_y (B, T, S, S) u8, imgs_c (B, T, S/2, S/2, 2) u8 CbCr;
              bg_y (B, S, S) u8, bg_c (B, S/2, S/2, 2) u8
    'planes'  stored-resolution planes padded to (Hp, Wp): imgs_y (B, T, Hp,
              Wp), imgs_c (B, T, Hp/2, Wp/2, 2), with per-clip resize taps
              imgs_taps_y (B, 6, S) / imgs_taps_c (B, 6, S/2) int32
              (``plane_resize_taps``); bg_y (B, Hp, Wp), bg_c, bg_taps_y,
              bg_taps_c likewise
    (the bg keys are absent for a corpus without backgrounds: with_bgmix=False)
  BGMix (``make_fast_input_fn``)
    flip (B,) bool whole-clip horizontal flip; apply_bgmix (B,) bool;
    apply_randaug (B,) bool; label (B, 1) int64; sample_weight (B,) f32 when
    the loader pads
  ActorCutMix (``make_fast_acm_input_fn``): the pixels of the actor clip as
    above and of the scene clip under scene_* (scene_u8, scene_y/scene_c,
    scene_taps_y/scene_taps_c); actor_boxes, scene_boxes (B, T, K, 4) f32
    in output coordinates; actor_full_mask, apply_acm, apply_randaug
    (= ~apply_acm), actor_flip, scene_flip (B,) bool; label, background_label
    (B, 1) int64; foreground_ratio (B,) f32
  RandAugment draws, in place of the JAX loaders' ``randaug_key`` (B, 2):
    randaug_op_indices (B, n) int64, randaug_flip_sign (B,) bool,
    randaug_x0, randaug_y0 (B,) f32 (``ops.rand_augment_dev.draw_randaug``)

``HOST_KEYS`` (apply_randaug and the draws) stay on the host: the input
function groups the clips by op from them without reading the device.
``batch_to_device`` moves every other key, asynchronously from pinned memory
(``pin_batch``). The input functions then run without a device-to-host sync.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.augment import (
    MEAN,
    STD,
    acm_composite,
    flip_clips,
    fused_train_augment,
    host_to_device,
    normalize_batch,
    resize_plane_bilinear_taps,
    yuv420_to_rgb,
)
from ..ops.rand_augment_dev import DRAW_KEYS, rand_augment_batch

HOST_KEYS = ("apply_randaug",) + DRAW_KEYS
WIRE_FORMATS = ("rgb", "yuv420", "planes")


def plane_resize_taps(sw, sh, dw, dh, cx, cy, out):
    """Per-axis taps of the windowed bilinear resize: the index and weight
    math of csrc/host/decoder.cpp resize_plane_window + bilinear_resize_window_t
    (f32 half-pixel-centre sampling, 8-bit fixed-point weights, clamped
    window) from a stored (sw, sh) plane resized to (dw, dh) and cropped at
    (cx, cy) to ``out`` x ``out``.

    Returns a (6, out) int32 array, rows (x0, x1, xw, y0, y1, yw), or None
    when the C++ would take its two-stage squash fallback (the window larger
    than the resize target); such a frame is host-resized and gets
    ``identity_plane_taps``."""
    cx = max(cx, 0)
    cy = max(cy, 0)
    if cx + out > dw:
        cx = dw - out
    if cy + out > dh:
        cy = dh - out
    if cx < 0 or cy < 0:
        return None
    if sw == dw and sh == dh:  # identity resize: a plain crop copy
        idx = np.arange(out, dtype=np.int32)
        zero = np.zeros(out, np.int32)
        return np.stack([idx + cx, idx + cx, zero, idx + cy, idx + cy, zero])

    def axis(offset, d, s):
        ratio = np.float32(s) / np.float32(d)
        sx = ((np.arange(out, dtype=np.float32) + np.float32(offset) + np.float32(0.5)) * ratio
              - np.float32(0.5))
        sx = np.maximum(sx, np.float32(0))
        i0 = np.minimum(sx.astype(np.int32), s - 1)
        i1 = np.minimum(i0 + 1, s - 1)
        w1 = ((sx - i0.astype(np.float32)) * np.float32(256.0) + np.float32(0.5)).astype(np.int32)
        return i0, i1, w1

    x0, x1, xw = axis(cx, dw, sw)
    y0, y1, yw = axis(cy, dh, sh)
    return np.stack([x0, x1, xw, y0, y1, yw])


def identity_plane_taps(out):
    """Taps that copy the top-left ``out`` x ``out`` corner unchanged, for
    frames the host already resized to final geometry (pasted at the origin)."""
    idx = np.arange(out, dtype=np.int32)
    zero = np.zeros(out, np.int32)
    return np.stack([idx, idx, zero, idx, idx, zero])


def pin_batch(batch: Dict) -> Dict[str, torch.Tensor]:
    """The batch as host tensors, every key but ``HOST_KEYS`` in pinned
    memory, ready for an asynchronous copy to the card."""
    return {k: torch.as_tensor(v) if k in HOST_KEYS else torch.as_tensor(v).pin_memory()
            for k, v in batch.items()}


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Every key but ``HOST_KEYS`` on ``device`` by ``host_to_device``; numpy
    arrays become tensors. On a card the copies do not block (``pin_batch``
    the batch where the loader makes it, or each tensor is pinned here)."""
    return {k: torch.as_tensor(v) if k in HOST_KEYS else host_to_device(v, device)
            for k, v in batch.items()}


def _check_wire_format(wire_format: str) -> str:
    if wire_format not in WIRE_FORMATS:
        raise ValueError(f"unknown wire_format {wire_format!r}; one of {WIRE_FORMATS} "
                         f"('auto' is resolved by the loader)")
    return wire_format


def decode_wire(batch: Dict[str, torch.Tensor], prefix: str, wire_format: str,
                clip: bool = True) -> torch.Tensor:
    """RGB uint8 of one pixel stream (``imgs``, ``bg`` or ``scene``) of the
    wire: (B, T, S, S, 3) for a clip stream, (B, S, S, 3) for ``bg``."""
    if wire_format == "rgb":
        return batch[f"{prefix}_u8"]
    y, c = batch[f"{prefix}_y"], batch[f"{prefix}_c"]
    if wire_format == "planes":
        ty, tc = batch[f"{prefix}_taps_y"], batch[f"{prefix}_taps_c"]
        if not clip:  # one frame per row: resize as clips of one frame
            y, c = y[:, None], c[:, None]
        y = resize_plane_bilinear_taps(y, ty, ty.shape[-1])
        c = resize_plane_bilinear_taps(c, tc, tc.shape[-1])
        if not clip:
            y, c = y[:, 0], c[:, 0]
    return yuv420_to_rgb(y, c)


def _randaug_draws(batch, n: int):
    ops = batch["randaug_op_indices"]
    if ops.shape[1] != n:
        raise ValueError(f"the batch carries {ops.shape[1]} RandAugment ops per clip, the "
                         f"input function was built for randaug_n={n}")
    return [batch[k] for k in DRAW_KEYS]


def make_fast_input_fn(alpha: float = 0.5, mean=MEAN, std=STD, randaug_n: int = 2,
                       randaug_m: int = 10, with_randaug: bool = True, with_bgmix: bool = True,
                       dtype: Optional[torch.dtype] = None,
                       wire_format: str = "rgb") -> Callable:
    """Device half of the fast BGMix path, for ``make_train_step(input_fn=...)``:
    wire batch -> normalized clips (B, T, S, S, 3) in ``dtype`` (f32 if None).

    Order of the reference train pipeline: the wire decoded to RGB uint8
    (``wire_format`` must match the loader's), RandAugment on the uint8 clips
    where ``apply_randaug``, then normalize, whole-clip flip and the
    background blend where ``apply_bgmix``. The loader draws ``apply_randaug``
    and ``apply_bgmix`` to exclude each other (the reference's randAug/BGMix
    mutex: a clip that RandAugments is never blended); the input function
    applies the masks as given. ``with_bgmix=False`` (a corpus without
    backgrounds) skips the blend: the batch carries no bg keys.

    The returned function has ``uint8_stage(batch) -> (imgs_u8, bg_u8 or
    None)``, the clips after RandAugment and the decoded backgrounds, before
    the float stage.
    """
    _check_wire_format(wire_format)
    out_dtype = dtype if dtype is not None else torch.float32

    def uint8_stage(batch):
        imgs_u8 = decode_wire(batch, "imgs", wire_format)
        bg_u8 = decode_wire(batch, "bg", wire_format, clip=False) if with_bgmix else None
        if with_randaug:
            imgs_u8 = rand_augment_batch(imgs_u8, *_randaug_draws(batch, randaug_n),
                                         m=randaug_m, rows=batch["apply_randaug"])
        return imgs_u8, bg_u8

    def input_fn(batch):
        imgs_u8, bg_u8 = uint8_stage(batch)
        return fused_train_augment(imgs_u8, bg_u8, batch["apply_bgmix"] if with_bgmix else None,
                                   batch["flip"], alpha=alpha, mean=mean, std=std,
                                   dtype=out_dtype)

    input_fn.uint8_stage = uint8_stage
    return input_fn


def make_fast_acm_input_fn(mean=MEAN, std=STD, randaug_n: int = 2, randaug_m: int = 10,
                           fill: int = 127, dtype: Optional[torch.dtype] = None,
                           wire_format: str = "rgb") -> Callable:
    """Device half of the fast ActorCutMix path: wire batch -> normalized
    clips in ``dtype`` (f32 if None).

    RandAugment only on non-ACM rows (``apply_randaug``, which the loader
    sets to ``~apply_acm``; reference actor_cut_mix_loader.py:92-103), with
    no flip. ACM rows: the actor and the scene clip each flipped by its own
    mask, then the box-mask composite (``acm_composite``: the scene's humans
    erased with ``fill``, the actor's box union pasted over). The result
    is the composite where ``apply_acm``, else the RandAugmented clip.

    The returned function has ``uint8_stage(batch) -> imgs_u8``, the clips
    before the normalize.
    """
    _check_wire_format(wire_format)
    out_dtype = dtype if dtype is not None else torch.float32

    def uint8_stage(batch):
        imgs = decode_wire(batch, "imgs", wire_format)
        scene = decode_wire(batch, "scene", wire_format)
        imgs_ra = rand_augment_batch(imgs, *_randaug_draws(batch, randaug_n), m=randaug_m,
                                     rows=batch["apply_randaug"])
        acm = acm_composite(flip_clips(imgs, batch["actor_flip"]),
                            flip_clips(scene, batch["scene_flip"]), batch["actor_boxes"],
                            batch["scene_boxes"], batch["actor_full_mask"], fill=fill)
        return torch.where(batch["apply_acm"].view(-1, 1, 1, 1, 1), acm, imgs_ra)

    def input_fn(batch):
        return normalize_batch(uint8_stage(batch), mean, std, out_dtype)

    input_fn.uint8_stage = uint8_stage
    return input_fn
