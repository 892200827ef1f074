"""Batched augmentation ops of the fast input path, on the batch's device
(port of ``bdvcil_tpu/ops/augment.py``).

Eager PyTorch on whole batches; none of them needs a hand-written kernel.

  * ``normalize_batch``            uint8 -> normalized float
  * ``fancy_upsample2x``, ``yuv420_to_rgb``
                                   the YUV420 wire's chroma upsample and
                                   libjpeg's fixed-point YCbCr -> RGB
  * ``resize_plane_bilinear_taps`` the planes wire's windowed bilinear resize,
                                   two-tap integer filter in int32
  * ``background_blend``, ``fused_train_augment``
                                   BGMix: normalize, whole-clip flip, blend
  * ``tencrop_expand``, ``eval_yuv_full_crops``
                                   the eval wires
  * ``temporal_median``            background extraction
  * ``boxes_union_mask``, ``acm_composite``
                                   ActorCutMix compositing
  * ``rand_bbox``, ``tubemix``, ``draw_tubemix``
                                   tube-CutMix; the draws are arguments, made
                                   by ``draw_tubemix`` from a generator

Integer ops are bit-identical to the JAX functions on any device; nothing
here reads a device tensor back to the host. Host-made constants reach the
card through ``host_to_device`` (pinned memory, asynchronous copy), so the
ops run under ``torch.cuda.set_sync_debug_mode("error")``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


def host_to_device(x, device) -> torch.Tensor:
    """A host array or tensor on ``device`` without a blocking copy: through
    pinned memory (pinned here unless it already is) and an asynchronous copy
    when ``device`` is a card."""
    t = torch.as_tensor(x)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    if t.device.type == "cpu" and not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


@functools.lru_cache(maxsize=None)
def device_const(values: Tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor on ``device``, copied there once."""
    return host_to_device(torch.tensor(values, dtype=dtype), device)


def _mean_inv_std(mean, std, device):
    m = device_const(tuple(float(v) for v in mean), torch.float32, device)
    # 1 / std in f32, as the JAX function computes it
    inv = device_const(tuple(float(v) for v in 1.0 / np.asarray(std, np.float32)),
                       torch.float32, device)
    return m, inv


def normalize_batch(imgs: torch.Tensor, mean=MEAN, std=STD,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., C) uint8/float -> ((x - mean) * (1 / std)) in ``dtype``."""
    m, inv = _mean_inv_std(mean, std, imgs.device)
    return ((imgs.to(torch.float32) - m) * inv).to(dtype)


def _shift_cols(p, left: bool):
    """Columns moved one to the right (``left``: each pixel's left neighbour)
    or to the left, with the edge replicated."""
    if left:
        return torch.cat([p[..., :, :1], p[..., :, :-1]], dim=-1)
    return torch.cat([p[..., :, 1:], p[..., :, -1:]], dim=-1)


def fancy_upsample2x(plane: torch.Tensor) -> torch.Tensor:
    """libjpeg's "fancy" 2x2 chroma upsample (jdsample.c h2v2_fancy_upsample):
    9/3/3/1 weights of the four nearest samples, edges replicated, +8 on even
    and +7 on odd output columns. (..., H, W) integer -> (..., 2H, 2W) uint8."""
    p = plane.to(torch.int32)
    he = 3 * p + _shift_cols(p, True)
    ho = 3 * p + _shift_cols(p, False)
    up = torch.cat([p[..., :1, :], p[..., :-1, :]], dim=-2)
    dn = torch.cat([p[..., 1:, :], p[..., -1:, :]], dim=-2)
    ue, uo = 3 * up + _shift_cols(up, True), 3 * up + _shift_cols(up, False)
    de, do = 3 * dn + _shift_cols(dn, True), 3 * dn + _shift_cols(dn, False)
    ree = (3 * he + ue + 8) >> 4
    reo = (3 * ho + uo + 7) >> 4
    roe = (3 * he + de + 8) >> 4
    roo = (3 * ho + do + 7) >> 4
    h, w = p.shape[-2], p.shape[-1]
    rows_e = torch.stack([ree, reo], dim=-1).reshape(*p.shape[:-1], 2 * w)
    rows_o = torch.stack([roe, roo], dim=-1).reshape(*p.shape[:-1], 2 * w)
    out = torch.stack([rows_e, rows_o], dim=-2).reshape(*p.shape[:-2], 2 * h, 2 * w)
    return out.to(torch.uint8)


def yuv420_to_rgb(y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """RGB uint8 from the YUV420 wire: y (..., H, W) uint8 luma, c
    (..., H/2, W/2, 2) uint8 interleaved CbCr; fancy-upsampled chroma and
    libjpeg's fixed-point coefficients (jdcolor.c). ``>>`` on int32 is an
    arithmetic shift, as in JAX. Returns (..., H, W, 3)."""
    cb = fancy_upsample2x(c[..., 0]).to(torch.int32) - 128
    cr = fancy_upsample2x(c[..., 1]).to(torch.int32) - 128
    yi = y.to(torch.int32)
    r = yi + ((91881 * cr + 32768) >> 16)  # FIX(1.40200)
    g = yi + ((-22554 * cb - 46802 * cr + 32768) >> 16)  # FIX(0.34414), FIX(0.71414)
    b = yi + ((116130 * cb + 32768) >> 16)  # FIX(1.77200)
    return torch.stack([r, g, b], dim=-1).clamp_(0, 255).to(torch.uint8)


def resize_plane_bilinear_taps(planes: torch.Tensor, taps: torch.Tensor, out: int) -> torch.Tensor:
    """Windowed bilinear resize of stored-resolution planes, bit-identical to
    the host C++ fixed-point path (csrc/host/decoder.cpp
    bilinear_resize_window_t): two taps per axis with integer weights in
    [0, 256], one rounding ``(acc + 32768) >> 16``.

    planes: (B, T, Hp, Wp) or (B, T, Hp, Wp, C) uint8, padded to (Hp, Wp).
    taps: (B, 6, out) int32, rows (x0, x1, xw, y0, y1, yw) from
      ``data/device_pipeline.plane_resize_taps``; one geometry per clip.

    Gathers in int32: the vertical pass on the ``out`` rows the taps name,
    then the horizontal pass. Each output is sum (256 - w or w)(256 - v or v)
    * pixel over four pixels, an exact integer of at most 255 * 256 * 256 <
    2^31, so the order of the passes changes nothing.
    """
    has_c = planes.dim() == 5
    if not has_c:
        planes = planes[..., None]
    b, t, hp, wp, ch = planes.shape
    taps = taps.to(device=planes.device, dtype=torch.int64)
    x0, x1, xw = taps[:, 0], taps[:, 1], taps[:, 2]
    y0, y1, yw = taps[:, 3], taps[:, 4], taps[:, 5]
    p = planes.to(torch.int32)

    def rows(idx):
        return torch.gather(p, 2, idx.view(b, 1, out, 1, 1).expand(b, t, out, wp, ch))

    v1 = yw.to(torch.int32).view(b, 1, out, 1, 1)
    vert = (256 - v1) * rows(y0) + v1 * rows(y1)  # (B, T, out, Wp, C)

    def cols(idx):
        return torch.gather(vert, 3, idx.view(b, 1, 1, out, 1).expand(b, t, out, out, ch))

    w1 = xw.to(torch.int32).view(b, 1, 1, out, 1)
    acc = (256 - w1) * cols(x0) + w1 * cols(x1)
    res = ((acc + 32768) >> 16).to(torch.uint8)
    return res if has_c else res[..., 0]


def background_blend(imgs: torch.Tensor, bg: torch.Tensor, alpha,
                     apply_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """imgs * (1 - alpha) + bg * alpha over (B, M, H, W, C) clips, bg (B, H,
    W, C) broadcast over the frames; ``alpha`` a number or (B,); rows where
    ``apply_mask`` (B,) is False pass through unchanged."""
    if isinstance(alpha, torch.Tensor):
        a = alpha.to(imgs.dtype)
        if a.dim() == 1:
            a = a.view(-1, 1, 1, 1, 1)
        one_minus = 1.0 - a
    else:  # 1 - alpha in f32, as JAX forms it from an f32 alpha
        a32 = np.float32(alpha)
        a, one_minus = float(a32), float(np.float32(1.0) - a32)
    blended = imgs * one_minus + bg[:, None] * a
    if apply_mask is None:
        return blended
    return torch.where(apply_mask.view(-1, 1, 1, 1, 1), blended, imgs)


def flip_clips(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Whole-clip horizontal flip of the rows where ``flip`` (B,) is True;
    x (B, T, H, W, C)."""
    return torch.where(flip.view(-1, 1, 1, 1, 1), torch.flip(x, dims=(3,)), x)


def fused_train_augment(imgs_u8: torch.Tensor, bg_u8: Optional[torch.Tensor],
                        apply_bgmix: Optional[torch.Tensor], flip: torch.Tensor,
                        alpha: float = 0.5, mean=MEAN, std=STD,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The BGMix half of the fast path: normalize, whole-clip flip, background
    blend where ``apply_bgmix``, cast to ``dtype``.

    imgs_u8 (B, M, H, W, C) uint8; bg_u8 (B, H, W, C) uint8 or None (no
    background at all: the blend is skipped); apply_bgmix, flip (B,) bool.
    The flip runs on the uint8 clips: it only moves pixels, and the
    normalize is the same per pixel, so the result is that of flipping the
    normalized clips at a quarter of the bytes.
    """
    imgs = normalize_batch(flip_clips(imgs_u8, flip), mean, std, torch.float32)
    if bg_u8 is None:
        return imgs.to(dtype)
    bg = normalize_batch(bg_u8, mean, std, torch.float32)
    return background_blend(imgs, bg, alpha, apply_mask=apply_bgmix).to(dtype)


def tencrop_expand(imgs: torch.Tensor) -> torch.Tensor:
    """(B, T, 5, h, w, C) five-crop frames -> (B, 10*T, h, w, C) TenCrop in
    the reference's group order [p0, p0 flipped, p1, p1 flipped, ...], each
    group's T frames consecutive."""
    b, t = imgs.shape[0], imgs.shape[1]
    x = imgs.movedim(2, 1)  # (B, 5, T, h, w, C)
    both = torch.stack([x, torch.flip(x, dims=(4,))], dim=2)  # (B, 5, 2, T, h, w, C)
    return both.reshape(b, 10 * t, *imgs.shape[3:])


def eval_yuv_full_crops(batch: Dict[str, torch.Tensor], crop: Optional[int] = None) -> torch.Tensor:
    """Full-frame YUV420 eval wire -> uint8 RGB crops.

    batch: {'imgs_y': (B, T, ph, pw) uint8, 'imgs_c': (B, T, ph/2, pw/2, 2)
    uint8, 'crop_yx_<px>': (B, K, 2) int (y, x) luma offsets}; K = 1
    (CenterCrop) or 5 (TenCrop positions; flips by ``tencrop_expand``). The
    crop size is the key's suffix unless ``crop`` is given. Offsets are
    clamped into the frame, as ``lax.dynamic_slice`` clamps them. One
    advanced-indexing gather per plane, no loop over crops.
    Returns (B, T, K, crop, crop, 3) uint8.
    """
    y, c = batch["imgs_y"], batch["imgs_c"]
    offs_key = next(k for k in batch if k.startswith("crop_yx"))
    offs = batch[offs_key].to(device=y.device, dtype=torch.int64)
    if crop is None:
        crop = int(offs_key.rsplit("_", 1)[1])
    half = crop // 2
    b, t, ph, pw = y.shape
    dev = y.device
    oy = offs[..., 0].clamp(0, ph - crop)  # (B, K)
    ox = offs[..., 1].clamp(0, pw - crop)
    coy = (oy // 2).clamp(0, c.shape[2] - half)
    cox = (ox // 2).clamp(0, c.shape[3] - half)
    bi = torch.arange(b, device=dev).view(b, 1, 1, 1, 1)
    ti = torch.arange(t, device=dev).view(1, 1, t, 1, 1)

    def window(start, size, row: bool):
        r = start[:, :, None] + torch.arange(size, device=dev)  # (B, K, size)
        return r[:, :, None, :, None] if row else r[:, :, None, None, :]

    yc = y[bi, ti, window(oy, crop, True), window(ox, crop, False)]  # (B, K, T, crop, crop)
    cc = c[bi, ti, window(coy, half, True), window(cox, half, False)]  # (..., half, half, 2)
    return yuv420_to_rgb(yc, cc).movedim(1, 2)


def temporal_median(frames: torch.Tensor) -> torch.Tensor:
    """Median over the frame axis, (T, H, W, C) -> (H, W, C) uint8. For even
    T the mean of the two middle values (as ``jnp.median``; ``torch.median``
    would return the lower one), rounded half to even."""
    s = torch.sort(frames.to(torch.float32), dim=0).values
    t = s.shape[0]
    med = s[t // 2] if t % 2 else (s[t // 2 - 1] + s[t // 2]) * 0.5
    return torch.round(med).clamp(0, 255).to(torch.uint8)


def boxes_union_mask(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., K, 4) float [x0, y0, x1, y1] boxes -> (..., H, W) bool union,
    rasterized as the reference's ``mask[int(y0):int(y1), int(x0):int(x1)]``:
    coordinates truncate toward zero, the box is half-open, degenerate
    (padding) boxes add nothing."""
    b = boxes.to(torch.int32)
    ys = torch.arange(h, dtype=torch.int32, device=boxes.device)
    xs = torch.arange(w, dtype=torch.int32, device=boxes.device)
    y_in = (ys >= b[..., 1:2]) & (ys < b[..., 3:4])  # (..., K, H)
    x_in = (xs >= b[..., 0:1]) & (xs < b[..., 2:3])  # (..., K, W)
    return (y_in[..., :, None] & x_in[..., None, :]).any(dim=-3)


def acm_composite(actor_u8: torch.Tensor, scene_u8: torch.Tensor, actor_boxes: torch.Tensor,
                  scene_boxes: torch.Tensor, actor_full_mask: torch.Tensor,
                  fill: int = 127) -> torch.Tensor:
    """ActorCutMix compositing: the scene clip's humans erased with ``fill``,
    then the actor clip's human-box union pasted over it; a clip whose action
    video has no detections (``actor_full_mask``) is the actor clip.

    actor_u8, scene_u8 (B, T, H, W, C) uint8, already flipped; boxes (B, T,
    K, 4) float in output coordinates; actor_full_mask (B,) bool.
    """
    h, w = actor_u8.shape[2], actor_u8.shape[3]
    amask = boxes_union_mask(actor_boxes, h, w) | actor_full_mask.view(-1, 1, 1, 1)
    smask = boxes_union_mask(scene_boxes, h, w)
    scene = scene_u8.masked_fill(smask[..., None], fill)
    return torch.where(amask[..., None], actor_u8, scene)


def rand_bbox(cx, cy, height: int, width: int, lam) -> Tuple:
    """The box of side ratio sqrt(1 - lam) centred at (cx, cy), clipped to the
    image: (x1, y1, x2, y2) int tensors. ``lam`` is an f32 tensor; cx, cy are
    integer tensors drawn in [0, width) and [0, height)."""
    cut_rat = torch.sqrt(1.0 - lam)
    cut_w = (width * cut_rat).to(torch.int64)
    cut_h = (height * cut_rat).to(torch.int64)
    x1 = (cx - torch.div(cut_w, 2, rounding_mode="floor")).clamp(0, width)
    y1 = (cy - torch.div(cut_h, 2, rounding_mode="floor")).clamp(0, height)
    x2 = (cx + torch.div(cut_w, 2, rounding_mode="floor")).clamp(0, width)
    y2 = (cy + torch.div(cut_h, 2, rounding_mode="floor")).clamp(0, height)
    return x1, y1, x2, y2


def draw_tubemix(generator: Optional[torch.Generator], b: int, h: int, w: int, alpha: float,
                 prob: float, device=None) -> Dict[str, torch.Tensor]:
    """tube-CutMix's random draws on the generator's device (else on
    ``device``, default the CPU), with no host sync: ``apply`` (0-d bool,
    with probability ``prob``), ``perm`` (B,) a permutation of the batch,
    ``box`` (4,) int64 (x1, y1, x2, y2) from a Beta(alpha, alpha) area ratio
    and a uniform centre."""
    if generator is not None:
        device = generator.device
    elif device is None:
        device = torch.device("cpu")
    u = torch.rand((), generator=generator, device=device)
    perm = torch.randperm(b, generator=generator, device=device)
    # Beta(a, a) as X / (X + Y) with X, Y ~ Gamma(a)
    g = torch._standard_gamma(torch.full((2,), float(alpha), device=device),
                              generator=generator)
    lam = g[0] / (g[0] + g[1])
    cx = torch.randint(0, w, (), generator=generator, device=device)
    cy = torch.randint(0, h, (), generator=generator, device=device)
    return dict(apply=u > 1.0 - prob, perm=perm,
                box=torch.stack(rand_bbox(cx, cy, h, w, lam.float())))


def tubemix(imgs: torch.Tensor, targets: torch.Tensor, apply: torch.Tensor,
            perm: torch.Tensor, box: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tube-CutMix: swap one spatial box across the batch for all frames and
    mix the targets by the box's true (clipped) area; identity unless
    ``apply``. imgs (B, M, H, W, C); targets (B, classes); the draws as
    ``draw_tubemix`` makes them (box as (x1, y1, x2, y2))."""
    b, m, h, w, c = imgs.shape
    dev = imgs.device
    x1, y1, x2, y2 = box.to(dev).unbind(0)
    ys = torch.arange(h, device=dev).view(1, 1, h, 1, 1)
    xs = torch.arange(w, device=dev).view(1, 1, 1, w, 1)
    in_box = ((ys >= y1) & (ys < y2) & (xs >= x1) & (xs < x2)).to(imgs.dtype)
    perm = perm.to(dev)
    mixed = imgs * (1.0 - in_box) + imgs[perm] * in_box
    area = ((x2 - x1) * (y2 - y1)).to(targets.dtype)
    lam = 1.0 - area / torch.full_like(area, float(h * w))  # a true division on any device
    mixed_targets = targets * lam + targets[perm] * (1.0 - lam)
    apply = apply.to(dev)
    return torch.where(apply, mixed, imgs), torch.where(apply, mixed_targets, targets)

