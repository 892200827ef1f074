"""Whole-clip-consistent RandAugment on the batch's device (port of
``bdvcil_tpu/ops/rand_augment_dev.py``).

The 15 FixMatch ops of the reference's PIL RandAugment, on uint8 clips. The
per-clip draws (two op indices, the magnitude sign, the cutout centre) are an
input, made on the host by ``draw_randaug`` from a CPU generator; they stand
where the JAX loader ships a PRNG key. Because they live on the host, the
clips are grouped by the op they drew without any read from the device, and
each op runs once per round on the clips that drew it.

Parity with the JAX function given the same draws:
  * the integer ops (AutoContrast, Equalize, Solarize, Posterize, Cutout)
    and the geometric ops Shear/Translate bit for bit;
  * Rotate: the affine matrix is built on the host in f32 (numpy's cos/sin
    against XLA's may differ by an ulp, and the floor of the sample position
    may then move a pixel); a stated count of pixels may differ;
  * the enhancement ops (Color, Contrast, Brightness, Sharpness) blend in
    f32 and may differ by 1 LSB where the two compilers order or fuse the
    float arithmetic differently.
The affine matrices depend only on (op, sign, h, w), so the host builds
them and the card and the CPU sample the same positions.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .augment import device_const, host_to_device

FILL_COLOR = (124, 116, 104)  # reference rand_augment.py:16

# (name, minval, maxval), the FixMatch table (reference rand_augment.py:200-216)
OP_TABLE = (
    ("Identity", 0.0, 1.0),
    ("AutoContrast", 0.0, 1.0),
    ("Equalize", 0.0, 1.0),
    ("Rotate", 0.0, 30.0),
    ("Solarize", 0.0, 256.0),
    ("Color", 0.05, 0.95),
    ("Contrast", 0.05, 0.95),
    ("Brightness", 0.05, 0.95),
    ("Sharpness", 0.05, 0.95),
    ("ShearX", 0.0, 0.3),
    ("TranslateX", 0.0, 0.3),
    ("TranslateY", 0.0, 0.3),
    ("Posterize", 4.0, 8.0),
    ("ShearY", 0.0, 0.3),
    ("CutoutAbs", 0.0, 112.0),
)
NUM_OPS = len(OP_TABLE)
ROTATE, SHEAR_X, TRANSLATE_X, TRANSLATE_Y, SHEAR_Y = 3, 9, 10, 11, 13
GEO_IDS = (ROTATE, SHEAR_X, TRANSLATE_X, TRANSLATE_Y, SHEAR_Y)
DRAW_KEYS = ("randaug_op_indices", "randaug_flip_sign", "randaug_x0", "randaug_y0")


def op_magnitudes(m: int) -> Tuple[float, ...]:
    """val = (m/30) * (max - min) + min per op (rand_augment.py:247)."""
    return tuple((float(m) / 30.0) * (mx - mn) + mn for _, mn, mx in OP_TABLE)


def draw_randaug(generator: Optional[torch.Generator], b: int, n: int, h: int,
                 w: int) -> Dict[str, torch.Tensor]:
    """The per-clip draws of one batch, on the host: ``randaug_op_indices``
    (B, n) int64 in [0, 15), ``randaug_flip_sign`` (B,) bool (the magnitude's
    sign), ``randaug_x0``/``randaug_y0`` (B,) f32 cutout centre in [0, w) and
    [0, h). ``generator`` is a CPU generator (or None: the default one)."""
    ops = torch.randint(0, NUM_OPS, (b, n), generator=generator)
    sign = torch.rand(b, generator=generator) > 0.5
    x0 = torch.rand(b, generator=generator) * w
    y0 = torch.rand(b, generator=generator) * h
    return dict(zip(DRAW_KEYS, (ops, sign, x0, y0)))


# -- helpers ----------------------------------------------------------------


def _f32(v) -> float:
    """A host scalar rounded to f32, as JAX holds the magnitudes."""
    return float(np.float32(v))


def _gray_l(img: torch.Tensor) -> torch.Tensor:
    """PIL 'L' conversion: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16."""
    x = img.to(torch.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16).to(
        torch.uint8)


def _blend(degenerate: torch.Tensor, img: torch.Tensor, factor: float) -> torch.Tensor:
    """PIL Image.blend(degenerate, img, factor), rounded half to even and clipped."""
    d = degenerate.to(torch.float32)
    out = d + _f32(factor) * (img.to(torch.float32) - d)
    return torch.round(out).clamp_(0, 255).to(torch.uint8)


# -- affine matrices, built on the host in f32 ------------------------------


def affine_matrix(op: int, val: float, sign: bool, h: int, w: int) -> np.ndarray:
    """PIL's inverse-map affine matrix (a, b, c, d, e, f), f32, for a
    geometric op; the arithmetic of the JAX builders in f32."""
    f = np.float32
    v = f(-val) if sign else f(val)
    if op == ROTATE:
        # PIL rotate(angle) negates the angle before building the matrix
        angle = -v * f(np.pi / 180.0)
        cx, cy = f(w / 2.0), f(h / 2.0)
        cos, sin = np.cos(angle), np.sin(angle)
        return np.array([cos, sin, cx - cx * cos - cy * sin, -sin, cos, cy + cx * sin - cy * cos],
                        np.float32)
    if op == SHEAR_X:
        return np.array([1, v, 0, 0, 1, 0], np.float32)
    if op == SHEAR_Y:
        return np.array([1, 0, 0, v, 1, 0], np.float32)
    if op == TRANSLATE_X:
        return np.array([1, 0, v * f(w), 0, 1, 0], np.float32)
    if op == TRANSLATE_Y:
        return np.array([1, 0, 0, 0, 1, v * f(h)], np.float32)
    raise ValueError(f"op {op} is not geometric")


def affine_nearest_clips(imgs: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """PIL Image.transform(AFFINE, NEAREST) of whole clips: the output pixel
    (x, y) samples floor(M @ (x + .5, y + .5)), out of bounds -> FILL_COLOR.
    imgs (G, T, H, W, C) uint8, mats (G, 6) f32 on the same device; one
    gather of every frame with the clip's index map."""
    g, t, h, w, c = imgs.shape
    dev = imgs.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5).view(1, h, 1)
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5).view(1, 1, w)
    a, b, cc, d, e, f = (mats[:, i].view(g, 1, 1) for i in range(6))
    ix = torch.floor(a * xs + b * ys + cc).to(torch.int64)
    iy = torch.floor(d * xs + e * ys + f).to(torch.int64)
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).view(g, 1, h * w, 1)
    out = torch.gather(imgs.reshape(g, t, h * w, c), 2, flat.expand(g, t, h * w, c))
    fill_t = device_const(FILL_COLOR, torch.uint8, dev)
    return torch.where(valid.view(g, 1, h, w, 1), out.view(g, t, h, w, c), fill_t)


# -- the 15 ops: (imgs (G, T, H, W, C) uint8, val, sign, x0, y0) -> uint8 ----
# sign, x0, y0 are host arrays (G,); each op treats every clip of the group


def _op_identity(imgs, val, sign, x0, y0):
    return imgs


def _op_autocontrast(imgs, val, sign, x0, y0):
    lo = imgs.amin(dim=(2, 3), keepdim=True).to(torch.float32)  # per frame and channel
    hi = imgs.amax(dim=(2, 3), keepdim=True).to(torch.float32)
    # a true division: ``255.0 / t`` in torch is t.reciprocal() * 255, which
    # rounds twice and moves int() on some pixels
    span = torch.clamp(hi - lo, min=1e-12)
    scale = torch.full_like(span, 255.0) / span
    # PIL's lut[ix] = int(ix * scale + offset), evaluated per pixel
    val_px = torch.clamp((imgs.to(torch.float32) - lo) * scale, 0, 255).to(torch.int32)
    return torch.where(hi > lo, val_px, imgs.to(torch.int32)).to(torch.uint8)


def _op_equalize(imgs, val, sign, x0, y0):
    """PIL's equalize per frame and channel: an exact integer histogram
    (``scatter_add_``), PIL's LUT, applied as a gather."""
    g, t, h, w, c = imgs.shape
    flat = imgs.permute(0, 1, 4, 2, 3).reshape(g * t * c, h * w).to(torch.int64)
    hist = torch.zeros((g * t * c, 256), dtype=torch.int64, device=imgs.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    levels = torch.arange(256, device=imgs.device)
    nonzero = hist > 0
    last_idx = torch.where(nonzero, levels, 0).amax(dim=1, keepdim=True)  # last nonzero bin
    last_count = hist.gather(1, last_idx)
    step = torch.div(h * w - last_count, 255, rounding_mode="floor")
    csum_ex = torch.cumsum(hist, dim=1) - hist
    lut = torch.div(torch.div(step, 2, rounding_mode="floor") + csum_ex,
                    step.clamp(min=1), rounding_mode="floor").clamp(0, 255)
    identity = (nonzero.sum(dim=1, keepdim=True) <= 1) | (step == 0)
    lut = torch.where(identity, levels, lut)
    out = lut.gather(1, flat).to(torch.uint8)
    return out.view(g, t, c, h, w).permute(0, 1, 3, 4, 2).contiguous()


def _op_solarize(imgs, val, sign, x0, y0):
    thr = int(np.float32(val))
    return torch.where(imgs < thr, imgs, 255 - imgs)


def _op_color(imgs, val, sign, x0, y0):
    return _blend(_gray_l(imgs)[..., None].expand(imgs.shape), imgs, val)


def _op_contrast(imgs, val, sign, x0, y0):
    h, w = imgs.shape[2], imgs.shape[3]
    # the sum of the gray levels is an integer below 2^24 (224^2 * 255), so
    # the f32 mean is exact in any summation order: sum it as an integer
    total = _gray_l(imgs).to(torch.int64).sum(dim=(2, 3)).to(torch.float32)
    # divided by a tensor: the card divides by a host scalar as a multiply
    # by its reciprocal, which can round differently
    mean = torch.floor(total / torch.full_like(total, float(h * w)) + 0.5)
    return _blend(mean.view(*mean.shape, 1, 1, 1).expand(imgs.shape), imgs, val)


def _op_brightness(imgs, val, sign, x0, y0):
    return _blend(torch.zeros_like(imgs), imgs, val)


_K_EDGE = float(np.float32(1.0) / np.float32(13.0))
_K_CENTRE = float(np.float32(5.0) / np.float32(13.0))


def _op_sharpness(imgs, val, sign, x0, y0):
    """PIL's SMOOTH filter ([[1,1,1],[1,5,1],[1,1,1]] / 13) on the interior,
    the 1-pixel border unchanged, then the blend. Nine shifted multiply-adds
    in a fixed order, in f32: no library convolution (and so no TF32)."""
    h, w = imgs.shape[2], imgs.shape[3]
    x = imgs.to(torch.float32)
    smooth = None
    for dy in range(3):
        for dx in range(3):
            k = _K_CENTRE if (dy, dx) == (1, 1) else _K_EDGE
            term = k * x[:, :, dy:dy + h - 2, dx:dx + w - 2]
            smooth = term if smooth is None else smooth + term
    degenerate = x.clone()
    degenerate[:, :, 1:-1, 1:-1] = torch.round(smooth).clamp_(0, 255)
    return _blend(degenerate, imgs, val)


def _op_posterize(imgs, val, sign, x0, y0):
    bits = max(int(np.float32(val)), 1)
    return imgs & ((0xFF << (8 - bits)) & 0xFF)


def _op_cutout(imgs, val, sign, x0, y0):
    """A square of side ``val`` around (x0, y0) filled with the mean colour;
    PIL's rectangle is inclusive of (x1, y1). Box corners in f32 on the host."""
    g, t, h, w, c = imgs.shape
    v = np.float32(val)
    bx0 = np.maximum(np.float32(0), np.asarray(x0, np.float32) - v / np.float32(2)).astype(np.int32)
    by0 = np.maximum(np.float32(0), np.asarray(y0, np.float32) - v / np.float32(2)).astype(np.int32)
    box = np.stack([bx0, by0, np.minimum(w, bx0 + int(v)), np.minimum(h, by0 + int(v))], 1)
    box = host_to_device(box.astype(np.int64), imgs.device)
    ys = torch.arange(h, device=imgs.device).view(1, h, 1)
    xs = torch.arange(w, device=imgs.device).view(1, 1, w)
    in_box = ((ys >= box[:, 1, None, None]) & (ys <= box[:, 3, None, None])
              & (xs >= box[:, 0, None, None]) & (xs <= box[:, 2, None, None]))
    fill = device_const(FILL_COLOR, torch.uint8, imgs.device)
    return torch.where(in_box.view(g, 1, h, w, 1), fill, imgs)


def _geometric_group(imgs, ops, vals, signs):
    """Geometric ops on a group of clips in one gather: clip i takes op
    ``ops[i]`` with magnitude ``vals[i]`` and sign ``signs[i]`` (host values),
    its matrix built on the host."""
    h, w = imgs.shape[2], imgs.shape[3]
    mats = np.stack([affine_matrix(int(op), val, bool(s), h, w)
                     for op, val, s in zip(ops, vals, signs)])
    return affine_nearest_clips(imgs, host_to_device(mats, imgs.device))


def _geometric(op: int):
    def apply(imgs, val, sign, x0, y0):
        return _geometric_group(imgs, [op] * len(sign), [val] * len(sign), sign)

    apply.__name__ = f"_op_{OP_TABLE[op][0].lower()}"
    return apply


_OPS = (
    _op_identity,
    _op_autocontrast,
    _op_equalize,
    _geometric(ROTATE),
    _op_solarize,
    _op_color,
    _op_contrast,
    _op_brightness,
    _op_sharpness,
    _geometric(SHEAR_X),
    _geometric(TRANSLATE_X),
    _geometric(TRANSLATE_Y),
    _op_posterize,
    _geometric(SHEAR_Y),
    _op_cutout,
)


def apply_op(op: int, imgs: torch.Tensor, val: float, sign, x0, y0) -> torch.Tensor:
    """Op ``op`` of the table on a group of clips (G, T, H, W, C) uint8;
    sign, x0, y0 are per-clip host values (G,)."""
    return _OPS[op](imgs, val, np.asarray(sign, bool).reshape(-1),
                    np.asarray(x0, np.float32).reshape(-1), np.asarray(y0, np.float32).reshape(-1))


def _host(t, name):
    if isinstance(t, torch.Tensor):
        if t.device.type != "cpu":
            raise ValueError(f"{name} must stay on the host: the clips are grouped by op "
                             f"without reading the device")
        return t.numpy()
    return np.asarray(t)


def rand_augment_batch(imgs: torch.Tensor, op_indices, flip_sign, x0, y0, m: int = 10,
                       rows=None) -> torch.Tensor:
    """RandAugment of a batch of clips (B, T, H, W, C) uint8, each clip with
    its own draws (``draw_randaug``; host tensors or arrays): op_indices (B,
    n), flip_sign, x0, y0 (B,). ``rows`` (B,) bool on the host, if given,
    names the clips to augment; the others pass through.

    Per round, the clips are grouped by the op they drew (on the host, no
    device read); the geometric ops share one gather with a per-clip matrix,
    each other op runs once on its group. Clips that augment nothing are
    never copied. The input is not modified.
    """
    ops = _host(op_indices, "op_indices").astype(np.int64)
    sign = _host(flip_sign, "flip_sign").astype(bool)
    x0 = _host(x0, "x0").astype(np.float32)
    y0 = _host(y0, "y0").astype(np.float32)
    active = np.ones(ops.shape[0], bool) if rows is None else _host(rows, "rows").astype(bool)
    vals = op_magnitudes(m)
    out = imgs
    for r in range(ops.shape[1]):
        op_r = np.where(active, ops[:, r], 0)  # inactive clips: the identity
        groups = []
        geo = np.flatnonzero(np.isin(op_r, GEO_IDS))
        if geo.size:
            groups.append((geo, lambda x, g=op_r[geo], s=sign[geo]: _geometric_group(
                x, g, [vals[op] for op in g], s)))
        for op in range(1, NUM_OPS):
            clips = np.flatnonzero(op_r == op)
            if clips.size and op not in GEO_IDS:
                groups.append((clips, lambda x, op=op, c=clips: _OPS[op](
                    x, vals[op], sign[c], x0[c], y0[c])))
        if not groups:
            continue
        if out is imgs:
            out = imgs.clone()
        # one host-to-device copy of the round's clip indices
        order = host_to_device(np.concatenate([g for g, _ in groups]), imgs.device)
        start = 0
        for clips, fn in groups:
            sel = order[start:start + clips.size]
            start += clips.size
            # groups are disjoint: each reads only rows no other group writes
            out.index_copy_(0, sel, fn(out.index_select(0, sel)))
    return out


def rand_augment_clip(imgs: torch.Tensor, op_indices, flip_sign, x0, y0,
                      m: int = 10) -> torch.Tensor:
    """RandAugment of one clip (T, H, W, C) uint8 with its draws (op_indices
    (n,), scalars flip_sign, x0, y0)."""
    return rand_augment_batch(imgs[None], np.asarray(op_indices).reshape(1, -1),
                              np.asarray(flip_sign).reshape(1), np.asarray(x0).reshape(1),
                              np.asarray(y0).reshape(1), m)[0]
