"""The train input function's arithmetic, clip by clip: the yuv420 wire to
RGB, RandAugment, the whole-clip flip, the normalisation and the background
blend (BGMix).

Published descriptions followed:
  * libjpeg's decompression of 4:2:0: the "fancy" triangle upsample of the
    chroma planes (jdsample.c, h2v2_fancy_upsample: 3/4 nearer and 1/4
    farther sample on each axis, +8 and +7 rounding on even and odd output
    columns, edges replicated) and the fixed-point YCbCr to RGB transform
    (jdcolor.c, 16 fraction bits);
  * RandAugment as FixMatch's table (15 ops, N = 2, M = 10: the magnitude
    (M / 30) (max - min) + min), on PIL's semantics: geometric ops as an
    inverse affine map with nearest sampling at pixel centres and the fill
    colour outside; AutoContrast, Equalize, Solarize, Posterize by PIL's
    lookup tables; Color, Contrast, Brightness, Sharpness as PIL's blend of
    a degenerate image; CutoutAbs a square of side M filled with the fill
    colour. The draws (the two op indices, the sign, the cutout centre) are
    the loader's, from the wire batch;
  * the background blend of the reference's BGMix: (1 - a) x + a bg on the
    normalised clip and background, a = 0.5, where the clip is not
    RandAugmented.

Departures from PIL, each a change of at most one level on a few pixels,
taken as the system under test states them: the enhancement blends round
half to even in float32 where PIL's uint8 blend truncates; AutoContrast
maps (x - lo) * (255 / (hi - lo)) in float32 where PIL evaluates
x * scale + offset in double; the cutout box spans [x0, x0 + int(v)]
inclusive with the fill colour (124, 116, 104) of the reference's table.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
FILL = (124, 116, 104)
OPS = (("Identity", 0.0, 1.0), ("AutoContrast", 0.0, 1.0), ("Equalize", 0.0, 1.0),
       ("Rotate", 0.0, 30.0), ("Solarize", 0.0, 256.0), ("Color", 0.05, 0.95),
       ("Contrast", 0.05, 0.95), ("Brightness", 0.05, 0.95), ("Sharpness", 0.05, 0.95),
       ("ShearX", 0.0, 0.3), ("TranslateX", 0.0, 0.3), ("TranslateY", 0.0, 0.3),
       ("Posterize", 4.0, 8.0), ("ShearY", 0.0, 0.3), ("CutoutAbs", 0.0, 112.0))


def _upsample2x(p: torch.Tensor) -> torch.Tensor:
    """libjpeg h2v2 fancy upsample of (..., H, W) uint8 -> (..., 2H, 2W)."""
    p = p.to(torch.int64)
    h, w = p.shape[-2:]
    above = torch.cat([p[..., :1, :], p[..., :-1, :]], dim=-2)
    below = torch.cat([p[..., 1:, :], p[..., -1:, :]], dim=-2)
    out = torch.empty((*p.shape[:-2], 2 * h, 2 * w), dtype=torch.int64, device=p.device)
    for dy, near in ((0, above), (1, below)):
        col = 3 * p + near  # the vertical pass: 3/4 this row, 1/4 the nearer one
        left = torch.cat([col[..., :1], col[..., :-1]], dim=-1)
        right = torch.cat([col[..., 1:], col[..., -1:]], dim=-1)
        out[..., dy::2, 0::2] = (3 * col + left + 8) >> 4
        out[..., dy::2, 1::2] = (3 * col + right + 7) >> 4
    return out


def yuv420_to_rgb(y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """y (..., H, W), c (..., H/2, W/2, 2) CbCr, uint8 -> (..., H, W, 3) uint8."""
    cb = _upsample2x(c[..., 0]) - 128
    cr = _upsample2x(c[..., 1]) - 128
    yy = y.to(torch.int64)
    one_half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)

    r = yy + ((fix(1.40200) * cr + one_half) >> 16)
    g = yy + ((-fix(0.34414) * cb - fix(0.71414) * cr + one_half) >> 16)
    b = yy + ((fix(1.77200) * cb + one_half) >> 16)
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


# -- RandAugment, one clip (T, H, W, 3) uint8 at a time ---------------------


def _gray(x: torch.Tensor) -> torch.Tensor:
    """PIL's 'L': (R 19595 + G 38470 + B 7471 + 2^15) >> 16."""
    x = x.to(torch.int64)
    return (x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 32768) >> 16


def _blend(degenerate: torch.Tensor, img: torch.Tensor, factor: float) -> torch.Tensor:
    d = degenerate.to(torch.float32)
    f = float(np.float32(factor))
    return torch.round(d + f * (img.to(torch.float32) - d)).clamp(0, 255).to(torch.uint8)


def _affine(img: torch.Tensor, m) -> torch.Tensor:
    """PIL's AFFINE transform with NEAREST: the output pixel (x, y) takes the
    input at floor(a (x + .5) + b (y + .5) + c, d (x + .5) + e (y + .5) + f)."""
    t, h, w, _ = img.shape
    dev = img.device
    ys = torch.arange(h, dtype=torch.float64, device=dev)[:, None] + 0.5
    xs = torch.arange(w, dtype=torch.float64, device=dev)[None, :] + 0.5
    a, b, c, d, e, f = (float(v) for v in m)
    ix = torch.floor(a * xs + b * ys + c).to(torch.int64)
    iy = torch.floor(d * xs + e * ys + f).to(torch.int64)
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    out = img[:, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
    fill = torch.tensor(FILL, dtype=torch.uint8, device=dev)
    return torch.where(valid[None, :, :, None], out, fill)


def _matrix(name: str, v: float, h: int, w: int):
    """The inverse map of a geometric op; numbers as float32, the precision
    the loader's magnitudes are held in."""
    v = float(np.float32(v))
    if name == "Rotate":
        angle = -math.radians(v)  # PIL rotates by -angle in its matrix
        cos, sin = math.cos(angle), math.sin(angle)
        cx, cy = w / 2.0, h / 2.0
        return (cos, sin, cx - cx * cos - cy * sin, -sin, cos, cy + cx * sin - cy * cos)
    if name == "ShearX":
        return (1, v, 0, 0, 1, 0)
    if name == "ShearY":
        return (1, 0, 0, v, 1, 0)
    if name == "TranslateX":
        return (1, 0, v * w, 0, 1, 0)
    return (1, 0, 0, 0, 1, v * h)  # TranslateY


def _equalize(img: torch.Tensor) -> torch.Tensor:
    """PIL's equalize, per frame and channel."""
    out = img.clone()
    t, h, w, c = img.shape
    for i in range(t):
        for ch in range(c):
            plane = img[i, :, :, ch].reshape(-1).to(torch.int64)
            hist = torch.bincount(plane, minlength=256)
            nonzero = hist[hist > 0]
            if nonzero.numel() <= 1:
                continue
            step = int((int(nonzero.sum()) - int(nonzero[-1])) // 255)
            if step == 0:
                continue
            csum = torch.cumsum(hist, 0) - hist
            lut = ((step // 2 + csum) // step).clamp(0, 255)
            out[i, :, :, ch] = lut[plane].reshape(h, w).to(torch.uint8)
    return out


def apply_op(name: str, img: torch.Tensor, v: float, sign: bool, x0: float,
             y0: float) -> torch.Tensor:
    t, h, w, _ = img.shape
    if name == "Identity":
        return img
    if name in ("Rotate", "ShearX", "ShearY", "TranslateX", "TranslateY"):
        return _affine(img, _matrix(name, -v if sign else v, h, w))
    if name == "AutoContrast":
        lo = img.amin(dim=(1, 2), keepdim=True).to(torch.float32)
        hi = img.amax(dim=(1, 2), keepdim=True).to(torch.float32)
        span = torch.clamp(hi - lo, min=1e-12)
        scale = torch.full_like(span, 255.0) / span
        px = torch.clamp((img.to(torch.float32) - lo) * scale, 0, 255).to(torch.int64)
        return torch.where(hi > lo, px, img.to(torch.int64)).to(torch.uint8)
    if name == "Equalize":
        return _equalize(img)
    if name == "Solarize":
        thr = int(np.float32(v))
        return torch.where(img < thr, img, 255 - img)
    if name == "Color":
        g = _gray(img).to(torch.uint8)[..., None].expand(img.shape)
        return _blend(g, img, v)
    if name == "Contrast":
        mean = torch.floor(_gray(img).to(torch.float64).mean(dim=(1, 2)) + 0.5)
        return _blend(mean[:, None, None, None].expand(img.shape), img, v)
    if name == "Brightness":
        return _blend(torch.zeros_like(img), img, v)
    if name == "Sharpness":
        x = img.to(torch.float64)
        smooth = sum(x[:, dy:dy + h - 2, dx:dx + w - 2] * (5.0 if (dy, dx) == (1, 1) else 1.0)
                     for dy in range(3) for dx in range(3)) / 13.0
        degenerate = x.clone()
        degenerate[:, 1:-1, 1:-1] = torch.round(smooth).clamp(0, 255)
        return _blend(degenerate, img, v)
    if name == "Posterize":
        bits = max(int(np.float32(v)), 1)
        return img & ((0xFF << (8 - bits)) & 0xFF)
    if name == "CutoutAbs":
        v32 = np.float32(v)
        bx0 = int(max(np.float32(0), np.float32(x0) - v32 / np.float32(2)))
        by0 = int(max(np.float32(0), np.float32(y0) - v32 / np.float32(2)))
        bx1, by1 = min(w, bx0 + int(v32)), min(h, by0 + int(v32))
        out = img.clone()
        out[:, by0:by1 + 1, bx0:bx1 + 1] = torch.tensor(FILL, dtype=torch.uint8,
                                                         device=img.device)
        return out
    raise ValueError(f"unknown op {name!r}")


def rand_augment(img: torch.Tensor, ops, sign: bool, x0: float, y0: float,
                 m: int = 10) -> torch.Tensor:
    for op in ops:
        name, lo, hi = OPS[int(op)]
        img = apply_op(name, img, (m / 30.0) * (hi - lo) + lo, sign, x0, y0)
    return img


def input_fn(batch: Dict[str, torch.Tensor], alpha: float = 0.5, m: int = 10) -> torch.Tensor:
    """A yuv420 BGMix wire batch -> normalised float32 clips (B, T, S, S, 3)."""
    clips = yuv420_to_rgb(batch["imgs_y"], batch["imgs_c"])
    bg = yuv420_to_rgb(batch["bg_y"], batch["bg_c"]) if "bg_y" in batch else None
    dev = clips.device
    mean = torch.tensor(MEAN, dtype=torch.float32, device=dev)
    inv_std = 1.0 / torch.tensor(STD, dtype=torch.float32, device=dev)
    out = []
    for i in range(clips.shape[0]):
        clip = clips[i]
        if bool(batch["apply_randaug"][i]):
            clip = rand_augment(clip, batch["randaug_op_indices"][i].tolist(),
                                bool(batch["randaug_flip_sign"][i]),
                                float(batch["randaug_x0"][i]), float(batch["randaug_y0"][i]), m)
        if bool(batch["flip"][i]):
            clip = torch.flip(clip, dims=(2,))
        x = (clip.to(torch.float32) - mean) * inv_std
        if bg is not None and bool(batch["apply_bgmix"][i]):
            x = x * (1.0 - alpha) + ((bg[i].to(torch.float32) - mean) * inv_std)[None] * alpha
        out.append(x)
    return torch.stack(out)
