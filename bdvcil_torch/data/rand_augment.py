"""Whole-clip-consistent RandAugment (host oracle, PIL-backed; the port's copy
of ``bdvcil_tpu/data/rand_augment.py``).

Reimplements the reference's FixMatch-flavoured video RandAugment
(libs/pipelines/rand_augment.py:19-264): 15 ops; per *clip* the op choice,
magnitude sign, and cutout location are sampled once and applied identically
to every frame; when a ``human_mask`` is present, geometric ops transform it
in lockstep with fill value 0. Sets ``results['randAug']`` which
BackgroundMixDataset uses for the randAug-XOR-bgmix mutual exclusion
(libs/loader/comix_loader.py:110-123).

PIL is used for the affine/enhance/histogram ops so outputs are bit-matched
with the reference by construction (BASELINE.md augmentation-fidelity goal).
The device-side variant lives in ops/rand_augment_dev.py.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import PIL
import PIL.ImageDraw
import PIL.ImageEnhance
import PIL.ImageOps
from PIL import Image

from ..registry import PIPELINES

# Mean pixel value as the out-of-image fill (reference rand_augment.py:16)
FILL_COLOR = (124, 116, 104)

GEOMETRIC_OPS = {"ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate"}


def shear_x(img, v, flip_sign, fillcolor=FILL_COLOR):
    if flip_sign:
        v = -v
    return img.transform(img.size, PIL.Image.AFFINE, (1, v, 0, 0, 1, 0), fillcolor=fillcolor)


def shear_y(img, v, flip_sign, fillcolor=FILL_COLOR):
    if flip_sign:
        v = -v
    return img.transform(img.size, PIL.Image.AFFINE, (1, 0, 0, v, 1, 0), fillcolor=fillcolor)


def translate_x(img, v, flip_sign, fillcolor=FILL_COLOR):
    if flip_sign:
        v = -v
    v = v * img.size[0]
    return img.transform(img.size, PIL.Image.AFFINE, (1, 0, v, 0, 1, 0), fillcolor=fillcolor)


def translate_y(img, v, flip_sign, fillcolor=FILL_COLOR):
    if flip_sign:
        v = -v
    v = v * img.size[1]
    return img.transform(img.size, PIL.Image.AFFINE, (1, 0, 0, 0, 1, v), fillcolor=fillcolor)


def rotate(img, v, flip_sign, fillcolor=FILL_COLOR):
    if flip_sign:
        v = -v
    return img.rotate(v, fillcolor=fillcolor)


def auto_contrast(img, _):
    return PIL.ImageOps.autocontrast(img)


def equalize(img, _):
    return PIL.ImageOps.equalize(img)


def solarize(img, v):
    return PIL.ImageOps.solarize(img, v)


def posterize(img, v):
    return PIL.ImageOps.posterize(img, max(1, int(v)))


def color(img, v):
    return PIL.ImageEnhance.Color(img).enhance(v)


def contrast(img, v):
    return PIL.ImageEnhance.Contrast(img).enhance(v)


def brightness(img, v):
    return PIL.ImageEnhance.Brightness(img).enhance(v)


def sharpness(img, v):
    return PIL.ImageEnhance.Sharpness(img).enhance(v)


def cutout_abs(img, v, init_loc, fillcolor=FILL_COLOR):
    if v < 0:
        return img
    w, h = img.size
    x0, y0 = init_loc
    x0 = int(max(0, x0 - v / 2.0))
    y0 = int(max(0, y0 - v / 2.0))
    x1 = min(w, x0 + v)
    y1 = min(h, y0 + v)
    img = img.copy()
    PIL.ImageDraw.Draw(img).rectangle((x0, y0, x1, y1), fillcolor)
    return img


def identity(img, v):
    return img


# FixMatch op table (arXiv 2001.07685 Table 12; reference rand_augment.py:200-216)
AUGMENT_LIST: List[Tuple] = [
    ("Identity", identity, 0.0, 1.0),
    ("AutoContrast", auto_contrast, 0, 1),
    ("Equalize", equalize, 0, 1),
    ("Rotate", rotate, 0, 30),
    ("Solarize", solarize, 0, 256),
    ("Color", color, 0.05, 0.95),
    ("Contrast", contrast, 0.05, 0.95),
    ("Brightness", brightness, 0.05, 0.95),
    ("Sharpness", sharpness, 0.05, 0.95),
    ("ShearX", shear_x, 0.0, 0.3),
    ("TranslateX", translate_x, 0.0, 0.3),
    ("TranslateY", translate_y, 0.0, 0.3),
    ("Posterize", posterize, 4, 8),
    ("ShearY", shear_y, 0.0, 0.3),
    ("CutoutAbs", cutout_abs, 0, 112),
]


@PIPELINES.register_module()
class RandAugment:
    def __init__(self, n: int, m: int, prob: float = 0.5):
        self.n = n
        self.m = m  # magnitude in [0, 30]
        self.prob = prob
        self.augment_list = AUGMENT_LIST

    def __call__(self, results: dict) -> dict:
        rng = results.get("rng") or np.random.default_rng()
        if rng.random() < self.prob:
            results["randAug"] = True
            return self._rand_aug(results, rng)
        results["randAug"] = False
        return results

    def _rand_aug(self, results: dict, rng: np.random.Generator) -> dict:
        # sample with replacement, like random.choices(k=n)
        op_indices = rng.integers(len(self.augment_list), size=self.n)
        # whole-clip-consistent parameters (reference rand_augment.py:239-244)
        flip_sign = rng.random() > 0.5
        H, W = results["imgs"][0].shape[:2]
        x0 = rng.uniform(0, W)
        y0 = rng.uniform(0, H)
        init_loc = (x0, y0)

        for op_idx in op_indices:
            name, op, minval, maxval = self.augment_list[int(op_idx)]
            val = (float(self.m) / 30) * float(maxval - minval) + minval
            for i in range(len(results["imgs"])):
                img = Image.fromarray(results["imgs"][i])
                mask = (
                    Image.fromarray(results["human_mask"][i])
                    if "human_mask" in results
                    else None
                )
                if name == "CutoutAbs":
                    results["imgs"][i] = np.array(op(img, val, init_loc))
                    if mask is not None:
                        results["human_mask"][i] = np.array(op(mask, val, init_loc, fillcolor=0))
                elif name in GEOMETRIC_OPS:
                    results["imgs"][i] = np.array(op(img, val, flip_sign))
                    if mask is not None:
                        results["human_mask"][i] = np.array(op(mask, val, flip_sign, fillcolor=0))
                else:
                    results["imgs"][i] = np.array(op(img, val))
        return results

    def __repr__(self):
        return f"RandAugment(n={self.n}, m={self.m}, prob={self.prob})"
