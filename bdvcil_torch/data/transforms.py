"""Host-side (numpy/cv2) video transform pipeline (the port's copy of
``bdvcil_tpu/data/transforms.py``; ``SampleFrames`` is registered from
``data/sampling.py``, and the crop box of ``RandomResizedCrop`` is drawn here;
``data/box.py``'s ``RandomResizedCropWithBox`` draws it through this class).

Provides the mmaction2 pipeline-op capability surface the reference configs
use (SURVEY.md §2.4 "Data pipeline ops"): SampleFrames (sampling.py),
RawFrameDecode, Resize, MultiScaleCrop, CenterCrop, TenCrop, ThreeCrop,
FiveCrop, Flip, Normalize, FormatShape, Collect, ToTensor, plus the
first-party MutexPipelines/PrintPipelines (libs/pipelines/mutex.py) and
FiveCrop (libs/pipelines/five_crops.py).

These numpy ops are the slow host pipeline: the trainer uses them when the
native decoder is unavailable or the config does not ask for the fast input
path, as the JAX trainer does; the fast path runs the normalization, blend and
crops on the device (``ops/augment.py``). All ops consume/produce a ``results`` dict and
draw randomness from ``results['rng']`` (numpy Generator) when present.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, List, Sequence, Tuple

import cv2
import numpy as np

from ..registry import PIPELINES
from .sampling import SampleFrames

PIPELINES.register_module()(SampleFrames)


def _rng(results: dict) -> np.random.Generator:
    rng = results.get("rng")
    if rng is None:
        rng = np.random.default_rng()
        results["rng"] = rng
    return rng


class Compose:
    """Chain of pipeline ops, built from config dicts or callables."""

    def __init__(self, transforms: Sequence):
        self.transforms = []
        for t in transforms:
            if callable(t):
                self.transforms.append(t)
            elif isinstance(t, dict):
                self.transforms.append(PIPELINES.build(t))
            else:
                raise TypeError(f"transform must be callable or dict, got {type(t)}")

    def __call__(self, results: dict) -> dict:
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results

    def __repr__(self):
        return f"Compose({self.transforms})"


@PIPELINES.register_module()
class RawFrameDecode:
    """Load the frames selected by ``frame_inds`` as RGB uint8 HWC arrays."""

    def __init__(self, decoding_backend: str = "cv2"):
        self.decoding_backend = decoding_backend

    def __call__(self, results: dict) -> dict:
        frame_dir = results["frame_dir"]
        filename_tmpl = results["filename_tmpl"]
        imgs = []
        cache: Dict[int, np.ndarray] = {}
        for idx in results["frame_inds"]:
            idx = int(idx)
            if idx in cache:
                imgs.append(cache[idx].copy())
                continue
            path = osp.join(frame_dir, filename_tmpl.format(idx))
            img = cv2.imread(path, cv2.IMREAD_COLOR)
            if img is None:
                raise FileNotFoundError(path)
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            cache[idx] = img
            imgs.append(img)
        results["imgs"] = imgs
        results["original_shape"] = imgs[0].shape[:2]
        results["img_shape"] = imgs[0].shape[:2]
        return results


def _rescale_size(w: int, h: int, scale: Tuple[float, float]) -> Tuple[int, int]:
    """mmcv.rescale_size semantics: fit (w, h) into scale keeping ratio."""
    max_long_edge = max(scale)
    max_short_edge = min(scale)
    factor = min(max_long_edge / max(h, w), max_short_edge / min(h, w))
    return int(w * factor + 0.5), int(h * factor + 0.5)


def _imresize(img: np.ndarray, size_wh: Tuple[int, int], interpolation: str = "bilinear") -> np.ndarray:
    interp = {
        "nearest": cv2.INTER_NEAREST,
        "bilinear": cv2.INTER_LINEAR,
        "bicubic": cv2.INTER_CUBIC,
        "area": cv2.INTER_AREA,
        "lanczos": cv2.INTER_LANCZOS4,
    }[interpolation]
    return cv2.resize(img, size_wh, interpolation=interp)


@PIPELINES.register_module()
class Resize:
    """Resize all clip frames.

    ``scale=(-1, S)`` rescales so the short side becomes S (keep_ratio);
    ``scale=(W, H), keep_ratio=False`` resizes exactly. Matches mmaction2
    Resize as used in every reference pipeline (config train_pipeline:126,128).
    """

    def __init__(self, scale, keep_ratio: bool = True, interpolation: str = "bilinear"):
        if isinstance(scale, (int, float)):
            scale = (np.inf, float(scale))
        else:
            scale = tuple(scale)
            max_long, max_short = max(scale), min(scale)
            if max_short == -1:
                scale = (np.inf, max_long)
        self.scale = scale
        self.keep_ratio = keep_ratio
        self.interpolation = interpolation

    def __call__(self, results: dict) -> dict:
        img_h, img_w = results["img_shape"]
        if self.keep_ratio:
            new_w, new_h = _rescale_size(img_w, img_h, self.scale)
        else:
            new_w, new_h = int(self.scale[0]), int(self.scale[1])

        scale_factor = np.array([new_w / img_w, new_h / img_h], dtype=np.float32)
        results["imgs"] = [
            _imresize(img, (new_w, new_h), self.interpolation) for img in results["imgs"]
        ]
        if "human_mask" in results:
            results["human_mask"] = [
                _imresize(m, (new_w, new_h), "nearest") for m in results["human_mask"]
            ]
        results["img_shape"] = (new_h, new_w)
        results["keep_ratio"] = self.keep_ratio
        results["scale_factor"] = results.get(
            "scale_factor", np.array([1, 1], dtype=np.float32)
        ) * scale_factor
        return results


def _crop_imgs(imgs: List[np.ndarray], x0: int, y0: int, w: int, h: int) -> List[np.ndarray]:
    return [img[y0 : y0 + h, x0 : x0 + w] for img in imgs]


@PIPELINES.register_module()
class MultiScaleCrop:
    """mmaction2 MultiScaleCrop: pick a (w, h) from scale products of the
    short side and one of 5/13 fixed spatial offsets (random_crop=False path,
    the one all reference configs use — config train_pipeline:129-135)."""

    def __init__(
        self,
        input_size,
        scales=(1,),
        max_wh_scale_gap: int = 1,
        random_crop: bool = False,
        num_fixed_crops: int = 5,
    ):
        self.input_size = (input_size, input_size) if isinstance(input_size, int) else tuple(input_size)
        self.scales = scales
        self.max_wh_scale_gap = max_wh_scale_gap
        self.random_crop = random_crop
        assert num_fixed_crops in (5, 13)
        self.num_fixed_crops = num_fixed_crops

    def __call__(self, results: dict) -> dict:
        rng = _rng(results)
        img_h, img_w = results["img_shape"]
        base_size = min(img_h, img_w)
        crop_sizes = [int(base_size * s) for s in self.scales]

        candidate_sizes = []
        for i, h in enumerate(crop_sizes):
            for j, w in enumerate(crop_sizes):
                if abs(i - j) <= self.max_wh_scale_gap:
                    candidate_sizes.append([w, h])

        crop_size = list(candidate_sizes[rng.integers(len(candidate_sizes))])
        for i in range(2):
            if abs(crop_size[i] - self.input_size[i]) < 3:
                crop_size[i] = self.input_size[i]
        crop_w, crop_h = crop_size

        if self.random_crop:
            x_offset = int(rng.integers(img_w - crop_w + 1))
            y_offset = int(rng.integers(img_h - crop_h + 1))
        else:
            w_step = (img_w - crop_w) // 4
            h_step = (img_h - crop_h) // 4
            candidate_offsets = [
                (0, 0),
                (4 * w_step, 0),
                (0, 4 * h_step),
                (4 * w_step, 4 * h_step),
                (2 * w_step, 2 * h_step),
            ]
            if self.num_fixed_crops == 13:
                candidate_offsets.extend(
                    [
                        (0, 2 * h_step),
                        (4 * w_step, 2 * h_step),
                        (2 * w_step, 4 * h_step),
                        (2 * w_step, 0),
                        (1 * w_step, 1 * h_step),
                        (3 * w_step, 1 * h_step),
                        (1 * w_step, 3 * h_step),
                        (3 * w_step, 3 * h_step),
                    ]
                )
            x_offset, y_offset = candidate_offsets[rng.integers(len(candidate_offsets))]

        results["imgs"] = _crop_imgs(results["imgs"], x_offset, y_offset, crop_w, crop_h)
        if "human_mask" in results:
            results["human_mask"] = _crop_imgs(
                results["human_mask"], x_offset, y_offset, crop_w, crop_h
            )
        results["crop_bbox"] = np.array(
            [x_offset, y_offset, x_offset + crop_w, y_offset + crop_h]
        )
        results["img_shape"] = (crop_h, crop_w)
        results["scales"] = self.scales
        return results


@PIPELINES.register_module()
class RandomCrop:
    """Random fixed-size crop (mmaction2 RandomCrop capability)."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, results: dict) -> dict:
        rng = _rng(results)
        img_h, img_w = results["img_shape"]
        crop_w, crop_h = self.size[0], self.size[1] if len(self.size) > 1 else self.size[0]
        x_offset = int(rng.integers(0, img_w - crop_w + 1))
        y_offset = int(rng.integers(0, img_h - crop_h + 1))
        results["imgs"] = _crop_imgs(results["imgs"], x_offset, y_offset, crop_w, crop_h)
        if "human_mask" in results:
            results["human_mask"] = _crop_imgs(
                results["human_mask"], x_offset, y_offset, crop_w, crop_h
            )
        results["crop_bbox"] = np.array(
            [x_offset, y_offset, x_offset + crop_w, y_offset + crop_h]
        )
        results["img_shape"] = (crop_h, crop_w)
        return results


@PIPELINES.register_module()
class RandomResizedCrop:
    """Random area/aspect crop (mmaction2 RandomResizedCrop capability; the
    box-aware variant is ``data/box.py``'s RandomResizedCropWithBox)."""

    def __init__(self, area_range=(0.08, 1.0), aspect_ratio_range=(3 / 4, 4 / 3)):
        self.area_range = area_range
        self.aspect_ratio_range = aspect_ratio_range

    @staticmethod
    def get_crop_bbox(img_shape, area_range, aspect_ratio_range, rng, max_attempts=10):
        """mmaction2 RandomResizedCrop.get_crop_bbox semantics (the JAX
        package keeps it on ``data/box.py``'s RandomResizedCropWithBox)."""
        assert 0 < area_range[0] <= area_range[1] <= 1
        assert 0 < aspect_ratio_range[0] <= aspect_ratio_range[1]
        img_h, img_w = img_shape
        area = img_h * img_w

        min_ar, max_ar = aspect_ratio_range
        aspect_ratios = np.exp(rng.uniform(np.log(min_ar), np.log(max_ar), size=max_attempts))
        target_areas = rng.uniform(*area_range, size=max_attempts) * area
        candidate_crop_w = np.round(np.sqrt(target_areas * aspect_ratios)).astype(np.int32)
        candidate_crop_h = np.round(np.sqrt(target_areas / aspect_ratios)).astype(np.int32)

        for i in range(max_attempts):
            crop_w = candidate_crop_w[i]
            crop_h = candidate_crop_h[i]
            if crop_h <= img_h and crop_w <= img_w:
                x_offset = int(rng.integers(0, img_w - crop_w + 1))
                y_offset = int(rng.integers(0, img_h - crop_h + 1))
                return x_offset, y_offset, x_offset + crop_w, y_offset + crop_h

        # fallback: center crop of the shorter edge
        crop_size = min(img_h, img_w)
        x_offset = (img_w - crop_size) // 2
        y_offset = (img_h - crop_size) // 2
        return x_offset, y_offset, x_offset + crop_size, y_offset + crop_size

    def __call__(self, results: dict) -> dict:
        rng = _rng(results)
        img_h, img_w = results["img_shape"]
        left, top, right, bottom = self.get_crop_bbox(
            (img_h, img_w), self.area_range, self.aspect_ratio_range, rng
        )
        new_h, new_w = bottom - top, right - left
        results["crop_bbox"] = np.array([left, top, right, bottom])
        results["img_shape"] = (new_h, new_w)
        results["imgs"] = [img[top:bottom, left:right] for img in results["imgs"]]
        if "human_mask" in results:
            results["human_mask"] = [
                m[top:bottom, left:right] for m in results["human_mask"]
            ]
        return results


@PIPELINES.register_module()
class CenterCrop:
    def __init__(self, crop_size):
        self.crop_size = (crop_size, crop_size) if isinstance(crop_size, int) else tuple(crop_size)

    def __call__(self, results: dict) -> dict:
        img_h, img_w = results["img_shape"]
        crop_w, crop_h = self.crop_size
        left = (img_w - crop_w) // 2
        top = (img_h - crop_h) // 2
        results["imgs"] = _crop_imgs(results["imgs"], left, top, crop_w, crop_h)
        if "human_mask" in results:
            results["human_mask"] = _crop_imgs(results["human_mask"], left, top, crop_w, crop_h)
        results["crop_bbox"] = np.array([left, top, left + crop_w, top + crop_h])
        results["img_shape"] = (crop_h, crop_w)
        return results


@PIPELINES.register_module()
class TenCrop:
    """4 corners + center, each with its horizontal flip (test-time).

    Matches mmaction2 TenCrop used by the reference's UCF101/HMDB51 test
    pipelines (config test_pipeline:164)."""

    def __init__(self, crop_size):
        self.crop_size = (crop_size, crop_size) if isinstance(crop_size, int) else tuple(crop_size)

    def __call__(self, results: dict) -> dict:
        imgs = results["imgs"]
        img_h, img_w = imgs[0].shape[:2]
        crop_w, crop_h = self.crop_size

        w_step = (img_w - crop_w) // 4
        h_step = (img_h - crop_h) // 4
        offsets = [
            (0, 0),
            (4 * w_step, 0),
            (0, 4 * h_step),
            (4 * w_step, 4 * h_step),
            (2 * w_step, 2 * h_step),
        ]
        img_crops = []
        crop_bboxes = []
        for x_offset, y_offset in offsets:
            crop = [
                img[y_offset : y_offset + crop_h, x_offset : x_offset + crop_w] for img in imgs
            ]
            flip_crop = [np.flip(c, axis=1).copy() for c in crop]
            bbox = [x_offset, y_offset, x_offset + crop_w, y_offset + crop_h]
            img_crops.extend(crop)
            img_crops.extend(flip_crop)
            crop_bboxes.extend([bbox for _ in range(len(imgs) * 2)])

        results["imgs"] = img_crops
        results["crop_bbox"] = np.array(crop_bboxes)
        results["img_shape"] = results["imgs"][0].shape[:2]
        return results


@PIPELINES.register_module()
class FiveCrop:
    """4 corners + center without flips (first-party op,
    libs/pipelines/five_crops.py:42-114)."""

    def __init__(self, crop_size):
        self.crop_size = (crop_size, crop_size) if isinstance(crop_size, int) else tuple(crop_size)

    def __call__(self, results: dict) -> dict:
        imgs = results["imgs"]
        img_h, img_w = imgs[0].shape[:2]
        crop_w, crop_h = self.crop_size

        w_step = (img_w - crop_w) // 4
        h_step = (img_h - crop_h) // 4
        offsets = [
            (0, 0),
            (4 * w_step, 0),
            (0, 4 * h_step),
            (4 * w_step, 4 * h_step),
            (2 * w_step, 2 * h_step),
        ]
        img_crops = []
        crop_bboxes = []
        for x_offset, y_offset in offsets:
            crop = [
                img[y_offset : y_offset + crop_h, x_offset : x_offset + crop_w] for img in imgs
            ]
            bbox = [x_offset, y_offset, x_offset + crop_w, y_offset + crop_h]
            img_crops.extend(crop)
            crop_bboxes.extend([bbox for _ in range(len(imgs) * 2)])

        results["imgs"] = img_crops
        results["crop_bbox"] = np.array(crop_bboxes)
        results["img_shape"] = results["imgs"][0].shape[:2]
        return results


@PIPELINES.register_module()
class ThreeCrop:
    """Three crops along the longer side (mmaction2 test-time op)."""

    def __init__(self, crop_size):
        self.crop_size = (crop_size, crop_size) if isinstance(crop_size, int) else tuple(crop_size)

    def __call__(self, results: dict) -> dict:
        imgs = results["imgs"]
        img_h, img_w = imgs[0].shape[:2]
        crop_w, crop_h = self.crop_size
        assert crop_h == img_h or crop_w == img_w

        if crop_h == img_h:
            w_step = (img_w - crop_w) // 2
            offsets = [(0, 0), (2 * w_step, 0), (w_step, 0)]
        else:
            h_step = (img_h - crop_h) // 2
            offsets = [(0, 0), (0, 2 * h_step), (0, h_step)]

        img_crops = []
        crop_bboxes = []
        for x_offset, y_offset in offsets:
            crop = [
                img[y_offset : y_offset + crop_h, x_offset : x_offset + crop_w] for img in imgs
            ]
            bbox = [x_offset, y_offset, x_offset + crop_w, y_offset + crop_h]
            img_crops.extend(crop)
            crop_bboxes.extend([bbox for _ in range(len(imgs))])

        results["imgs"] = img_crops
        results["crop_bbox"] = np.array(crop_bboxes)
        results["img_shape"] = results["imgs"][0].shape[:2]
        return results


@PIPELINES.register_module()
class Flip:
    """Whole-clip-consistent horizontal flip."""

    def __init__(self, flip_ratio: float = 0.5, direction: str = "horizontal"):
        assert direction in ("horizontal", "vertical")
        self.flip_ratio = flip_ratio
        self.direction = direction

    def __call__(self, results: dict) -> dict:
        rng = _rng(results)
        flip = rng.random() < self.flip_ratio
        results["flip"] = flip
        results["flip_direction"] = self.direction
        if flip:
            axis = 1 if self.direction == "horizontal" else 0
            results["imgs"] = [np.flip(img, axis=axis).copy() for img in results["imgs"]]
            if "human_mask" in results:
                results["human_mask"] = [
                    np.flip(m, axis=axis).copy() for m in results["human_mask"]
                ]
        return results


@PIPELINES.register_module()
class Normalize:
    def __init__(self, mean, std, to_bgr: bool = False):
        self.mean = np.array(mean, dtype=np.float32)
        self.std = np.array(std, dtype=np.float32)
        self.to_bgr = to_bgr

    def __call__(self, results: dict) -> dict:
        out = []
        for img in results["imgs"]:
            img = np.asarray(img, dtype=np.float32)
            if self.to_bgr:
                img = img[..., ::-1]
            out.append((img - self.mean) / self.std)
        results["imgs"] = out
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std, to_bgr=self.to_bgr)
        return results


@PIPELINES.register_module()
class FormatShape:
    """Stack frame list into one array.

    'NCHW' matches the reference configs; 'NHWC' is the TPU-native layout the
    device pipeline prefers (channels-last convs)."""

    def __init__(self, input_format: str):
        assert input_format in ("NCHW", "NHWC")
        self.input_format = input_format

    def __call__(self, results: dict) -> dict:
        imgs = np.stack(results["imgs"], axis=0)  # (M, H, W, C)
        if self.input_format == "NCHW":
            imgs = np.transpose(imgs, (0, 3, 1, 2))
        results["imgs"] = np.ascontiguousarray(imgs)
        results["input_shape"] = imgs.shape
        return results


@PIPELINES.register_module()
class Collect:
    def __init__(self, keys: Sequence[str], meta_keys: Sequence[str] = ()):
        self.keys = list(keys)
        self.meta_keys = list(meta_keys)

    def __call__(self, results: dict) -> dict:
        out = {}
        for key in self.keys:
            out[key] = results[key]
        for key in self.meta_keys:
            out[key] = results[key]
        if "rng" in results:
            out["rng"] = results["rng"]
        return out


@PIPELINES.register_module()
class ToTensor:
    """Convert keys to numpy arrays ready for batching (device transfer is
    done by the loader; there is no host tensor type in this framework).

    Ints become shape-(1,) int64 arrays to match the reference's batch
    contract where labels collate to (B, 1) (libs/cil/icarl.py:101)."""

    def __init__(self, keys: Sequence[str]):
        self.keys = list(keys)

    def __call__(self, results: dict) -> dict:
        for key in self.keys:
            value = results[key]
            if isinstance(value, (int, np.integer)):
                results[key] = np.array([value], dtype=np.int64)
            elif isinstance(value, float):
                results[key] = np.array([value], dtype=np.float32)
            else:
                results[key] = np.asarray(value)
        return results


@PIPELINES.register_module()
class MutexPipelines:
    """First sub-pipeline whose probability fires wins
    (libs/pipelines/mutex.py:7-25)."""

    def __init__(self, mutex_pipelines: List, probs: List[float]):
        if len(probs) != len(mutex_pipelines):
            raise ValueError("len(probs) must equal len(mutex_pipelines)")
        self.mutex_pipelines = [Compose(p) for p in mutex_pipelines]
        self.probs = probs

    def __call__(self, results: dict) -> dict:
        rng = _rng(results)
        for pipeline, prob in zip(self.mutex_pipelines, self.probs):
            if rng.random() < prob:
                return pipeline(results)
        return results


@PIPELINES.register_module()
class PrintPipelines:
    """Debug printer (libs/pipelines/mutex.py:28-38)."""

    def __init__(self, message: str):
        self.message = message

    def __call__(self, results: dict) -> dict:
        print(self.message)
        return results


@PIPELINES.register_module()
class Identity:
    """No-op placeholder (libs/pipelines/box.py:58-67)."""

    def __call__(self, results: dict) -> dict:
        return results
