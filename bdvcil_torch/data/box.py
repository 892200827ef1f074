"""Detection-aware pipeline ops for ActorCutMix (the port's copy of
``bdvcil_tpu/data/box.py``; reference libs/pipelines/box.py).

Semantics preserved:
  * DetectionLoad — per-frame box lookup from ``all_detections`` with a score
    threshold (box.py:11-54): frame ``i`` of ``frame_inds`` reads
    ``all_detections[i + offset]``, and a box is kept only when its score is
    strictly above ``thres``
  * SceneCutOut — keep only pixels inside human boxes, fill elsewhere
    (box.py:70-113); no-op when the clip has no detections
  * ActorCutOut — erase human boxes with fill color (box.py:116-159)
  * BuildHumanMask — binary mask over boxes; whole-frame mask when no
    detections (box.py:162-207)
  * ResizeWithBox / RandomResizedCropWithBox / FlipWithBox — geometry ops that
    co-transform boxes (box.py:210-379)

Every op draws from ``results['rng']`` exactly as the JAX package's does.
"""

from __future__ import annotations

import numpy as np

from ..registry import PIPELINES
from .transforms import Flip, RandomResizedCrop, Resize, _imresize, _rescale_size, _rng


@PIPELINES.register_module()
class DetectionLoad:
    def __init__(self, thres: float = 0.4, **kwargs):
        self.thres = thres

    def __call__(self, results: dict) -> dict:
        detections = []
        frame_inds = np.asarray(results["frame_inds"])
        if frame_inds.ndim != 1:
            frame_inds = np.squeeze(frame_inds)
        offset = results.get("offset", 0)
        for frame_idx in frame_inds:
            cur = results["all_detections"][int(frame_idx) + offset]
            cur = (np.asarray(cur, dtype=np.float32).reshape(-1, 5) if len(cur)
                   else np.zeros((0, 5), np.float32))
            sel = cur[:, -1] > self.thres
            detections.append(cur[sel, :4].copy())
        results["detections"] = detections
        results.pop("all_detections", None)
        return results


def _has_boxes(results: dict) -> bool:
    return sum(det.shape[0] for det in results["detections"]) > 0


@PIPELINES.register_module()
class SceneCutOut:
    """Keep human-box pixels, fill the rest of the frame with fill_color."""

    def __init__(self, fill_color, **kwargs):
        self.fill_color = np.array(fill_color, dtype=np.uint8)

    def __call__(self, results: dict) -> dict:
        if not _has_boxes(results):
            return results
        for idx, cur in enumerate(results["detections"]):
            human_img = np.ones_like(results["imgs"][idx]) * self.fill_color
            for box in cur.astype(int):
                human_img[box[1] : box[3], box[0] : box[2], :] = results["imgs"][idx][
                    box[1] : box[3], box[0] : box[2], :
                ]
            results["imgs"][idx] = human_img
        return results


@PIPELINES.register_module()
class ActorCutOut:
    """Erase human boxes with fill_color."""

    def __init__(self, fill_color, **kwargs):
        self.fill_color = np.array(fill_color, dtype=np.uint8)

    def __call__(self, results: dict) -> dict:
        if not _has_boxes(results):
            return results
        for idx, cur in enumerate(results["detections"]):
            scene_img = results["imgs"][idx]
            for box in cur.astype(int):
                scene_img[box[1] : box[3], box[0] : box[2], :] = self.fill_color
            results["imgs"][idx] = scene_img
        return results


@PIPELINES.register_module()
class BuildHumanMask:
    """Binary (H, W, C) mask of human boxes; all-ones when no detections."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, results: dict) -> dict:
        num = len(results["detections"])
        if not _has_boxes(results):
            results["human_mask"] = [np.ones_like(results["imgs"][i]) for i in range(num)]
            return results
        human_mask = [np.zeros_like(results["imgs"][i]) for i in range(num)]
        for idx, cur in enumerate(results["detections"]):
            for box in cur.astype(int):
                human_mask[idx][box[1] : box[3], box[0] : box[2], :] = 1
        results["human_mask"] = human_mask
        return results


@PIPELINES.register_module()
class ResizeWithBox(Resize):
    def __call__(self, results: dict) -> dict:
        if "scale_factor" not in results:
            results["scale_factor"] = np.array([1, 1], dtype=np.float32)
        img_h, img_w = results["img_shape"]

        if self.keep_ratio:
            new_w, new_h = _rescale_size(img_w, img_h, self.scale)
        else:
            new_w, new_h = int(self.scale[0]), int(self.scale[1])

        scale_factor = np.array([new_w / img_w, new_h / img_h], dtype=np.float32)
        results["img_shape"] = (new_h, new_w)
        results["keep_ratio"] = self.keep_ratio
        results["scale_factor"] = results["scale_factor"] * scale_factor
        results["imgs"] = [
            _imresize(img, (new_w, new_h), self.interpolation) for img in results["imgs"]
        ]
        for idx, cur in enumerate(results["detections"]):
            cur[:, 0::2] = np.clip(cur[:, 0::2] * scale_factor[0], 0, new_w)
            cur[:, 1::2] = np.clip(cur[:, 1::2] * scale_factor[1], 0, new_h)
            results["detections"][idx] = cur
        return results


@PIPELINES.register_module()
class RandomResizedCropWithBox(RandomResizedCrop):
    """Random area/aspect crop co-transforming boxes (box.py:274-320); the
    crop box is ``RandomResizedCrop.get_crop_bbox``'s."""

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
        for idx, cur in enumerate(results["detections"]):
            cur[:, 0::2] = np.clip(cur[:, 0::2] - left, 0, new_w)
            cur[:, 1::2] = np.clip(cur[:, 1::2] - top, 0, new_h)
            results["detections"][idx] = cur
        return results


@PIPELINES.register_module()
class FlipWithBox(Flip):
    def __call__(self, results: dict) -> dict:
        assert results.get("modality", "RGB") == "RGB"
        rng = _rng(results)
        flip = rng.random() < self.flip_ratio
        results["flip"] = flip
        results["flip_direction"] = self.direction
        if flip:
            axis = 1 if self.direction == "horizontal" else 0
            results["imgs"] = [np.flip(img, axis=axis).copy() for img in results["imgs"]]
            img_h, img_w = results["img_shape"]
            for idx in range(len(results["detections"])):
                prev = results["detections"][idx]
                cur = prev.copy()
                if self.direction == "horizontal":
                    cur[:, 0] = img_w - prev[:, 2]
                    cur[:, 2] = img_w - prev[:, 0]
                else:
                    cur[:, 1] = img_h - prev[:, 3]
                    cur[:, 3] = img_h - prev[:, 1]
                results["detections"][idx] = cur
        return results
