"""Rawframe datasets: base, BackgroundMix and ActorCutMix (the port's copy
of ``bdvcil_tpu/data/datasets.py``).

The JAX package's re-design of the reference's dataset layer:
  * ``RawframeDataset`` — the mmaction2 base-class capability surface the
    reference builds on (video_infos from annotation files, train/test
    pipeline dispatch), with explicit per-sample RNG derived from
    (seed, epoch, index) instead of global ``random`` state, so every sample
    is reproducible and shardable across hosts.
  * ``BackgroundMixDataset`` — the headline background-debiasing dataset
    (reference libs/loader/comix_loader.py:16-179): per-video background
    lookup in ``bg_dir`` (same stem + extension), on-the-fly temporal-median
    extraction when missing, alpha-blend with probability ``prob``, mutual
    exclusion with RandAugment when ``with_randAug``.
  * ``ActorCutMixDataset`` — actor/scene compositing with human-box
    detections (reference libs/loader/actor_cut_mix_loader.py:11-167), on
    the box ops of ``data/box.py``.
"""

from __future__ import annotations

import copy
import os.path as osp
import pathlib
from typing import List, Optional

import cv2
import numpy as np

from ..registry import DATASETS
from . import box, rand_augment  # noqa: F401  (register the box ops and RandAugment)
from .annotations import read_annotation_file
from .transforms import Compose, _imresize


def build_dataset(cfg: dict):
    return DATASETS.build(dict(cfg))


@DATASETS.register_module()
class RawframeDataset:
    def __init__(
        self,
        ann_file: str,
        pipeline,
        data_prefix: Optional[str] = None,
        test_mode: bool = False,
        filename_tmpl: str = "img_{:05}.jpg",
        with_offset: bool = False,
        multi_class: bool = False,
        num_classes: Optional[int] = None,
        start_index: int = 1,
        modality: str = "RGB",
        sample_by_class: bool = False,
        power: float = 0.0,
        dynamic_length: bool = False,
        seed: int = 0,
        **kwargs,
    ):
        self.ann_file = ann_file
        # realpath to resolve symlinked roots, matching the reference contract
        # for exemplar annotation files (cil.py:348-355)
        self.data_prefix = osp.realpath(data_prefix) if data_prefix is not None else data_prefix
        self.test_mode = test_mode
        self.filename_tmpl = filename_tmpl
        self.with_offset = with_offset
        self.multi_class = multi_class
        self.num_classes = num_classes
        self.start_index = start_index
        self.modality = modality
        self.seed = seed
        self.epoch = 0

        self.pipeline = pipeline if isinstance(pipeline, Compose) else Compose(pipeline)
        self.video_infos = self.load_annotations()

    # -- annotations -------------------------------------------------------
    def load_annotations(self) -> List[dict]:
        infos = []
        if not self.ann_file or not osp.exists(str(self.ann_file)):
            # empty dataset constructor — used by CBF/merged-eval dataset
            # factories that fill video_infos afterwards (cil.py:147-148)
            return infos
        for rec in read_annotation_file(self.ann_file):
            frame_dir = rec.frame_dir
            if self.data_prefix is not None:
                frame_dir = osp.join(self.data_prefix, frame_dir)
            infos.append(
                dict(frame_dir=frame_dir, total_frames=rec.total_frames, label=rec.label)
            )
        return infos

    # -- rng ---------------------------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _make_rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, idx, int(self.test_mode)])
        )

    # -- sample preparation ------------------------------------------------
    def _base_results(self, idx: int) -> dict:
        results = copy.deepcopy(self.video_infos[idx])
        results["filename_tmpl"] = self.filename_tmpl
        results["modality"] = self.modality
        # a video_info may carry its own start_index (mixed 0-/1-based
        # rawframe layouts, cil_tools/predict.py discovery); dataset-level
        # start_index is the default
        results.setdefault("start_index", self.start_index)
        results["index"] = idx
        results["rng"] = self._make_rng(idx)
        return results

    def prepare_train_frames(self, idx: int) -> dict:
        return self.pipeline(self._base_results(idx))

    def prepare_test_frames(self, idx: int) -> dict:
        return self.pipeline(self._base_results(idx))

    def __getitem__(self, idx: int) -> dict:
        if self.test_mode:
            return self.prepare_test_frames(idx)
        return self.prepare_train_frames(idx)

    def __len__(self) -> int:
        return len(self.video_infos)


def bg_extraction_tmf(data_path: pathlib.Path, dest: Optional[pathlib.Path] = None) -> np.ndarray:
    """Temporal-median-filter background from a rawframe directory.

    Matches reference comix_loader.py:148-164 / extract_background.py:42-75:
    median over all frames, written as JPEG when ``dest`` given.
    """
    data_path = pathlib.Path(data_path)
    frames = []
    for img_f in sorted(data_path.glob("*")):
        img = cv2.imread(str(img_f))
        if img is not None:
            frames.append(img)
    if not frames:
        raise FileNotFoundError(f"no frames under {data_path}")
    median_frame = np.median(np.stack(frames, axis=0), axis=0).astype(np.uint8)
    if dest is not None:
        dest = pathlib.Path(dest)
        dest.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(dest), median_frame)
    return median_frame


@DATASETS.register_module()
class BackgroundMixDataset(RawframeDataset):
    def __init__(
        self,
        ann_file: str,
        pipeline,
        bg_dir: str,
        extract_bg_if_not_found: bool = True,
        back_ground_from_bg_dir: bool = True,
        map_bg_to_video: bool = True,
        merge_bg_files: bool = True,
        bg_image_extension: str = ".jpg",
        bg_resize: int = 256,
        bg_crop_size=(224, 224),
        bg_mean=(123.675, 116.28, 103.53),
        bg_std=(58.395, 57.12, 57.375),
        alpha: float = 0.5,
        prob: float = 0.25,
        with_randAug: bool = False,
        **kwargs,
    ):
        super().__init__(ann_file, pipeline, **kwargs)

        bg_dir = osp.realpath(bg_dir)
        self.bg_dir = pathlib.Path(bg_dir)
        self.bg_image_extension = bg_image_extension
        self.bg_dir.mkdir(exist_ok=True, parents=True)
        self.bg_resize = bg_resize
        self.bg_crop_size = tuple(bg_crop_size)
        self.bg_mean = np.array(bg_mean, dtype=np.float32)
        self.bg_std = np.array(bg_std, dtype=np.float32)
        self.alpha = alpha
        self.prob = prob
        self.with_randAug = with_randAug
        self.extract_bg_if_not_found = extract_bg_if_not_found
        self.back_ground_from_bg_dir = back_ground_from_bg_dir
        self.map_bg_to_video = map_bg_to_video
        self.merge_bg_files = merge_bg_files

        if self.back_ground_from_bg_dir:
            if map_bg_to_video:
                self.bg_files: List[str] = []
                for info in self.video_infos:
                    data_path = pathlib.Path(info["frame_dir"])
                    bg_image_file = (self.bg_dir / data_path.name).with_suffix(
                        self.bg_image_extension
                    )
                    if bg_image_file.exists():
                        self.bg_files.append(str(bg_image_file))
                    elif self.extract_bg_if_not_found:
                        bg_extraction_tmf(data_path, bg_image_file)
                        self.bg_files.append(str(bg_image_file))
            else:
                self.bg_files = [str(p) for p in self.bg_dir.glob("*")]
        else:
            self.bg_files = []

    # -- background machinery ---------------------------------------------
    def _bg_pipeline(self, bg_img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Resize short side -> random crop -> normalize (comix_loader.py:72-75)."""
        h, w = bg_img.shape[:2]
        scale = self.bg_resize / min(h, w)
        new_w, new_h = int(round(w * scale)), int(round(h * scale))
        bg_img = _imresize(bg_img, (new_w, new_h), "bilinear").astype(np.float32)

        crop_w, crop_h = self.bg_crop_size
        top = int(rng.integers(0, max(new_h - crop_h, 0) + 1))
        left = int(rng.integers(0, max(new_w - crop_w, 0) + 1))
        bg_img = bg_img[top : top + crop_h, left : left + crop_w]
        return (bg_img - self.bg_mean) / self.bg_std  # (H, W, C) float32

    def _get_bg_image(self, rng: np.random.Generator):
        if self.back_ground_from_bg_dir:
            bg_idx = int(rng.integers(len(self.bg_files)))
            bg_img = cv2.cvtColor(cv2.imread(self.bg_files[bg_idx]), cv2.COLOR_BGR2RGB)
            return bg_img, bg_idx
        video = self.video_infos[int(rng.integers(len(self.video_infos)))]
        frame_index = int(
            rng.integers(self.start_index, video["total_frames"] - 1 + self.start_index + 1)
        )
        path = osp.join(video["frame_dir"], self.filename_tmpl.format(frame_index))
        bg_img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        return bg_img, -2  # sentinel passes the bg_idx sanity check (comix_loader.py:136)

    def _mix_background(self, result: dict, rng: np.random.Generator) -> dict:
        bg_img, bg_idx = self._get_bg_image(rng)
        bg = self._bg_pipeline(bg_img, rng)  # (H, W, C)
        imgs = result["imgs"]
        if imgs.ndim == 4 and imgs.shape[1] == 3 and imgs.shape[-1] != 3:
            bg = np.transpose(bg, (2, 0, 1))[None]  # NCHW layout
        else:
            bg = bg[None]  # NHWC layout
        result["imgs"] = imgs * (1 - self.alpha) + bg * self.alpha
        result["bg_idx"] = bg_idx
        return result

    def prepare_train_frames(self, idx: int) -> dict:
        result = super().prepare_train_frames(idx)
        rng = result.get("rng") or self._make_rng(idx)
        result["bg_idx"] = -1

        if self.with_randAug:
            # mutual exclusion: bgmix exactly when randAug did not fire
            if not result["randAug"]:
                result = self._mix_background(result, rng)
        elif rng.random() < self.prob:
            result = self._mix_background(result, rng)

        if self.with_randAug:
            if result["randAug"]:
                assert result["bg_idx"] == -1
            else:
                assert result["bg_idx"] != -1
        return result


@DATASETS.register_module()
class ActorCutMixDataset(RawframeDataset):
    """Composites the human-box region of one video onto another's scene.

    Internal randAug/scene/action/out pipelines are hardcoded exactly like the
    reference (actor_cut_mix_loader.py:39-103); emits ``foreground_ratio`` and
    ``background_label`` consumed by ACMSmoothCE / the iCaRL step.
    """

    IMG_NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375], to_bgr=False)
    # the reference hardcodes 8-clip sampling inside every internal pipeline
    # (actor_cut_mix_loader.py:39-103); the trainer's fast-ACM gate compares
    # the model's num_segments against THIS constant so the two can't drift
    NUM_CLIPS = 8

    def __init__(
        self,
        ann_file: str,
        det_file: Optional[str],
        acm_prob: float = 1.0,
        **kwargs,
    ):
        randaug_pipeline = [
            dict(type="SampleFrames", clip_len=1, frame_interval=1, num_clips=self.NUM_CLIPS),
            dict(type="RawFrameDecode"),
            dict(type="Resize", scale=(-1, 256)),
            dict(type="RandAugment", n=2, m=10, prob=1),
            dict(
                type="MultiScaleCrop",
                input_size=224,
                scales=(1, 0.875, 0.75, 0.66),
                random_crop=False,
                max_wh_scale_gap=1,
                num_fixed_crops=13,
            ),
            dict(type="Resize", scale=(224, 224), keep_ratio=False),
        ]
        kwargs.pop("pipeline", None)
        super().__init__(ann_file, randaug_pipeline, **kwargs)
        self.randAug_pipeline = self.pipeline

        if det_file is not None:
            self.load_detections(det_file)
        self.det_file = det_file
        self.acm_prob = acm_prob

        self.scene_pipeline = Compose(
            [
                dict(type="SampleFrames", clip_len=1, frame_interval=1, num_clips=self.NUM_CLIPS),
                dict(type="RawFrameDecode"),
                dict(type="DetectionLoad", thres=0.4),
                dict(type="ResizeWithBox", scale=(-1, 256)),
                dict(type="FlipWithBox", flip_ratio=0.5),
                dict(type="ResizeWithBox", scale=(224, 224), keep_ratio=False),
                dict(type="ActorCutOut", fill_color=127),
            ]
        )
        self.action_pipeline = Compose(
            [
                dict(type="SampleFrames", clip_len=1, frame_interval=1, num_clips=self.NUM_CLIPS),
                dict(type="RawFrameDecode"),
                dict(type="DetectionLoad", thres=0.4),
                dict(type="ResizeWithBox", scale=(-1, 256)),
                dict(type="FlipWithBox", flip_ratio=0.5),
                dict(type="ResizeWithBox", scale=(224, 224), keep_ratio=False),
                dict(type="BuildHumanMask"),
                dict(type="SceneCutOut", fill_color=127),
            ]
        )
        self.out_pipeline = Compose(
            [
                dict(type="Normalize", **self.IMG_NORM),
                dict(type="FormatShape", input_format="NCHW"),
                dict(
                    type="Collect",
                    keys=["imgs", "label", "foreground_ratio", "background_label"],
                    meta_keys=[],
                ),
                dict(type="ToTensor", keys=["imgs", "label", "background_label"]),
            ]
        )

    def load_detections(self, det_file: str) -> None:
        """Merge human-box detections (.npy dict keyed by sequence name) into
        video_infos (actor_cut_mix_loader.py:105-115)."""
        dets = np.load(det_file, allow_pickle=True).item()
        for idx in range(len(self.video_infos)):
            seq_name = self.video_infos[idx]["frame_dir"].split("/")[-1]
            if "kinetics" in det_file:
                seq_name = seq_name[:11]
            self.video_infos[idx]["all_detections"] = dets[seq_name]

    def prepare_train_frames(self, idx: int) -> dict:
        results = self._base_results(idx)
        rng = results["rng"]
        if rng.random() < self.acm_prob:
            results = self.actor_cut_mix(results, rng)
        else:
            results = self.randAug_pipeline(results)
            results["foreground_ratio"] = 1
            results["background_label"] = -1
        return self.out_pipeline(results)

    def actor_cut_mix(self, result: dict, rng: np.random.Generator) -> dict:
        result = self.action_pipeline(result)

        scene_index = int(rng.integers(len(self.video_infos)))
        scene_video = self._base_results(scene_index)
        scene_video["rng"] = rng
        scene_video = self.scene_pipeline(scene_video)

        for frame_idx in range(len(result["imgs"])):
            actor_img = result["imgs"][frame_idx]
            scene_img = scene_video["imgs"][frame_idx]
            actor_mask = result["human_mask"][frame_idx]
            result["imgs"][frame_idx] = actor_img * actor_mask + scene_img * (1 - actor_mask)
        result["foreground_ratio"] = self._calc_foreground_ratio(result)
        result["background_label"] = scene_video["label"]
        return result

    @staticmethod
    def _calc_foreground_ratio(result: dict) -> float:
        h, w = result["imgs"][0].shape[:2]
        num_segments = len(result["imgs"])
        total_area = num_segments * w * h
        foreground_area = sum(float(m[:, :, 0].sum()) for m in result["human_mask"])
        return foreground_area / total_area

    def prepare_test_frames(self, idx: int) -> dict:
        raise NotImplementedError("ActorCutMixDataset is train-only (reference :166)")
