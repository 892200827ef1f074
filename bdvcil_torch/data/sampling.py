"""Frame-index sampling with mmaction2 ``SampleFrames`` semantics (the port's
copy of ``bdvcil_tpu/data/sampling.py:19``; ``data/transforms.py`` registers it
as a pipeline op).

Train mode jitters an offset inside each of ``num_clips`` segments; test mode
takes the segment centres. The generator is an explicit
``numpy.random.Generator``, so a clip's frames are a pure function of its
(seed, epoch, sample) and equal the JAX loaders' for the same generator.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SampleFrames:
    def __init__(
        self,
        clip_len: int,
        frame_interval: int = 1,
        num_clips: int = 1,
        temporal_jitter: bool = False,
        twice_sample: bool = False,
        out_of_bound_opt: str = "loop",
        test_mode: bool = False,
    ):
        if out_of_bound_opt not in ("loop", "repeat_last"):
            raise ValueError(f"out_of_bound_opt must be 'loop' or 'repeat_last', "
                             f"got {out_of_bound_opt!r}")
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.num_clips = num_clips
        self.temporal_jitter = temporal_jitter
        self.twice_sample = twice_sample
        self.out_of_bound_opt = out_of_bound_opt
        self.test_mode = test_mode

    def _get_train_clips(self, num_frames: int, rng: np.random.Generator) -> np.ndarray:
        ori_clip_len = self.clip_len * self.frame_interval
        avg_interval = (num_frames - ori_clip_len + 1) // self.num_clips
        if avg_interval > 0:
            base_offsets = np.arange(self.num_clips) * avg_interval
            return base_offsets + rng.integers(avg_interval, size=self.num_clips)
        if num_frames > max(self.num_clips, ori_clip_len):
            return np.sort(rng.integers(num_frames - ori_clip_len + 1, size=self.num_clips))
        if avg_interval == 0:
            ratio = (num_frames - ori_clip_len + 1.0) / self.num_clips
            return np.around(np.arange(self.num_clips) * ratio)
        return np.zeros((self.num_clips,), dtype=np.int64)

    def _get_test_clips(self, num_frames: int) -> np.ndarray:
        ori_clip_len = self.clip_len * self.frame_interval
        avg_interval = (num_frames - ori_clip_len + 1) / float(self.num_clips)
        if num_frames <= ori_clip_len - 1:
            return np.zeros((self.num_clips,), dtype=np.int64)
        base_offsets = np.arange(self.num_clips) * avg_interval
        clip_offsets = (base_offsets + avg_interval / 2.0).astype(np.int64)
        if self.twice_sample:
            clip_offsets = np.concatenate([clip_offsets, base_offsets.astype(np.int64)])
        return clip_offsets

    def __call__(self, results: dict) -> dict:
        """The pipeline op: ``frame_inds`` (shifted by ``start_index``) and
        the clip fields from ``results['total_frames']`` and ``results['rng']``."""
        frame_inds = self.sample(results["total_frames"], results.get("rng"))
        results["frame_inds"] = frame_inds + results.get("start_index", 0)
        results["clip_len"] = self.clip_len
        results["frame_interval"] = self.frame_interval
        results["num_clips"] = (
            self.num_clips * 2 if (self.test_mode and self.twice_sample) else self.num_clips
        )
        return results

    def sample(self, num_frames: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Flat frame indices, 0-based (before the ``start_index`` shift)."""
        if self.test_mode:
            clip_offsets = self._get_test_clips(num_frames)
        else:
            if rng is None:
                rng = np.random.default_rng()
            clip_offsets = self._get_train_clips(num_frames, rng)

        frame_inds = clip_offsets[:, None] + np.arange(self.clip_len)[None, :] * self.frame_interval
        frame_inds = np.concatenate(frame_inds)
        if self.temporal_jitter and not self.test_mode and rng is not None:
            frame_inds = frame_inds + rng.integers(self.frame_interval, size=len(frame_inds))

        frame_inds = frame_inds.reshape((-1, self.clip_len))
        if self.out_of_bound_opt == "loop":
            frame_inds = np.mod(frame_inds, num_frames)
        else:  # repeat_last
            safe_inds = frame_inds < num_frames
            unsafe_inds = 1 - safe_inds
            last_ind = np.max(safe_inds * frame_inds, axis=1)
            frame_inds = safe_inds * frame_inds + (unsafe_inds.T * last_ind).T
        return np.concatenate(frame_inds).astype(np.int64)
