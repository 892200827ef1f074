"""iCaRL herding exemplar selection (the port's copy of ``bdvcil_tpu/cil/herding.py``).

Port of the reference ``Herding`` semantics (libs/cil/memory_selection.py:7-161)
to numpy (host): feature extraction is batched on device, the greedy selection
loop is tiny (budget x classes iterations over <=few-hundred vectors) and runs
on host.

Semantics preserved:
  * per-class greedy pick minimizing the distance between the running
    exemplar mean (including the candidate) and the full-class mean
    (memory_selection.py:76-93)
  * cosine distance on L2-normalized features with an L2-normalized class
    mean, or raw euclidean (memory_selection.py:148-161)
  * storing_methods 'videos' (features (videos, samples, dims), samples
    averaged) and 'clips' ((videos, clips, samples, dims) flattened to
    video-clips rows) (memory_selection.py:51-69)
  * budget_type 'fixed' (budget // num_classes per class) or 'class'
    (budget per class) (memory_selection.py:35-38)
  * returned meta per class: selected indices, dists, the full-set
    class_mean, and the gathered sample metadata (memory_selection.py:95-114)
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _l2_normalize(x: np.ndarray, axis: int = -1) -> np.ndarray:
    norm = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / np.maximum(norm, 1e-12)


class Herding:
    def __init__(
        self,
        budget_size: int,
        class_indices: Sequence[int],
        cosine_distance: bool = True,
        storing_methods: str = "videos",
        budget_type: str = "class",
    ):
        assert storing_methods in ("videos", "clips", "frames")
        assert budget_type in ("fixed", "class")
        if storing_methods == "frames":
            raise NotImplementedError("frame herding not supported (reference :128)")

        self.cosine_distance = cosine_distance
        self.storing_methods = storing_methods
        self.budget_type = budget_type
        self.budget_size = budget_size
        self.class_indices = list(class_indices)
        self.num_classes = len(self.class_indices)
        if budget_type == "fixed":
            self.num_exemplars_per_class = budget_size // self.num_classes
        else:
            self.num_exemplars_per_class = budget_size

    # -- public API --------------------------------------------------------
    def construct_exemplar(self, prediction_with_meta: Dict) -> Dict[int, Dict]:
        self._check_dimension(
            np.asarray(prediction_with_meta["repr_"]), np.asarray(prediction_with_meta["label"])
        )
        meta_by_class = self.split_meta_by_class(prediction_with_meta)
        exemplar_meta: Dict[int, Dict] = {}

        for class_idx, meta in meta_by_class.items():
            features = np.asarray(meta["repr_"], dtype=np.float64)
            if self.storing_methods == "videos":
                # (videos, samples, dims) -> (videos, dims)
                features = features[:, 0] if features.shape[1] == 1 else features.mean(axis=1)
            else:  # clips
                # (videos, clips, samples, dims) -> (videos*clips, dims)
                v, c = features.shape[0], features.shape[1]
                features = features.reshape(v * c, features.shape[2], features.shape[3])
                features = features[:, 0] if features.shape[1] == 1 else features.mean(axis=1)

            selected, dists, class_mean = self._greedy_select(features)
            exemplar_meta[class_idx] = {
                "indices": selected,
                "dist": dists,
                "class_mean": class_mean,
            }

        return self._update_exemplar(exemplar_meta, meta_by_class)

    # -- selection core ----------------------------------------------------
    def _greedy_select(self, features: np.ndarray):
        class_mean, normalized = self.calc_mean_features(features)

        n_pick = min(self.num_exemplars_per_class, features.shape[0])
        indexer = np.arange(features.shape[0])
        moving_mean = np.zeros((1, features.shape[-1]))
        selected: List[int] = []
        dists: List[float] = []

        for n in range(1, n_pick + 1):
            candidate_means = moving_mean * (n - 1) / n + normalized / n
            if self.cosine_distance:
                sims = _l2_normalize(candidate_means) @ _l2_normalize(class_mean).T
                dist = 1.0 - sims[:, 0]
            else:
                dist = np.linalg.norm(candidate_means - class_mean, axis=1)
            row = int(np.argmin(dist))
            moving_mean = moving_mean * (n - 1) / n + normalized[row] / n
            selected.append(int(indexer[row]))
            dists.append(float(dist[row]))
            keep = np.ones(normalized.shape[0], dtype=bool)
            keep[row] = False
            normalized = normalized[keep]
            indexer = indexer[keep]

        return selected, dists, class_mean

    def calc_mean_features(self, features: np.ndarray):
        """class mean over the full set; features normalized when cosine
        (memory_selection.py:148-161)."""
        normalized = _l2_normalize(features) if self.cosine_distance else features
        mean = features.reshape(-1, features.shape[-1]).mean(axis=0, keepdims=True)
        if self.cosine_distance:
            mean = _l2_normalize(mean)
        return mean, normalized

    # -- bookkeeping -------------------------------------------------------
    def _check_dimension(self, all_features: np.ndarray, labels: np.ndarray):
        if all_features.shape[0] != labels.shape[0]:
            raise ValueError("repr_ and label must share dim 0")
        if self.storing_methods == "videos" and all_features.ndim != 3:
            raise ValueError("expecting 3D features: (videos, samples, dims)")
        if self.storing_methods == "clips" and all_features.ndim != 4:
            raise ValueError("expecting 4D features: (videos, clips, samples, dims)")

    def split_meta_by_class(self, prediction_with_meta: Dict) -> Dict[int, Dict]:
        labels = np.asarray(prediction_with_meta["label"]).reshape(-1)
        frame_dir = prediction_with_meta["frame_dir"]
        out = {}
        for class_idx in self.class_indices:
            idxs = np.nonzero(labels == class_idx)[0]
            entry = {"frame_dir": [frame_dir[i] for i in idxs]}
            for key in ("total_frames", "label", "repr_", "cls_score"):
                if key in prediction_with_meta:
                    entry[key] = np.asarray(prediction_with_meta[key])[idxs]
            for key in ("clip_len", "num_clips", "frame_inds"):
                if key in prediction_with_meta:
                    entry[key] = np.asarray(prediction_with_meta[key])[idxs]
            out[class_idx] = entry
        return out

    def _update_exemplar(self, exemplar_meta: Dict, meta_by_class: Dict) -> Dict:
        for class_idx, meta in meta_by_class.items():
            picks = exemplar_meta[class_idx]["indices"]
            if self.storing_methods == "clips":
                # rows are video-clip pairs; map back to the owning video
                num_clips = np.asarray(meta["repr_"]).shape[1]
                video_rows = [p // num_clips for p in picks]
            else:
                video_rows = picks
            exemplar_meta[class_idx]["frame_dir"] = [meta["frame_dir"][i] for i in video_rows]
            for key in ("total_frames", "label", "clip_len", "frame_inds"):
                if key in meta:
                    exemplar_meta[class_idx][key] = meta[key][video_rows]
        return exemplar_meta
