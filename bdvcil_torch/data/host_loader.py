"""Batching data loader with threaded prefetch for the host pipeline (the
port's copy of ``bdvcil_tpu/data/loader.py``; the name keeps it apart from the
fast path's ``loaders.py``).

A thread pool runs the datasets' ``__getitem__`` (cv2/PIL release the GIL for
decode and resize). Batches are plain dicts of numpy arrays, which
``runtime/loops.py`` stages to the card. ``batch_size`` is the global batch;
under a process group each rank loads its contiguous rows of it
(``process_index``/``process_count`` default to the group's rank and size).
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

from ..parallel import distributed

_SKIP_KEYS = ("rng",)


def collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack numeric fields, keep strings/objects as lists.

    Ints were wrapped to shape-(1,) arrays by ToTensor, so labels collate to
    (B, 1) matching the reference batch contract (icarl.py:101).
    """
    out: Dict[str, Any] = {}
    keys = [k for k in samples[0].keys() if k not in _SKIP_KEYS]
    for key in keys:
        values = [s[key] for s in samples]
        first = values[0]
        if isinstance(first, np.ndarray):
            out[key] = np.stack(values, axis=0)
        elif isinstance(first, (bool, np.bool_)):
            out[key] = np.array(values, dtype=bool)
        elif isinstance(first, (int, np.integer)):
            out[key] = np.array(values, dtype=np.int64)
        elif isinstance(first, (float, np.floating)):
            out[key] = np.array(values, dtype=np.float32)
        else:
            out[key] = list(values)
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 4,
        drop_last: bool = False,
        seed: int = 0,
        prefetch_batches: int = 2,
        pad_to_batch: bool = False,
        process_index: int = None,
        process_count: int = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size  # GLOBAL batch size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        # pad the final partial batch by wrapping indices and emit a
        # 'sample_weight' field (0 on pad rows) — keeps every sample like the
        # reference's variable last batch while batch shapes stay static for
        # jit and mesh-divisible for sharding
        self.pad_to_batch = pad_to_batch
        # multi-process: every process computes the same global batch order
        # (seeded shuffle) and loads only its contiguous row slice; the
        # runtime reassembles the global batch on the mesh (parallel/mesh.py
        # shard_batch). Replaces the reference's DistributedSampler shards.
        # (the process group's rank and size unless given)
        self.process_count = max(1, process_count or distributed.process_count())
        self.process_index = (distributed.process_index() if process_index is None
                              else process_index)
        if self.process_count > 1:
            assert batch_size % self.process_count == 0, (batch_size, self.process_count)
            self.pad_to_batch = self.pad_to_batch or not self.drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch]))
            rng.shuffle(indices)
        batches = [
            indices[i : i + self.batch_size] for i in range(0, n, self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.pad_to_batch and batches and len(batches[-1]) < self.batch_size:
            short = batches[-1]
            pad = indices[: self.batch_size - len(short)]
            while len(short) + len(pad) < self.batch_size:  # tiny datasets
                pad = np.concatenate([pad, pad])[: self.batch_size - len(short)]
            batches[-1] = np.concatenate([short, pad[: self.batch_size - len(short)]])
            self._last_valid = len(short)
        else:
            self._last_valid = None
        return batches

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._batch_indices()
        if not batches:
            return
        # per-process contiguous slice of every global batch
        if self.process_count > 1:
            per = self.batch_size // self.process_count
            lo = self.process_index * per
            slices = [(idxs[lo : lo + per], lo, lo + per) for idxs in batches]
        else:
            slices = [(idxs, 0, len(idxs)) for idxs in batches]
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # pipeline: submit up to prefetch_batches batches ahead
            pending: "queue.Queue" = queue.Queue()
            it = iter(slices)

            def submit_next():
                try:
                    idxs, lo, hi = next(it)
                except StopIteration:
                    return False
                futures = [pool.submit(self.dataset.__getitem__, int(i)) for i in idxs]
                pending.put((futures, lo, hi))
                return True

            ahead = 1 + self.prefetch_batches
            for _ in range(ahead):
                if not submit_next():
                    break
            batch_idx = 0
            while not pending.empty():
                futures, lo, hi = pending.get()
                samples = [f.result() for f in futures]
                submit_next()
                batch = collate(samples)
                if self.pad_to_batch:
                    # weights over the GLOBAL batch row range, sliced locally
                    weights = np.ones(self.batch_size, np.float32)
                    if batch_idx == len(batches) - 1 and self._last_valid is not None:
                        weights[self._last_valid :] = 0.0
                    batch["sample_weight"] = weights[lo:hi]
                batch_idx += 1
                yield batch
