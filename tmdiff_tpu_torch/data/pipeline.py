"""Host-side input pipeline (port of tmdiff_tpu/data/pipeline.py): infinite
shuffled batches and per-step sensor mixing, with the same numpy generators,
so a seed gives the JAX package's batch and sensor sequences.

The reference draws one sensor per step with probability proportional to
4 len(QB) : 4 len(GF2) : 8 len(WV3)
(`general_sharpening_joint_random_batch_finetune.py:45-53, 155-165`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class BatchIterator:
    """Infinite shuffled epoch cycler over a dataset with `batch(idx)`."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 3407,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self._order = np.arange(len(dataset))
        self._pos = len(dataset)  # reshuffle on the first draw

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        n = len(self.dataset)
        if self._pos + self.batch_size > n:
            if self.shuffle:
                self.rng.shuffle(self._order)
            self._pos = 0
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return self.dataset.batch(idx)


class SensorMixer:
    """Per-step sensor choice, length-weighted: sensor k is drawn with
    probability weights[k] * len(iterators[k]), normalised. The weights
    default to the reference's 4:4:8."""

    DEFAULT_WEIGHTS = {"QB": 4.0, "GF2": 4.0, "WV3": 8.0}

    def __init__(self, iterators: dict, weights: Optional[dict] = None, seed: int = 3407):
        self.iterators = iterators
        weights = weights or {k: self.DEFAULT_WEIGHTS.get(k, 1.0) for k in iterators}
        raw = np.array([weights[k] * len(iterators[k]) for k in iterators], dtype=np.float64)
        self.sensors = list(iterators.keys())
        self.probs = raw / raw.sum()
        self.rng = np.random.default_rng(seed)

    def __next__(self) -> tuple[dict, str]:
        sensor = self.sensors[self.rng.choice(len(self.sensors), p=self.probs)]
        return next(self.iterators[sensor]), sensor

    def __iter__(self):
        return self
