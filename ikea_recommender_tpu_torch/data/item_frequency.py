"""Unpopular-item (low frequency) set construction.

The port's own copy of ``ikea_recommender_tpu/data/item_frequency.py``
(reference ``data_utils/item_frequency.py:8-48``): value counts -> a
quantile threshold -> the item ids strictly below it, saved as JSON and
loaded as a Python set. The eval protocol takes the set as a bool mask of
shape ``(num_actions,)``, so novelty and coverage are gathers.
"""

from __future__ import annotations

import json
import pickle
from typing import Iterable, Set

import numpy as np


def get_low_frequency_items(items: np.ndarray, quantile: float) -> np.ndarray:
    """Item ids whose frequency is strictly below the `quantile` quantile of
    the (descending) frequency distribution."""
    ids, counts = np.unique(np.asarray(items), return_counts=True)
    thresh = np.quantile(counts, q=quantile)
    return ids[counts < thresh]


def save_unpopular_items(items: np.ndarray, path: str, quantile: float = 0.9) -> None:
    unpopular = get_low_frequency_items(items, quantile=quantile)
    with open(path, "w") as fh:
        json.dump([int(i) for i in unpopular], fh)


def load_unpopular_items(path: str) -> Set:
    """JSON or pickle list -> set (reference ``item_frequency.py:38-48``)."""
    if "pkl" in path:
        with open(path, "rb") as fh:
            return set(pickle.load(fh))
    with open(path, "r") as fh:
        return set(json.load(fh))


def unpopular_mask(unpopular: Iterable[int], num_actions: int) -> np.ndarray:
    """Set -> (num_actions,) bool device mask."""
    mask = np.zeros(num_actions, dtype=bool)
    ids = np.fromiter((int(i) for i in unpopular), dtype=np.int64)
    ids = ids[(ids >= 0) & (ids < num_actions)]
    mask[ids] = True
    return mask
