"""Session-level train/val/test split.

The port's own copy of ``ikea_recommender_tpu/data/split.py`` (reference
``ikea/data_utils/split_data.py:5-43``): shuffle the unique session ids
with a seeded ``np.random.RandomState``, slice by ratio, filter rows by
membership. pandas is imported only inside :func:`train_test_split`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def train_test_split_ids(
    session_ids: np.ndarray,
    ratio: Sequence[float] = (0.8, 0.1, 0.1),
    seed: int = 118,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return boolean row masks (train, val, test) over the input rows."""
    session_ids = np.asarray(session_ids)
    unique = np.unique(session_ids)  # session order is irrelevant post-shuffle
    n = len(unique)
    n_train = round(n * ratio[0])
    n_val = round(n * ratio[1])
    rng = np.random.RandomState(seed)
    rng.shuffle(unique)
    in_train = np.isin(session_ids, unique[:n_train])
    in_val = np.isin(session_ids, unique[n_train : n_train + n_val])
    in_test = ~(in_train | in_val)
    return in_train, in_val, in_test


def train_test_split(full_df, session_key: str = "sessionID", ratio=(0.8, 0.1, 0.1),
                     random_seed: int = 118):
    """DataFrame-facing wrapper with the reference signature."""
    import pandas as pd

    if isinstance(full_df, str):
        full_df = pd.read_csv(full_df)
    tr, va, te = train_test_split_ids(
        full_df[session_key].to_numpy(), ratio=ratio, seed=random_seed
    )
    return full_df[tr], full_df[va], full_df[te]
