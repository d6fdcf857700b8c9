"""Deterministic synthetic clickstream generator.

The port's own copy of ``ikea_recommender_tpu/data/synthetic.py``: sessions
follow a noisy successor process (item -> item+1 mod A with probability
``p``), so next-item prediction is learnable and an end-to-end run has a
known signal. The same seed gives the same arrays as the reference
(``np.random.RandomState``, drawn in the same order).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ikea_recommender_tpu_torch.data.preprocessing import window_sessions
from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer, ReplayBuffer


def synthetic_sessions(
    num_sessions: int,
    num_items: int,
    mean_len: int = 8,
    p_successor: float = 0.8,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (items, session_ids) event arrays."""
    rs = np.random.RandomState(seed)
    items, sids = [], []
    for s in range(num_sessions):
        length = max(2, int(rs.poisson(mean_len)))
        cur = rs.randint(num_items)
        for _ in range(length):
            items.append(cur)
            sids.append(s)
            if rs.rand() < p_successor:
                cur = (cur + 1) % num_items
            else:
                cur = rs.randint(num_items)
    return np.asarray(items), np.asarray(sids)


def synthetic_buffers(
    num_sessions: int = 200,
    num_items: int = 50,
    state_len: int = 10,
    pad_pos: str = "end",
    seed: int = 0,
    reward: float = 1.0,
) -> Tuple[ReplayBuffer, EvalBuffer]:
    """Windowed train + eval buffers over one synthetic log (pad id =
    num_items, the reference convention)."""
    items, sids = synthetic_sessions(num_sessions, num_items, seed=seed)
    win = window_sessions(items, sids, state_len, pad_id=num_items, pad_pos=pad_pos)
    train = ReplayBuffer(
        state=win.state,
        action=win.action,
        reward=np.full(len(win), reward, dtype=np.float32),
        next_state=win.next_state,
        true_len=win.true_state_len,
        true_next_len=win.true_next_state_len,
        is_end=win.is_end,
    )
    return train, EvalBuffer.from_replay_buffer(train)
