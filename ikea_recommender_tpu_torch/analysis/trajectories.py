"""Replay-buffer trajectory mining: the buffer rows whose state or action
involve given items, and sampled model rollouts.

Port of ``ikea_recommender_tpu/analysis/trajectories.py`` (reference
``ikea/results/result_analysis.py:12-72``) over the port's
``data/replay_buffer.py`` buffers and ``run/serve.py::Recommender``, whose
``recommend`` returns tensors on its device: each call's ids are read back
once.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ikea_recommender_tpu_torch.data.replay_buffer import ReplayBuffer


def find_action_rows(buf: ReplayBuffer, item_ids: Sequence[int]) -> np.ndarray:
    """Row indices whose action is one of `item_ids`."""
    return np.flatnonzero(np.isin(buf.action, np.asarray(item_ids)))


def find_state_rows(buf: ReplayBuffer, item_ids: Sequence[int]) -> np.ndarray:
    """Row indices whose state contains any of `item_ids`."""
    return np.flatnonzero(np.isin(buf.state, np.asarray(item_ids)).any(axis=1))


def _top_ids(recommender, states, lens, k: int) -> np.ndarray:
    """(B, k) numpy ids of ``recommender``'s top-k: one read-back."""
    return recommender.recommend(states, lens, k=k)[1].cpu().numpy()


def sample_trajectories(
    recommender,
    start_items: Sequence[int],
    steps: int,
    state_len: int,
    pad_id: int,
    top_preds_to_show: int = 3,
    rng: Optional[np.random.Generator] = None,
) -> List[List[int]]:
    """Simulate customers who pick one of the model's top predictions at
    each step (reference ``repetitiveness.py:6-18``'s unfinished
    simulate_trajectories, completed). Returns item-id trajectories; the
    same ``rng`` draws the same picks as the reference's."""
    rng = rng or np.random.default_rng(0)
    trajectories = []
    for start in start_items:
        history = [int(start)]
        for _ in range(steps):
            window = history[-state_len:]
            state = np.full((1, state_len), pad_id, dtype=np.int32)
            state[0, : len(window)] = window
            lens = np.asarray([max(len(window), 1)], dtype=np.int32)
            idx = _top_ids(recommender, state, lens, top_preds_to_show)
            history.append(int(idx[0, rng.integers(top_preds_to_show)]))
        trajectories.append(history)
    return trajectories


def predict_and_describe(
    recommender,
    buf: ReplayBuffer,
    rows: Sequence[int],
    k: int,
    lookup_fn: Optional[Callable[[Sequence[int]], Dict[int, object]]] = None,
) -> List[Dict]:
    """Top-k predictions for selected buffer rows, with optional item
    metadata attached via ``lookup_fn`` (item ids -> metadata dict), a
    pluggable callback (BigQuery-, CSV- or dict-backed) where the reference
    (``ikea/results/result_analysis.py:129+``) hardwires a BigQuery query."""
    rows = np.asarray(rows)
    states = buf.state[rows]
    lens = buf.true_len[rows]
    idx = _top_ids(recommender, states, lens, k)
    all_ids = sorted(set(idx.ravel().tolist()) | set(buf.action[rows].tolist()))
    meta = lookup_fn(all_ids) if lookup_fn else {}
    out = []
    for r, row in enumerate(rows):
        out.append(
            {
                "row": int(row),
                "state": states[r, : lens[r]].tolist(),
                "true_action": int(buf.action[row]),
                "predictions": [
                    {"item": int(i), "meta": meta.get(int(i))} for i in idx[r]
                ],
            }
        )
    return out
