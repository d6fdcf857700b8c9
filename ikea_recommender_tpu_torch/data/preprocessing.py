"""Session -> replay-buffer windowing (host side, vectorized numpy).

The port's own copy of ``ikea_recommender_tpu/data/preprocessing.py``
(reference ``data_utils/preprocessing.py:57-61,71-140,199-489``). Per
event row it builds

- ``state``              int[state_len]: the ``state_len`` items before this
                          event, padded with ``pad_id``;
- ``action``             int: the item of this event;
- ``true_state_len``     int: the number of real items in ``state``, clamped
                          to [1, state_len] (the empty first state counts as
                          one pad token, as the reference's packed sequences
                          need: ``data_utils/preprocessing.py:260``);

and, for the train buffer, ``r_act`` (the event's reward), ``next_state``,
``true_next_state_len`` and ``is_end``. Padding: ``pad_pos="end"`` gives
``[oldest..newest, pad...]``, ``pad_pos="beg"`` ``[pad..., oldest..newest]``.
One (N, state_len) gather-index matrix and two fancy-indexing passes do
it, linear in events x state_len.

:func:`window_sessions` and :func:`map_rewards` are numpy only. pandas is
imported only inside :func:`_read_frame` and the ``preprocess_*``
functions, the DataFrame-facing layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass
class WindowedSessions:
    """Array-of-columns replay buffer (row order == input row order)."""

    state: np.ndarray  # (N, L) int64
    action: np.ndarray  # (N,)
    next_state: np.ndarray  # (N, L) int64
    true_state_len: np.ndarray  # (N,) int64
    true_next_state_len: np.ndarray  # (N,) int64
    is_end: np.ndarray  # (N,) bool
    n_items_bef: np.ndarray  # (N,) int64 (unclamped, pre-forcing)

    def __len__(self) -> int:
        return len(self.action)


def _session_layout(
    session_ids: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Return (order, offsets, n_items_bef, is_last), the last three in
    sorted order, for a stable sort-by-session layout. ``order`` maps sorted
    position -> original row."""
    codes = np.unique(session_ids, return_inverse=True)[1]
    order = np.argsort(codes, kind="stable")
    sorted_codes = codes[order]
    n = len(codes)
    change = np.ones(n, dtype=bool)
    if n > 1:
        change[1:] = sorted_codes[1:] != sorted_codes[:-1]
    seg_start = np.flatnonzero(change)
    seg_id = np.cumsum(change) - 1
    offsets = seg_start[seg_id]
    n_bef = np.arange(n) - offsets
    seg_sizes = np.diff(np.concatenate([seg_start, [n]]))
    is_last = n_bef == (seg_sizes[seg_id] - 1)
    return order, offsets, n_bef, is_last


def _gather_windows(
    sorted_items: np.ndarray,
    offsets: np.ndarray,
    n_real: np.ndarray,
    state_len: int,
    pad_id: int,
    pad_pos: str,
) -> np.ndarray:
    """Build (N, L) windows of the last min(n_real, L) items ending at
    offsets + n_real (exclusive), padded to L at ``pad_pos``."""
    if pad_pos not in ("end", "beg"):
        raise ValueError(f"pad_pos must be 'end' or 'beg', got {pad_pos!r}")
    n = len(n_real)
    L = state_len
    k = np.minimum(n_real, L)  # real items per row
    start = offsets + n_real - k  # absolute index of oldest kept item
    j = np.arange(L)[None, :]  # (1, L) slot index
    if pad_pos == "end":
        real = j < k[:, None]
        src = start[:, None] + j
    else:
        lead_pad = (L - k)[:, None]
        real = j >= lead_pad
        src = start[:, None] + (j - lead_pad)
    src = np.clip(src, 0, max(len(sorted_items) - 1, 0))
    out = np.where(real, sorted_items[src], pad_id)
    return out


def window_sessions(
    items: np.ndarray,
    session_ids: np.ndarray,
    state_len: int,
    pad_id: int,
    pad_pos: str = "end",
) -> WindowedSessions:
    """Vectorized state/next_state windowing over (possibly interleaved)
    session rows. Row order of the output matches the input."""
    items = np.asarray(items)
    session_ids = np.asarray(session_ids)
    n = len(items)
    order, offsets, n_bef, is_last = _session_layout(session_ids)
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    sorted_items = items[order]

    state_sorted = _gather_windows(
        sorted_items, offsets, n_bef, state_len, pad_id, pad_pos
    )
    next_state_sorted = _gather_windows(
        sorted_items, offsets, n_bef + 1, state_len, pad_id, pad_pos
    )

    true_len_sorted = np.clip(n_bef, 1, state_len)
    true_next_len_sorted = np.minimum(n_bef + 1, state_len)

    return WindowedSessions(
        state=state_sorted[inv],
        action=items.copy(),
        next_state=next_state_sorted[inv],
        true_state_len=true_len_sorted[inv].astype(np.int64),
        true_next_state_len=true_next_len_sorted[inv].astype(np.int64),
        is_end=is_last[inv],
        n_items_bef=n_bef[inv].astype(np.int64),
    )


def map_rewards(
    action_types: np.ndarray, action_to_reward: Dict, default: float = 0.0
) -> np.ndarray:
    """Action type -> reward, ``default`` where unmapped (reference
    ``data_utils/preprocessing.py:57-61``, ``ikea/...:51-68``)."""
    out = np.full(len(action_types), default, dtype=np.float64)
    for act, rew in action_to_reward.items():
        out[action_types == act] = rew
    return out


# ---------------------------------------------------------------------------
# DataFrame-facing wrappers (reference ``data_utils/preprocessing.py:71-140,
# 199-489``). pandas only at this offline layer.
# ---------------------------------------------------------------------------


def _read_frame(src):
    import pandas as pd

    if isinstance(src, str):
        if src.endswith(".csv"):
            return pd.read_csv(src)
        if src.endswith(".json") or src.endswith(".jsonl"):
            return pd.read_json(src, orient="records", lines=True)
        return pd.read_pickle(src)
    return src.copy()


def _windows(df, padding_id, state_len, pad_pos, session_id_name, action_name):
    return window_sessions(
        items=df[action_name].to_numpy(),
        session_ids=df[session_id_name].to_numpy(),
        state_len=state_len,
        pad_id=padding_id,
        pad_pos=pad_pos,
    )


def preprocess_train_data(
    src,
    padding_id: int,
    state_len: int,
    pad_pos: str = "end",
    reward_name: str = "reward",
    session_id_name: str = "session_id",
    action_name: str = "item_id",
):
    """Session df -> the 7-column train replay-buffer df
    (reference ``data_utils/preprocessing.py:385-489``)."""
    import pandas as pd

    df = _read_frame(src)
    win = _windows(df, padding_id, state_len, pad_pos, session_id_name, action_name)
    return pd.DataFrame(
        {
            "state": list(win.state),
            "action": win.action,
            "r_act": df[reward_name].to_numpy(),
            "next_state": list(win.next_state),
            "true_state_len": win.true_state_len,
            "true_next_state_len": win.true_next_state_len,
            "is_end": win.is_end,
        }
    )


def preprocess_val_data(
    src,
    padding_id: int,
    state_len: int,
    pad_pos: str = "end",
    session_id_name: str = "session_id",
    action_name: str = "item_id",
):
    """Session df -> (state, action, true_state_len) eval df
    (reference ``data_utils/preprocessing.py:320-382``)."""
    import pandas as pd

    df = _read_frame(src)
    win = _windows(df, padding_id, state_len, pad_pos, session_id_name, action_name)
    return pd.DataFrame(
        {
            "state": list(win.state),
            "action": win.action,
            "true_state_len": win.true_state_len,
        }
    )


def preprocess_train_data_incl_act_rew(
    src,
    padding_id: int,
    state_len: int,
    incl_reward: bool = False,
    action_to_reward_dict: Optional[Dict] = None,
    pad_pos: str = "end",
    action_type_name: str = "is_buy",
    session_id_name: str = "session_id",
    action_name: str = "item_id",
):
    """The train df with each row's action type and, with ``incl_reward``,
    a ``reward`` column mapped from it (reference
    ``data_utils/preprocessing.py:199-317``)."""
    import pandas as pd

    df = _read_frame(src)
    win = _windows(df, padding_id, state_len, pad_pos, session_id_name, action_name)
    cols = {"state": list(win.state), "action": win.action}
    if incl_reward:
        cols["reward"] = map_rewards(
            df[action_type_name].to_numpy(), action_to_reward_dict or {}
        )
    cols.update(
        {
            "next_state": list(win.next_state),
            "action_type": df[action_type_name].to_numpy(),
            "true_state_len": win.true_state_len,
            "true_next_state_len": win.true_next_state_len,
            "is_end": win.is_end,
        }
    )
    return pd.DataFrame(cols)


def preprocess_val_data_incl_act_rew(
    src,
    padding_id: int,
    state_len: int,
    action_to_reward_dict: Optional[Dict] = None,
    pad_pos: str = "end",
    action_type_name: str = "is_buy",
    session_id_name: str = "session_id",
    action_name: str = "item_id",
):
    """The eval df with each row's action type and mapped reward
    (reference ``data_utils/preprocessing.py:71-140``)."""
    import pandas as pd

    df = _read_frame(src)
    win = _windows(df, padding_id, state_len, pad_pos, session_id_name, action_name)
    return pd.DataFrame(
        {
            "state": list(win.state),
            "action": win.action,
            "reward": map_rewards(df[action_type_name].to_numpy(), action_to_reward_dict or {}),
            "action_type": df[action_type_name].to_numpy(),
            "true_state_len": win.true_state_len,
        }
    )
