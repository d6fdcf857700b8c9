"""Replay buffers and their fixed-shape batches.

The port's own copy of ``ikea_recommender_tpu/data/replay_buffer.py`` (the
reference's ``ikea/data_utils/replay_buffer.py:6-127``): columnar numpy
storage of the train buffer (the 7-column contract) and the eval buffer,
and iterators of batches that all have one shape, the trailing partial
batch padded by repeating its first row and carrying a ``valid`` mask that
every loss and metric respects.

On-disk formats: ``.npz`` (the native columnar format, numpy only), JSON
lines (read through ``data/storage.py`` and parsed by the native parser of
``data/native.py``, which needs numpy and a C++ compiler; pandas where it
cannot be built or the rows carry a column it does not know) and pickled
DataFrames (the RetailRocket generation, pandas). Files written by either
package load in the other.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class Batch:
    """One fixed-shape training batch (numpy)."""

    state: np.ndarray  # (B, L) int32
    action: np.ndarray  # (B,) int32
    reward: np.ndarray  # (B,) float32
    next_state: np.ndarray  # (B, L) int32
    true_len: np.ndarray  # (B,) int32
    true_next_len: np.ndarray  # (B,) int32
    is_end: np.ndarray  # (B,) bool
    valid: np.ndarray  # (B,) bool, False on padded tail rows


@dataclass
class EvalBatch:
    state: np.ndarray  # (B, L) int32
    action: np.ndarray  # (B,) int32
    true_len: np.ndarray  # (B,) int32
    valid: np.ndarray  # (B,) bool
    action_type: Optional[np.ndarray] = None  # (B,) int32 when carried


_TRAIN_COLS = (
    "state",
    "action",
    "r_act",
    "next_state",
    "true_state_len",
    "true_next_state_len",
    "is_end",
    # optional: each row's action-type id (enables metrics.action_type_names)
    "action_type",
)
_EVAL_COLS = ("state", "action", "true_state_len", "action_type")


def _load_columns(path: str, columns):
    """{column: array} of the ``columns`` the file holds."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {c: data[c] for c in columns if c in data}
    if path.endswith(".json") or path.endswith(".jsonl"):
        from ikea_recommender_tpu_torch.data import native
        from ikea_recommender_tpu_torch.data.storage import Storage

        with Storage().open(path, "rb") as f:
            raw = f.read()
        cols = native.parse_jsonl_buffer(raw, columns)
        if cols is not None:
            return cols
    import pandas as pd

    if path.endswith(".json") or path.endswith(".jsonl"):
        df = pd.read_json(path, orient="records", lines=True)
    else:
        df = pd.read_pickle(path)
    out = {}
    for c in columns:
        if c not in df.columns:
            continue
        col = df[c].values
        if len(col) and isinstance(col[0], (list, np.ndarray)):
            out[c] = np.asarray(col.tolist())
        else:
            out[c] = df[c].to_numpy()
    return out


class ReplayBuffer:
    """Training buffer: the 7-column contract, fully materialized as arrays
    (the reference materializes to numpy at init too,
    ``ikea/data_utils/replay_buffer.py:51-57``)."""

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        state: Optional[np.ndarray] = None,
        action: Optional[np.ndarray] = None,
        reward: Optional[np.ndarray] = None,
        next_state: Optional[np.ndarray] = None,
        true_len: Optional[np.ndarray] = None,
        true_next_len: Optional[np.ndarray] = None,
        is_end: Optional[np.ndarray] = None,
        action_type: Optional[np.ndarray] = None,
    ):
        if path is not None:
            cols = _load_columns(path, _TRAIN_COLS)
            state = cols["state"]
            action = cols["action"]
            reward = cols["r_act"]
            next_state = cols["next_state"]
            true_len = cols["true_state_len"]
            true_next_len = cols["true_next_state_len"]
            is_end = cols["is_end"]
            action_type = cols.get("action_type")
        self.state = np.asarray(state, dtype=np.int32)
        self.action = np.asarray(action, dtype=np.int32)
        self.reward = np.asarray(reward, dtype=np.float32)
        self.next_state = np.asarray(next_state, dtype=np.int32)
        self.true_len = np.asarray(true_len, dtype=np.int32)
        self.true_next_len = np.asarray(true_next_len, dtype=np.int32)
        self.is_end = np.asarray(is_end, dtype=bool)
        self.action_type = None if action_type is None else np.asarray(action_type, np.int32)

    @classmethod
    def from_dataframe(cls, df) -> "ReplayBuffer":
        return cls(
            state=np.asarray(df["state"].values.tolist()),
            action=df["action"].to_numpy(),
            reward=df["r_act"].to_numpy(),
            next_state=np.asarray(df["next_state"].values.tolist()),
            true_len=df["true_state_len"].to_numpy(),
            true_next_len=df["true_next_state_len"].to_numpy(),
            is_end=df["is_end"].to_numpy(),
        )

    def save_npz(self, path: str) -> None:
        cols = dict(
            state=self.state,
            action=self.action,
            r_act=self.reward,
            next_state=self.next_state,
            true_state_len=self.true_len,
            true_next_state_len=self.true_next_len,
            is_end=self.is_end,
        )
        if self.action_type is not None:
            cols["action_type"] = self.action_type
        np.savez_compressed(path, **cols)

    def __len__(self) -> int:
        return len(self.action)


class EvalBuffer:
    """Evaluation buffer: (state, action, true_state_len) and optionally
    each row's action type (reference ``ikea/data_utils/replay_buffer.py:85-127``)."""

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        state: Optional[np.ndarray] = None,
        action: Optional[np.ndarray] = None,
        true_len: Optional[np.ndarray] = None,
        action_type: Optional[np.ndarray] = None,
    ):
        if path is not None:
            cols = _load_columns(path, _EVAL_COLS)
            state = cols["state"]
            action = cols["action"]
            true_len = cols["true_state_len"]
            action_type = cols.get("action_type")
        self.state = np.asarray(state, dtype=np.int32)
        self.action = np.asarray(action, dtype=np.int32)
        self.true_len = np.asarray(true_len, dtype=np.int32)
        self.action_type = None if action_type is None else np.asarray(action_type, np.int32)

    @classmethod
    def from_dataframe(cls, df) -> "EvalBuffer":
        return cls(
            state=np.asarray(df["state"].values.tolist()),
            action=df["action"].to_numpy(),
            true_len=df["true_state_len"].to_numpy(),
        )

    @classmethod
    def from_replay_buffer(cls, buf: ReplayBuffer) -> "EvalBuffer":
        return cls(
            state=buf.state, action=buf.action, true_len=buf.true_len,
            action_type=buf.action_type,
        )

    def save_npz(self, path: str) -> None:
        cols = dict(state=self.state, action=self.action, true_state_len=self.true_len)
        if self.action_type is not None:
            cols["action_type"] = self.action_type
        np.savez_compressed(path, **cols)

    def __len__(self) -> int:
        return len(self.action)


def load_eval_source(
    path: str,
    *,
    padding_id: int,
    state_len: int,
    pad_pos: str = "end",
    session_col: str = "session_id",
    item_col: str = "item_id",
) -> EvalBuffer:
    """Eval data from either a prebuilt eval buffer or a raw session file.

    A prebuilt buffer has a ``state`` column (or is an ``.npz``); a raw
    val/test session file has session-id and item columns and is windowed in
    memory by ``preprocess_val_data`` (the reference's
    ``evaluate/eval_dataset.py:6-77``). A JSON-lines file is told apart by
    its first row, so that a prebuilt one loads without pandas."""
    from ikea_recommender_tpu_torch.data.preprocessing import _read_frame, preprocess_val_data

    if path.endswith(".npz") or _jsonl_first_row_has(path, "state"):
        return EvalBuffer(path)
    df = _read_frame(path)
    if "state" in df.columns:
        return EvalBuffer(path)
    if session_col not in df.columns or item_col not in df.columns:
        raise ValueError(
            f"{path}: neither a prebuilt eval buffer (no 'state' column) "
            f"nor a raw session file (missing {session_col!r}/{item_col!r})"
        )
    win = preprocess_val_data(
        df,
        padding_id=padding_id,
        state_len=state_len,
        pad_pos=pad_pos,
        session_id_name=session_col,
        action_name=item_col,
    )
    return EvalBuffer.from_dataframe(win)


def _jsonl_first_row_has(path: str, column: str) -> bool:
    """Whether ``path`` is JSON lines whose first non-blank row holds
    ``column``."""
    if not (path.endswith(".json") or path.endswith(".jsonl")):
        return False
    from ikea_recommender_tpu_torch.data.storage import Storage

    with Storage().open(path, "rb") as f:
        for line in f:
            if line.strip():
                try:
                    return column in json.loads(line)
                except ValueError:
                    return False
    return False


def _pad_take(arr: np.ndarray, idx: np.ndarray, batch_size: int) -> np.ndarray:
    """Take rows ``idx``, then repeat the first of them up to ``batch_size``."""
    out = arr[idx]
    pad = batch_size - len(idx)
    if pad > 0:
        filler = np.broadcast_to(out[:1], (pad,) + out.shape[1:])
        out = np.concatenate([out, filler], axis=0)
    return out


def num_batches(n: int, batch_size: int, drop_last: bool = False) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


def train_batches(
    buf: ReplayBuffer,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
    drop_last: bool = False,
) -> Iterator[Batch]:
    """Shuffled fixed-shape batches; the trailing batch padded and masked."""
    n = len(buf)
    idx = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    stop = (n // batch_size) * batch_size if drop_last else n
    for lo in range(0, stop, batch_size):
        take = idx[lo : lo + batch_size]
        valid = np.zeros(batch_size, dtype=bool)
        valid[: len(take)] = True
        yield Batch(
            state=_pad_take(buf.state, take, batch_size),
            action=_pad_take(buf.action, take, batch_size),
            reward=_pad_take(buf.reward, take, batch_size),
            next_state=_pad_take(buf.next_state, take, batch_size),
            true_len=_pad_take(buf.true_len, take, batch_size),
            true_next_len=_pad_take(buf.true_next_len, take, batch_size),
            is_end=_pad_take(buf.is_end, take, batch_size),
            valid=valid,
        )


def eval_batches(buf: EvalBuffer, batch_size: int, drop_last: bool = False) -> Iterator[EvalBatch]:
    """Sequential fixed-shape eval batches (the protocol does not depend on
    the order, so nothing is shuffled: reference quirk 9)."""
    n = len(buf)
    stop = (n // batch_size) * batch_size if drop_last else n
    for lo in range(0, stop, batch_size):
        take = np.arange(lo, min(lo + batch_size, n))
        valid = np.zeros(batch_size, dtype=bool)
        valid[: len(take)] = True
        yield EvalBatch(
            state=_pad_take(buf.state, take, batch_size),
            action=_pad_take(buf.action, take, batch_size),
            true_len=_pad_take(buf.true_len, take, batch_size),
            valid=valid,
            action_type=(
                None if buf.action_type is None else _pad_take(buf.action_type, take, batch_size)
            ),
        )
