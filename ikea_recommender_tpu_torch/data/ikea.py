"""IKEA-generation preprocessing: raw clickstream sessions -> replay buffer.

The port's own copy of ``ikea_recommender_tpu/data/ikea.py``, pipeline
parity with ``recommenders/ikea/data_utils/preprocessing.py``:

1. ``prepare_sessions``       — raw JSON session records -> exploded event
                                frame with composite session ids (:12-48);
2. ``add_reward_simple``      — action-type -> reward map, unknown -> 0
                                (:51-68);
3. ``prepare_for_replay_buffer`` — dedup / drop / column select (:71-97);
4. ``prepare_full_data``      — multi-file loop over gzip-JSON blobs
                                (:100-183);
5. ``mark_last_inspiration_click`` — ``is_end`` is the session's LAST
                                inspiration click, not its last event
                                (:186-208);
6. n-step futures             — optional next-state = state at +k steps or
                                at the next inspiration click, with
                                cumulated in-between rewards (:211-291);
7. ``preprocess_train_data``  — tokenize (input vocab), window over ALL
                                events, filter to inspiration clicks only,
                                re-tokenize actions to the output vocab,
                                derive true lengths by pad counting
                                (:294-487).

Steps 5-7 are frame wrappers of ``data/ikea_columns.py``, which holds
their rules on numpy columns. pandas is imported inside the functions that
use it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

from ikea_recommender_tpu_torch.data import ikea_columns
from ikea_recommender_tpu_torch.data.ikea_columns import INSPIRATION_ACTIONS  # noqa: F401
from ikea_recommender_tpu_torch.data.storage import Storage, load_json_gz_records
from ikea_recommender_tpu_torch.data.tokenizer import Tokenizer


# The three functions below implement a FIXED ETL contract over the raw
# GA-export JSON schema (reference ikea/data_utils/preprocessing.py:12-97):
# the field names, the composite-session-id rule (one session per unique
# (market, fullVisitorId, start_time_ms) triple, numbered in sorted-key
# order) and the surviving 5-column set are all dictated by that external
# format — byte-identical output is the requirement. The implementation is
# this repo's own (plain-Python event flattening + a vectorized reward map
# instead of pandas json_normalize/ngroup chains).

_SESSION_META = ("market", "fullVisitorId", "start_time_ms")


def prepare_sessions(info_list: List[dict], session_prefix: str, to_drop=("propensity",)):
    """Raw list of session dicts (each with an ``events`` list + session
    metadata) -> exploded event DataFrame with composite ``sessionID``.

    Each event dict becomes one row carrying its session's metadata; the
    ``action`` field is surfaced as ``action_type`` and the session id is
    ``f"{prefix}{n}"`` where n numbers the unique metadata triples in sorted
    order (the contract's ngroup semantics).
    """
    import pandas as pd

    rows: List[dict] = []
    keys = []
    for rec in info_list:
        meta = {k: rec.get(k) for k in _SESSION_META}
        key = tuple(meta[k] for k in _SESSION_META)
        for event in rec.get("events", ()):
            row = {k: v for k, v in event.items() if k not in to_drop}
            if "action" in row:
                row["action_type"] = row.pop("action")
            row.update(meta)
            rows.append(row)
            keys.append(key)
    df = pd.DataFrame(rows)
    df.rename(columns={"start_time_ms": "sessionStartTime"}, inplace=True)
    group_no = {k: i for i, k in enumerate(sorted(set(keys)))}
    df["sessionID"] = [f"{session_prefix}{group_no[k]}" for k in keys]
    return df


def add_reward_simple(session_df, action_to_rew_dict: Dict[str, float]):
    """Vectorized action_type -> reward map; anything unmapped gets 0
    (the contract's reward rule)."""
    session_df["reward"] = (
        session_df["action_type"].map(action_to_rew_dict).fillna(0.0)
    )
    return session_df


# Buffer rows keep exactly these columns, in this order (the downstream
# window/tokenize stages and the reference's stored buffers agree on it).
_BUFFER_COLS = ("sessionID", "item_id", "action_type", "market", "reward")


def prepare_for_replay_buffer(
    df,
    to_drop=(
        "fullVisitorId",
        "sessionStartTime",
        "start_time_ms",
        "timestamp_ms",
        "visitNumber",
        "feed_location",
    ),
):
    """Exact-duplicate rows collapse to one; the listed metadata columns are
    excluded from the NaN scan; any row still missing a value in ANY
    remaining column drops (ragged event schemas drop whole rows — contract
    behavior); only the 5 buffer columns survive."""
    df = df.drop_duplicates(keep="first")
    df = df.drop(columns=[c for c in to_drop if c in df.columns])
    df = df.dropna()
    return df[list(_BUFFER_COLS)]


def prepare_full_data(
    prefix: str,
    action_to_rew_dict: Dict[str, float],
    storage: Optional[Storage] = None,
    max_files: Optional[int] = None,
):
    """Loop over gzip-JSON clickstream files under ``prefix`` and build one
    event frame ready for splitting."""
    import pandas as pd

    storage = storage or Storage()
    frames = []
    for i, path in enumerate(storage.list_files(prefix)):
        records = load_json_gz_records(path, storage)
        df = prepare_sessions(records, session_prefix=f"{i}_")
        df = add_reward_simple(df, action_to_rew_dict)
        df = prepare_for_replay_buffer(df)
        df = df[~(df.item_id == "")]
        # drop rows whose item_id holds multiple comma-separated ids
        df = df[~df.item_id.astype(str).str.match(r"\d+,.*")]
        frames.append(df)
        if max_files is not None and i + 1 == max_files:
            break
    full = pd.concat(frames, axis=0).reset_index(drop=True)
    return full


def mark_last_inspiration_click(df, session_col: str = "sessionID") -> np.ndarray:
    """Boolean column: True only on the LAST inspiration-click row of each
    session (otherwise no episode-end signal would survive the filtering —
    reference :186-208). "Last" is by row order; the reference compares
    index labels, the same on the default index ``preprocess_train_data``
    gives it."""
    return ikea_columns.mark_last_inspiration_click(
        df["action_type"].to_numpy(), df[session_col].to_numpy())


def preprocess_train_data(
    src,
    padding_id: int,
    state_len: int,
    tokenizer_market: Union[str, Tokenizer, None],
    tokenizer_input: Union[str, Tokenizer],
    tokenizer_output: Union[str, Tokenizer],
    pad_pos: str = "end",
    reward_name: str = "reward",
    session_id_name: str = "sessionID",
    action_name: str = "item_id",
    future_steps_next_state: Union[int, str] = 1,
):
    """Event frame (or CSV path) -> 7-column IKEA replay buffer frame (dual
    tokenizers), through ``ikea_columns.preprocess_train_columns``."""
    import pandas as pd

    df = pd.read_csv(src) if isinstance(src, str) else src
    names = (session_id_name, action_name, "action_type", reward_name, "market")
    out = ikea_columns.preprocess_train_columns(
        {k: df[k].to_numpy() for k in names if k in df.columns},
        padding_id=padding_id,
        state_len=state_len,
        tokenizer_market=tokenizer_market,
        tokenizer_input=tokenizer_input,
        tokenizer_output=tokenizer_output,
        pad_pos=pad_pos,
        reward_name=reward_name,
        session_id_name=session_id_name,
        action_name=action_name,
        future_steps_next_state=future_steps_next_state,
    )
    return pd.DataFrame({k: list(v) if v.ndim == 2 else v for k, v in out.items()})


def to_eval_frame(train_df):
    """Train buffer frame -> eval buffer frame (state, action, true_state_len)."""
    return train_df[["state", "action", "true_state_len"]].copy()
