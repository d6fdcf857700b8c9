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

All group-wise steps are vectorized (groupby-transform / shifts), not
per-group ``apply`` loops. pandas is imported inside the functions that
use it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

from ikea_recommender_tpu_torch.data.preprocessing import window_sessions
from ikea_recommender_tpu_torch.data.storage import Storage, load_json_gz_records
from ikea_recommender_tpu_torch.data.tokenizer import Tokenizer

INSPIRATION_ACTIONS = ("click_inspiration", "select_content")


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
    reference :186-208). Vectorized over the whole frame."""
    import pandas as pd

    cond = df["action_type"].isin(INSPIRATION_ACTIONS)
    idx = pd.Series(df.index.where(cond), index=df.index, dtype="float64")
    last = idx.groupby(df[session_col]).transform("max")
    return (df.index == last).to_numpy()


def _nstep_next_state_and_reward(df, future_steps, session_col="sessionID"):
    """Apply the n-step / till-next-click next-state + cumulated-reward
    transform to the pre-filter frame (reference :211-291).

    future_steps: "all" | int >= 2.
    Mutates ``next_state`` and ``reward`` columns on inspiration rows.
    """
    import pandas as pd

    cond = df["action_type"].isin(INSPIRATION_ACTIONS)
    g = df.groupby(session_col, sort=False)

    if future_steps == "all":
        # next_state: state of the NEXT inspiration row in the session;
        # the session's last inspiration row keeps its own next_state.
        insp = df[cond]
        nxt = insp.groupby(insp[session_col], sort=False)["state"].shift(-1)
        keep_own = nxt.isna()
        df.loc[insp.index[~keep_own], "next_state"] = nxt[~keep_own]

        # reward: if the immediately-following row is another inspiration
        # click -> own reward; else own + following non-inspiration rewards
        # up to (excl.) the next inspiration row / session end.
        grp = cond.groupby(df[session_col], sort=False).cumsum()
        group_sum = df.groupby([df[session_col], grp], sort=False)["reward"].transform("sum")
        next_is_insp = (
            cond.groupby(df[session_col], sort=False).shift(-1).fillna(False)
        )
        new_rew = np.where(cond & next_is_insp, df["reward"], group_sum)
        df.loc[cond, "reward"] = new_rew[cond.to_numpy()]
    elif int(future_steps) >= 2:
        k = int(future_steps)
        shifted_state = g["state"].shift(-k)
        keep_own = shifted_state.isna()
        take = cond & ~keep_own
        df.loc[take, "next_state"] = shifted_state[take]
        # True cumulated k-step return: own reward + the next k-1 rewards,
        # truncated at the session boundary. At k=2 this reproduces the
        # reference exactly (own + immediate next, reference
        # ikea/data_utils/preprocessing.py:283-287); the reference raises
        # NotImplementedError for k>2 — this is the generalization its
        # docstring describes.
        total = df["reward"].astype(float).copy()
        for j in range(1, k):
            total = total + g["reward"].shift(-j).fillna(0.0)
        df["reward"] = total
    else:
        raise ValueError("future_steps must be 'all' or an int >= 2")
    return df


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
    """Event frame -> 7-column IKEA replay buffer (dual tokenizers)."""
    import pandas as pd

    if isinstance(src, str):
        df = pd.read_csv(src)
    else:
        df = src.copy()

    if isinstance(tokenizer_input, str):
        tokenizer_input = Tokenizer.from_file(tokenizer_input)
    if isinstance(tokenizer_output, str):
        tokenizer_output = Tokenizer.from_file(tokenizer_output)
    if isinstance(tokenizer_market, str):
        tokenizer_market = Tokenizer.from_file(tokenizer_market)

    df[action_name] = df[action_name].map(tokenizer_input.stoi)
    if tokenizer_market is not None and "market" in df.columns:
        df["market"] = df["market"].map(tokenizer_market.stoi)
    df.reset_index(drop=True, inplace=True)

    # Window over ALL events (views extend history; only clicks are samples)
    win = window_sessions(
        items=df[action_name].to_numpy(),
        session_ids=df[session_id_name].to_numpy(),
        state_len=state_len,
        pad_id=padding_id,
        pad_pos=pad_pos,
    )
    df["state"] = list(win.state)
    df["next_state"] = list(win.next_state)
    df["is_end"] = mark_last_inspiration_click(df, session_id_name)

    if future_steps_next_state != 1:
        df = _nstep_next_state_and_reward(
            df, future_steps_next_state, session_col=session_id_name
        )

    # Keep only the real actions: inspiration clicks.
    df = df[df["action_type"].isin(INSPIRATION_ACTIONS)].copy()

    # action: input token -> string -> output token.
    df[action_name] = df[action_name].map(
        lambda idx: tokenizer_output.stoi(tokenizer_input.itos(int(idx)))
    )

    # true lens derived by counting pad tokens (reference :452-463).
    pad_idx = tokenizer_input.pad_idx if tokenizer_input.pad_idx is not None else padding_id
    state_arr = np.stack(df["state"].to_numpy())
    next_arr = np.stack(df["next_state"].to_numpy())
    true_len = state_len - (state_arr == pad_idx).sum(axis=1)
    true_len[true_len == 0] = 1
    true_next_len = state_len - (next_arr == pad_idx).sum(axis=1)

    out = pd.DataFrame(
        {
            "state": list(state_arr),
            "action": df[action_name].to_numpy(),
            "r_act": df[reward_name].to_numpy(),
            "next_state": list(next_arr),
            "true_state_len": true_len,
            "true_next_state_len": true_next_len,
            "is_end": df["is_end"].to_numpy(),
        }
    )
    return out


def to_eval_frame(train_df):
    """Train buffer frame -> eval buffer frame (state, action, true_state_len)."""
    return train_df[["state", "action", "true_state_len"]].copy()
