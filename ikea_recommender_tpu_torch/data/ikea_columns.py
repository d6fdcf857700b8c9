"""IKEA-generation preprocessing on columns, numpy only.

The one implementation of the IKEA buffer rules: the frame functions of
:mod:`ikea_recommender_tpu_torch.data.ikea` convert to and from these, and
the reference's (``ikea_recommender_tpu/data/ikea.py:145-287``, pandas)
give the same values, bit for bit, for the same events:

- :func:`mark_last_inspiration_click` — True only on a session's LAST
  inspiration row; a session without one has no True row;
- :func:`nstep_next_state_and_reward` — ``future_steps`` k >= 2: the next
  state is the state k rows later in the session (a row whose shift leaves
  the session keeps its own), the reward the row's own plus the next k - 1,
  cut at the session's end, summed left to right in float64; ``"all"``: the
  next state is the next inspiration row's, the reward the row's own where
  the next row is an inspiration click, else the sum over the row and the
  rows up to the next inspiration click, compensated as pandas' grouped sum
  is;
- :func:`preprocess_train_columns` — tokenize, window over ALL events, the
  two steps above, keep the inspiration rows, remap each action from the
  input to the output vocabulary through an integer table
  (``tokenizer.build_input_to_output_table``) and derive the true lengths by
  counting pads (a length of 0 becomes 1; the next state's is not clamped).

Rows of one session need not be contiguous: every within-session step runs
on one stable sort by session (:func:`session_layout`, made once a call),
as pandas' groupby keeps each group's row order.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np

from ikea_recommender_tpu_torch.data.preprocessing import _session_layout, window_sessions
from ikea_recommender_tpu_torch.data.tokenizer import Tokenizer, build_input_to_output_table

INSPIRATION_ACTIONS = ("click_inspiration", "select_content")


class SessionLayout(NamedTuple):
    """A stable sort of the rows by session, made once and shared by every
    within-session step."""

    order: np.ndarray  # sorted position -> row
    seg: np.ndarray  # each sorted row's session number
    first: np.ndarray  # each sorted row opens its session


def session_layout(session_ids: np.ndarray) -> SessionLayout:
    order, _, n_bef, _ = _session_layout(np.asarray(session_ids))
    first = n_bef == 0
    return SessionLayout(order, np.cumsum(first) - 1, first)


def _shifted_rows(layout: SessionLayout, k: int, among: Optional[np.ndarray] = None) -> np.ndarray:
    """For each row, the row ``k`` rows later in its session, or -1 where
    that leaves the session (pandas' ``groupby(...).shift(-k)``). With a
    boolean ``among``, only those rows count, and only they get a row."""
    order, seg = layout.order, layout.seg
    out = np.full(len(order), -1, dtype=np.int64)
    pos = np.arange(len(order)) if among is None else np.flatnonzero(among[order])
    if len(pos) > k:
        same = seg[pos[k:]] == seg[pos[:-k]]
        out[order[pos[:-k][same]]] = order[pos[k:][same]]
    return out


def mark_last_inspiration_click(
    action_type: np.ndarray, session_ids: np.ndarray, layout: Optional[SessionLayout] = None,
) -> np.ndarray:
    """Boolean column: True only on the last inspiration-click row of each
    session (reference ``data/ikea.py:145-155``): the inspiration rows with
    no later inspiration row in their session."""
    cond = np.isin(np.asarray(action_type), INSPIRATION_ACTIONS)
    layout = session_layout(session_ids) if layout is None else layout
    return cond & (_shifted_rows(layout, 1, among=cond) < 0)


def _compensated_run_sums(values: np.ndarray, run_start: np.ndarray) -> np.ndarray:
    """Per run of consecutive rows (``run_start`` marks each run's first),
    the sum of its values in row order with pandas' ``group_sum``
    compensation (Kahan: ``y = v - c; t = s + y; c = t - s - y; s = t``,
    ``c`` reset to 0 where it is NaN), broadcast to every row of the run."""
    n = len(values)
    starts = np.flatnonzero(run_start)
    lengths = np.diff(np.append(starts, n))
    s = np.zeros(len(starts), dtype=np.float64)
    c = np.zeros(len(starts), dtype=np.float64)
    for j in range(int(lengths.max()) if n else 0):
        live = lengths > j
        v = values[starts[live] + j]
        y = v - c[live]
        t = s[live] + y
        comp = t - s[live] - y
        c[live] = np.where(np.isnan(comp), 0.0, comp)
        s[live] = t
    return np.repeat(s, lengths)


def nstep_next_state_and_reward(
    state: np.ndarray,
    next_state: np.ndarray,
    reward: np.ndarray,
    action_type: np.ndarray,
    session_ids: np.ndarray,
    future_steps: Union[int, str],
    layout: Optional[SessionLayout] = None,
):
    """(next_state, reward) after the k-step or till-next-click transform
    (reference ``data/ikea.py:157-207``); new arrays, the inputs untouched.

    ``future_steps``: ``"all"`` or an int >= 2. The next state changes on
    inspiration rows only; the k-step reward on every row (the caller keeps
    the inspiration rows)."""
    cond = np.isin(np.asarray(action_type), INSPIRATION_ACTIONS)
    layout = session_layout(session_ids) if layout is None else layout
    next_state = np.array(next_state, copy=True)
    if future_steps == "all":
        nxt = _shifted_rows(layout, 1, among=cond)
        has = nxt >= 0
        next_state[has] = state[nxt[has]]

        # runs: a session's rows from one inspiration click up to the next
        # (the rows before its first click are a run of their own)
        order = layout.order
        reward = np.asarray(reward)
        sums = np.empty(len(reward), dtype=np.float64)
        sums[order] = _compensated_run_sums(reward[order].astype(np.float64),
                                            layout.first | cond[order])
        after = _shifted_rows(layout, 1)
        next_is_insp = np.zeros(len(cond), dtype=bool)
        next_is_insp[after >= 0] = cond[after[after >= 0]]
        new_rew = np.where(cond & next_is_insp, reward, sums)
        reward = np.array(reward, copy=True)
        reward[cond] = new_rew[cond]
        return next_state, reward
    if int(future_steps) >= 2:
        k = int(future_steps)
        shifted = _shifted_rows(layout, k)
        take = cond & (shifted >= 0)
        next_state[take] = state[shifted[take]]
        own = np.asarray(reward).astype(np.float64)
        total = own.copy()
        for j in range(1, k):
            later = _shifted_rows(layout, j)
            total = total + np.where(later >= 0, own[later], 0.0)
        return next_state, total
    raise ValueError("future_steps must be 'all' or an int >= 2")


def _tokenizer(tok):
    return Tokenizer.from_file(tok) if isinstance(tok, str) else tok


def preprocess_train_columns(
    cols: Dict[str, np.ndarray],
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
) -> Dict[str, np.ndarray]:
    """Event columns (numpy arrays: the session ids, the item strings, the
    action types, the rewards, and optionally ``market``) -> the 7 IKEA
    replay-buffer columns (dual tokenizers), the values of the frame path's
    ``preprocess_train_data`` for the same events: ``state``,
    ``next_state`` (N, state_len) int64, ``action`` int64 (output
    vocabulary), ``r_act`` (the reward's dtype; float64 after a k-step
    sum), ``true_state_len``, ``true_next_state_len`` int64, ``is_end``
    bool. The k-step sum acts on ``reward_name``'s column; the reference
    sums the column named ``reward`` whatever ``reward_name`` says, the same
    at the default."""
    tokenizer_input = _tokenizer(tokenizer_input)
    tokenizer_output = _tokenizer(tokenizer_output)
    tokenizer_market = _tokenizer(tokenizer_market)

    items = tokenizer_input.encode(cols[action_name].tolist())
    if tokenizer_market is not None and "market" in cols:
        tokenizer_market.encode(cols["market"].tolist())  # unknown markets raise, as there
    sessions = cols[session_id_name]
    action_type = cols["action_type"]
    reward = cols[reward_name]

    # window over ALL events (views extend history; only clicks are samples)
    win = window_sessions(items, sessions, state_len, padding_id, pad_pos)
    state, next_state = win.state, win.next_state
    layout = session_layout(sessions)
    is_end = mark_last_inspiration_click(action_type, sessions, layout)
    if future_steps_next_state != 1:
        next_state, reward = nstep_next_state_and_reward(
            state, next_state, reward, action_type, sessions, future_steps_next_state, layout)

    keep = np.isin(action_type, INSPIRATION_ACTIONS)
    table = build_input_to_output_table(tokenizer_input, tokenizer_output)
    action = table[items[keep]]
    if (action < 0).any():  # the frame path's stoi raises on an unknown string
        raise KeyError(tokenizer_input.itos(int(items[keep][np.argmax(action < 0)])))

    pad_idx = tokenizer_input.pad_idx if tokenizer_input.pad_idx is not None else padding_id
    state, next_state = state[keep], next_state[keep]
    true_len = state_len - (state == pad_idx).sum(axis=1)
    true_len[true_len == 0] = 1
    true_next_len = state_len - (next_state == pad_idx).sum(axis=1)
    return {
        "state": state,
        "action": action.astype(np.int64),
        "r_act": np.asarray(reward)[keep],
        "next_state": next_state,
        "true_state_len": true_len,
        "true_next_state_len": true_next_len,
        "is_end": is_end[keep],
    }

