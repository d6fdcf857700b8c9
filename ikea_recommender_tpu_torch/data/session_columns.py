"""Raw session files as numpy columns: the pandas-free path of
:mod:`ikea_recommender_tpu_torch.data.preprocessing`.

The frame functions there (``_read_frame``, ``preprocess_train_data``,
``preprocess_val_data``; reference ``data_utils/preprocessing.py:320-489``)
read a session file with pandas and window it. These read the same files
into ``{column: array}`` with the columns, dtypes and values that pandas
gives, and window them through the same :func:`window_sessions`:

- ``.csv`` (:func:`read_csv_columns`, ``pandas.read_csv``'s defaults): a
  header row; a column is ``int64`` when every field is an integer
  (``uint64``, or Python ints in an object array, past int64's range),
  ``float64`` when any field has a ``.``, an exponent or an infinity, or is
  empty or one of pandas' NA strings (NaN there), ``bool`` when every field
  is ``True``/``False`` (object with NaN if some are missing), and ``str``
  otherwise: an object array of the fields, NaN where missing. Floats are
  parsed as pandas' default C parser parses them (:func:`xstrtod`), which
  may differ from Python's ``float`` in the last bit of a 17-digit field;
- ``.json`` / ``.jsonl`` (:func:`read_jsonl_columns`, ``pandas.read_json(
  orient="records", lines=True)``): one record a line, the columns in order
  of first appearance, a missing key NaN; numbers decoded as pandas' JSON
  decoder does (:func:`json_float`), then its dtype coercion: a column of
  strings or objects that all convert to float becomes ``float64``, and a
  ``float64`` or object column whose values all equal their ``int64`` cast
  becomes ``int64``. pandas also turns columns named like dates
  (``timestamp``, ``*_at``, ``*_time``, ...) into datetimes; no buffer
  reads such a column, and here they keep their numeric or string dtype;
- ``.npz``: the arrays it holds. It stands in for a pickled DataFrame
  (``.df``), which needs pandas: a pickle gets a ``SystemExit`` that names
  the ``.npz`` form (ROADMAP C.9, the RetailRocket splits' rule, extended to
  session files).

:func:`preprocess_train_columns` and :func:`preprocess_val_columns` return
the frame functions' columns as arrays: the windows, ``action`` (the item
column as read) and, for the train buffer, ``r_act`` (the reward column as
read, in input row order). A missing column raises ``KeyError``, as the
frame's lookup does; NaN ids and rewards pass through as they do there.
"""

from __future__ import annotations

import csv
import io
import json
import math
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from ikea_recommender_tpu_torch.data.preprocessing import window_sessions

# pandas.read_csv's default NA strings (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_TRUE, _FALSE = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})
_INF = {"inf": np.inf, "+inf": np.inf, "-inf": -np.inf, "infinity": np.inf,
        "+infinity": np.inf, "-infinity": -np.inf}
_SPACE = " \t\n\r\f\v"
_INT = re.compile(r"[ \t\r\f\v]*[+-]?[0-9]+[ \t\r\f\v]*", re.ASCII)
_SHORT = re.compile(r"[ \t\r\f\v]*[+-]?(?=[0-9.]{1,15}[ \t\r\f\v]*$)"
                    r"(?:[0-9]+\.?[0-9]*|\.[0-9]+)[ \t\r\f\v]*", re.ASCII)
_INT64 = (-(2**63), 2**63 - 1)
_POW10 = [float(f"1e{i}") for i in range(309)]
_FRAC10 = [1.0, 0.1, 0.01, 0.001, 0.0001, 0.00001, 0.000001, 0.0000001, 0.00000001,
           0.000000001, 0.0000000001, 0.00000000001, 0.000000000001, 0.0000000000001,
           0.00000000000001, 0.000000000000001, 0.0000000000000001]


# ---------------------------------------------------------------------------
# number parsers, as pandas' C code parses
# ---------------------------------------------------------------------------


def xstrtod(s: str) -> Optional[float]:
    """A CSV field as pandas' default float converter reads it
    (``precise_xstrtod`` in pandas' tokenizer: up to 17 significant digits
    accumulated in a double, scaled by one power of ten), or None where it
    is no number. An exponent past 308 falls back to Python's ``float``, as
    pandas does on a range error."""
    p, n = 0, len(s)
    while p < n and s[p] in _SPACE:
        p += 1
    neg = p < n and s[p] == "-"
    p += p < n and s[p] in "+-"
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while p < n and "0" <= s[p] <= "9":
        if digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        while digits < 17 and p < n and "0" <= s[p] <= "9":
            number = number * 10.0 + (ord(s[p]) - 48)
            digits, decimals, p = digits + 1, decimals + 1, p + 1
        while p < n and "0" <= s[p] <= "9":
            p += 1
        exponent -= decimals
    if digits == 0:
        return None
    number = -number if neg else number
    if p < n and s[p] in "eE":
        q = p + 1
        eneg = q < n and s[q] == "-"
        q += q < n and s[q] in "+-"
        k = m = 0
        while k < 17 and q < n and "0" <= s[q] <= "9":
            m, k, q = m * 10 + ord(s[q]) - 48, k + 1, q + 1
        if k:
            exponent, p = exponent + (-m if eneg else m), q
    while p < n and s[p] in _SPACE:
        p += 1
    if p != n:
        return None
    if exponent > 308:
        return float(s)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0 * number
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def json_float(s: str) -> float:
    """A JSON number with a fraction or an exponent as pandas' JSON decoder
    reads it (ujson's ``decode_numeric`` without ``precise_float``: the
    integer part as an integer, at most 15 fraction digits accumulated in a
    double and scaled by a tabled 10^-k, then ``pow(10, exponent)``)."""
    neg = s.startswith("-")
    p, n = int(neg), len(s)
    whole = 0
    while p < n and "0" <= s[p] <= "9":
        whole, p = whole * 10 + ord(s[p]) - 48, p + 1
    _check_json_int(-whole if neg else whole)
    frac, count = 0.0, 0
    if p < n and s[p] == ".":
        p += 1
        while p < n and "0" <= s[p] <= "9":
            if count < 15:
                frac, count = frac * 10.0 + (ord(s[p]) - 48), count + 1
            p += 1
    value = (float(whole) + frac * _FRAC10[count]) * (-1.0 if neg else 1.0)
    if p < n and s[p] in "eE":
        p += 1
        sign = -1.0 if s[p] == "-" else 1.0
        p += s[p] in "+-"
        exp = 0.0
        while p < n and "0" <= s[p] <= "9":
            exp, p = exp * 10.0 + (ord(s[p]) - 48), p + 1
        try:
            value *= 10.0 ** (exp * sign)
        except OverflowError:  # C's pow gives infinity
            value *= math.inf
    return value


def _check_json_int(v: int) -> int:
    if v > 2**64 - 1:
        raise ValueError("Value is too big!")
    if v < _INT64[0]:
        raise ValueError("Value is too small")
    return v


def _json_int(s: str) -> int:
    return _check_json_int(int(s))


# ---------------------------------------------------------------------------
# .csv
# ---------------------------------------------------------------------------


def _int_column(fields: Sequence[str]) -> np.ndarray:
    """Integer fields as pandas types them: int64, else uint64, else an
    object array of Python ints."""
    try:
        return np.array(fields, dtype=np.int64)
    except OverflowError:
        pass
    ints = [int(f) for f in fields]
    if min(ints) >= 0 and max(ints) <= 2**64 - 1:
        return np.array(ints, dtype=np.uint64)
    out = np.empty(len(ints), dtype=object)
    out[:] = ints
    return out


def _float_field(f: str) -> Optional[float]:
    v = xstrtod(f)
    return _INF.get(f.strip(_SPACE).lower()) if v is None else v


def _csv_column(fields: List[Optional[str]]) -> np.ndarray:
    """One CSV column's fields (None where a short row lacks it) as the
    array pandas' C parser makes of them."""
    if not fields:  # a header without rows
        return np.empty(0, dtype=object)
    na = np.fromiter((f is None or f in NA_VALUES for f in fields), dtype=bool,
                     count=len(fields))
    if not na.any() and all(_INT.fullmatch(f) for f in fields):
        return _int_column(fields)
    real = [f for f, bad in zip(fields, na) if not bad]
    if all(_SHORT.fullmatch(f) for f in real):
        # at most 15 digits and no exponent: xstrtod's value is the
        # correctly rounded one, which numpy's conversion gives
        values = np.array(real, dtype=np.float64)
    else:
        values = [_float_field(f) for f in real]
    if all(v is not None for v in values):
        out = np.full(len(fields), np.nan)
        out[~na] = values
        return out
    out = np.empty(len(fields), dtype=object)
    if all(f in _TRUE or f in _FALSE for f in real):
        if not na.any():
            return np.array([f in _TRUE for f in fields], dtype=bool)
        out[:] = [np.nan if bad else f in _TRUE for f, bad in zip(fields, na)]
    else:
        out[:] = [np.nan if bad else f for f, bad in zip(fields, na)]
    return out


def _column_names(header: List[str]) -> List[str]:
    """pandas' names for a header row: ``Unnamed: i`` for an empty one, a
    repeated name numbered ``name.1``, ``name.2``, ..."""
    names, seen = [], {}
    for i, h in enumerate(header):
        name = h if h else f"Unnamed: {i}"
        base, k = name, seen.get(name, 0)
        while name in seen:
            k += 1
            name = f"{base}.{k}"
        seen[base] = k
        seen[name] = 0
        names.append(name)
    return names


def read_csv_columns(path: str) -> Dict[str, np.ndarray]:
    """A comma-separated file with a header row -> ``{column: array}`` as
    ``pandas.read_csv(path)`` types it (module docstring). Blank lines are
    skipped; a short row's missing fields are NaN; a first data row with one
    field more than the header makes the first field the (dropped) index,
    as pandas does; a row longer than that raises ``ValueError``."""
    with open(path, "r", encoding="utf-8-sig", newline="") as fh:
        text = fh.read()
    if '"' in text:
        rows = [r for r in csv.reader(io.StringIO(text)) if r]
    else:
        lines = text.replace("\r\n", "\n").replace("\r", "\n").split("\n")
        rows = [ln.split(",") for ln in lines if ln]
    if not rows:
        raise ValueError(f"{path}: no columns to parse from file")
    names, body = _column_names(rows[0]), rows[1:]
    width = len(names)
    skip = int(bool(body) and len(body[0]) == width + 1)
    full = width + skip
    cols: List[List[Optional[str]]] = [[] for _ in range(width)]
    if all(len(r) == full for r in body):
        for j in range(width):
            cols[j] = [r[j + skip] for r in body]
    else:
        for i, r in enumerate(body):
            if len(r) > full:
                raise ValueError(f"{path}: expected {full} fields in line {i + 2}, saw {len(r)}")
            r = r[skip:] + [None] * (full - len(r))
            for j in range(width):
                cols[j].append(r[j])
    return {name: _csv_column(col) for name, col in zip(names, cols)}


# ---------------------------------------------------------------------------
# .json / .jsonl
# ---------------------------------------------------------------------------

_MISSING = object()


def _as_float(v) -> float:
    if v is None or v is _MISSING:
        return np.nan
    if isinstance(v, (list, dict)):
        raise TypeError(type(v).__name__)
    return float(v)


def _json_column(values: list) -> np.ndarray:
    """One column's decoded JSON values (``_MISSING`` where a record lacks
    the key) as ``read_json`` types it: the frame constructor's inference,
    then its float and int64 coercions."""
    present = [v for v in values if v is not None and v is not _MISSING]
    has_na = len(present) < len(values)
    kinds = {bool if isinstance(v, bool) else int if isinstance(v, int) else
             float if isinstance(v, float) else str if isinstance(v, str) else object
             for v in present}
    if not has_na and kinds == {bool}:
        return np.array(values, dtype=bool)
    if not has_na and kinds == {int}:
        if all(_INT64[0] <= v <= _INT64[1] for v in values):
            return np.array(values, dtype=np.int64)
        return np.array(values, dtype=np.uint64)
    if kinds and kinds <= {int, float}:
        data = np.array([_as_float(v) for v in values], dtype=np.float64)
        org = data
    else:
        org = np.empty(len(values), dtype=object)
        org[:] = [np.nan if v is _MISSING or (v is None and kinds == {str}) else v
                  for v in values]
        try:  # strings and objects that all convert to float become float64
            data = np.array([_as_float(v) for v in values], dtype=np.float64)
        except (TypeError, ValueError):
            return org
    if len(values):  # and any column that equals its int64 cast, int64
        try:
            if org.dtype == object:
                ints = [int(v) for v in org]
            elif (np.abs(org) < 2.0**63).all():  # finite and within int64
                ints = org.astype(np.int64)
            else:
                ints = None
            if ints is not None and all(_INT64[0] <= i <= _INT64[1] for i in ints) and all(
                    i == d for i, d in zip(ints, data.tolist())):
                return np.array(ints, dtype=np.int64)
        except (TypeError, ValueError, OverflowError):
            pass
    return data


def read_jsonl_columns(path: str) -> Dict[str, np.ndarray]:
    """JSON lines, one record a line -> ``{column: array}`` as
    ``pandas.read_json(path, orient="records", lines=True)`` types it
    (module docstring). Blank lines are skipped."""
    records = []
    with open(path, "rb") as fh:
        for line in fh:
            if line.strip():
                rec = json.loads(line, parse_float=json_float, parse_int=_json_int)
                if not isinstance(rec, dict):
                    raise ValueError(f"{path}: a line is not a JSON object: {line[:80]!r}")
                records.append(rec)
    names = list(dict.fromkeys(k for rec in records for k in rec))
    return {name: _json_column([rec.get(name, _MISSING) for rec in records])
            for name in names}


# ---------------------------------------------------------------------------
# any session file, and the windows
# ---------------------------------------------------------------------------


def read_session_columns(path: str) -> Dict[str, np.ndarray]:
    """A raw session file -> its columns: ``.csv``, ``.json``/``.jsonl`` or
    ``.npz``. Any other file is a pickle to the frame path, which needs
    pandas: ``SystemExit`` naming the ``.npz`` to write in its place."""
    if path.endswith(".csv"):
        return read_csv_columns(path)
    if path.endswith(".json") or path.endswith(".jsonl"):
        return read_jsonl_columns(path)
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    raise SystemExit(
        f"{path}: a pickled DataFrame needs pandas, which this package does not use; "
        f"save its columns with numpy.savez to {os.path.splitext(path)[0]}.npz and pass that")


def _columns(src) -> Dict[str, np.ndarray]:
    return read_session_columns(src) if isinstance(src, str) else dict(src)


def preprocess_train_columns(
    src,
    padding_id: int,
    state_len: int,
    pad_pos: str = "end",
    reward_name: str = "reward",
    session_id_name: str = "session_id",
    action_name: str = "item_id",
) -> Dict[str, np.ndarray]:
    """A session file (or its columns) -> the 7 train-buffer columns of
    ``preprocess_train_data``'s frame, as arrays."""
    cols = _columns(src)
    win = window_sessions(cols[action_name], cols[session_id_name], state_len,
                          pad_id=padding_id, pad_pos=pad_pos)
    return {
        "state": win.state,
        "action": win.action,
        "r_act": cols[reward_name],
        "next_state": win.next_state,
        "true_state_len": win.true_state_len,
        "true_next_state_len": win.true_next_state_len,
        "is_end": win.is_end,
    }


def preprocess_val_columns(
    src,
    padding_id: int,
    state_len: int,
    pad_pos: str = "end",
    session_id_name: str = "session_id",
    action_name: str = "item_id",
) -> Dict[str, np.ndarray]:
    """A session file (or its columns) -> ``preprocess_val_data``'s
    (state, action, true_state_len) columns, as arrays."""
    cols = _columns(src)
    win = window_sessions(cols[action_name], cols[session_id_name], state_len,
                          pad_id=padding_id, pad_pos=pad_pos)
    return {"state": win.state, "action": win.action, "true_state_len": win.true_state_len}
