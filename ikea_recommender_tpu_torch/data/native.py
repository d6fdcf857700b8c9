"""ctypes bindings of the native JSON-lines parser of replay buffers.

The port's own copy of ``ikea_recommender_tpu/data/native.py``. The parser
(``native/src/jsonl_buffer.cpp``) knows the 7-column buffer row and writes
each column straight into a numpy array, on several threads split at line
boundaries, where pandas' ``read_json`` builds a Python object per cell.
It needs only numpy and a C++ compiler.

The library is compiled by ``ops/build.py::load_host`` with the host
compiler on first use, into ``ikea_recommender_tpu_torch/_build/``. Where
it cannot be built or loaded (no compiler, no source), or the file holds a
column the parser does not know, :func:`parse_jsonl_buffer` returns None and
the caller reads the file with pandas: the two give the same arrays.
``NATIVE_PARSES`` counts the files the native parser read.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import Dict, Optional, Sequence

import numpy as np

from ikea_recommender_tpu_torch.ops import build

SOURCE = build.PACKAGE_DIR.parent / "native" / "src" / "jsonl_buffer.cpp"

NATIVE_PARSES = 0  # files parsed by the native library

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def load_library() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None if it cannot be."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = build.load_host(SOURCE)
        except (OSError, RuntimeError):
            _build_failed = True
            return None
        lib.ikea_jsonl_count.restype = ctypes.c_int64
        lib.ikea_jsonl_count.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.ikea_jsonl_parse.restype = ctypes.c_int
        lib.ikea_jsonl_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


_ARRAY_COLS = ("state", "next_state")
_INT_COLS = ("action", "true_state_len", "true_next_state_len")
_KNOWN = set(_ARRAY_COLS) | set(_INT_COLS) | {"r_act", "is_end"}


def parse_jsonl_buffer(
    data: bytes,
    columns: Sequence[str],
    n_threads: int = 0,
) -> Optional[Dict[str, np.ndarray]]:
    """Parse a JSON-lines train or eval buffer into column arrays.

    Returns None where the native library is unavailable, or the first row
    cannot be read or holds a requested column the parser does not know
    (the caller then reads the file with pandas). Raises ValueError on a
    malformed row. Only the requested columns present in the first row are
    returned (eval buffers carry a subset)."""
    global NATIVE_PARSES
    lib = load_library()
    if lib is None:
        return None
    n = lib.ikea_jsonl_count(data, len(data))
    if n == 0:
        NATIVE_PARSES += 1
        return {c: np.empty((0,), np.int32) for c in columns}

    # The columns and state_len come from the first non-blank line (the
    # parser's row count skips blank lines too).
    try:
        first = json.loads(next(ln for ln in data.splitlines() if ln.strip()))
    except (StopIteration, ValueError):
        return None
    present = [c for c in columns if c in first]
    if any(c not in _KNOWN for c in present):
        return None
    state_len = len(first["state"]) if "state" in first else 0

    out: Dict[str, np.ndarray] = {}
    for c in present:
        if c in _ARRAY_COLS:
            out[c] = np.empty((n, state_len), np.int32)
        elif c in _INT_COLS:
            out[c] = np.empty((n,), np.int32)
        elif c == "r_act":
            out[c] = np.empty((n,), np.float32)
        else:  # is_end
            out[c] = np.empty((n,), np.uint8)
    ptrs = {c: a.ctypes.data_as(ctypes.c_void_p) for c, a in out.items()}

    err = ctypes.create_string_buffer(256)
    rc = lib.ikea_jsonl_parse(
        data, len(data), state_len, n,
        ptrs.get("state"), ptrs.get("action"), ptrs.get("r_act"),
        ptrs.get("next_state"), ptrs.get("true_state_len"),
        ptrs.get("true_next_state_len"), ptrs.get("is_end"),
        n_threads or os.cpu_count() or 1, err, len(err),
    )
    if rc != 0:
        raise ValueError(f"native jsonl parse failed: {err.value.decode()}")
    if "is_end" in out:
        out["is_end"] = out["is_end"].astype(bool)
    NATIVE_PARSES += 1
    return out
