"""String <-> index tokenizer with the reference's vocabulary contract.

Contract (reference ``recommenders/utils/tokenizer.py:4-130``):

- vocabulary entries are enumerated in order, then ``<unk>`` (optional) and
  ``<pad>`` are appended so ``<pad>`` is always the LAST index — the pad id
  occupies the extra row of the ``(num_items + 1, E)`` embedding table;
- ``stoi`` falls back to ``<unk>`` only when the tokenizer has one;
- JSON round-trip via {"stoi": ..., "itos": ...}.

Deviation from the reference (documented): ``extend`` assigns new indices
starting at the current vocab length; the reference has an off-by-one
(``index + curr_len - 1``, ``tokenizer.py:56-59``) that collides the first new
token with the last existing one.

For device-side metric kernels the dual input/output vocab remap (diversity,
repetitions — reference ``evaluate/diversity.py:55-60``) is precomputed once
into an int32 gather table by :func:`build_output_to_input_table` instead of
the reference's per-element CPU ``Tensor.apply_``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

UNK_TOKEN = "<unk>"
PAD_TOKEN = "<pad>"


class Tokenizer:
    def __init__(
        self,
        vocabulary: Sequence[str] = (),
        unknown: bool = False,
        padding: bool = True,
    ):
        self.stoi_: Dict[str, int] = {s: i for i, s in enumerate(vocabulary)}
        self.unknown = bool(unknown)
        self.unk_token = UNK_TOKEN
        self.pad_token = PAD_TOKEN
        self.unk_idx: Optional[int] = None
        self.pad_idx: Optional[int] = None
        self.padding = bool(padding)

        if unknown:
            self.unk_idx = len(self.stoi_)
            self.stoi_[UNK_TOKEN] = self.unk_idx
        if padding:
            self.pad_idx = len(self.stoi_)
            self.stoi_[PAD_TOKEN] = self.pad_idx

        self.itos_: List[str] = [
            s for s, _ in sorted(self.stoi_.items(), key=lambda kv: kv[1])
        ]

    def stoi(self, string: str) -> int:
        if self.unknown:
            idx = self.stoi_.get(string)
            return self.unk_idx if idx is None else idx
        return self.stoi_[string]

    def itos(self, index: int) -> str:
        return self.itos_[index]

    def encode(self, strings: Sequence[str]) -> np.ndarray:
        return np.fromiter(
            (self.stoi(s) for s in strings), dtype=np.int64, count=len(strings)
        )

    def extend(self, new_vocabulary: Sequence[str]) -> None:
        start = len(self.stoi_)
        for i, s in enumerate(new_vocabulary):
            self.stoi_[s] = start + i
            self.itos_.append(s)

    def __len__(self) -> int:
        return len(self.itos_)

    def to_dict(self) -> Dict:
        return {"stoi": self.stoi_, "itos": self.itos_}

    def save_to_file(self, file_path: str) -> None:
        with open(file_path, "w") as fh:
            json.dump(self.to_dict(), fh)

    @classmethod
    def from_dict(cls, tokenizer_dict: Dict) -> "Tokenizer":
        tok = cls([], unknown=False, padding=False)
        tok.stoi_ = dict(tokenizer_dict["stoi"])
        tok.itos_ = list(tokenizer_dict["itos"])
        if PAD_TOKEN in tok.stoi_:
            tok.padding = True
            tok.pad_idx = tok.stoi_[PAD_TOKEN]
        if UNK_TOKEN in tok.stoi_:
            tok.unknown = True
            tok.unk_idx = tok.stoi_[UNK_TOKEN]
        return tok

    @classmethod
    def from_file(cls, file_path: str) -> "Tokenizer":
        with open(file_path, "r") as fh:
            return cls.from_dict(json.load(fh))


def build_output_to_input_table(
    input_tokenizer: Tokenizer, output_tokenizer: Tokenizer
) -> np.ndarray:
    """Precompute output-token -> input-token remap as an int32 gather table.

    Replaces the reference's per-element host remap
    ``input_tokenizer.stoi(output_tokenizer.itos(x))`` (diversity.py:57-59)
    with a single device gather: ``table[output_ids]``.
    """
    table = np.fromiter(
        (input_tokenizer.stoi(s) for s in output_tokenizer.itos_),
        dtype=np.int32,
        count=len(output_tokenizer),
    )
    return table


def build_input_to_output_table(
    input_tokenizer: Tokenizer, output_tokenizer: Tokenizer
) -> np.ndarray:
    """Input-token -> output-token remap as an int64 table, -1 where the
    output vocabulary lacks the token (its ``<unk>`` where it has one).

    ``table[ids]`` is ``output_tokenizer.stoi(input_tokenizer.itos(i))`` for
    every id whose token the output vocabulary holds, the per-row remap of
    ``data/ikea.py::preprocess_train_data`` as one gather; on the output
    vocabulary's tokens it inverts :func:`build_output_to_input_table`."""
    missing = -1 if output_tokenizer.unk_idx is None else output_tokenizer.unk_idx
    get = output_tokenizer.stoi_.get
    return np.fromiter(
        (get(s, missing) for s in input_tokenizer.itos_),
        dtype=np.int64,
        count=len(input_tokenizer),
    )
