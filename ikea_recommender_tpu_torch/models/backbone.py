"""Shared embedding + GRU backbone.

Port of ``ikea_recommender_tpu/models/backbone.py`` (``BackboneConfig``,
``embedding_grad_mask`` and ``apply_backbone``). It is differentiable: the
recurrence's gradient runs through the B4 kernel (``ops/gru_cuda.py``).
The conventions carry over:
- the embedding table has ``num_items + 1`` rows (padded up to a multiple
  of ``vocab_align``; the extra rows are never indexed) and the pad id
  defaults to ``num_items``;
- multi-layer and bidirectional stacking: each layer reads the previous
  layer's output sequence, the two directions' outputs concatenated;
- the head input is the last layer's final state, or the first layer's
  with ``head_layer="first"`` (the reference's quirk 4);
- ``train_pad_embed=False`` masks the pad row's gradient
  (:func:`embedding_grad_mask`);
- dropout on the head input, in training only, keeps each value with
  probability ``1 - dropout`` and scales it by ``1 / keep``. The keep mask
  comes from a ``torch.Generator`` that the caller passes in, where the
  reference draws it from its PRNG key; the two give different masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ikea_recommender_tpu_torch.models.gru import gru_layer_apply


@dataclass(frozen=True)
class BackboneConfig:
    num_items: int  # input vocabulary size (pad row is extra)
    embedding_dim: int = 64
    hidden_dim: int = 64
    gru_layers: int = 1
    bidirectional: bool = False
    pad_id: Optional[int] = None  # defaults to num_items
    train_pad_embed: bool = True
    masked_recurrence: bool = True  # the reference's use_packed_seq
    head_layer: str = "last"  # "last" (correct) | "first" (reference quirk 4)
    dropout: float = 0.0  # applied to the head input in training (BidirGRU4Rec)
    compute_dtype: str = "float32"
    vocab_align: int = 1  # pad the table's row count up to a multiple

    @property
    def num_embeddings(self) -> int:
        rows = self.num_items + 1
        a = self.vocab_align
        return -(-rows // a) * a

    @property
    def padding_idx(self) -> int:
        return self.num_items if self.pad_id is None else self.pad_id

    @property
    def feature_dim(self) -> int:
        return self.hidden_dim * (2 if self.bidirectional else 1)


def embedding_grad_mask(cfg: BackboneConfig, device=None) -> Optional[torch.Tensor]:
    """(V_pad, 1) multiplier zeroing the pad row's gradient when the pad
    embedding is frozen. None when fully trainable."""
    if cfg.train_pad_embed:
        return None
    mask = torch.ones((cfg.num_embeddings, 1), dtype=torch.float32, device=device)
    mask[cfg.padding_idx] = 0.0
    return mask


def draw_keep_mask(
    shape, keep: float, generator: torch.Generator, device
) -> torch.Tensor:
    """Bool mask, True with probability ``keep``, from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < keep


def apply_dropout(h: torch.Tensor, keep_mask: torch.Tensor, keep: float) -> torch.Tensor:
    """``where(keep_mask, h / keep, 0)``, the reference's dropout formula."""
    return torch.where(keep_mask, h / keep, 0.0)


def apply_backbone(
    params: Dict,
    cfg: BackboneConfig,
    states: torch.Tensor,  # (B, T) int
    lengths: torch.Tensor,  # (B,) int
    *,
    dropout_generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Encode a batch of padded sessions -> (B, feature_dim) float32.

    With ``cfg.dropout > 0`` and ``deterministic=False`` the head input goes
    through dropout, its keep mask drawn from ``dropout_generator``."""
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port runs float32 only "
            "so far; bfloat16 compute comes with a later slice"
        )
    x = params["embedding"][states.long()]  # (B, T, E)
    lens = lengths if cfg.masked_recurrence else None

    finals_fwd: List[torch.Tensor] = []
    finals_bwd: List[torch.Tensor] = []
    seq = x
    for layer_params in params["gru"]:
        y_fwd, h_fwd = gru_layer_apply(layer_params["fwd"], seq, lens)
        finals_fwd.append(h_fwd)
        if cfg.bidirectional:
            y_bwd, h_bwd = gru_layer_apply(layer_params["bwd"], seq, lens, reverse=True)
            finals_bwd.append(h_bwd)
            seq = torch.cat([y_fwd, y_bwd], dim=-1)
        else:
            seq = y_fwd

    pick = 0 if cfg.head_layer == "first" else -1
    if cfg.bidirectional:
        h = torch.cat([finals_fwd[pick], finals_bwd[pick]], dim=-1)
    else:
        h = finals_fwd[pick]

    if cfg.dropout > 0.0 and not deterministic:
        if dropout_generator is None:
            raise ValueError("training dropout needs a dropout_generator")
        keep = 1.0 - cfg.dropout
        h = apply_dropout(h, draw_keep_mask(h.shape, keep, dropout_generator, h.device), keep)
    return h
