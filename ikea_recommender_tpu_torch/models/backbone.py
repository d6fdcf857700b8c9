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
  reference draws it from its PRNG key; the two give different masks;
- ``compute_dtype`` ("float32" or "bfloat16") is the type the backbone
  computes in: the embedding rows and each GRU layer's four params are cast
  to it (the params stay float32; autograd casts their gradients back), the
  recurrence runs on it (the bf16 kernels of ``ops/gru_cuda.py``), dropout
  applies in it, and the head input leaves as float32, as in the reference.
  The rows are gathered, then cast, where the reference casts the table,
  then gathers: the same values, no (V, E) cast a step, and a gradient
  whose duplicate ids are summed in float32 where the reference sums them
  in bfloat16 (ROADMAP C.5);
- on a mesh whose model axis divides the table's rows, each rank holds a
  contiguous block of them (``parallel/sharding.py``): the gather runs
  through ``parallel/topk.py::sharded_embedding_lookup`` (the reference
  leaves it to XLA), and :func:`embedding_grad_mask` masks the pad row on
  the rank that holds it, at its global row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ikea_recommender_tpu_torch.core.mesh import MODEL_AXIS
from ikea_recommender_tpu_torch.models.gru import gru_layer_apply

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def compute_dtype(cfg: BackboneConfig) -> torch.dtype:
    """The torch dtype of ``cfg.compute_dtype``; raises on any other name."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype={cfg.compute_dtype!r}: the port computes in "
            f"{' or '.join(COMPUTE_DTYPES)}"
        )
    return COMPUTE_DTYPES[cfg.compute_dtype]


def embedding_rows(cfg: BackboneConfig, mesh=None) -> Tuple[int, int]:
    """(rows, global row of the first) of the table block this rank
    holds: all of it without a mesh or where the model axis does not divide
    its rows (``parallel/sharding.py``'s guard)."""
    V = cfg.num_embeddings
    n = 1 if mesh is None else mesh.size(MODEL_AXIS)
    if n == 1 or V % n:
        return V, 0
    return V // n, mesh.index(MODEL_AXIS) * (V // n)


def embedding_grad_mask(cfg: BackboneConfig, device=None, mesh=None) -> Optional[torch.Tensor]:
    """(V_pad, 1) multiplier zeroing the pad row's gradient when the pad
    embedding is frozen (on a mesh: this rank's rows). None when fully
    trainable."""
    if cfg.train_pad_embed:
        return None
    rows, first = embedding_rows(cfg, mesh)
    mask = torch.ones((rows, 1), dtype=torch.float32, device=device)
    if first <= cfg.padding_idx < first + rows:
        mask[cfg.padding_idx - first] = 0.0
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
    inputs_embeds: Optional[torch.Tensor] = None,
    keep_mask: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """Encode a batch of padded sessions -> (B, feature_dim) float32.

    With ``cfg.dropout > 0`` and ``deterministic=False`` the head input goes
    through dropout, its keep mask ``keep_mask`` (B, feature_dim) where
    given (a mesh's data rank takes its rows of the global batch's mask),
    else drawn from ``dropout_generator``. ``mesh``: this rank's place on a
    (data, model) mesh, whose table rows it holds.
    ``inputs_embeds`` (B, T, E) replaces the table gather: the lazy
    embedding Adam gathers the rows outside autograd, so their gradient
    stays (B, T, E) instead of a (V, E) scatter. Everything up to the head
    input runs in ``cfg.compute_dtype``; the result is float32."""
    dtype = compute_dtype(cfg)
    if inputs_embeds is not None:
        x = inputs_embeds
    elif embedding_rows(cfg, mesh)[0] < cfg.num_embeddings:
        from ikea_recommender_tpu_torch.parallel.topk import sharded_embedding_lookup

        x = sharded_embedding_lookup(params["embedding"], states, mesh)
    else:
        x = params["embedding"][states.long()]
    x = x.to(dtype)
    lens = lengths if cfg.masked_recurrence else None

    def cast(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.to(dtype) for k, v in p.items()}

    finals_fwd: List[torch.Tensor] = []
    finals_bwd: List[torch.Tensor] = []
    seq = x
    for layer_params in params["gru"]:
        y_fwd, h_fwd = gru_layer_apply(cast(layer_params["fwd"]), seq, lens)
        finals_fwd.append(h_fwd)
        if cfg.bidirectional:
            y_bwd, h_bwd = gru_layer_apply(cast(layer_params["bwd"]), seq, lens, reverse=True)
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
        keep = 1.0 - cfg.dropout
        if keep_mask is None:
            if dropout_generator is None:
                raise ValueError("training dropout needs a dropout_generator")
            keep_mask = draw_keep_mask(h.shape, keep, dropout_generator, h.device)
        h = apply_dropout(h, keep_mask, keep)
    return h.to(torch.float32)
