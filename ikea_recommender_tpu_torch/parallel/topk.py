"""Top-k, softmax CE and the embedding lookup over model-sharded columns.

Port of ``ikea_recommender_tpu/parallel/topk.py`` (``sharded_top_k``,
``sharded_softmax_ce``, ``sharded_head_topk_ce`` and
``sharded_embedding_lookup``). Each rank holds its shard: the (B, A/n)
logits of its head columns (global ids ``[my A/n, (my + 1) A/n)``), or
(V/n, E) rows of the embedding table. The merges move O(B k) or O(B)
values over the ``model`` axis, never O(A); each merge gathers the
shards' pieces in one collective and reduces them on every rank
(:func:`topk_from_shards`, :func:`lse_from_shards`), functions that also
merge pieces computed in one process:

- **top-k**: each shard ranks its columns by C.1's unique key
  (``ops/fused_topk.py::order_keys``: value descending, global id
  ascending), the k best keys of every shard are gathered shard-major and
  the k best of those kept. The global top-k is a subset of the union of
  the shards' top-ks, and the key orders ties to the lower global id, as
  ``lax.top_k`` over the whole row does;
- **softmax CE**: a max over the shards, the shards' sums of exp, and the
  label logit from the one shard that owns it;
- **the head scan** (eval and serving): each shard runs
  ``ops/fused_topk.py::blockwise_head_topk_ce`` over its columns with their
  global offset, and the pieces merge as above, the label logit by a max
  over the -1e30 sentinel of the shards that do not own it;
- **embedding lookup**: each shard gathers the rows it owns, zero
  elsewhere, and a sum assembles the vectors.

``sharded_softmax_ce`` and ``sharded_embedding_lookup`` are differentiable
(the reference's ``sharded_softmax_ce`` is not: its ``pmax`` has no
derivative rule; here the max is a constant shift); the top-k and the head
scan are not. An op whose column or row count does not divide by the model
axis raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ikea_recommender_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh, psum, pvary
from ikea_recommender_tpu_torch.ops.fused_topk import (
    DEFAULT_BLOCK_COLS,
    blockwise_head_topk_ce,
    decode_keys,
    order_keys,
)


def shard_width(total: int, mesh: Mesh, what: str = "action dim") -> int:
    """``total / n`` for the model axis' n; raises where n does not divide."""
    n = mesh.size(MODEL_AXIS)
    if total % n:
        raise ValueError(f"{what} {total} not divisible by model axis {n}")
    return total // n


def _offset(local_width: int, mesh: Mesh) -> int:
    """The global id of this shard's first column (row)."""
    return mesh.index(MODEL_AXIS) * local_width


def topk_from_shards(keys: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, global ids) of the k best of the shards' (n, B, k') keys,
    stacked in shard order: the key orders ties to the lower global id."""
    cat = keys.permute(1, 0, 2).reshape(keys.shape[1], -1)
    return decode_keys(cat.topk(k, dim=1).values)


def lse_from_shards(m: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The whole row's logsumexp (B,) from each shard's (n, B) max and sum
    of exp(x - max); a shard of padding only (max about -1e30) adds 0."""
    g = m.max(dim=0).values
    return g + torch.log((s * torch.exp(m - g)).sum(dim=0))


def merge_topk_keys(keys: torch.Tensor, k: int, mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_from_shards` over every model rank's (B, k') keys."""
    return topk_from_shards(mesh.gather(keys, MODEL_AXIS), k)


def sharded_top_k(logits: torch.Tensor, k: int, mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the (B, A) row of which this rank holds the (B, A/n)
    shard -> (values (B, k), global ids (B, k) int64), equal values in
    ascending id order. Not differentiable."""
    logits = logits.detach()
    width = logits.shape[-1]
    ids = _offset(width, mesh) + torch.arange(width, device=logits.device)
    keys = order_keys(logits, ids).topk(min(k, width), dim=-1).values
    return merge_topk_keys(keys, k, mesh)


def sharded_softmax_ce(logits: torch.Tensor, labels: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Per-sample softmax CE (B,) over the (B, A) logits of which this
    rank holds its columns' shard; ``labels`` are global ids.
    Differentiable in the shard's logits."""
    width = logits.shape[-1]
    g_max = mesh.all_reduce(logits.detach().amax(dim=-1), "max", MODEL_AXIS)
    s = torch.exp(logits - g_max[:, None]).sum(dim=-1)
    loc = labels.long() - _offset(width, mesh)
    in_range = (loc >= 0) & (loc < width)
    picked = logits.gather(1, loc.clamp(0, width - 1)[:, None])[:, 0]
    # one sum for both: the shards' sums of exp and the owner's label logit
    sums = psum(torch.stack([s, torch.where(in_range, picked, 0.0)]), mesh, MODEL_AXIS)
    return g_max + torch.log(sums[0]) - sums[1]


@torch.no_grad()
def sharded_head_topk_ce(
    h: torch.Tensor,  # (B, F) backbone features
    kernel: torch.Tensor,  # (F, A_pad / n): this rank's head columns
    bias: torch.Tensor,  # (A_pad / n,)
    k: int,
    action_dim: int,  # the real catalog; global columns >= action_dim are masked
    mesh: Mesh,
    labels: Optional[torch.Tensor] = None,  # (B,) global ids, for the per-sample CE
    block_cols: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The blockwise head + top-k + CE scan over this rank's head columns,
    merged over the model axis -> (top values (B, k), global top ids (B, k),
    per-sample CE (B,) or None). Top-k exact, tie order included; CE equal
    to the dense one up to the order of its sums. The scan runs at fp32
    products, as the reference's sharded arm does (it takes no precision)."""
    width = kernel.shape[1]
    want_ce = labels is not None
    if labels is None:
        labels = torch.zeros((h.shape[0],), dtype=torch.int64, device=h.device)
    blk = min(block_cols or DEFAULT_BLOCK_COLS, width)
    top_v, top_i, m, s, lbl = blockwise_head_topk_ce(
        h, kernel, bias, k, action_dim, labels=labels, block_cols=blk,
        col_offset=_offset(width, mesh), raw_pieces=True,
    )
    g_v, g_i = merge_topk_keys(order_keys(top_v, top_i), k, mesh)
    if not want_ce:
        return g_v, g_i, None
    lse, g_lbl = merge_scan_pieces(m, s, lbl, mesh)
    return g_v, g_i, lse - g_lbl


def merge_scan_pieces(m: torch.Tensor, s: torch.Tensor, lbl: torch.Tensor, mesh: Mesh):
    """(lse, label logit) of the whole row from each shard's blockwise scan
    pieces (max, sum of exp, label logit or the -1e30 sentinel), in one
    gather of O(B) values."""
    pieces = mesh.gather(torch.stack([m, s, lbl]), MODEL_AXIS)  # (n, 3, B)
    # the owner's label logit survives a max over the others' -1e30
    return lse_from_shards(pieces[:, 0], pieces[:, 1]), pieces[:, 2].max(dim=0).values


def sharded_embedding_lookup(
    table: torch.Tensor, ids: torch.Tensor, mesh: Mesh, data_axis: Optional[str] = None
) -> torch.Tensor:
    """Rows ``ids`` (any shape) of the (V, E) table of which this rank
    holds rows ``[my V/n, (my + 1) V/n)`` -> (*ids.shape, E); ids outside
    the shard give zero and a sum over the model axis assembles the
    vectors. Differentiable in the shard; with ``data_axis`` the batch is
    split over the data axis and the table's gradient is summed over it."""
    if data_axis is not None:
        table = pvary(table, mesh, DATA_AXIS)
    rows = table.shape[0]
    loc = ids.long() - _offset(rows, mesh)
    in_range = (loc >= 0) & (loc < rows)
    vecs = table[loc.clamp(0, rows - 1)]
    return psum(torch.where(in_range[..., None], vecs, 0.0), mesh, MODEL_AXIS)
