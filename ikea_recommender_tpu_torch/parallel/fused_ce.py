"""The fused softmax CE over a column-sharded head: B1 and B2 per shard.

Port of ``ikea_recommender_tpu/parallel/fused_ce.py``
(``sharded_fused_softmax_ce`` with its custom backward, and
``sharded_fused_softmax_ce_topk``). Each rank holds the head's columns
``[my A/n, (my + 1) A/n)`` and runs the single-device kernels on them as
they are (``ops/fused_ce.py``): the forward B1 with ``local_valid = clip(
valid_dim - my A/n, 0, A/n)`` (a shard of padding only has 0) and the
labels shifted by the shard's offset, so that no other shard matches a
label (a shifted label may be negative or past the shard: the kernels
compare it with their columns and find nothing). Every rank gathers the
shards' (lse, label logit) pairs, O(B) values in one collective where the
reference takes a ``pmax`` and two ``psum``, and merges them itself
(:func:`ce_from_shards`): the logsumexps by a max and a sum of
``exp(lse_s - max)`` (a shard of padding leaves about -1e30 and adds 0),
the label logits by a sum (0 but on the owner). The backward runs B2 per shard with the global logsumexp, sums dh
over the model axis, and, where the batch is split over the data axis
(``data_axis``), dW and db over it. Per call that moves O(B) scalars
forward and one (B, F) sum backward, whatever the catalog's size.

``sharded_fused_softmax_ce_topk`` (smorl) takes the CE and the online
rewards' top-k from one blockwise scan per shard
(``ops/fused_topk.py::blockwise_head_topk_ce`` with the shard's offset),
merged as ``parallel/topk.py::sharded_head_topk_ce`` merges them; its
backward is the same B2 per shard.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ikea_recommender_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from ikea_recommender_tpu_torch.ops.fused_ce import fused_ce_bwd, fused_ce_fwd
from ikea_recommender_tpu_torch.ops.fused_topk import (
    DEFAULT_BLOCK_COLS,
    blockwise_head_topk_ce,
    order_keys,
)
from ikea_recommender_tpu_torch.parallel.topk import lse_from_shards, merge_scan_pieces, merge_topk_keys


def shard_contract(width: int, valid_dim: int, labels: torch.Tensor, mesh: Mesh):
    """(local_valid, shifted labels) of this rank's ``width`` columns."""
    off = mesh.index(MODEL_AXIS) * width
    local_valid = min(max(int(valid_dim) - off, 0), width)
    return local_valid, labels.long() - off


def ce_from_shards(lse_s: torch.Tensor, lbl_s: torch.Tensor):
    """(lse, label logit) of the whole row from each shard's B1 outputs,
    stacked (n, B): a max-stabilised sum of exp(lse_s), and the label
    logits summed (0 on the shards that do not own the label)."""
    return lse_from_shards(lse_s, torch.ones_like(lse_s)), lbl_s.sum(dim=0)


def merge_lse(lse_s: torch.Tensor, lbl_s: torch.Tensor, mesh: Mesh):
    """:func:`ce_from_shards` over every model rank's B1 outputs, in one
    gather of O(B) values."""
    pieces = mesh.gather(torch.stack([lse_s, lbl_s]), MODEL_AXIS)  # (n, 2, B)
    return ce_from_shards(pieces[:, 0], pieces[:, 1])


def _sharded_bwd(ctx, ct):
    h, w, b, loc, lse = ctx.saved_tensors
    mesh = ctx.mesh
    dh, dw, db = fused_ce_bwd(h, w, b, loc, lse, ct.contiguous(), ctx.local_valid, ctx.precision)
    dh = mesh.all_reduce(dh, "sum", MODEL_AXIS)
    if ctx.data_axis is not None:
        # each data rank holds only its rows' part of the head's gradient
        dw = mesh.all_reduce(dw, "sum", DATA_AXIS)
        db = mesh.all_reduce(db, "sum", DATA_AXIS)
    return dh, dw, db


class _ShardedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, labels, mesh, valid_dim, data_axis, precision):
        local_valid, loc = shard_contract(w.shape[1], valid_dim, labels, mesh)
        lse_s, lbl_s = fused_ce_fwd(h, w, b, loc, local_valid, precision)
        lse, lbl = merge_lse(lse_s, lbl_s, mesh)
        ctx.mesh, ctx.local_valid, ctx.data_axis, ctx.precision = (
            mesh, local_valid, data_axis, precision)
        ctx.save_for_backward(h, w, b, loc, lse)
        return lse - lbl

    @staticmethod
    def backward(ctx, ct):
        return (*_sharded_bwd(ctx, ct), None, None, None, None, None)


def sharded_fused_softmax_ce(
    h: torch.Tensor,  # (B, F): replicated over model; this data rank's rows
    w: torch.Tensor,  # (F, A/n): this rank's head columns
    b: torch.Tensor,  # (A/n,)
    labels: torch.Tensor,  # (B,) global ids
    mesh: Mesh,
    valid_dim: int,  # the real catalog
    data_axis: Optional[str] = None,
    precision: str = "highest",
) -> torch.Tensor:
    """Per-sample CE (B,) fp32 over the whole column-sharded head, the
    logits never written. Differentiable in h, w and b: dh is the whole
    head's, dW and db this rank's columns' (summed over the data axis with
    ``data_axis``). ``precision`` is the kernels' (``ops/fused_ce.py``)."""
    return _ShardedCE.apply(h, w, b, labels, mesh, int(valid_dim), data_axis, precision)


class _ShardedCETopk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, labels, k, mesh, valid_dim, data_axis, precision):
        width = w.shape[1]
        local_valid, loc = shard_contract(width, valid_dim, labels, mesh)
        top_v, top_i, m, s, lbl = blockwise_head_topk_ce(
            h, w, b, k, valid_dim, labels=labels, block_cols=min(DEFAULT_BLOCK_COLS, width),
            col_offset=mesh.index(MODEL_AXIS) * width, raw_pieces=True, precision=precision,
        )
        _, g_i = merge_topk_keys(order_keys(top_v, top_i), k, mesh)
        lse, g_lbl = merge_scan_pieces(m, s, lbl, mesh)
        ctx.mesh, ctx.local_valid, ctx.data_axis, ctx.precision = (
            mesh, local_valid, data_axis, precision)
        ctx.save_for_backward(h, w, b, loc, lse)
        ctx.mark_non_differentiable(g_i)
        return lse - g_lbl, g_i

    @staticmethod
    def backward(ctx, ct, _ids_ct):
        return (*_sharded_bwd(ctx, ct), None, None, None, None, None, None)


def sharded_fused_softmax_ce_topk(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (F, A/n)
    b: torch.Tensor,  # (A/n,)
    labels: torch.Tensor,  # (B,) global ids
    k: int,
    mesh: Mesh,
    valid_dim: int,
    data_axis: Optional[str] = None,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-sample CE (B,), global top-k ids (B, k)) of the column-sharded
    head from one blockwise pass per shard; the CE differentiable as
    :func:`sharded_fused_softmax_ce`'s (B2 per shard), the ids not."""
    return _ShardedCETopk.apply(h, w, b, labels, int(k), mesh, int(valid_dim), data_axis,
                                precision)
