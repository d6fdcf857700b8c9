"""The double-Q and sarm head ops over column-sharded Q heads.

Port of the column-sharded part of ``ikea_recommender_tpu/parallel/
q_kernels.py`` (``_merge_shard_argmax``, ``sharded_linear_argmax``,
``sharded_weighted_multihead_argmax``, ``sharded_row_logit``,
``sharded_multihead_row_logit``, ``sharded_multihead_max``,
``sharded_sup_topk``). The same kernels run on each rank's columns and
merge with O(B) or O(B K) collectives over the model axis:

- **argmax** (sqn's target action, B5; smorl's weighted one, B6): each
  shard's kernel returns its max and argmax with ``with_max`` over
  ``local_valid`` columns, the ids shifted by the shard's offset; the best
  of the shards' (max, global id) keys, the reference's max over the
  shards then min over the global ids that reach it, reproduces the dense
  argmax and its tie order (a shard's kernel keeps its lowest id, and
  lower shards own lower ids);
- **row logits** (Q(s, a)): the shard that owns a row's action gathers and
  dots, the others give 0, and a sum assembles (B,) or (B, K);
  differentiable, the W and b gradients staying on their shard;
- **per-head max** (sarm's targets): each shard's
  ``ops/fused_topk.py::blockwise_multihead_max``, then a max.

The dense arm's counterparts over a shard's (B, A/n) or (B, K, A/n)
logits are :func:`sharded_argmax` and :func:`sharded_take`.

The lazy Q heads' data-parallel islands (:func:`dp_linear_argmax_am`,
:func:`dp_weighted_multihead_argmax_am`; reference ``q_kernels.py:275-358``)
serve the other layout: the action-major head (``kernel_am`` (A, K*F)) is
replicated on every rank, so the target action is B5 or B6 in their
action-major form over the whole catalog, launched on this rank's own rows
of ``h``. There is no collective inside: the reference's ``shard_map``
splits only the batch over the data axis, which the port's ranks hold
already, and the model ranks of one data index re-run the same rows, as
the reference's model axis does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ikea_recommender_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh, psum, pvary
from ikea_recommender_tpu_torch.ops.fused_argmax import (
    fused_linear_argmax,
    fused_weighted_multihead_argmax,
    multihead_row_logit,
    row_logit,
)
from ikea_recommender_tpu_torch.ops.fused_topk import (
    blockwise_multihead_max,
    decode_keys,
    order_keys,
)
from ikea_recommender_tpu_torch.parallel.topk import sharded_head_topk_ce

def _local(width: int, valid_dim: int, mesh: Mesh):
    """(offset, local_valid) of this rank's ``width`` columns."""
    off = mesh.index(MODEL_AXIS) * width
    return off, min(max(int(valid_dim) - off, 0), width)


def argmax_from_shards(keys: torch.Tensor) -> torch.Tensor:
    """The global argmax (B,) from each shard's (n, B) keys of its max and
    its argmax as a global id (``ops/fused_topk.py::order_keys``): the best
    key is the largest max at the lowest global id, the reference's
    ``pmax`` then ``pmin`` over the ids that reach it."""
    return decode_keys(keys.max(dim=0).values)[1]


def merge_shard_argmax(m: torch.Tensor, gidx: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(this shard's max, its argmax as a global id) -> the global argmax,
    the lowest global id among equal maxima, in one gather of O(B) keys."""
    return argmax_from_shards(mesh.gather(order_keys(m, gidx), MODEL_AXIS))


@torch.no_grad()
def sharded_linear_argmax(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (F, A/n): this rank's columns
    b: torch.Tensor,  # (A/n,)
    valid_dim: int,
    mesh: Mesh,
    precision: str = "highest",
) -> torch.Tensor:
    """argmax over the whole sharded ``h @ w + b`` masked at
    ``valid_dim`` -> (B,) global int64 ids; B5 on the card. Not
    differentiable."""
    off, local_valid = _local(w.shape[1], valid_dim, mesh)
    idx, m = fused_linear_argmax(h, w, b, local_valid, precision, with_max=True)
    return merge_shard_argmax(m, idx + off, mesh)


@torch.no_grad()
def sharded_weighted_multihead_argmax(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (K, F, A/n)
    b: torch.Tensor,  # (K, A/n)
    q_weights: Union[torch.Tensor, Sequence[float]],  # (K,)
    valid_dim: int,
    mesh: Mesh,
    precision: str = "highest",
) -> torch.Tensor:
    """smorl's target action over sharded heads: argmax of
    ``sum_k q_weights[k] (h @ w[k] + b[k])`` -> (B,) global ids; B6 on the
    card. Not differentiable."""
    off, local_valid = _local(w.shape[2], valid_dim, mesh)
    idx, m = fused_weighted_multihead_argmax(h, w, b, q_weights, local_valid, precision,
                                             with_max=True)
    return merge_shard_argmax(m, idx + off, mesh)


def _owner_rows(width: int, idx: torch.Tensor, mesh: Mesh):
    loc = idx.long() - mesh.index(MODEL_AXIS) * width
    in_range = (loc >= 0) & (loc < width)
    return torch.where(in_range, loc, 0), in_range


def sharded_row_logit(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (F, A/n)
    b: torch.Tensor,  # (A/n,)
    idx: torch.Tensor,  # (B,) global ids
    mesh: Mesh,
    data_axis: Optional[str] = None,
) -> torch.Tensor:
    """``(h @ w + b)[i, idx[i]]`` over the sharded head -> (B,).
    Differentiable: dh the whole head's, dW and db this rank's columns'
    (summed over the data axis with ``data_axis``)."""
    safe, in_range = _owner_rows(w.shape[1], idx, mesh)
    if data_axis is not None:
        w, b = pvary(w, mesh, DATA_AXIS), pvary(b, mesh, DATA_AXIS)
    vals = row_logit(pvary(h, mesh, MODEL_AXIS), w, b, safe)
    return psum(torch.where(in_range, vals, 0.0), mesh, MODEL_AXIS)


def sharded_multihead_row_logit(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (K, F, A/n)
    b: torch.Tensor,  # (K, A/n)
    idx: torch.Tensor,  # (B,) global ids
    mesh: Mesh,
    data_axis: Optional[str] = None,
) -> torch.Tensor:
    """Every head's logit at ``idx`` over the sharded heads -> (B, K);
    differentiable as :func:`sharded_row_logit`."""
    safe, in_range = _owner_rows(w.shape[2], idx, mesh)
    if data_axis is not None:
        w, b = pvary(w, mesh, DATA_AXIS), pvary(b, mesh, DATA_AXIS)
    vals = multihead_row_logit(pvary(h, mesh, MODEL_AXIS), w, b, safe)
    return psum(torch.where(in_range[:, None], vals, 0.0), mesh, MODEL_AXIS)


@torch.no_grad()
def sharded_multihead_max(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (K, F, A/n)
    b: torch.Tensor,  # (K, A/n)
    valid_dim: int,
    mesh: Mesh,
    precision: Optional[str] = None,
) -> torch.Tensor:
    """Each head's max over the sharded, masked columns -> (B, K): sarm's
    self-bootstrapped targets. Not differentiable."""
    _, local_valid = _local(w.shape[2], valid_dim, mesh)
    m = blockwise_multihead_max(h, w, b, local_valid, precision=precision)
    return mesh.all_reduce(m, "max", MODEL_AXIS)


@torch.no_grad()
def sharded_sup_topk(
    h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, k: int, action_dim: int,
    mesh: Mesh,
) -> torch.Tensor:
    """Global top-k ids (B, k) of the sharded supervised head (smorl's
    online rewards), tie order included."""
    return sharded_head_topk_ce(h, kernel, bias, k, action_dim, mesh)[1]


@torch.no_grad()
def sharded_argmax(values: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """argmax over the last axis of the (B, A) values of which this rank
    holds the (B, A/n) shard -> (B,) global ids, the lowest among equal
    maxima (the dense arm's target action)."""
    m, idx = values.max(dim=-1)
    return merge_shard_argmax(m, idx + mesh.index(MODEL_AXIS) * values.shape[-1], mesh)


def sharded_take(values: torch.Tensor, idx: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``values[..., idx]`` per row for the (B, A/n) or (B, K, A/n) shard of
    (B, [K,] A) values -> (B,) or (B, K); differentiable in the shard."""
    safe, in_range = _owner_rows(values.shape[-1], idx, mesh)
    if values.dim() == 2:
        vals, mask = values.gather(1, safe[:, None])[:, 0], in_range
    else:
        index = safe[:, None, None].expand(-1, values.shape[1], 1)
        vals, mask = values.gather(2, index)[:, :, 0], in_range[:, None]
    return psum(torch.where(mask, vals, 0.0), mesh, MODEL_AXIS)


@torch.no_grad()
def dp_linear_argmax_am(
    h: torch.Tensor,  # (B/D, F): this rank's rows
    kernel_am: torch.Tensor,  # (A_pad, F) action-major, replicated
    bias: torch.Tensor,  # (A_pad,)
    valid_dim: int,
    mesh: Mesh,
    precision: str = "highest",
) -> torch.Tensor:
    """sqn's lazy target action: argmax over the replicated action-major
    head of this rank's rows -> (B/D,) int64 ids; B5 action-major on the
    card. No collective; not differentiable. ``mesh`` only names the
    rank's place: the rows are its own already."""
    return fused_linear_argmax(h, kernel_am, bias, valid_dim, precision, action_major=True)


@torch.no_grad()
def dp_weighted_multihead_argmax_am(
    h: torch.Tensor,  # (B/D, F): this rank's rows
    kernel_am: torch.Tensor,  # (A_pad, K*F) action-major, replicated
    bias: torch.Tensor,  # (K, A_pad)
    q_weights: Union[torch.Tensor, Sequence[float]],  # (K,)
    valid_dim: int,
    mesh: Mesh,
    precision: str = "highest",
) -> torch.Tensor:
    """smorl's lazy target action: argmax of the weighted head sum over the
    replicated action-major heads, on this rank's rows -> (B/D,) ids; B6
    action-major on the card. No collective; not differentiable."""
    return fused_weighted_multihead_argmax(h, kernel_am, bias, q_weights, valid_dim, precision,
                                           action_major=True)
