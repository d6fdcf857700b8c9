"""Top-k ranking and HR@k / NDCG@k on the device.

Port of ``ikea_recommender_tpu/ops/ranking.py``: one top-k over the catalog
axis, the rank of the true action within it found by equality, and masked
sums. A rank r in [1, k] is the position of the true action among the top-k
predictions; equal scores rank the lower action id first, as ``lax.top_k``
does (``ops/fused_topk.py::topk_lowest_id``). NDCG contributes
1 / log2(r + 1), and 0 when the action is not in the top-k.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ikea_recommender_tpu_torch.ops.fused_topk import topk_lowest_id


def topk_indices(predictions: torch.Tensor, k: int) -> torch.Tensor:
    """(B, A) scores -> (B, k) top-k action ids, descending, the lower id
    first among equal scores."""
    return topk_lowest_id(predictions, k)[1]


def hit_ranks(topk_idx: torch.Tensor, true_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, maxk) top-k ids + (B,) labels -> (hit (B,) bool, rank (B,) int64).

    rank is the 1-based position of the first match in the top-k list, 0
    when there is none."""
    matches = topk_idx == true_idx[:, None].to(topk_idx.dtype)  # (B, maxk)
    pos = torch.arange(1, matches.shape[1] + 1, device=matches.device)
    rank = torch.where(matches, pos, matches.shape[1] + 1).min(dim=1).values
    hit = matches.any(dim=1)
    return hit, torch.where(hit, rank, 0)


def _ndcg_terms(hit_k: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    return torch.where(hit_k, 1.0 / torch.log2(rank.to(torch.float32) + 1.0), 0.0)


def hr_ndcg_from_topk(
    topk_idx: torch.Tensor,
    true_idx: torch.Tensor,
    top_k: Sequence[int],
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch sums of hits and NDCG for each k from precomputed (B, >= max k)
    top-k ids. Returns (hits (len(top_k),), ndcg (len(top_k),)), float32."""
    hit, rank = hit_ranks(topk_idx, true_idx)
    if valid is None:
        valid = torch.ones_like(hit)
    hits, ndcgs = [], []
    for k in top_k:
        hit_k = hit & (rank <= k) & valid.bool()
        hits.append(hit_k.sum())
        ndcgs.append(_ndcg_terms(hit_k, rank).sum())
    return torch.stack(hits).to(torch.float32), torch.stack(ndcgs)


def hr_ndcg_at_k(
    predictions: torch.Tensor,
    true_idx: torch.Tensor,
    top_k: Sequence[int],
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch sums of hits and NDCG for each k from (B, A) scores."""
    idx = topk_indices(predictions, max(top_k))
    return hr_ndcg_from_topk(idx, true_idx, top_k, valid)


def hr_ndcg_by_type_from_topk(
    topk_idx: torch.Tensor,
    true_idx: torch.Tensor,
    action_types: torch.Tensor,  # (B,) int in [0, num_types)
    num_types: int,
    top_k: Sequence[int],
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-action-type HR/NDCG sums from precomputed top-k ids (click
    against buy events in the old generation's eval): the reference's
    one-hot product per k, taken as a product and a sum over the batch so
    that it stays fp32 whatever the TF32 setting. Returns (hits
    (num_types, n_k), ndcg (num_types, n_k), counts (num_types,)),
    float32."""
    hit, rank = hit_ranks(topk_idx, true_idx)
    if valid is None:
        valid = torch.ones_like(hit)
    onehot = torch.nn.functional.one_hot(action_types.long(), num_types).to(torch.float32)
    onehot = onehot * valid.to(torch.float32)[:, None]  # (B, num_types)
    hits, ndcgs = [], []
    for k in top_k:
        hit_k = hit & (rank <= k)
        hits.append((onehot * hit_k.to(torch.float32)[:, None]).sum(dim=0))
        ndcgs.append((onehot * _ndcg_terms(hit_k, rank)[:, None]).sum(dim=0))
    return torch.stack(hits, dim=1), torch.stack(ndcgs, dim=1), onehot.sum(dim=0)


def hr_ndcg_by_action_type(
    predictions: torch.Tensor,
    true_idx: torch.Tensor,
    action_types: torch.Tensor,
    num_types: int,
    top_k: Sequence[int],
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    idx = topk_indices(predictions, max(top_k))
    return hr_ndcg_by_type_from_topk(idx, true_idx, action_types, num_types, top_k, valid)
