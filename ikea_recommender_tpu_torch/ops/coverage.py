"""Catalog coverage, accumulated on the device.

Port of ``ikea_recommender_tpu/ops/coverage.py``. The reference keeps, per
k, the set of every action id that appeared in some top-k recommendation
over the pass (``evaluate/coverage.py:24-74``); here it is a
(len(top_k), num_actions) bool array, and the coverage ratios are masked
counts over it. Coverage lives in output-token space: no output-to-input
remap, as in the reference.

The update is a scatter of each row's ids with its ``valid`` flag, where
the reference's ``.at[ids].max(updates)`` takes the OR over duplicate ids.
A padded tail row repeats a valid row's ids with ``valid`` False, so a
plain ``index_put_`` would let the last of the duplicates win, in an order
CUDA leaves open; ``scatter_reduce(..., "amax")`` on an int32 copy keeps
the OR on any order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ikea_recommender_tpu_torch.ops.ranking import topk_indices


def init_coverage(num_actions: int, num_ks: int, device=None) -> torch.Tensor:
    return torch.zeros((num_ks, num_actions), dtype=torch.bool, device=device)


def update_coverage_from_topk(
    covered: torch.Tensor,  # (n_k, A) bool
    idx: torch.Tensor,  # (B, >= max k) top-k predicted action ids
    top_k: Sequence[int],
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """-> the new (n_k, A) bool coverage: row i ORs in the first
    ``top_k[i]`` ids of every valid row of ``idx``."""
    rows = []
    for i, k in enumerate(top_k):
        ids = idx[:, :k].long()
        if valid is None:
            updates = torch.ones(ids.shape, dtype=torch.int32, device=ids.device)
        else:
            updates = valid[:, None].to(torch.int32).expand(ids.shape)
        row = covered[i].to(torch.int32).scatter_reduce(
            0, ids.reshape(-1), updates.reshape(-1), reduce="amax"
        )
        rows.append(row.bool())
    return torch.stack(rows)


def update_coverage(
    covered: torch.Tensor,  # (n_k, A) bool
    predictions: torch.Tensor,  # (B, A)
    top_k: Sequence[int],
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    idx = topk_indices(predictions, max(top_k))
    return update_coverage_from_topk(covered, idx, top_k, valid)


def coverage_ratios(
    covered: torch.Tensor,  # (n_k, A) bool
    unpopular_mask: torch.Tensor,  # (A,) bool
    num_actions: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (unpopular coverage (n_k,), all coverage (n_k,)), float32:
    |covered ∩ unpopular| / |unpopular| and |covered| / num_actions
    (reference ``coverage.py:4-21``)."""
    n_unpop = torch.clamp(unpopular_mask.sum(), min=1)
    unpop_cov = (covered & unpopular_mask[None, :]).sum(dim=1) / n_unpop
    all_cov = covered.sum(dim=1) / num_actions
    return unpop_cov.to(torch.float32), all_cov.to(torch.float32)
