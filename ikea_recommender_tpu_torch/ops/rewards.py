"""Online rewards and behavioural metrics, computed on the device.

Port of ``ikea_recommender_tpu/ops/rewards.py`` (the reference's
``evaluate/diversity.py``, ``novelty.py`` and ``repetitiveness.py``): the
smorl train step's diversity and novelty rewards, and the eval protocol's
rewards and repetition counts. Each reads top-k ids; the ``*_rewards`` and
``repetition_counts`` forms take them from (B, A) scores through
``ops/ranking.py::topk_indices``, which keeps ``lax.top_k``'s tie order.
The output-to-input vocabulary remap is an int gather table
(``out_to_in``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ikea_recommender_tpu_torch.ops.ranking import topk_indices


def get_last_action(states: torch.Tensor, lengths: torch.Tensor, padding_pos: str) -> torch.Tensor:
    """Last real item of each state: ``s[len - 1]`` with end padding,
    ``s[:, -1]`` with beginning padding."""
    if padding_pos == "end":
        idx = torch.clamp(lengths.long() - 1, 0, states.shape[1] - 1)
        return states.gather(1, idx[:, None]).squeeze(1)
    return states[:, -1]


def diversity_from_topk(
    states: torch.Tensor,  # (B, T) input-token ids
    pred_idx: torch.Tensor,  # (B, k) top-k predicted action ids
    lengths: torch.Tensor,  # (B,)
    padding_pos: str,
    div_embedding: torch.Tensor,  # (V_in, E) frozen pretrained embedding
    out_to_in: Optional[torch.Tensor] = None,  # (A,) output -> input id table
    eps: float = 1e-6,
) -> torch.Tensor:
    """reward = 1 - mean cosine similarity of emb(last item) and emb(each
    top-k prediction), in [0, 2]. The denominator is ``max(|a| |b|, eps)``,
    ``torch.nn.CosineSimilarity``'s rule."""
    last = get_last_action(states, lengths, padding_pos).long()
    pred_idx = pred_idx.long()
    if out_to_in is not None:
        pred_idx = out_to_in[pred_idx].long()
    div_embedding = div_embedding.detach()
    e_last = div_embedding[last]  # (B, E)
    e_pred = div_embedding[pred_idx]  # (B, k, E)
    num = torch.einsum("be,bke->bk", e_last, e_pred)
    denom = torch.clamp(
        torch.linalg.vector_norm(e_last, dim=-1)[:, None]
        * torch.linalg.vector_norm(e_pred, dim=-1),
        min=eps,
    )
    return 1.0 - torch.mean(num / denom, dim=1)


def diversity_rewards(
    states: torch.Tensor,  # (B, T) input-token ids
    predictions: torch.Tensor,  # (B, A) output-head scores
    lengths: torch.Tensor,  # (B,)
    padding_pos: str,
    topk: int,
    div_embedding: torch.Tensor,
    out_to_in: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    return diversity_from_topk(
        states, topk_indices(predictions, topk), lengths, padding_pos, div_embedding,
        out_to_in=out_to_in, eps=eps,
    )


def novelty_from_topk(
    pred_idx: torch.Tensor,  # (B, k) top-k predicted action ids
    unpopular_mask: torch.Tensor,  # (A,) bool
    reward: float = 1.0,
) -> torch.Tensor:
    """Per sample, the mean over the top-k of (prediction is unpopular) *
    ``reward``; the unpopular set lives in output-token space."""
    nov = unpopular_mask[pred_idx.long()].to(torch.float32) * reward
    return torch.mean(nov, dim=1)


def novelty_rewards(
    predictions: torch.Tensor,  # (B, A)
    unpopular_mask: torch.Tensor,  # (A,) bool
    reward: float = 1.0,
    topk: int = 1,
) -> torch.Tensor:
    return novelty_from_topk(topk_indices(predictions, topk), unpopular_mask, reward)


def repetitions_from_topk(
    states: torch.Tensor,  # (B, T) input-token ids
    idx: torch.Tensor,  # (B, >= max k) top-k predicted action ids
    top_k: Sequence[int],
    out_to_in: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Total count, per k, of (state position, top-k prediction) pairs that
    hold the same item, summed over the batch (reference
    ``repetitiveness.py:21-57``). Returns (len(top_k),) float32 sums."""
    idx = idx.long()
    if out_to_in is not None:
        idx = out_to_in[idx].long()
    eq = states.long()[:, :, None] == idx[:, None, :]  # (B, T, maxk)
    if valid is not None:
        eq = eq & valid.bool()[:, None, None]
    return torch.stack([eq[:, :, :k].sum() for k in top_k]).to(torch.float32)


def repetition_counts(
    states: torch.Tensor,  # (B, T) input-token ids
    predictions: torch.Tensor,  # (B, A)
    top_k: Sequence[int],
    out_to_in: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    return repetitions_from_topk(
        states, topk_indices(predictions, max(top_k)), top_k, out_to_in=out_to_in, valid=valid
    )
