"""Online rewards of the smorl train step, computed on the device.

Port of ``ikea_recommender_tpu/ops/rewards.py`` (``get_last_action``,
``diversity_from_topk`` and ``novelty_from_topk``; the reference's
``evaluate/diversity.py`` and ``novelty.py``). Both rewards read the
supervised head's top-k ids; the output-to-input vocabulary remap is an
int gather table (``out_to_in``). The module's other functions come with the
eval slice (ROADMAP A.3).
"""

from __future__ import annotations

from typing import Optional

import torch


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


def novelty_from_topk(
    pred_idx: torch.Tensor,  # (B, k) top-k predicted action ids
    unpopular_mask: torch.Tensor,  # (A,) bool
    reward: float = 1.0,
) -> torch.Tensor:
    """Per sample, the mean over the top-k of (prediction is unpopular) *
    ``reward``; the unpopular set lives in output-token space."""
    nov = unpopular_mask[pred_idx.long()].to(torch.float32) * reward
    return torch.mean(nov, dim=1)
