"""RL tensor operations: multi-head Q gathering and scalarization.

Port of ``ikea_recommender_tpu/ops/rl.py`` (the reference's
``utils/tensor_operations.py:4-84``): the dense forms that the unfused smorl
step uses; the fused step replaces them with ``ops/fused_argmax.py``.
"""

from __future__ import annotations

import torch


def gather_from_3d(q_tensor: torch.Tensor, action_idxs: torch.Tensor) -> torch.Tensor:
    """(B, K, A) Q-values and (B,) action ids -> (B, K): every head's value
    at the sample's action."""
    K = q_tensor.shape[1]
    idx = action_idxs.long()[:, None, None].expand(-1, K, 1)
    return q_tensor.gather(2, idx).squeeze(-1)


def weighted_q_loss(q_vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, K) per-head values x (K,) weights -> (B,) scalarized."""
    return q_vals @ w


def get_weighted_q_target(q_vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, K, A) x (K,) -> (B, A) weighted head sum."""
    return torch.sum(q_vals * w[None, :, None], dim=1)


def get_max_action(q_vals: torch.Tensor) -> torch.Tensor:
    """(B, A) -> (B,) argmax action, the lowest id among equal maxima."""
    return torch.argmax(q_vals, dim=1)
