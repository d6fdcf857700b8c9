"""One GRU direction over a padded session batch.

Port of ``ikea_recommender_tpu/models/gru.py::gru_layer_apply``. The input
projection ``x W_i + b_i`` for all timesteps is one ``torch.matmul``
outside any kernel, as the reference leaves it to XLA, then ``+ b_i``: two
roundings in bfloat16 compute, as the reference's ``einsum(...) + bi``
(a fused ``addmm`` would add b_i before its one rounding); the serial
recurrence always runs through
:func:`ikea_recommender_tpu_torch.ops.gru_cuda.gru_scan` (the hand-written
forward and backward kernels on the card, their plain twins on the CPU), so
the layer is differentiable in its four params and its input. The reference's
``scan_impl`` regime rule picks between XLA's scan and its Pallas kernel;
the port has one recurrence, so it has no such rule.

The length mask ``t < lengths`` reproduces packed-sequence semantics,
including the "empty state consumes one pad token" convention (lengths are
always >= 1). ``lengths=None`` runs the cell over pad tokens too.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ikea_recommender_tpu_torch.ops.gru_cuda import gru_scan


def length_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """(B,) lengths -> (B, T) float32 mask of ``t < lengths``."""
    t_idx = torch.arange(T, device=lengths.device)
    return (t_idx[None, :] < lengths[:, None]).to(torch.float32)


def gru_layer_apply(
    params: Dict[str, torch.Tensor],  # wi (E, 3H), wh (H, 3H), bi, bh (3H,)
    x_seq: torch.Tensor,  # (B, T, E_in) in the params' dtype (float32 or bfloat16)
    lengths: Optional[torch.Tensor],  # (B,) int or None for unmasked
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y_seq (B, T, H), final_h (B, H)) in x_seq's dtype; the mask
    stays float32."""
    T = x_seq.shape[1]
    xw = torch.matmul(x_seq, params["wi"]) + params["bi"]
    mask = None if lengths is None else length_mask(lengths, T)
    return gru_scan(xw, params["wh"], params["bh"], mask, reverse=reverse)
