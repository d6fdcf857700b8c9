"""Embedding-space analysis: the cosine-similarity structure of a trained
item-embedding matrix and nearest-neighbour lookups.

Port of ``ikea_recommender_tpu/analysis/embeddings.py`` (reference
``ikea/results/embedding_analysis.py:11-77``). The products are plain fp32
``torch.matmul`` on ``device`` (TF32 stays off, torch's default, as for
every dense product of the port): the reference computes them outside any
Pallas kernel. Equal similarities rank the lower id first, as
``lax.top_k`` does (``ops/fused_topk.py::topk_lowest_id``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ikea_recommender_tpu_torch.core.device import resolve_device
from ikea_recommender_tpu_torch.ops.fused_topk import topk_lowest_id


def _unit(emb, eps: float, device) -> torch.Tensor:
    emb = torch.as_tensor(emb, dtype=torch.float32, device=resolve_device(device))
    return emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True).clamp_min(eps)


def cosine_similarity_matrix(emb, eps: float = 1e-8, device="cuda") -> torch.Tensor:
    """(V, E) -> (V, V) cosine similarities on ``device`` (raises without
    CUDA unless ``device="cpu"``)."""
    unit = _unit(emb, eps, device)
    return unit @ unit.T


def nearest_neighbors(
    emb, item_ids, k: int = 10, eps: float = 1e-8, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k most similar items for each query id (the item itself
    excluded: its similarity is set to -inf). Returns numpy
    (neighbor_ids (Q, k), similarities (Q, k))."""
    unit = _unit(emb, eps, device)
    ids = torch.as_tensor(np.asarray(item_ids), dtype=torch.int64, device=unit.device)
    sims = unit[ids] @ unit.T  # (Q, V)
    sims[torch.arange(len(ids), device=unit.device), ids] = -torch.inf
    vals, idx = topk_lowest_id(sims, k)
    return idx.cpu().numpy(), vals.cpu().numpy()
