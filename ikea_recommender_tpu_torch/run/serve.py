"""Serving path: top-k recommendation over session states.

Port of ``ikea_recommender_tpu/run/serve.py::Recommender`` on one device.
Big catalogs (``action_dim >= FUSED_CE_MIN_ACTIONS``) score the head
blockwise (``ops/fused_topk.py``: the (B, A) logits never exist whole);
small ones take the dense logits and one top-k. Either way equal scores
rank the lower action id first, as in the reference. Params of a lazily
trained model (action-major Q heads, ``train/lazy_adam.py``) are laid out
canonically once, when the recommender is built.

On a (data, model) mesh (``mesh``, ``core/mesh.py``) the params are this
rank's slice (``parallel/sharding.py``) and every rank scores the same
batch: a model-sharded head takes the blockwise scan over the rank's
columns by default, merged by ``parallel/topk.py::sharded_head_topk_ce``
(ties to the lower global id), as the reference's ``Recommender`` does;
the dense arm the shard's logits through ``sharded_top_k``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ikea_recommender_tpu_torch.convert import tree_map
from ikea_recommender_tpu_torch.core.device import resolve_device
from ikea_recommender_tpu_torch.core.mesh import MODEL_AXIS
from ikea_recommender_tpu_torch.models.families import (
    FUSED_CE_MIN_ACTIONS,
    ModelConfig,
    apply_features,
    apply_model,
    canonicalize_qheads,
)
from ikea_recommender_tpu_torch.ops.fused_topk import (
    blockwise_head_topk_ce,
    eval_head,
    topk_lowest_id,
)
from ikea_recommender_tpu_torch.parallel.topk import (
    shard_width,
    sharded_head_topk_ce,
    sharded_top_k,
)


class Recommender:
    """Bundles params + model config into a batch scorer on ``device``."""

    def __init__(
        self,
        params,
        model_cfg: ModelConfig,
        head_idx: int = 0,
        fused: Optional[bool] = None,
        mesh=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh lies on {mesh.device}, the recommender on {self.device}")
            shard_width(model_cfg.padded_action_dim, mesh)  # raises where it does not divide
        self.mesh = mesh
        self.params = canonicalize_qheads(tree_map(lambda t: t.to(self.device), params),
                                          model_cfg)
        self.model_cfg = model_cfg
        self.head_idx = head_idx
        fam = model_cfg.family
        can_fuse = (
            fam == "sarm" or head_idx == 0 or (fam == "sqn" and head_idx == 1)
        )
        self._model_sharded = mesh is not None and mesh.size(MODEL_AXIS) > 1
        if fused is None:
            fused = self._model_sharded or model_cfg.action_dim >= FUSED_CE_MIN_ACTIONS
        self.fused = bool(fused) and can_fuse

    def _inputs(self, states, lengths):
        return (
            torch.as_tensor(states, device=self.device),
            torch.as_tensor(lengths, device=self.device),
        )

    @torch.inference_mode()
    def recommend(self, states, lengths, k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T) states + (B,) lengths -> (scores (B, k), action ids (B, k))."""
        states, lengths = self._inputs(states, lengths)
        mesh = self.mesh
        if self.fused:
            h = apply_features(self.params, self.model_cfg, states, lengths, mesh=mesh)
            kernel, bias = eval_head(self.params, self.model_cfg, self.head_idx)
            if self._model_sharded:
                vals, idx, _ = sharded_head_topk_ce(h, kernel, bias, k,
                                                    self.model_cfg.action_dim, mesh)
            else:
                vals, idx, _ = blockwise_head_topk_ce(
                    h, kernel, bias, k, self.model_cfg.action_dim
                )
            return vals, idx
        preds = apply_model(self.params, self.model_cfg, states, lengths, mesh=mesh)[self.head_idx]
        return topk_lowest_id(preds, k) if mesh is None else sharded_top_k(preds, k, mesh)

    @torch.inference_mode()
    def scores(self, states, lengths) -> torch.Tensor:
        """The selected head's full output for (B, T) states (on a mesh,
        gathered from the shards)."""
        states, lengths = self._inputs(states, lengths)
        preds = apply_model(self.params, self.model_cfg, states, lengths,
                            mesh=self.mesh)[self.head_idx]
        if self.mesh is None:
            return preds
        return torch.cat(list(self.mesh.gather(preds, MODEL_AXIS).unbind(0)), dim=-1)
