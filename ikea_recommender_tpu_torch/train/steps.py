"""The supervised CE train step of gru4rec and bidir_gru4rec.

Port of ``ikea_recommender_tpu/train/steps.py`` (``_masked_mean``,
``_ce_loss``, ``_fused_sup_ce``, ``_apply_grad_mask``, ``ce_train_step``,
``TrainStep`` and ``make_train_step``) for the families that train with the
supervised CE alone (reference ``models/GRU4Rec/model.py:131-158``).

One step: embedding gather, the GRU layers (B3 forward and B4 backward on
the card), the masked-mean CE over the catalog, the pad row's gradient mask
and Adam. Catalogs of at least ``FUSED_CE_MIN_ACTIONS`` take the fused CE
(B1 forward and B2 backward: the (B, A) logits are never written); smaller
ones the dense logits path over ``mask_pad_logits``. The step is split into
:func:`loss_and_grads` and the Adam update, so the gradients can be
compared on their own.

Batches are dicts of arrays: ``state`` (B, T) int, ``action`` (B,) int,
``true_len`` (B,) int and ``valid`` (B,) bool, the mask of a padded tail
batch; every mean is a masked mean. The step returns its metrics as device
tensors and never waits on the device itself.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ikea_recommender_tpu_torch.convert import tree_leaves, tree_map, tree_unflatten
from ikea_recommender_tpu_torch.core.device import resolve_device
from ikea_recommender_tpu_torch.models.backbone import embedding_grad_mask
from ikea_recommender_tpu_torch.models.families import (
    ModelConfig,
    apply_features,
    apply_model,
)
from ikea_recommender_tpu_torch.ops.fused_ce import fused_softmax_ce
from ikea_recommender_tpu_torch.train.state import Adam, TrainState

_LATER = {
    "sqn": "the sqn slice (ROADMAP A.5)",
    "smorl": "the smorl slice (ROADMAP A.6)",
    "sarm": "the bidir_gru4rec and sarm training slice (ROADMAP A.7)",
}


def _masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    w = valid.to(x.dtype)
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)


def _ce_loss(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    per = F.cross_entropy(logits, labels.long(), reduction="none")
    return _masked_mean(per, valid)


def _fused_sup_ce(
    params: Dict, cfg: ModelConfig, h: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Supervised CE through the fused kernels, the same masked mean as
    :func:`_ce_loss` over ``mask_pad_logits``-masked logits."""
    head = params["sup_head"]
    per = fused_softmax_ce(
        h.to(torch.float32), head["kernel"], head["bias"], labels,
        cfg.action_dim, cfg.head_precision,
    )
    return _masked_mean(per, valid)


def _apply_grad_mask(grads: Dict, model_cfg: ModelConfig) -> Dict:
    emb = grads["backbone"]["embedding"]
    mask = embedding_grad_mask(model_cfg.backbone, emb.device)
    if mask is None:
        return grads
    out = dict(grads)
    out["backbone"] = {**grads["backbone"], "embedding": emb * mask}
    return out


def loss_and_grads(
    params: Dict,
    batch: Dict[str, torch.Tensor],
    model_cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads) of the supervised CE step at ``params``, grads in the
    params' layout with the pad row's gradient masked. ``generator`` draws
    the dropout mask (needed only when ``model_cfg.backbone.dropout > 0``)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    deterministic = model_cfg.backbone.dropout == 0.0
    kw = dict(dropout_generator=generator, deterministic=deterministic)
    with torch.enable_grad():
        if model_cfg.fused_ce:
            h = apply_features(leaves, model_cfg, batch["state"], batch["true_len"], **kw)
            loss = _fused_sup_ce(leaves, model_cfg, h, batch["action"], batch["valid"])
        else:
            logits = apply_model(leaves, model_cfg, batch["state"], batch["true_len"], **kw)[0]
            loss = _ce_loss(logits, batch["action"], batch["valid"])
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), _apply_grad_mask(tree_unflatten(leaves, grads), model_cfg)


def ce_train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    model_cfg: ModelConfig,
    opt: Adam,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One supervised CE step. Moves ``state``'s params and moments in
    place and returns it with the step advanced, and the metrics."""
    loss, grads = loss_and_grads(state.params, batch, model_cfg, state.generator)
    opt.update(grads, state.opt_state, state.params)
    state.step += 1
    return state, {"sup_loss": loss, "q_loss": torch.zeros_like(loss)}


class TrainStep:
    """``step(state, batch) -> (state, metrics)`` on one device. The
    batch's arrays (numpy or tensors) are copied to the device; the state
    must already lie there."""

    def __init__(self, raw: Callable, device: torch.device):
        self.raw = raw
        self.device = device

    def __call__(self, state: TrainState, batch):
        emb = state.params["backbone"]["embedding"]
        if emb.device.type != self.device.type:
            raise ValueError(f"the state lies on {emb.device}, the step runs on {self.device}")
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        return self.raw(state, batch)


def make_train_step(
    model_cfg: ModelConfig,
    opt: Adam,
    *,
    lazy_embedding_lr: Optional[float] = None,
    lazy_qhead_lr: Optional[float] = None,
    mesh=None,
    device="cuda",
) -> TrainStep:
    """Build ``step(state, batch) -> (state, metrics)`` for the family on
    ``device`` (raises without CUDA unless ``device="cpu"``). The port has
    the supervised CE step of gru4rec and bidir_gru4rec so far; the other
    families, the lazy optimizers and ``mesh`` raise."""
    dev = resolve_device(device)
    fam = model_cfg.family
    if fam in _LATER:
        raise NotImplementedError(f"the {fam} train step comes with {_LATER[fam]}")
    if lazy_embedding_lr is not None or lazy_qhead_lr is not None:
        raise NotImplementedError(
            "lazy optimizers come with the presets and lazy-optimizers slice (ROADMAP A.8)"
        )
    if mesh is not None:
        raise NotImplementedError("a mesh comes with the multi-GPU slice (ROADMAP A.9)")
    return TrainStep(lambda state, batch: ce_train_step(state, batch, model_cfg, opt), dev)
