"""Model families as head configurations over the shared backbone.

Port of ``ikea_recommender_tpu/models/families.py``:

- ``gru4rec``       -> sup head only
- ``bidir_gru4rec`` -> sup head on 2H bidirectional features
- ``sqn``           -> sup + 1 Q head
- ``smorl``         -> sup + K Q heads (canonical K=3: acc/div/nov)
- ``sarm``          -> 5 Q heads, head 0 doubles as the supervised head

``apply_model`` returns a tuple of head outputs so that a ``head_idx``
selects the scored head uniformly. Params keep the reference's layout
(see :mod:`ikea_recommender_tpu_torch.convert`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ikea_recommender_tpu_torch.models.backbone import BackboneConfig, apply_backbone
from ikea_recommender_tpu_torch.models.heads import linear_apply, multihead_apply

FAMILIES = ("gru4rec", "bidir_gru4rec", "sqn", "smorl", "sarm")

# Catalog size from which the train step takes the fused CE kernels and
# serving scores the head blockwise (the reference's threshold, kept so both
# packages pick the same paths).
FUSED_CE_MIN_ACTIONS = 8192


@dataclass(frozen=True)
class ModelConfig:
    family: str
    backbone: BackboneConfig
    action_dim: int
    num_q_heads: int = 0  # sqn: 1, smorl: K (default 3), sarm: 5
    # Pad the output head's action dim up to a multiple. Padded logits are
    # masked to -1e9 so softmax / top-k / argmax semantics are untouched.
    action_align: int = 1
    # Train the supervised CE through the fused kernels (ops/fused_ce.py):
    # the (B, A) logits are never written to device memory.
    fused_ce: bool = False
    # Precision of the fused head products: "high" = bf16x3, "highest" =
    # fp32, "default" = one bf16 pass (ops/fused_ce.py).
    head_precision: str = "high"

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown model family {self.family!r}")

    @property
    def padded_action_dim(self) -> int:
        a = self.action_align
        return -(-self.action_dim // a) * a


def model_config_from_train(train_cfg, data_cfg, align: int = 1) -> ModelConfig:
    """Build a ModelConfig from the typed experiment config sections
    (:mod:`ikea_recommender_tpu_torch.core.config`). ``align`` pads vocab
    rows and the action dim to a multiple."""
    family = train_cfg.model
    backbone = BackboneConfig(
        num_items=data_cfg.num_items,
        embedding_dim=train_cfg.embedding_size,
        hidden_dim=train_cfg.hidden_state_size,
        gru_layers=train_cfg.gru_layers,
        bidirectional=(family == "bidir_gru4rec"),
        pad_id=train_cfg.padding_id,
        train_pad_embed=train_cfg.train_padding_embed,
        masked_recurrence=train_cfg.use_packed_seq,
        head_layer="first" if train_cfg.compat_first_layer_head else "last",
        dropout=train_cfg.dropout,
        compute_dtype=train_cfg.compute_dtype,
        vocab_align=align,
    )
    num_q = {"gru4rec": 0, "bidir_gru4rec": 0, "sqn": 1, "sarm": 5}.get(
        family, train_cfg.num_q_heads
    )
    return ModelConfig(
        family=family,
        backbone=backbone,
        action_dim=data_cfg.num_actions,
        num_q_heads=num_q,
        action_align=align,
        fused_ce=(
            train_cfg.fused_ce
            and data_cfg.num_actions
            >= (
                FUSED_CE_MIN_ACTIONS
                if train_cfg.fused_ce_min_actions is None
                else train_cfg.fused_ce_min_actions
            )
        ),
        head_precision=train_cfg.head_precision,
    )


def apply_features(
    params: Dict,
    cfg: ModelConfig,
    states: torch.Tensor,
    lengths: torch.Tensor,
    *,
    dropout_generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Backbone features (B, F) — the input every head shares."""
    return apply_backbone(
        params["backbone"],
        cfg.backbone,
        states,
        lengths,
        dropout_generator=dropout_generator,
        deterministic=deterministic,
    )


def mask_pad_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Padded action slots never win softmax / top-k / argmax."""
    n_pad = cfg.padded_action_dim - cfg.action_dim
    if n_pad == 0:
        return logits
    neg = logits.new_full(logits.shape[:-1] + (n_pad,), -1e9)
    return torch.cat([logits[..., : cfg.action_dim], neg], dim=-1)


def canonicalize_qheads(params: Dict, cfg: ModelConfig) -> Dict:
    """The reference's lazy optimizers store Q-head kernels action-major
    (``kernel_am``, and SARM's split ``kernel0``); the port reads only the
    canonical (K, F, A) layout so far."""
    for name in ("q_head", "q_heads"):
        head = params.get(name, {})
        if "kernel_am" in head or "kernel0" in head:
            raise NotImplementedError(
                f"{name} holds a lazy action-major layout (kernel_am/kernel0); "
                "the port reads it from the presets and lazy-optimizers slice "
                "on (ROADMAP A.8). Export canonical (K, F, A) kernels instead."
            )
    return params


def apply_model(
    params: Dict,
    cfg: ModelConfig,
    states: torch.Tensor,
    lengths: torch.Tensor,
    *,
    dropout_generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """Forward pass -> tuple of head outputs.

    gru4rec / bidir: (logits,)
    sqn:   (sup_logits, q_values (B, A))
    smorl: (sup_logits, q_all (B, K, A))
    sarm:  (head_0, ..., head_4) each (B, A)
    """
    params = canonicalize_qheads(params, cfg)
    h = apply_features(
        params, cfg, states, lengths,
        dropout_generator=dropout_generator, deterministic=deterministic,
    )

    def mask_pad(logits):
        return mask_pad_logits(cfg, logits)

    if cfg.family == "sarm":
        q_all = mask_pad(multihead_apply(params["q_heads"], h))  # (B, 5, A)
        return tuple(q_all[:, i, :] for i in range(5))
    sup = mask_pad(linear_apply(params["sup_head"], h))
    if cfg.family == "sqn":
        return sup, mask_pad(linear_apply(params["q_head"], h))
    if cfg.family == "smorl":
        return sup, mask_pad(multihead_apply(params["q_heads"], h))
    return (sup,)
