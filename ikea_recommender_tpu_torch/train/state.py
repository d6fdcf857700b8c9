"""Train state and the Adam optimizer.

Port of ``ikea_recommender_tpu/train/state.py`` (``TrainState``,
``make_optimizer``, ``_scale_by_adam_mv`` and ``make_train_state``) for the
single-network families (gru4rec, bidir_gru4rec).

Adam is written out as tensor operations rather than taken from
``torch.optim``, so that the bf16-moment variant, and the lazy variants that
build on it, share one update. It mirrors ``optax.adam(b1=0.9, b2=0.999,
eps=1e-8)``: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``p -= lr * (m / bc1) / (sqrt(v / bc2) + eps)`` with ``eps_root`` 0 and the
bias corrections ``bc = 1 - b^count`` in fp32. With ``mv_dtype`` the moments
are stored in that dtype and the math runs in fp32, as
``_scale_by_adam_mv`` does.

The update works in place on the params and the moments: a state passed to
a step must not be used again by the caller (the reference's buffer
donation asks the same). The step count stays a device tensor, so the
update never waits on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ikea_recommender_tpu_torch.convert import tree_leaves, tree_map
from ikea_recommender_tpu_torch.core.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B1, B2, EPS = 0.9, 0.999, 1e-8  # torch's Adam defaults, as the reference uses


@dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the update count (int32 scalar tensor)
    and the two moments in the param layout."""

    count: torch.Tensor
    mu: Any
    nu: Any


@dataclass
class TrainState:
    params: Dict
    opt_state: AdamState
    step: int
    generator: torch.Generator  # dropout masks; the reference's PRNG key


class Adam:
    """``init(params) -> AdamState`` and ``update(grads, state, params)``,
    which moves params and state in place."""

    def __init__(self, learning_rate: float, mv_dtype: Optional[str] = None):
        if mv_dtype is not None and mv_dtype not in _DTYPES:
            raise ValueError(f"mv_dtype must be one of {sorted(_DTYPES)} or None, got {mv_dtype!r}")
        self.lr = learning_rate
        self.mv_dtype = None if mv_dtype is None else _DTYPES[mv_dtype]

    def init(self, params: Dict) -> AdamState:
        def zeros(p):
            return torch.zeros_like(p, dtype=self.mv_dtype or p.dtype)

        device = tree_leaves(params)[0].device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(zeros, params),
            nu=tree_map(zeros, params),
        )

    @torch.no_grad()
    def update(self, grads: Dict, state: AdamState, params: Dict) -> AdamState:
        state.count += 1
        c = state.count.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(B1, device=c.device), c)
        bc2 = 1.0 - torch.pow(torch.tensor(B2, device=c.device), c)
        for p, g, m, v in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu)
        ):
            if self.mv_dtype is None:
                m.mul_(B1).add_(g, alpha=1.0 - B1)
                v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
                m32, v32 = m, v
            else:
                g32 = g.to(torch.float32)
                m32 = B1 * m.to(torch.float32) + (1.0 - B1) * g32
                v32 = B2 * v.to(torch.float32) + (1.0 - B2) * (g32 * g32)
                m.copy_(m32)
                v.copy_(v32)
            upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + EPS)
            p.add_(upd.to(p.dtype), alpha=-self.lr)
        return state


def make_optimizer(learning_rate: float, mv_dtype: Optional[str] = None) -> Adam:
    """Adam with torch defaults (betas 0.9/0.999, eps 1e-8), the reference's
    optimizer everywhere. ``mv_dtype`` (e.g. "bfloat16", config
    ``optimizer_mv_dtype``) stores both moments in that dtype."""
    return Adam(learning_rate, mv_dtype)


def make_train_state(
    params: Dict, model_cfg, learning_rate: float, mv_dtype: Optional[str] = None,
    seed: int = 0, device="cuda",
) -> Tuple[TrainState, Adam]:
    """A fresh state over ``params`` (already tensors on ``device``, e.g.
    from ``convert.params_from_numpy``; the reference's PRNG init cannot be
    reproduced, so the port takes params rather than drawing them). The
    embedding and the head must have ``model_cfg``'s shapes. Raises without
    CUDA unless ``device="cpu"``."""
    dev = resolve_device(device)
    for leaf in tree_leaves(params):
        if leaf.device.type != dev.type:
            raise ValueError(f"params lie on {leaf.device}, the state on {dev}")
    bb = model_cfg.backbone
    want = {"embedding": (bb.num_embeddings, bb.embedding_dim)}
    got = {"embedding": tuple(params["backbone"]["embedding"].shape)}
    if "sup_head" in params:
        want["sup_head"] = (bb.feature_dim, model_cfg.padded_action_dim)
        got["sup_head"] = tuple(params["sup_head"]["kernel"].shape)
    if got != want:
        raise ValueError(f"params have shapes {got}, the model config asks for {want}")
    opt = make_optimizer(learning_rate, mv_dtype)
    generator = torch.Generator(device=dev).manual_seed(seed)
    return TrainState(params, opt.init(params), 0, generator), opt
