"""Train state and the Adam optimizer.

Port of ``ikea_recommender_tpu/train/state.py`` (``TrainState``,
``DoubleQState``, ``make_optimizer``, ``_scale_by_adam_mv``,
``make_train_state`` and ``make_double_q_state``): one network for gru4rec
and bidir_gru4rec, the (net0, net1) pair of sqn and smorl.

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
from typing import Any, Dict, Optional, Sequence, Tuple

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


@dataclass
class DoubleQState:
    """The double-Q pair of sqn and smorl: ``params`` is (net0, net1), and
    ``opt_state`` one :class:`AdamState` per net, or one over the pair with
    ``single_optimizer``. ``generator`` is a CPU generator that draws each
    step's coin (which net is the main one) on the host, so choosing the
    branch never waits on the device."""

    params: Tuple[Dict, Dict]
    opt_state: Any
    step: int
    generator: torch.Generator


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


def _check_params(params: Dict, model_cfg, dev: torch.device) -> None:
    """The params lie on ``dev`` and have ``model_cfg``'s embedding and
    head shapes."""
    for leaf in tree_leaves(params):
        if leaf.device.type != dev.type:
            raise ValueError(f"params lie on {leaf.device}, the state on {dev}")
    bb = model_cfg.backbone
    F, A = bb.feature_dim, model_cfg.padded_action_dim
    want = {"embedding": (bb.num_embeddings, bb.embedding_dim)}
    got = {"embedding": tuple(params["backbone"]["embedding"].shape)}
    heads = {"sup_head": (F, A), "q_head": (F, A), "q_heads": (model_cfg.num_q_heads, F, A)}
    for name, shape in heads.items():
        if name in params:
            want[name] = shape
            got[name] = tuple(params[name]["kernel"].shape)
    if got != want:
        raise ValueError(f"params have shapes {got}, the model config asks for {want}")


def make_train_state(
    params: Dict, model_cfg, learning_rate: float, mv_dtype: Optional[str] = None,
    seed: int = 0, device="cuda",
) -> Tuple[TrainState, Adam]:
    """A fresh state over ``params`` (already tensors on ``device``, e.g.
    from ``convert.params_from_numpy``; the reference's PRNG init cannot be
    reproduced, so the port takes params rather than drawing them). The
    embedding and the heads must have ``model_cfg``'s shapes. Raises without
    CUDA unless ``device="cpu"``."""
    dev = resolve_device(device)
    _check_params(params, model_cfg, dev)
    opt = make_optimizer(learning_rate, mv_dtype)
    generator = torch.Generator(device=dev).manual_seed(seed)
    return TrainState(params, opt.init(params), 0, generator), opt


def make_double_q_state(
    params: Sequence[Dict], model_cfg, learning_rate: float, mv_dtype: Optional[str] = None,
    single_optimizer: bool = False, seed: int = 0, device="cuda",
) -> Tuple[DoubleQState, Adam]:
    """A fresh double-Q state over the pair ``params`` = (net0, net1), each
    a param tree of tensors on ``device`` with ``model_cfg``'s shapes (e.g.
    ``convert.numpy_init_double_q`` through ``params_from_numpy``). One Adam
    state per net, or with ``single_optimizer`` one over the pair (the
    reference's 1-vs-2-optimizer ablation). ``seed`` seeds the host
    generator of the coin. Raises without CUDA unless ``device="cpu"``."""
    dev = resolve_device(device)
    if len(params) != 2:
        raise ValueError(f"a double-Q state takes two param trees, got {len(params)}")
    for net in params:
        _check_params(net, model_cfg, dev)
    pair = tuple(params)
    opt = make_optimizer(learning_rate, mv_dtype)
    opt_state = opt.init(pair) if single_optimizer else tuple(opt.init(p) for p in pair)
    return DoubleQState(pair, opt_state, 0, torch.Generator().manual_seed(seed)), opt
