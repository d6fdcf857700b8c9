"""Train state and the Adam optimizer.

Port of ``ikea_recommender_tpu/train/state.py`` (``TrainState``,
``DoubleQState``, ``make_optimizer``, ``_scale_by_adam_mv``,
``make_train_state``, ``make_double_q_state`` and the lazy optimizers'
builders: ``split_embedding``, ``merge_embedding``,
``make_lazy_train_state``, ``split_qhead``, ``lazy_qhead_params``,
``_lazy_net_opt_state``, ``make_lazy_double_q_state`` and
``make_lazy_sarm_state``): one network for gru4rec and bidir_gru4rec, the
(net0, net1) pair of sqn and smorl.

The lazy states (``train/lazy_adam.py``) split each net's params in two:
the dense part, under dense Adam, and the lazily updated embedding table
and/or action-major Q heads, whose moments live in their own buffers. The
dense part is ``{"rest": params without the lazy leaves}`` plus, for sarm's
lazy heads, ``"h0"``: its head 0 (``kernel0``, ``bias0``), which the CE
trains densely (:func:`dense_part`). A :class:`LazyAdamState` holds the
dense part's Adam state, the lazy moment buffers and the count that their
bias correction reads, which advances only on the steps that train the
net (the reference's per-net ``count``).

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


def select_net(params: Any, idx: int) -> Any:
    """Network ``idx`` of a double-Q (net0, net1) pair."""
    return params[idx]


# ---------------------------------------------------------------------------
# Lazy optimizers (train/lazy_adam.py)
# ---------------------------------------------------------------------------

QH_KEY = {"sqn": "q_head", "smorl": "q_heads", "sarm": "q_heads"}


@dataclass
class LazyAdamState:
    """One net's optimizer state on the lazy paths: dense Adam over
    :func:`dense_part`, the embedding's row moments (``emb``, with
    ``optimizer: lazy_adam``), the action-major Q heads' row moments
    (``qh``, with ``qhead_optimizer: lazy_adam``) and the count (int32
    scalar tensor) of the updates of the lazy parts so far."""

    rest: AdamState
    count: torch.Tensor
    emb: Any = None  # lazy_adam.EmbAdamState
    qh: Any = None  # lazy_adam.ColAdamState


def split_embedding(params: Dict) -> Tuple[torch.Tensor, Dict]:
    """(embedding table, params without it)."""
    rest = dict(params)
    rest["backbone"] = {k: v for k, v in params["backbone"].items() if k != "embedding"}
    return params["backbone"]["embedding"], rest


def merge_embedding(rest: Dict, emb: torch.Tensor) -> Dict:
    params = dict(rest)
    params["backbone"] = {**rest["backbone"], "embedding": emb}
    return params


def split_qhead(params: Dict, family: str) -> Tuple[Dict, Dict]:
    """(Q-head subtree, params without it)."""
    key = QH_KEY[family]
    return params[key], {k: v for k, v in params.items() if k != key}


def lazy_qhead_params(params: Dict, family: str) -> Dict:
    """``params`` with its canonical Q head in the action-major lazy layout:
    sqn and smorl ``{"kernel_am" (A, K*F), "bias"}``; sarm keeps head 0
    (the CE's, densely updated) as ``kernel0``/``bias0`` and takes heads 1-4
    as ``kernel_am`` (A, 4F) and ``bias_rest`` (4, A).
    ``models.families.canonicalize_qheads`` is the inverse."""
    from ikea_recommender_tpu_torch.train.lazy_adam import to_action_major

    qh = params[QH_KEY[family]]
    if family == "sarm":
        new = {"kernel0": qh["kernel"][0].contiguous(), "bias0": qh["bias"][0].contiguous(),
               "kernel_am": to_action_major(qh["kernel"][1:]),
               "bias_rest": qh["bias"][1:].contiguous()}
    else:
        new = {"kernel_am": to_action_major(qh["kernel"]), "bias": qh["bias"]}
    return {**params, QH_KEY[family]: new}


def dense_part(params: Dict, family: str, lazy_emb: bool, lazy_qh: bool) -> Dict:
    """The tree dense Adam owns on the lazy paths, sharing ``params``'
    tensors: ``{"rest": params without the lazy leaves}``, and for sarm's
    lazy heads ``"h0"``, its head 0."""
    rest, qh = params, None
    if lazy_emb:
        rest = split_embedding(rest)[1]
    if lazy_qh:
        qh, rest = split_qhead(rest, family)
    dense = {"rest": rest}
    if lazy_qh and family == "sarm":
        dense["h0"] = {"kernel": qh["kernel0"], "bias": qh["bias0"]}
    return dense


def _lazy_net_opt_state(opt: Adam, params: Dict, family: str, lazy_emb: bool, lazy_qh: bool,
                        mv_dtype: Optional[str] = None) -> LazyAdamState:
    """A fresh :class:`LazyAdamState` over one net's ``params``, already in
    the action-major layout where ``lazy_qh``. ``mv_dtype`` applies to the
    dense moments and the lazy buffers alike."""
    from ikea_recommender_tpu_torch.train.lazy_adam import init_col_adam, init_emb_adam

    dense = dense_part(params, family, lazy_emb, lazy_qh)
    emb = qh = None
    if lazy_emb:
        emb = init_emb_adam(params["backbone"]["embedding"], mv_dtype)
    if lazy_qh:
        head = params[QH_KEY[family]]
        b = head["bias_rest"] if family == "sarm" else head["bias"]
        qh = init_col_adam(head["kernel_am"], b.shape[0] if b.dim() == 2 else 1, mv_dtype)
    rest = opt.init(dense)
    return LazyAdamState(rest, torch.zeros_like(rest.count), emb, qh)


def make_lazy_train_state(
    params: Dict, model_cfg, learning_rate: float, mv_dtype: Optional[str] = None,
    seed: int = 0, device="cuda",
) -> Tuple[TrainState, Adam]:
    """The CE families' state with the lazy embedding Adam (``optimizer:
    lazy_adam``) over ``params`` (tensors on ``device``), as
    :func:`make_train_state` takes them."""
    dev = resolve_device(device)
    _check_params(params, model_cfg, dev)
    opt = make_optimizer(learning_rate, mv_dtype)
    opt_state = _lazy_net_opt_state(opt, params, model_cfg.family, True, False, mv_dtype)
    return TrainState(params, opt_state, 0, torch.Generator(device=dev).manual_seed(seed)), opt


def make_lazy_double_q_state(
    params: Sequence[Dict], model_cfg, learning_rate: float, mv_dtype: Optional[str] = None,
    *, lazy_emb: bool = False, lazy_qh: bool = False, seed: int = 0, device="cuda",
) -> Tuple[DoubleQState, Adam]:
    """sqn's or smorl's pair with lazy optimizer parts: ``params`` (net0,
    net1) in the canonical layout, as :func:`make_double_q_state` takes
    them, moved to the action-major layout where ``lazy_qh``; one
    :class:`LazyAdamState` per net (the one-optimizer arm is dense only)."""
    dev = resolve_device(device)
    if len(params) != 2:
        raise ValueError(f"a double-Q state takes two param trees, got {len(params)}")
    fam = model_cfg.family
    pair = []
    for net in params:
        _check_params(net, model_cfg, dev)
        pair.append(lazy_qhead_params(net, fam) if lazy_qh else net)
    opt = make_optimizer(learning_rate, mv_dtype)
    opt_state = tuple(_lazy_net_opt_state(opt, p, fam, lazy_emb, lazy_qh, mv_dtype) for p in pair)
    return DoubleQState(tuple(pair), opt_state, 0, torch.Generator().manual_seed(seed)), opt


def make_lazy_sarm_state(
    params: Dict, model_cfg, learning_rate: float, mv_dtype: Optional[str] = None,
    *, lazy_emb: bool = False, lazy_qh: bool = False, seed: int = 0, device="cuda",
) -> Tuple[TrainState, Adam]:
    """sarm's state with lazy optimizer parts over canonical ``params``."""
    dev = resolve_device(device)
    _check_params(params, model_cfg, dev)
    if lazy_qh:
        params = lazy_qhead_params(params, "sarm")
    opt = make_optimizer(learning_rate, mv_dtype)
    opt_state = _lazy_net_opt_state(opt, params, "sarm", lazy_emb, lazy_qh, mv_dtype)
    return TrainState(params, opt_state, 0, torch.Generator(device=dev).manual_seed(seed)), opt
