"""Params across the packages: the reference's layout, as numpy, to tensors.

The port keeps the reference's param tree and layouts, so a checkpoint
crosses without transposes:

- ``backbone/embedding`` (V_pad, E);
- ``backbone/gru/<layer>/<fwd|bwd>/{wi (E_in, 3H), wh (H, 3H), bi, bh (3H)}``;
- ``sup_head`` / ``q_head``: ``{kernel (F, A_pad), bias (A_pad)}``;
- ``q_heads``: ``{kernel (K, F, A_pad), bias (K, A_pad)}``.

:func:`params_from_numpy` takes that tree as nested dicts/lists of arrays, or
as the flat ``"a/b/0/c"``-keyed dict of the reference's
``run/checkpoints.py::save_params_npz``. :func:`numpy_init_params` draws a
tree with the reference's init distributions from a numpy seed.
:func:`opt_state_from_numpy` carries optax's Adam state (``count``, ``mu``,
``nu``) across, so a run of the reference can be continued in the port;
:func:`double_q_from_numpy` does the same for the double-Q pair of sqn and
smorl, whose two nets :func:`numpy_init_double_q` draws from two seeds.
:func:`tree_leaves` fixes the one leaf order (keys sorted, as JAX orders
them) that params, gradients and Adam moments share.

The lazy optimizers' layouts cross too: :func:`lazy_params_from_numpy` puts
a canonical numpy tree in the action-major Q-head layout
(``train/lazy_adam.py``; ``kernel_am`` (A, K*F), and sarm's ``kernel0``,
``bias0``, ``bias_rest``), and :func:`lazy_state_from_numpy` carries a
reference lazy state across: the params (flat ``q_head/kernel_am``-style
keys or nested), the dense Adam over the ``rest`` tree, the row moment
buffers ``emb.mv`` and ``qh.mv``, and the per-net ``count``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ikea_recommender_tpu_torch.core.device import resolve_device


def unflatten(flat: Mapping[str, Any]) -> Dict:
    """``{"a/b/0/c": leaf}`` -> nested dicts, with all-digit levels as lists."""
    root: Dict = {}
    for key, leaf in flat.items():
        node = root
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[k]) for k in sorted(node, key=int)]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> List:
    """Leaves of a params-like tree of dicts and lists, in a fixed order
    (dict keys sorted, as ``jax.tree.leaves`` orders them)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """The inverse of :func:`tree_leaves`: ``leaves`` in ``like``'s layout."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(like)


def params_from_numpy(tree_or_flat: Mapping, device="cuda") -> Dict:
    """The reference's param tree (nested or flat-keyed, numpy leaves) ->
    the port's param dict of tensors on ``device``, same layout."""
    dev = resolve_device(device)
    tree = tree_or_flat
    if any("/" in k for k in tree_or_flat):
        tree = unflatten(tree_or_flat)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev), tree)


def _tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
    return torch.tensor(a, device=dev)


def opt_state_from_numpy(adam_state, device="cuda"):
    """optax's ``ScaleByAdamState`` with numpy leaves (``count``, and
    ``mu``/``nu`` in the param layout) -> the port's
    ``train.state.AdamState`` on ``device``. bfloat16 moments
    (``optimizer_mv_dtype="bfloat16"``) stay bfloat16."""
    from ikea_recommender_tpu_torch.train.state import AdamState

    dev = resolve_device(device)
    count = torch.tensor(int(np.asarray(adam_state.count)), dtype=torch.int32, device=dev)
    return AdamState(
        count=count,
        mu=tree_map(lambda a: _tensor(a, dev), adam_state.mu),
        nu=tree_map(lambda a: _tensor(a, dev), adam_state.nu),
    )


def numpy_init_params(cfg, seed: int) -> Dict:
    """A param tree for ``cfg`` (a ModelConfig) drawn from
    ``np.random.RandomState(seed)`` with the reference's init distributions:
    embedding N(0, 0.01^2) (pad row zero when frozen), GRU leaves
    U(+-1/sqrt(H)), heads U(+-1/sqrt(F))."""
    rs = np.random.RandomState(seed)
    bb = cfg.backbone

    def uni(bound, shape):
        return rs.uniform(-bound, bound, shape).astype(np.float32)

    emb = (0.01 * rs.standard_normal((bb.num_embeddings, bb.embedding_dim))).astype(
        np.float32
    )
    if not bb.train_pad_embed:
        emb[bb.padding_idx] = 0.0
    n_dir = 2 if bb.bidirectional else 1
    H = bb.hidden_dim
    layers = []
    for layer in range(bb.gru_layers):
        in_dim = bb.embedding_dim if layer == 0 else H * n_dir
        entry = {}
        for name in ("fwd", "bwd")[:n_dir]:
            b = 1.0 / np.sqrt(H)
            entry[name] = {
                "wi": uni(b, (in_dim, 3 * H)),
                "wh": uni(b, (H, 3 * H)),
                "bi": uni(b, (3 * H,)),
                "bh": uni(b, (3 * H,)),
            }
        layers.append(entry)
    params: Dict = {"backbone": {"embedding": emb, "gru": layers}}

    F, A = bb.feature_dim, cfg.padded_action_dim
    b = 1.0 / np.sqrt(F)
    if cfg.family == "sarm":
        params["q_heads"] = {"kernel": uni(b, (5, F, A)), "bias": uni(b, (5, A))}
        return params
    params["sup_head"] = {"kernel": uni(b, (F, A)), "bias": uni(b, (A,))}
    if cfg.family == "sqn":
        params["q_head"] = {"kernel": uni(b, (F, A)), "bias": uni(b, (A,))}
    elif cfg.family == "smorl":
        K = cfg.num_q_heads
        params["q_heads"] = {"kernel": uni(b, (K, F, A)), "bias": uni(b, (K, A))}
    return params


def numpy_init_double_q(cfg, seeds: Sequence[int] = (0, 1)) -> Tuple[Dict, Dict]:
    """The (net0, net1) pair of a double-Q family, each drawn by
    :func:`numpy_init_params` from its own seed (the reference draws the
    two nets independently from its PRNG)."""
    if len(seeds) != 2 or seeds[0] == seeds[1]:
        raise ValueError(f"the two nets need two different seeds, got {tuple(seeds)}")
    return numpy_init_params(cfg, seeds[0]), numpy_init_params(cfg, seeds[1])


def _adam_states(opt_state) -> List:
    """The optax ``ScaleByAdamState``s (anything with ``count``, ``mu`` and
    ``nu``) inside an optimizer state, depth first."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return [opt_state]
    if isinstance(opt_state, (list, tuple)):
        return [s for part in opt_state for s in _adam_states(part)]
    return []


def double_q_from_numpy(params, opt_state, device="cuda"):
    """A reference ``DoubleQState``'s ``params`` (net0, net1) and
    ``opt_state``, with numpy leaves -> (params pair, opt state) for the
    port's ``train.state.DoubleQState`` on ``device``. The optimizer state
    is one Adam state per net (the default, two optimizers), or one over the
    pair (``single_optimizer``); which one is read off the state."""
    pair = tuple(params_from_numpy(p, device) for p in params)
    adam = [opt_state_from_numpy(s, device) for s in _adam_states(opt_state)]
    if len(adam) == 2:
        return pair, tuple(adam)
    if len(adam) == 1 and isinstance(adam[0].mu, list) and len(adam[0].mu) == 2:
        return pair, adam[0]
    raise ValueError(
        f"expected one Adam state per net or one over the pair, found {len(adam)}"
    )


def lazy_params_from_numpy(params: Mapping, family: str, device="cuda") -> Dict:
    """A canonical numpy param tree (e.g. :func:`numpy_init_params`) as
    tensors on ``device`` in the lazy optimizers' action-major Q-head
    layout."""
    from ikea_recommender_tpu_torch.train.state import lazy_qhead_params

    return lazy_qhead_params(params_from_numpy(params, device), family)


def _lazy_opt_state(opt_state: Mapping, count, dev):
    from ikea_recommender_tpu_torch.train.lazy_adam import ColAdamState, EmbAdamState
    from ikea_recommender_tpu_torch.train.state import LazyAdamState

    (adam,) = _adam_states(opt_state["rest"])
    rest = opt_state_from_numpy(adam, dev)
    if "rest" not in rest.mu:  # the CE state's Adam runs over the rest tree itself
        rest.mu, rest.nu = {"rest": rest.mu}, {"rest": rest.nu}
    count = opt_state.get("count", count)
    if count is None:
        raise ValueError("a lazy CE state keeps no count: pass the state's step")
    emb, qh = opt_state.get("emb"), opt_state.get("qh")
    return LazyAdamState(
        rest=rest,
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32, device=dev),
        emb=None if emb is None else EmbAdamState(_tensor(emb.mv, dev)),
        qh=None if qh is None else ColAdamState(_tensor(qh.mv, dev)),
    )


def lazy_state_from_numpy(params, opt_state, step=None, device="cuda"):
    """A reference lazy state's ``params`` and ``opt_state`` (numpy leaves;
    for sqn and smorl the (net0, net1) pairs of both) -> (params, opt state)
    for the port: ``train.state.LazyAdamState`` per net. The CE families'
    lazy state counts with its ``step``, which is then needed."""
    dev = resolve_device(device)
    if isinstance(params, (tuple, list)):
        return (tuple(params_from_numpy(p, dev) for p in params),
                tuple(_lazy_opt_state(o, step, dev) for o in opt_state))
    return params_from_numpy(params, dev), _lazy_opt_state(opt_state, step, dev)
