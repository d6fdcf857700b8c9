"""Which leaves split over the model axis, and the train step on a mesh.

Port of ``ikea_recommender_tpu/parallel/sharding.py`` (``_spec_for``,
``state_shardings``, ``shard_state``, ``make_sharded_train_step`` and
``sharded_fused_ce_raw_step``). The rules are the reference's:

- the embedding's (V, E) rows split over ``model`` (the largest tensor),
  and so do the lazy embedding Adam's packed (V, 2E) moments ``mv``;
- every head's kernel and bias split their last (action) dim over
  ``model``: ``sup_head``, ``q_head`` and ``q_heads``; but once a tree
  holds a ``kernel_am`` (the lazy action-major Q-head layout,
  ``train/lazy_adam.py``) the whole Q head, its bias and its packed
  moments are replicated: its update touches only the batch's rows, and
  the data-parallel islands (``parallel/q_kernels.py``) read the whole
  kernel on every rank;
- the GRU weights, and any leaf whose size does not divide by the axis
  (``guarded``), are replicated.

The reference annotates a whole state and lets XLA place it; here each rank
keeps only its slice: :func:`shard_tree` cuts this rank's part of every
leaf of a full tree (numpy in the reference's layout, as
``convert.numpy_init_params`` draws it, or tensors), :func:`shard_state`
of a train state's params and optimizer state (dense Adam, or a lazy
state's dense part, row moments and count), and :func:`gather_tree` puts a
tree of slices back together on every rank (the trainer's best model).

The step on a mesh (``train/steps.py::make_train_step`` with ``mesh``)
runs the family's loss on the sharded params, sums every dense gradient
over the data axis with one collective (:func:`allreduce_grads`), and takes
Adam on each shard: Adam is elementwise, so a shard's update is its slice
of the full one. The lazy rows' gradients cross the data axis in one
gather instead (``train/steps.py``).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ikea_recommender_tpu_torch.convert import tree_leaves, tree_map, tree_unflatten
from ikea_recommender_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh

_HEADS = ("sup_head", "q_head", "q_heads")
_QHEADS = ("q_head", "q_heads")


def _spec_for(path: Sequence[str], shape: Sequence[int], n_model: int,
              lazy_qh: bool = False) -> Optional[int]:
    """The dim of a leaf that splits over the model axis, by its name and
    shape, or None (replicated). ``lazy_qh``: the tree holds the lazy
    action-major Q-head layout, whose head stays whole."""
    if n_model <= 1 or len(shape) == 0:
        return None
    if "embedding" in path:
        dim = len(shape) - 2
    elif lazy_qh and any(h in path for h in _QHEADS):
        return None
    elif any(h in path for h in _HEADS) and path[-1] in ("kernel", "bias"):
        dim = len(shape) - 1
    else:
        return None
    return dim if shape[dim] % n_model == 0 else None  # guarded


def _paths(tree, prefix=()) -> List[tuple]:
    """Each leaf's key path, in :func:`convert.tree_leaves` order."""
    if isinstance(tree, Mapping):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, prefix + (str(i),))]
    return [prefix]


def has_lazy_qhead(tree) -> bool:
    """Whether a param tree holds the lazy action-major Q-head layout (a
    ``kernel_am`` leaf anywhere), as the reference detects it once for the
    whole tree: a lone ``bias`` cannot tell the layouts apart."""
    return any(p[-1] == "kernel_am" for p in _paths(tree))


def state_shardings(tree, mesh: Mesh, lazy_qh: Optional[bool] = None):
    """The split dim (or None) of every leaf of a full param tree, in the
    tree's layout. ``lazy_qh`` defaults to :func:`has_lazy_qhead` of the
    tree."""
    n = mesh.size(MODEL_AXIS)
    lazy = has_lazy_qhead(tree) if lazy_qh is None else lazy_qh
    return tree_unflatten(tree, [_spec_for(p, np.shape(leaf), n, lazy)
                                 for p, leaf in zip(_paths(tree), tree_leaves(tree))])


def _slice(leaf, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(leaf)) if isinstance(leaf, np.ndarray) else leaf
    if dim is not None:
        n, my = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
        width = t.shape[dim] // n
        t = t.narrow(dim, my * width, width)
    return t.to(mesh.device).contiguous().clone()


def shard_tree(tree, mesh: Mesh):
    """This rank's slice of every leaf of a full tree (numpy arrays or
    tensors), as tensors on the mesh's device."""
    dims = tree_leaves(state_shardings(tree, mesh))
    return tree_unflatten(tree, [_slice(x, d, mesh) for x, d in zip(tree_leaves(tree), dims)])


def gather_tree(tree, mesh: Mesh, full):
    """The full tree from every rank's slices (``full``: any tree of the
    full shapes, e.g. the numpy params a run started from, or meta
    tensors), on every rank."""
    dims = tree_leaves(state_shardings(full, mesh))
    out = []
    for t, d in zip(tree_leaves(tree), dims):
        if d is None:
            out.append(t.detach().clone())
        else:
            parts = mesh.gather(t.detach(), MODEL_AXIS)  # (n, ...) in model order
            out.append(torch.cat(list(parts.unbind(0)), dim=d))
    return tree_unflatten(full, out)


def _row_dim(table_rows: int, mesh: Mesh) -> Optional[int]:
    """0 where the model axis divides the embedding's rows (the table and
    its lazy moments split by rows), else None (``guarded``)."""
    n = mesh.size(MODEL_AXIS)
    return 0 if n > 1 and table_rows % n == 0 else None


def _family_of(params) -> str:
    """The family whose Q-head key a lazy net's params hold ("gru4rec" for
    none): what ``train.state.dense_part`` needs to split them."""
    if "q_head" in params:
        return "sqn"
    if "q_heads" in params:
        return "sarm" if "kernel0" in params["q_heads"] else "smorl"
    return "gru4rec"


def _shard_opt(opt, params, mesh: Mesh, lazy_qh: bool):
    """This rank's slice of ``opt`` (dense ``AdamState`` or
    ``LazyAdamState``), each moment split as the leaf of ``params`` (the
    full tree it moves) that it follows; the counts are kept."""
    from ikea_recommender_tpu_torch.train.lazy_adam import ColAdamState, EmbAdamState
    from ikea_recommender_tpu_torch.train.state import AdamState, LazyAdamState, dense_part

    lazy = isinstance(opt, LazyAdamState)
    adam = opt.rest if lazy else opt
    like = dense_part(params, _family_of(params), opt.emb is not None,
                      opt.qh is not None) if lazy else params
    dims = tree_leaves(state_shardings(like, mesh, lazy_qh))

    def moments(tree):
        return tree_unflatten(tree, [_slice(x, d, mesh) for x, d in zip(tree_leaves(tree), dims)])

    dense = AdamState(adam.count, moments(adam.mu), moments(adam.nu))
    if not lazy:
        return dense
    rows = np.shape(params["backbone"]["embedding"])[0]
    emb = None if opt.emb is None else EmbAdamState(_slice(opt.emb.mv, _row_dim(rows, mesh),
                                                           mesh))
    # the lazy Q head's moments stay whole with it
    qh = None if opt.qh is None else ColAdamState(_slice(opt.qh.mv, None, mesh))
    return LazyAdamState(dense, opt.count, emb, qh)


def shard_state(state, mesh: Mesh):
    """A train state (``train/state.py``: ``TrainState`` or
    ``DoubleQState``, with dense Adam or lazy states, full params on the
    mesh's device) cut to this rank's slice of its params and optimizer
    state: a lazy state's dense part as its params, the embedding's row
    moments by rows, the lazy Q head's moments whole; the counts, step and
    generator are kept."""
    params = state.params
    lazy_qh = has_lazy_qhead(params)
    if isinstance(params, tuple):  # the double-Q pair
        new_params = tuple(shard_tree(p, mesh) for p in params)
        if isinstance(state.opt_state, tuple):
            opt = tuple(_shard_opt(s, p, mesh, lazy_qh) for s, p in zip(state.opt_state, params))
        else:
            opt = _shard_opt(state.opt_state, list(params), mesh, lazy_qh)
    else:
        new_params = shard_tree(params, mesh)
        opt = _shard_opt(state.opt_state, params, mesh, lazy_qh)
    return type(state)(new_params, opt, state.step, state.generator)


def allreduce_grads(grads: Any, mesh: Mesh) -> Any:
    """Every gradient summed over the data axis in one collective (the
    leaves flattened into one buffer)."""
    if mesh.size(DATA_AXIS) == 1:
        return grads
    leaves = tree_leaves(grads)
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in leaves]), "sum", DATA_AXIS)
    out, at = [], 0
    for g in leaves:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return tree_unflatten(grads, out)


def make_sharded_train_step(model_cfg, opt, mesh: Mesh, rl=None, sharded_ce: bool = False,
                            **kw):
    """The family's train step on this rank's shard, its batch this rank's
    rows of a batch split over the data axis (``train/steps.py::
    make_train_step`` with ``mesh`` and ``data_axis="data"``).

    ``sharded_ce`` (``parallel.sharded_ce``; gru4rec and bidir_gru4rec
    only) is the reference's ``sharded_fused_ce_raw_step``, whose CE is
    always the fused, action-sharded one: here the CE family's step with
    ``fused_ce`` forced on, B1 and B2 on this rank's columns whatever
    ``fused_ce`` resolved to. Where it resolved on, that is the step
    ``make_train_step`` builds on a mesh already, and ``sharded_ce``
    changes nothing; where it resolved off (``fused_ce: false``, or a
    catalog under ``fused_ce_min_actions``), it replaces the dense
    logits arm (``parallel/topk.py::sharded_softmax_ce``)."""
    from ikea_recommender_tpu_torch.train.steps import make_train_step

    if sharded_ce:
        if model_cfg.family not in ("gru4rec", "bidir_gru4rec"):
            raise ValueError("sharded_ce supports gru4rec/bidir_gru4rec only")
        model_cfg = replace(model_cfg, fused_ce=True)
    return make_train_step(model_cfg, opt, rl, mesh=mesh, data_axis=DATA_AXIS,
                           device=mesh.device, **kw)
