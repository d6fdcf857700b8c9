"""Which leaves split over the model axis, and the train step on a mesh.

Port of ``ikea_recommender_tpu/parallel/sharding.py`` (``_spec_for``,
``state_shardings``, ``shard_state``, ``make_sharded_train_step``; its
``sharded_fused_ce_raw_step`` is ``make_sharded_train_step`` on a gru4rec
or bidir_gru4rec model with the fused CE, whose CE is then the sharded
one). The rules are the reference's:

- the embedding's (V, E) rows split over ``model`` (the largest tensor);
- every head's kernel and bias split their last (action) dim over
  ``model``: ``sup_head``, ``q_head`` and ``q_heads``;
- the GRU weights, and any leaf whose size does not divide by the axis
  (``guarded``), are replicated.

The reference annotates a whole state and lets XLA place it; here each rank
keeps only its slice: :func:`shard_tree` cuts this rank's part of every
leaf of a full tree (numpy in the reference's layout, as
``convert.numpy_init_params`` draws it, or tensors), :func:`shard_state`
of a train state's params and Adam moments, and :func:`gather_tree` puts a
tree of slices back together on every rank (for the tests and, later,
checkpoints).

The step on a mesh (``train/steps.py::make_train_step`` with ``mesh``)
runs the family's loss on the sharded params, sums every gradient over
the data axis with one collective (:func:`allreduce_grads`), and takes
Adam on each shard: Adam is elementwise, so a shard's update is its slice
of the full one.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ikea_recommender_tpu_torch.convert import tree_leaves, tree_map, tree_unflatten
from ikea_recommender_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh

_HEADS = ("sup_head", "q_head", "q_heads")


def _spec_for(path: Sequence[str], shape: Sequence[int], n_model: int) -> Optional[int]:
    """The dim of a leaf that splits over the model axis, by its name and
    shape, or None (replicated)."""
    if n_model <= 1 or len(shape) == 0:
        return None
    if "embedding" in path:
        dim = len(shape) - 2
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


def state_shardings(tree, mesh: Mesh):
    """The split dim (or None) of every leaf of a full param tree, in the
    tree's layout."""
    n = mesh.size(MODEL_AXIS)
    return tree_unflatten(tree, [_spec_for(p, np.shape(leaf), n)
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
    full shapes, e.g. the numpy params a run started from), on every rank."""
    dims = tree_leaves(state_shardings(full, mesh))
    out = []
    for t, d in zip(tree_leaves(tree), dims):
        if d is None:
            out.append(t.detach().clone())
        else:
            parts = mesh.gather(t.detach(), MODEL_AXIS)  # (n, ...) in model order
            out.append(torch.cat(list(parts.unbind(0)), dim=d))
    return tree_unflatten(full, out)


def shard_state(state, mesh: Mesh):
    """A train state (``train/state.py``: ``TrainState`` or
    ``DoubleQState`` with dense Adam, full params on the mesh's device)
    cut to this rank's slice of its params and moments; the count, step and
    generator are kept."""
    from ikea_recommender_tpu_torch.train.state import AdamState

    def adam(s: AdamState, like) -> AdamState:
        return AdamState(s.count, _shard_like(s.mu, like), _shard_like(s.nu, like))

    def _shard_like(tree, like):
        dims = tree_leaves(state_shardings(like, mesh))
        return tree_unflatten(like, [_slice(x, d, mesh) for x, d in zip(tree_leaves(tree), dims)])

    params = state.params
    if isinstance(params, tuple):  # the double-Q pair
        new_params = tuple(shard_tree(p, mesh) for p in params)
        if isinstance(state.opt_state, tuple):
            opt = tuple(adam(s, p) for s, p in zip(state.opt_state, params))
        else:
            opt = adam(state.opt_state, list(params))
    else:
        new_params, opt = shard_tree(params, mesh), adam(state.opt_state, params)
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


def make_sharded_train_step(model_cfg, opt, mesh: Mesh, rl=None, **kw):
    """The family's train step on this rank's shard, its batch this rank's
    rows of a batch split over the data axis (``train/steps.py::
    make_train_step`` with ``mesh`` and ``data_axis="data"``)."""
    from ikea_recommender_tpu_torch.train.steps import make_train_step

    return make_train_step(model_cfg, opt, rl, mesh=mesh, data_axis=DATA_AXIS,
                           device=mesh.device, **kw)
