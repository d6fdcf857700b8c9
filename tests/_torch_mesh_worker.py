"""Ranks of the port's (data, model) mesh for tests/test_torch_parallel.py
and tests/test_torch_mesh.py.

:class:`RankPool` spawns ``world`` processes once; each starts a gloo
process group over a ``file://`` store (no port to contend for), keeps one
:class:`Mesh` per shape it is asked for, and runs every case sent to it:
``pool.run(case, (data, model), **kwargs)`` calls ``case(mesh, **kwargs)``
on every rank (data x model must be the pool's size) and returns each
rank's result, in rank order. This module
imports no JAX and nothing of the reference package, so a rank stays light
and can show it (:func:`loaded_forbidden`).

Each case takes the whole numpy inputs and cuts its own rank's part: the
columns (rows) of its model index, the batch rows of its data index.
"""

import contextlib
import io
import multiprocessing as mp
import os
import sys
import traceback

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ikea_recommender_tpu")
TIMEOUT_S = 300


class RankPool:
    def __init__(self, world, store_dir):
        ctx = mp.get_context("spawn")
        store = os.path.join(str(store_dir), f"store{world}-{os.getpid()}-{id(self)}")
        self.world = world
        self.conns, self.procs = [], []
        for rank in range(world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_rank_main, args=(rank, world, store, child), daemon=True)
            proc.start()
            self.conns.append(parent)
            self.procs.append(proc)

    def run(self, case, spec, **kwargs):
        """``case(mesh, **kwargs)`` on every rank of a ``spec`` = (data,
        model) mesh; their results in rank order."""
        if spec[0] * spec[1] != self.world:
            raise ValueError(f"a {spec} mesh on a pool of {self.world} ranks")
        for conn in self.conns:
            conn.send((case.__name__, tuple(spec), kwargs))
        out = []
        for rank, conn in enumerate(self.conns):
            if not conn.poll(TIMEOUT_S):
                raise TimeoutError(f"rank {rank} gave no result for {case.__name__}")
            ok, value = conn.recv()
            if not ok:
                raise RuntimeError(f"rank {rank} failed in {case.__name__}:\n{value}")
            out.append(value)
        return out

    def close(self):
        for conn in self.conns:
            conn.send(None)
        for proc in self.procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)


def _rank_main(rank, world, store, conn):
    import torch
    import torch.distributed as dist

    from ikea_recommender_tpu_torch.core.mesh import MeshSpec, make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    meshes = {}
    module = sys.modules[__name__]
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, spec, kwargs = msg
        try:
            if spec not in meshes:
                meshes[spec] = make_mesh(MeshSpec(*spec), "gloo", "cpu")
            conn.send((True, getattr(module, name)(meshes[spec], **kwargs)))
        except Exception:  # reported to the test, which fails
            conn.send((False, traceback.format_exc()))
    dist.destroy_process_group()


# -- helpers ------------------------------------------------------------------


def _t(a):
    import torch

    return torch.as_tensor(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def _cols(a, mesh):
    """This rank's block of ``a``'s last axis."""
    n, my = mesh.size("model"), mesh.index("model")
    w = a.shape[-1] // n
    return a[..., my * w:(my + 1) * w]


def _rows(a, mesh, data_axis):
    """This rank's rows of ``a`` where the batch is split over data."""
    if data_axis is None:
        return a
    from ikea_recommender_tpu_torch.core.distributed import data_rows

    return a[data_rows(len(a), mesh)]


def _grads(loss, *xs):
    import torch

    return [_np(g) for g in torch.autograd.grad(loss, xs)]


def _leaf(x):
    return _t(x).clone().requires_grad_()


# -- cases ----------------------------------------------------------------------


def loaded_forbidden(mesh):
    """The reference's or JAX's modules this rank has loaded."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def fused_ce(mesh, h, w, b, labels, valid, weights, data_axis=None, precision="highest", k=0):
    """sharded_fused_softmax_ce (or, with k, its top-k form): this rank's
    per-sample CE, ids, and the gradients of sum(CE * weights)."""
    from ikea_recommender_tpu_torch.parallel.fused_ce import (
        sharded_fused_softmax_ce,
        sharded_fused_softmax_ce_topk,
    )

    hl, wl, bl = _leaf(_rows(h, mesh, data_axis)), _leaf(_cols(w, mesh)), _leaf(_cols(b, mesh))
    lab, wt = _t(_rows(labels, mesh, data_axis)), _t(_rows(weights, mesh, data_axis))
    out = {}
    if k:
        per, ids = sharded_fused_softmax_ce_topk(hl, wl, bl, lab, k, mesh, valid, data_axis,
                                                 precision)
        out["ids"] = _np(ids)
    else:
        per = sharded_fused_softmax_ce(hl, wl, bl, lab, mesh, valid, data_axis, precision)
    out["per"] = _np(per)
    out["dh"], out["dw"], out["db"] = _grads((per * wt).sum(), hl, wl, bl)
    return out


def argmax(mesh, h, w, b, valid, q_weights=None, precision="highest"):
    from ikea_recommender_tpu_torch.parallel.q_kernels import (
        sharded_linear_argmax,
        sharded_weighted_multihead_argmax,
    )

    if q_weights is None:
        return _np(sharded_linear_argmax(_t(h), _t(_cols(w, mesh)), _t(_cols(b, mesh)), valid,
                                         mesh, precision))
    return _np(sharded_weighted_multihead_argmax(_t(h), _t(_cols(w, mesh)), _t(_cols(b, mesh)),
                                                 _t(q_weights), valid, mesh, precision))


def row_logit(mesh, h, w, b, idx, ct, data_axis=None):
    """sharded_row_logit (w (F, A)) or sharded_multihead_row_logit (w (K,
    F, A)): values and the gradients of sum(values * ct)."""
    from ikea_recommender_tpu_torch.parallel.q_kernels import (
        sharded_multihead_row_logit,
        sharded_row_logit,
    )

    fn = sharded_row_logit if np.ndim(w) == 2 else sharded_multihead_row_logit
    hl, wl, bl = _leaf(_rows(h, mesh, data_axis)), _leaf(_cols(w, mesh)), _leaf(_cols(b, mesh))
    vals = fn(hl, wl, bl, _t(_rows(idx, mesh, data_axis)), mesh, data_axis)
    dh, dw, db = _grads((vals * _t(_rows(ct, mesh, data_axis))).sum(), hl, wl, bl)
    return {"vals": _np(vals), "dh": dh, "dw": dw, "db": db}


def multihead_max(mesh, h, w, b, valid, precision=None):
    from ikea_recommender_tpu_torch.parallel.q_kernels import sharded_multihead_max

    return _np(sharded_multihead_max(_t(h), _t(_cols(w, mesh)), _t(_cols(b, mesh)), valid, mesh,
                                     precision))


def head_topk_ce(mesh, h, w, b, k, valid, labels=None):
    from ikea_recommender_tpu_torch.parallel.q_kernels import sharded_sup_topk
    from ikea_recommender_tpu_torch.parallel.topk import sharded_head_topk_ce

    v, i, ce = sharded_head_topk_ce(_t(h), _t(_cols(w, mesh)), _t(_cols(b, mesh)), k, valid,
                                    mesh, labels=None if labels is None else _t(labels))
    sup = sharded_sup_topk(_t(h), _t(_cols(w, mesh)), _t(_cols(b, mesh)), k, valid, mesh)
    return {"vals": _np(v), "ids": _np(i), "ce": None if ce is None else _np(ce),
            "sup_ids": _np(sup)}


def dense_ops(mesh, logits, labels, ct, k, values3=None):
    """sharded_top_k, sharded_softmax_ce (and its gradient against ct),
    sharded_argmax and sharded_take over this rank's columns."""
    from ikea_recommender_tpu_torch.parallel.q_kernels import sharded_argmax, sharded_take
    from ikea_recommender_tpu_torch.parallel.topk import sharded_softmax_ce, sharded_top_k

    lg = _leaf(_cols(logits, mesh))
    v, i = sharded_top_k(lg, k, mesh)
    per = sharded_softmax_ce(lg, _t(labels), mesh)
    (dl,) = _grads((per * _t(ct)).sum(), lg)
    out = {"vals": _np(v), "ids": _np(i), "per": _np(per), "dlogits": dl,
           "argmax": _np(sharded_argmax(lg, mesh)), "take": _np(sharded_take(lg, _t(labels), mesh))}
    if values3 is not None:
        out["take3"] = _np(sharded_take(_t(_cols(values3, mesh)), _t(labels), mesh))
    return out


def embedding(mesh, table, ids, ct, data_axis=None):
    from ikea_recommender_tpu_torch.parallel.topk import sharded_embedding_lookup

    n, my = mesh.size("model"), mesh.index("model")
    rows = table.shape[0] // n
    tl = _leaf(table[my * rows:(my + 1) * rows])
    vecs = sharded_embedding_lookup(tl, _t(_rows(ids, mesh, data_axis)), mesh, data_axis)
    (dt,) = _grads((vecs * _t(_rows(ct, mesh, data_axis))).sum(), tl)
    return {"vecs": _np(vecs), "dtable": dt}


def raises(mesh, A, E=4):
    """Each indivisible action or row count's error message, per entry
    point (None where nothing raised)."""
    import torch

    from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
    from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
    from ikea_recommender_tpu_torch.eval.protocol import EvalProtocol
    from ikea_recommender_tpu_torch.models.families import model_config_from_train
    from ikea_recommender_tpu_torch.parallel.topk import shard_width
    from ikea_recommender_tpu_torch.run.serve import Recommender
    from ikea_recommender_tpu_torch.train.state import make_train_state
    from ikea_recommender_tpu_torch.train.steps import make_train_step

    mc = model_config_from_train(TrainConfig(embedding_size=E, hidden_state_size=E),
                                 DataConfig(num_items=A))
    sarm = model_config_from_train(TrainConfig(model="sarm", embedding_size=E,
                                               hidden_state_size=E), DataConfig(num_items=A))
    params = params_from_numpy(numpy_init_params(mc, 0), "cpu")
    _, opt = make_train_state(params, mc, 0.01, device="cpu")
    calls = {
        "shard_width": lambda: shard_width(A, mesh),
        "make_train_step": lambda: make_train_step(mc, opt, mesh=mesh, device="cpu"),
        "EvalProtocol": lambda: EvalProtocol(mc, mesh=mesh, device="cpu"),
        "Recommender": lambda: Recommender(params, mc, mesh=mesh, device="cpu"),
        "lazy": lambda: make_train_step(sarm, opt, lazy_qhead_lr=0.01, mesh=mesh, device="cpu"),
        "lazy_gru4rec": lambda: make_train_step(mc, opt, lazy_embedding_lr=0.01, mesh=mesh,
                                                device="cpu"),
        "nccl_on_cpu": lambda: type(mesh)(mesh.spec, "nccl", mesh.device, mesh.rank,
                                          mesh.groups).all_reduce(torch.zeros(1)),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def shard_roundtrip(mesh, tree):
    """(the split dim of each leaf, the full tree gathered back from this
    rank's slices, this rank's slice shapes)."""
    from ikea_recommender_tpu_torch.convert import tree_leaves
    from ikea_recommender_tpu_torch.parallel.sharding import (
        gather_tree,
        shard_tree,
        state_shardings,
    )

    local = shard_tree(tree, mesh)
    return {"dims": tree_leaves(state_shardings(tree, mesh)),
            "back": [_np(x) for x in tree_leaves(gather_tree(local, mesh, tree))],
            "shapes": [tuple(x.shape) for x in tree_leaves(local)]}


def model_config(A, align, **train_kw):
    """The port's ModelConfig of a catalog of A from TrainConfig fields
    (``fused_ce_min_actions=0``: a toy catalog may take the fused CE)."""
    from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
    from ikea_recommender_tpu_torch.models.families import model_config_from_train

    return model_config_from_train(TrainConfig(fused_ce_min_actions=0, **train_kw),
                                   DataConfig(num_items=A), align)


def _snapshot(state, mesh, full):
    """(params, Adam first moments) of every net, gathered to full numpy
    trees' leaves; rank 0's only."""
    from ikea_recommender_tpu_torch.convert import tree_leaves
    from ikea_recommender_tpu_torch.parallel.sharding import gather_tree

    nets = state.params if isinstance(state.params, tuple) else (state.params,)
    opts = state.opt_state if isinstance(state.opt_state, tuple) else (state.opt_state,)
    out = {"params": [], "mu": []}
    for k, net in enumerate(nets):
        out["params"].append([_np(x) for x in tree_leaves(gather_tree(net, mesh, full[k]))])
    for k, opt in enumerate(opts):
        mu = opt.mu if len(opts) == len(nets) else list(opt.mu)
        like = full[k] if len(opts) == len(nets) else list(full)
        out["mu"].append([_np(x) for x in tree_leaves(gather_tree(mu, mesh, like))])
    return out


def train(mesh, A, align, train_kw, np_params, batches, coins=None, data_axis="data", lr=0.01,
          rl=None, aux=None, seed=0, single_optimizer=False):
    """Steps of the family on this rank's shard from the full numpy params
    (one tree, or the double-Q pair), each batch cut to this rank's rows
    (``data_axis``), the coins given (double-Q) -> rank 0: each step's
    losses and target actions, and the params and first moments, gathered,
    before and after every step."""
    from ikea_recommender_tpu_torch.convert import params_from_numpy
    from ikea_recommender_tpu_torch.core.distributed import local_rows
    from ikea_recommender_tpu_torch.parallel.sharding import shard_state
    from ikea_recommender_tpu_torch.train.state import make_double_q_state, make_train_state
    from ikea_recommender_tpu_torch.train.steps import RLStepConfig, make_train_step

    mc = model_config(A, align, **train_kw)
    pair = isinstance(np_params, (tuple, list))
    full = tuple(np_params) if pair else (np_params,)
    if pair:
        state, opt = make_double_q_state([params_from_numpy(p, "cpu") for p in full], mc, lr,
                                         single_optimizer=single_optimizer, seed=seed,
                                         device="cpu")
    else:
        state, opt = make_train_state(params_from_numpy(np_params, "cpu"), mc, lr, seed=seed,
                                      device="cpu")
    state = shard_state(state, mesh)
    step = make_train_step(mc, opt, RLStepConfig(**(rl or {})), mesh=mesh, data_axis=data_axis,
                           device="cpu", **(aux or {}))
    traj, losses, targets = [_snapshot(state, mesh, full)], [], []
    for k, b in enumerate(batches):
        lb = local_rows(b, mesh) if data_axis is not None else b
        kw = {} if coins is None else {"coin": coins[k]}
        state, m = step(state, lb, **kw)
        losses.append((float(m["sup_loss"]), float(m["q_loss"])))
        if "target_action" in m:
            targets.append(_np(m["target_action"]))
        traj.append(_snapshot(state, mesh, full))
    return {"losses": losses, "targets": targets, "traj": traj} if mesh.rank == 0 else None


def serve(mesh, A, align, train_kw, np_params, states, lens, k, head_idx=0, fused=None):
    """Recommender(mesh=...) on this rank's slice -> (values, ids) and the
    gathered full scores."""
    from ikea_recommender_tpu_torch.parallel.sharding import shard_tree
    from ikea_recommender_tpu_torch.run.serve import Recommender

    mc = model_config(A, align, **train_kw)
    rec = Recommender(shard_tree(np_params, mesh), mc, head_idx=head_idx, mesh=mesh,
                      fused=fused, device="cpu")
    v, i = rec.recommend(states, lens, k)
    return {"vals": _np(v), "ids": _np(i), "fused": rec.fused,
            "scores": _np(rec.scores(states, lens))}


def evaluate(mesh, A, align, train_kw, np_params, buf, batch_size, proto_kw):
    """EvalProtocol(mesh=...).evaluate over the buffer's columns (each
    rank scoring its rows of every batch) -> the result's fields."""
    from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer
    from ikea_recommender_tpu_torch.eval.protocol import EvalProtocol
    from ikea_recommender_tpu_torch.parallel.sharding import shard_tree

    mc = model_config(A, align, **train_kw)
    proto = EvalProtocol(mc, mesh=mesh, device="cpu", **proto_kw)
    res = proto.evaluate(shard_tree(np_params, mesh), EvalBuffer(**buf), batch_size)
    return {"fused": proto.fused, **vars(res)}


# -- the trainer on a mesh -------------------------------------------------------


def _recording_protocol(gap):
    """The port's EvalProtocol, recording for each finalize (a train window
    or an eval pass, in call order) (this rank's valid rows near a tie, its
    valid rows), as tests/test_torch_trainer.py's ``_NearTies`` does."""
    import torch

    from ikea_recommender_tpu_torch.eval.protocol import EvalProtocol

    class NearTies(EvalProtocol):
        made = []

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.windows, self._near, self._n = [], 0, 0
            NearTies.made.append(self)

        def update(self, params, accum, state, action, true_len, valid, action_type=None):
            rows = self._on_device(state), self._on_device(true_len), self._on_device(action)
            vals = self.topk_ce(params, rows[0], rows[1], rows[2], k=self._max_k + 1)[0]
            ok = torch.as_tensor(valid, dtype=torch.bool)
            self._near += int((ok & ((vals[:, :-1] - vals[:, 1:]) <= gap).any(dim=1)).sum())
            self._n += int(ok.sum())
            return super().update(params, accum, state, action, true_len, valid, action_type)

        def finalize(self, accum):
            self.windows.append((self._near, self._n))
            self._near = self._n = 0
            return super().finalize(accum)

    return NearTies


def _state_leaves(state, full, mesh):
    """{name: (this rank's leaf, split dim or None)} of a train state's
    params and lazy row moments, ``full`` the gathered params of one net."""
    from ikea_recommender_tpu_torch.convert import tree_leaves
    from ikea_recommender_tpu_torch.parallel.sharding import _paths, state_shardings
    from ikea_recommender_tpu_torch.train.state import LazyAdamState

    dims = tree_leaves(state_shardings(full, mesh))
    names = ["/".join(p) for p in _paths(full)]
    nets = state.params if isinstance(state.params, tuple) else (state.params,)
    opts = state.opt_state if isinstance(state.opt_state, tuple) else (state.opt_state,)
    out = {}
    for k, net in enumerate(nets):
        for name, leaf, d in zip(names, tree_leaves(net), dims):
            out[f"net{k}/{name}"] = (_np(leaf), d)
    emb_dim = dims[names.index("backbone/embedding")]
    for k, o in enumerate(opts):
        if isinstance(o, LazyAdamState):
            if o.emb is not None:
                out[f"opt{k}/emb_mv"] = (_np(o.emb.mv), emb_dim)
            if o.qh is not None:
                out[f"opt{k}/qh_mv"] = (_np(o.qh.mv), None)
    return out


def trainer(mesh, cfg, bufs, init=None, coins=None, extra=None, gap=1e-4, cli_argv=None,
            hook=None, deterministic=False):
    """The port's ``run.trainer.train`` (or, with ``cli_argv``, its CLI) on
    this rank of the mesh, the double-Q coins ``coins[step]`` given to the
    step (``hook``: a function of this module called with each step's
    local batch) -> this rank's outcome: logs, best point, test metrics,
    the near ties of each finalize, its state's leaves with their split
    dims, the bytes of the train rows it holds; rank 0 also the gathered
    best params. ``deterministic``: under
    ``torch.use_deterministic_algorithms`` (the CPU's ``index_put_`` sums
    duplicates across threads in no fixed order otherwise)."""
    import torch

    from ikea_recommender_tpu_torch.run import checkpoints, cli
    from ikea_recommender_tpu_torch.run import trainer as port_trainer

    make, proto_cls = port_trainer.make_train_step, port_trainer.EvalProtocol
    uploads = (port_trainer._device_train_data, port_trainer._device_train_data_process_sharded)
    recording = _recording_protocol(gap)
    recording.made = []
    seen = {}

    def wrapped(*args, **kw):
        step = make(*args, **kw)

        def call(state, batch):
            kw = {} if coins is None else {"coin": coins[state.step]}
            if hook is not None:
                globals()[hook](mesh, state, batch, seen)
            return step(state, batch, **kw)

        return call

    def held(fn):
        def upload(*args):
            out = fn(*args)
            data = out[0] if isinstance(out, tuple) else out
            # the last upload is the rows the rank keeps
            seen["train_bytes"] = sum(t.numel() * t.element_size() for t in data.values())
            return out

        return upload

    port_trainer.make_train_step, port_trainer.EvalProtocol = wrapped, recording
    port_trainer._device_train_data, port_trainer._device_train_data_process_sharded = map(
        held, uploads)
    torch.use_deterministic_algorithms(deterministic)
    outcomes, printed = [], io.StringIO()
    try:
        torch.manual_seed(0)
        with contextlib.redirect_stdout(printed):
            out = _train_or_cli(port_trainer, cli, cfg, bufs, init, extra, cli_argv, outcomes,
                                seen)
    finally:
        port_trainer.make_train_step, port_trainer.EvalProtocol = make, proto_cls
        port_trainer._device_train_data, port_trainer._device_train_data_process_sharded = (
            uploads)
        torch.use_deterministic_algorithms(False)
    flat = checkpoints.flatten_params(out.best_params)
    return {
        "logs": out.logs, "pretrain": out.pretrain_metrics, "test": out.test_metrics,
        "best_metric": out.best_metric, "best_epoch": out.best_epoch,
        "windows": recording.made[0].windows, "seen": seen,
        "leaves": _state_leaves(out.state, out.best_params, mesh),
        "best_params": flat if mesh.rank == 0 else None,
        "throughput": out.throughput_sessions_per_sec, "printed": printed.getvalue(),
    }


def _train_or_cli(port_trainer, cli, cfg, bufs, init, extra, cli_argv, outcomes, seen):
    if cli_argv is None:
        return port_trainer.train(cfg, device="cpu", init_params=init, **bufs, **(extra or {}))
    train = cli.train
    cli.train = lambda *a, **k: outcomes.append(train(*a, **k)) or outcomes[-1]
    try:
        seen["rc"] = cli.main(cli_argv)
    finally:
        cli.train = train
    return outcomes[0]


def batch_rows(mesh, state, batch, seen):
    """A trainer hook: each step's local batch rows (state and valid)."""
    seen.setdefault("batches", []).append((_np(batch["state"]), _np(batch["valid"])))


def raises_in_train(mesh, cfg, bufs):
    """The error ``run.trainer.train`` raises on this rank, as a string
    (None if it trained)."""
    from ikea_recommender_tpu_torch.run import trainer as port_trainer

    try:
        port_trainer.train(cfg, device="cpu", **bufs)
    except (RuntimeError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def scaling_bench(mesh, specs, **kw):
    """``parallel/scaling_bench.py::run_scaling_bench`` on every rank of the
    pool, each point's mesh on the pool's first ranks (the pool's own mesh
    is not used); its points as dicts."""
    import dataclasses

    from ikea_recommender_tpu_torch.core.mesh import MeshSpec
    from ikea_recommender_tpu_torch.parallel.scaling_bench import run_scaling_bench

    pts = run_scaling_bench(mesh_specs=[MeshSpec(*s) for s in specs], backend="gloo",
                            device="cpu", **kw)
    return [dataclasses.asdict(p) for p in pts]
