"""Training orchestration on one device.

Port of ``ikea_recommender_tpu/run/trainer.py::train`` (:355): one engine
for gru4rec, bidir_gru4rec, sqn, smorl and sarm, configured by the
experiment config. What it keeps of the reference:

- the data path: buffers, tokenizers (``out_to_in``, and ``num_items`` /
  ``num_actions`` from their sizes), the unpopular mask, the frozen
  diversity embedding and the ``require_div_emb`` guard;
- the whole train buffer goes to the device once; each epoch uploads one
  ``(n_b, B)`` index matrix and its valid mask, drawn from
  ``np.random.default_rng(seed * 100_003 + epoch)``, and each step gathers
  its batch on the device;
- fractional-epoch evaluation: boundaries ``sorted({int(n_b * p) for p in
  eval_at} - {0})``, one train span per boundary and a train-only tail;
- per-batch train metrics with the post-step params of net 0
  (``metrics.train_metrics``; off, ``Train_*`` finalize to 0), reset after
  each eval point; the loss sums stay on the device and are read once per
  eval point;
- double-Q families evaluate both nets, log the second under ``Sec_`` and
  checkpoint whichever wins the watched metric;
- a warm-up eval logged as ``Pretrain_`` at step 0;
- at the end: reload the best params, evaluate on test (``real_test``
  flips the prefix), write ``test_metrics.json`` and, with
  ``experiment.save_pretrained_embeddings``, ``embedding_weights.npy``;
- resume at epoch granularity: the checkpoint carries the train state (its
  ``torch.Generator`` state included: the double-Q coin and dropout), the
  best-model tracker, the best params and the eval-point counter, so a
  resumed run ships the same model as an uninterrupted one.

What differs: the loop is a host loop of steps (the reference's scanned
windows, ``_make_window_runner``, and its device-resident eval data are
the TPU's one-dispatch form and are not ported), and the params come in
rather than being drawn: the port cannot reproduce JAX's PRNG init, so
``train`` starts from ``convert.numpy_init_params`` (``numpy_init_double_q``
for the double-Q pair) seeded by the config, or from ``init_params``.
The lazy optimizers run as the reference's: ``optimizer: lazy_adam`` (lazy
embedding rows) and ``qhead_optimizer: lazy_adam`` on sqn, smorl or sarm
(lazy action-major Q-head rows, also set by ``preset: fast``), under the
reference's preconditions: where one fails, a preset's setting falls back
to dense Adam with a ``[trainer]`` line and an explicit one raises. The
lazily trained params keep the action-major layout in the checkpoints and
in ``best_model.npz``, as the reference saves them.

On a (data, model) mesh (the config's ``parallel:`` section with
``data x model > 1``) each rank is one process, started by ``torchrun`` or
by the caller, over an initialized process group of ``data x model``
ranks (``core/distributed.py::initialize``); without one, ``train``
raises. The reference treats a mesh in one process more widely than one
over several processes; the port's ranks stand for the reference's single
process, as the tests hold them to it:

- lazy embedding Adam runs on a mesh for gru4rec, bidir_gru4rec, sqn and
  smorl, and lazy Q-head Adam for sqn and smorl;
- sarm on a mesh keeps the reference's rules: an explicit
  ``optimizer: lazy_adam`` or ``qhead_optimizer: lazy_adam`` raises, and
  the setting of ``preset: fast`` falls back to dense Adam with the
  reference's ``[trainer]`` line;
- ``process_sharded: null`` means off; only ``process_sharded: true``
  splits the train rows.

Each rank draws the same full params (or takes ``init_params``) and keeps
its slice (``parallel/sharding.py::shard_state``), takes its rows of each
global batch (``core/distributed.py::local_rows``), evaluates its rows of
each eval batch (``EvalProtocol(mesh=)``) and saves its own checkpoint
(``run/checkpoints.py``). With ``process_sharded: true`` a rank uploads
only its data index's block of the train rows and the epoch's index
matrices are the reference's ``_sharded_index_matrices``; its gather is
local. ``sharded_ce`` is ``parallel/sharding.py::make_sharded_train_step``
with ``sharded_ce``. The best model is put together on every rank
(``gather_tree``); rank 0 alone writes files and prints.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ikea_recommender_tpu_torch.convert import (
    numpy_init_double_q,
    numpy_init_params,
    params_from_numpy,
    tree_leaves,
    tree_map,
)
from ikea_recommender_tpu_torch.core.config import Config
from ikea_recommender_tpu_torch.core.device import resolve_device
from ikea_recommender_tpu_torch.core.distributed import data_rows
from ikea_recommender_tpu_torch.core.mesh import DATA_AXIS, MeshSpec, make_mesh
from ikea_recommender_tpu_torch.data.item_frequency import (
    load_unpopular_items,
    unpopular_mask as build_unpopular_mask,
)
from ikea_recommender_tpu_torch.data.replay_buffer import (
    EvalBuffer,
    ReplayBuffer,
    load_eval_source,
    num_batches,
)
from ikea_recommender_tpu_torch.data.tokenizer import Tokenizer, build_output_to_input_table
from ikea_recommender_tpu_torch.eval.protocol import EvalProtocol
from ikea_recommender_tpu_torch.models.families import model_config_from_train
from ikea_recommender_tpu_torch.parallel.sharding import (
    gather_tree,
    make_sharded_train_step,
    shard_state,
)
from ikea_recommender_tpu_torch.run.checkpoints import BestModelTracker, CheckpointManager
from ikea_recommender_tpu_torch.train.state import (
    DoubleQState,
    LazyAdamState,
    make_double_q_state,
    make_lazy_double_q_state,
    make_lazy_sarm_state,
    make_lazy_train_state,
    make_train_state,
)
from ikea_recommender_tpu_torch.train.steps import RLStepConfig, make_train_step
from ikea_recommender_tpu_torch.utils.logging_dicts import (
    get_logging_dict_by_type,
    get_logging_dict_test,
    get_logging_dict_train,
)

DOUBLE_Q_FAMILIES = ("sqn", "smorl")


def load_div_embedding(path: str) -> np.ndarray:
    """Frozen pretrained diversity embedding: .npy/.npz (native) or .pt
    (a torch export)."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        with np.load(path) as data:
            return data["embedding"] if "embedding" in data else data[data.files[0]]
    return np.asarray(torch.load(path, map_location="cpu", weights_only=True))


@dataclass
class TrainOutcome:
    best_metric: float
    best_epoch: Optional[int]
    test_metrics: Dict[str, float]
    logs: List[Dict[str, float]] = field(default_factory=list)
    best_params: Any = None
    throughput_sessions_per_sec: float = 0.0
    pretrain_metrics: Dict[str, float] = field(default_factory=dict)
    # Wall-clock attribution of the train loop (seconds, whole run):
    # idx_build (host index-matrix construction), dispatch (host time
    # launching a span's steps, the index upload included), sync (the read
    # of the span's loss sums, which waits for the device), eval
    # (validation passes).
    timing: Dict[str, float] = field(default_factory=dict)
    # The final train state (on a mesh, this rank's slice of it).
    state: Any = None


def _eval_params_list(state, family):
    """Networks to evaluate: [net0] or [net0, net1] for double-Q."""
    if family in DOUBLE_Q_FAMILIES:
        return [state.params[0], state.params[1]]
    return [state.params]


def _device_train_data(buf: ReplayBuffer, dev: torch.device) -> Dict[str, torch.Tensor]:
    """The whole replay buffer on the device, one upload per column."""
    cols = {
        "state": buf.state,
        "action": buf.action,
        "reward": buf.reward,
        "next_state": buf.next_state,
        "true_len": buf.true_len,
        "true_next_len": buf.true_next_len,
        "is_end": buf.is_end,
    }
    if buf.action_type is not None:
        cols["action_type"] = buf.action_type
    return {k: torch.as_tensor(v).to(dev) for k, v in cols.items()}


def _device_train_data_process_sharded(buf: ReplayBuffer, mesh, dev: torch.device):
    """This rank's block of the train rows on the device (reference
    ``_device_train_data_process_sharded``): the rows padded with zeros to
    ``D * per``, ``per = ceil(n / D)`` for the data axis' D, in contiguous
    blocks, and the block of this rank's data index, the block the
    reference's row-sharded global array puts on that data shard (the
    model ranks of one data index hold the same block). Returns (data,
    per, n)."""
    D, d = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)
    n = len(buf)
    per = -(-n // D)
    lo, hi = d * per, min((d + 1) * per, n)
    host = _device_train_data(buf, torch.device("cpu"))  # views of the buffer's arrays
    out = {}
    for k, col in host.items():
        block = torch.zeros((per,) + tuple(col.shape[1:]), dtype=col.dtype)
        if hi > lo:
            block[: hi - lo] = col[lo:hi]
        out[k] = block.to(dev)
    return out, per, n


def _sharded_index_matrices(rng, n: int, per: int, D: int, batch_size: int):
    """Per-data-shard epoch sampling (reference ``_sharded_index_matrices``):
    shard d permutes its ``per`` rows (global rows ``[d per, (d + 1) per)``),
    each batch takes B/D rows from every shard; rows past the real count
    ``n`` (block padding) are invalid. One ``rng`` draws the D shards'
    permutations in order, so every rank draws all of them and keeps its
    own. -> (idx (n_b, D, B/D) shard-local ids, valid (n_b, D, B/D))."""
    Bd = batch_size // D
    n_b = -(-per // Bd)
    idx = np.zeros((n_b, D, Bd), dtype=np.int32)
    valid = np.zeros((n_b, D, Bd), dtype=bool)
    for d in range(D):
        perm = rng.permutation(per).astype(np.int32)
        for i in range(n_b):
            take = perm[i * Bd : (i + 1) * Bd]
            idx[i, d, : len(take)] = take
            valid[i, d, : len(take)] = (d * per + take) < n
    return idx, valid


def _window_index_matrices(perm: np.ndarray, batch_size: int):
    """Shuffled row permutation -> (idx (n_b, B) int32, valid (n_b, B)); the
    tail batch is padded with row 0 and masked."""
    n = len(perm)
    n_b = -(-n // batch_size)
    idx = np.zeros((n_b, batch_size), dtype=np.int32)
    valid = np.zeros((n_b, batch_size), dtype=bool)
    for i in range(n_b):
        take = perm[i * batch_size : (i + 1) * batch_size]
        idx[i, : len(take)] = take
        valid[i, : len(take)] = True
    return idx, valid


def _adam_leaves(state) -> List:
    """[count, mu, nu] of each Adam state of ``state``'s optimizer: one, or
    one per net; a lazy state adds its count and its row moment buffers."""
    opt = state.opt_state
    out = []
    for s in opt if isinstance(opt, (tuple, list)) else [opt]:
        if isinstance(s, LazyAdamState):
            out.append([s.rest.count, s.rest.mu, s.rest.nu, s.count]
                       + [part.mv for part in (s.emb, s.qh) if part is not None])
        else:
            out.append([s.count, s.mu, s.nu])
    return out


def _state_payload(state) -> Dict:
    """The train state as nested dicts and lists of tensors: params, Adam
    moments and count, step, and the generator's state."""
    return {
        "params": list(state.params) if isinstance(state, DoubleQState) else state.params,
        "opt_state": _adam_leaves(state),
        "step": int(state.step),
        "generator": state.generator.get_state(),
    }


def _copy_into(dst_tree, src_tree, what: str) -> None:
    dst, src = tree_leaves(dst_tree), tree_leaves(src_tree)
    if len(dst) != len(src) or any(d.shape != s.shape for d, s in zip(dst, src)):
        raise ValueError(f"checkpoint {what} do not match this run's model")
    with torch.no_grad():
        for d, s in zip(dst, src):
            d.copy_(s)


def _restore_state(state, payload: Dict) -> None:
    """Loads ``payload`` (from :func:`_state_payload`) into ``state`` in place."""
    _copy_into(state.params, payload["params"], "params")
    _copy_into(_adam_leaves(state), payload["opt_state"], "optimizer states")
    state.step = int(payload["step"])
    state.generator.set_state(payload["generator"].cpu())


def _check_supported(cfg: Config) -> None:
    """Raises for a config the trainer cannot take, as the reference's
    checks do."""
    t_cfg, p_cfg = cfg.train, cfg.parallel
    family = t_cfg.model
    if t_cfg.optimizer not in ("adam", "lazy_adam"):
        raise ValueError(f"unknown optimizer {t_cfg.optimizer!r}")
    if t_cfg.qhead_optimizer not in (None, "adam", "lazy_adam"):
        raise ValueError(f"unknown qhead_optimizer {t_cfg.qhead_optimizer!r}")
    if t_cfg.optimizer == "lazy_adam" and family in ("sqn", "smorl", "sarm") and (
            t_cfg.double_q_optimizers == 1):
        raise ValueError("lazy optimizers need double_q_optimizers=2")
    if p_cfg.enabled:
        if t_cfg.batch_size % p_cfg.data or t_cfg.val_batch_size % p_cfg.data:
            raise ValueError(f"batch_size and val_batch_size must divide the data axis "
                             f"({p_cfg.data})")
        if p_cfg.sharded_ce and family not in ("gru4rec", "bidir_gru4rec"):
            raise ValueError("sharded_ce supports gru4rec/bidir_gru4rec only")
        if t_cfg.optimizer == "lazy_adam" and family == "sarm":
            raise ValueError("optimizer='lazy_adam' on a mesh: mesh + lazy is not supported "
                             "for sarm (head-0 dense split)")
    elif p_cfg.sharded_ce:
        raise ValueError("sharded_ce requires a multi-device mesh")
    elif p_cfg.process_sharded:
        raise ValueError("process_sharded requires a multi-device mesh")
    if t_cfg.double_q_optimizers not in (1, 2):
        raise ValueError(f"double_q_optimizers must be 1 or 2, got {t_cfg.double_q_optimizers}")


def _mesh(cfg: Config, dev: torch.device):
    """This rank's mesh for ``parallel:`` (None for one device): the
    initialized process group must have ``data x model`` ranks."""
    p_cfg = cfg.parallel
    if not p_cfg.enabled:
        return None
    n = p_cfg.num_devices
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = (f"a process group of {dist.get_world_size()}" if dist.is_initialized()
                else "no process group")
        raise RuntimeError(
            f"parallel: data {p_cfg.data} x model {p_cfg.model} trains as {n} ranks, one "
            f"process each, and this process has {have}: start them with `torchrun "
            f"--nproc-per-node {n} -m ikea_recommender_tpu_torch.run.cli -f <yaml> --backend "
            f"nccl` (or `--backend gloo`), or call core.distributed.initialize first")
    return make_mesh(MeshSpec(p_cfg.data, p_cfg.model), device=dev)


def _lazy_qhead(t_cfg, model_cfg, mesh=None, say=print) -> bool:
    """Whether the Q heads take lazy Adam: ``qhead_optimizer: lazy_adam`` on
    sqn, smorl or sarm (a no-op elsewhere, as the fast preset sets it for
    every family), under the reference's preconditions. Where one fails, a
    setting from ``preset: fast`` falls back to dense Adam with a line
    (``say``), and an explicit setting raises."""
    family = t_cfg.model
    if t_cfg.qhead_optimizer != "lazy_adam" or family not in ("sqn", "smorl", "sarm"):
        return False
    blocker = None
    if t_cfg.double_q_optimizers == 1:
        blocker = "double_q_optimizers=1 (lazy optimizers need 2)"
    elif not model_cfg.fused_ce:
        blocker = ("the fused train path resolved off (fused_ce=False or catalog under "
                   "fused_ce_min_actions)")
    elif family == "sqn" and t_cfg.head_idx != 0:
        # the eval head would be the action-major q head
        blocker = "head_idx != 0"
    elif mesh is not None and family == "sarm":
        # sarm's lazy layout splits off a densely updated head 0
        blocker = "sarm on a mesh (head-0 dense split)"
    if blocker is None:
        return True
    if getattr(t_cfg, "qhead_from_preset", False):
        say(f"[trainer] {blocker}: preset-fast qhead_optimizer falls back to dense Adam")
        return False
    raise ValueError(f"qhead_optimizer='lazy_adam' unsupported here: {blocker}")


def train(
    cfg: Config,
    *,
    train_buf: Optional[ReplayBuffer] = None,
    val_buf: Optional[EvalBuffer] = None,
    test_buf: Optional[EvalBuffer] = None,
    div_embedding: Optional[np.ndarray] = None,
    unpopular: Optional[set] = None,
    input_tokenizer: Optional[Tokenizer] = None,
    output_tokenizer: Optional[Tokenizer] = None,
    log_fn: Optional[Callable[[Dict[str, float], int], None]] = None,
    progress: bool = False,
    init_params: Any = None,
    device="cuda",
) -> TrainOutcome:
    """Train ``cfg.train.model`` on ``device`` (raises without CUDA unless
    ``device="cpu"``). Buffers, embedding, unpopular set and tokenizers
    default to the paths in ``cfg``. ``init_params`` is the starting param
    tree as numpy arrays in the reference's layout (a (net0, net1) pair for
    sqn and smorl), e.g. a JAX run's init; without it the params are drawn
    from ``cfg.seed`` by ``convert.numpy_init_params``.
    ``train.max_window_batches`` bounds the reference's scanned windows and
    means nothing to this host loop: it is accepted and ignored.

    With ``parallel.data x parallel.model > 1`` every rank of the mesh
    calls ``train`` with the same arguments; ``device`` is the rank's
    (``core/distributed.py::local_device`` under nccl)."""
    t_cfg, d_cfg, m_cfg, p_cfg = cfg.train, cfg.data, cfg.metrics, cfg.parallel
    family = t_cfg.model
    _check_supported(cfg)
    dev = resolve_device(device)
    mesh = _mesh(cfg, dev)
    is_main = mesh is None or mesh.rank == 0

    def say(msg):
        if is_main:
            print(msg)

    # ---- data -----------------------------------------------------------
    if train_buf is None:
        train_buf = ReplayBuffer(d_cfg.train_path)
    _eval_src = dict(
        padding_id=cfg.padding_id,
        state_len=t_cfg.state_size,
        pad_pos=t_cfg.padding_position,
        session_col=d_cfg.session_col,
        item_col=d_cfg.item_col,
    )
    if val_buf is None:
        val_buf = load_eval_source(d_cfg.val_path, **_eval_src)
    real_test = bool(d_cfg.test_path) and d_cfg.test_path != d_cfg.val_path
    if test_buf is None:
        test_buf = load_eval_source(d_cfg.test_path, **_eval_src) if real_test else val_buf

    if input_tokenizer is None and d_cfg.input_tokenizer:
        input_tokenizer = Tokenizer.from_file(d_cfg.input_tokenizer)
    if output_tokenizer is None and d_cfg.output_tokenizer:
        output_tokenizer = Tokenizer.from_file(d_cfg.output_tokenizer)
    out_to_in = None
    if input_tokenizer is not None and output_tokenizer is not None:
        out_to_in = build_output_to_input_table(input_tokenizer, output_tokenizer)
    # Configs may leave vocab sizes at 0 and carry tokenizers instead
    # (reference trainGRU.py:27-28,114-116; pad excluded).
    if d_cfg.num_items == 0 and input_tokenizer is not None:
        d_cfg.num_items = len(input_tokenizer) - 1
    if d_cfg.num_actions == 0:
        d_cfg.num_actions = (
            len(output_tokenizer) - 1 if output_tokenizer is not None else d_cfg.num_items
        )

    if unpopular is None and m_cfg.unpopular_actions_path:
        unpopular = load_unpopular_items(m_cfg.unpopular_actions_path)
    unpop_mask = build_unpopular_mask(unpopular or set(), d_cfg.num_actions)

    if div_embedding is None and m_cfg.div_emb_dir:
        div_embedding = load_div_embedding(m_cfg.div_emb_dir)
    if div_embedding is None and family == "smorl":
        # Without a frozen pretrained embedding the cosine similarity is
        # identically 1 and the diversity reward identically 0: the third
        # SMORL objective trains against zeros. The protocol is two-phase:
        # a GRU4Rec run exports its embedding matrix and SMORL loads it
        # frozen via metrics.div_emb_dir.
        msg = (
            "SMORL run has no diversity embedding (metrics.div_emb_dir unset "
            "and no div_embedding passed): the diversity reward will be "
            "identically 0 and the diversity Q-head trains against zeros. "
            "Export embeddings from a GRU4Rec run "
            "(experiment.save_pretrained_embeddings: true -> "
            "embedding_weights.npy) and set metrics.div_emb_dir."
        )
        if m_cfg.require_div_emb:
            raise ValueError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
        say(f"[trainer] WARNING: {msg}")
    div_emb = (
        np.asarray(div_embedding, np.float32) if div_embedding is not None
        else np.ones((d_cfg.num_items + 1, 1), np.float32)
    )

    # ---- model / state / step / protocol -------------------------------
    # on a mesh the vocab rows and action columns pad to the model axis
    model_cfg = model_config_from_train(t_cfg, d_cfg, align=p_cfg.model if mesh else 1)
    rl = RLStepConfig(
        gamma=t_cfg.gamma,
        alpha=t_cfg.alpha,
        q_weights=tuple(t_cfg.q_weights),
        topk_div=m_cfg.topk_div,
        topk_nov=m_cfg.topk_nov,
        nov_rew_sig=m_cfg.nov_rew_sig,
        padding_pos=t_cfg.padding_position,
        compat_boot_len_bug=t_cfg.compat_boot_len_bug,
        compat_div_len_bug=t_cfg.compat_div_len_bug,
        sarm_gamma=t_cfg.sarm_gamma,
        single_optimizer=(t_cfg.double_q_optimizers == 1),
    )
    lr, mv = t_cfg.learning_rate, t_cfg.optimizer_mv_dtype
    lazy_emb = t_cfg.optimizer == "lazy_adam"
    lazy_qh = _lazy_qhead(t_cfg, model_cfg, mesh, say)
    lazy_kw = dict(lazy_emb=lazy_emb, lazy_qh=lazy_qh, seed=cfg.seed, device=dev)
    if family in DOUBLE_Q_FAMILIES:
        pair = init_params if init_params is not None else numpy_init_double_q(
            model_cfg, (cfg.seed, cfg.seed + 1))
        pair = [params_from_numpy(p, dev) for p in pair]
        if lazy_emb or lazy_qh:
            state, opt = make_lazy_double_q_state(pair, model_cfg, lr, mv, **lazy_kw)
        else:
            state, opt = make_double_q_state(pair, model_cfg, lr, mv,
                                             single_optimizer=rl.single_optimizer,
                                             seed=cfg.seed, device=dev)
    else:
        np_params = init_params if init_params is not None else numpy_init_params(
            model_cfg, cfg.seed)
        params = params_from_numpy(np_params, dev)
        if family == "sarm" and (lazy_emb or lazy_qh):
            state, opt = make_lazy_sarm_state(params, model_cfg, lr, mv, **lazy_kw)
        elif lazy_emb:
            state, opt = make_lazy_train_state(params, model_cfg, lr, mv, seed=cfg.seed,
                                               device=dev)
        else:
            state, opt = make_train_state(params, model_cfg, lr, mv, seed=cfg.seed, device=dev)
    # the full layout of one net, for putting the best model together
    template = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                        _eval_params_list(state, family)[0])
    step_kw = dict(rl=rl, div_embedding=div_emb, unpopular_mask=unpop_mask, out_to_in=out_to_in,
                   lazy_embedding_lr=lr if lazy_emb else None,
                   lazy_qhead_lr=lr if lazy_qh else None)
    if mesh is not None:
        state = shard_state(state, mesh)
    if p_cfg.sharded_ce:
        step_fn = make_sharded_train_step(model_cfg, opt, mesh, sharded_ce=True, **step_kw)
    else:
        step_fn = make_train_step(model_cfg, opt, mesh=mesh,
                                  data_axis=None if mesh is None else DATA_AXIS, device=dev,
                                  **step_kw)
    protocol = EvalProtocol(
        model_cfg,
        topk_hr_ndcg=m_cfg.topk_hr_ndcg,
        topk_cov=m_cfg.topk_cov,
        topk_div=m_cfg.topk_div,
        topk_nov=m_cfg.topk_nov,
        nov_rew_sig=m_cfg.nov_rew_sig,
        padding_pos=t_cfg.padding_position,
        div_embedding=div_emb,
        unpopular_mask=unpop_mask,
        out_to_in=out_to_in,
        head_idx=t_cfg.head_idx,
        fused=m_cfg.fused_eval,
        type_names=m_cfg.action_type_names,
        eval_precision=m_cfg.eval_precision,
        mesh=mesh,
        device=dev,
    )

    tracker = BestModelTracker(
        cfg.exp_dir, metric_name=t_cfg.best_model_metric, mode=t_cfg.best_model_mode,
        write_files=is_main,
    )
    dims = {
        "hidden_dim": t_cfg.hidden_state_size,
        "item_num": d_cfg.num_items,
        "action_dim": d_cfg.num_actions,
        "state_size": t_cfg.state_size,
        "embedding_dim": t_cfg.embedding_size,
    }

    ckpt_mngr = None
    start_epoch = 0
    log_counter = 0  # eval points so far; the tracker's epoch
    best_live = None  # a copy of the whole-run best params (on a mesh, this rank's slice)

    def whole(params):
        """The full params from every rank's slices (on every rank)."""
        return params if mesh is None else gather_tree(params, mesh, template)

    # The checkpoint carries the best-model tracker beside the train state,
    # so a resume cannot change which model ships.
    def _ckpt_payload(best):
        return {
            "train": _state_payload(state),
            "best_meta": {
                "metric": float(tracker.best),
                "epoch": -1 if tracker.best_epoch is None else int(tracker.best_epoch),
                "model_idx": int(tracker.best_model_idx or 0),
                "has": best is not None,
            },
            "best_params": best,
            "log_counter": log_counter,
        }

    if t_cfg.checkpoint_dir:
        ckpt_mngr = CheckpointManager(t_cfg.checkpoint_dir, mesh=mesh)
        if t_cfg.resume:
            restored = ckpt_mngr.restore()
            if restored is not None:
                _restore_state(state, restored["train"])
                bm = restored["best_meta"]
                if bm["has"]:
                    best_live = tree_map(lambda t: t.to(dev), restored["best_params"])
                    tracker.restore(bm["metric"], bm["epoch"], bm["model_idx"],
                                    params=whole(best_live), dims=dims)
                log_counter = int(restored["log_counter"])
                start_epoch = int(ckpt_mngr.restored_step)
                say(f"[resume] restored checkpoint, continuing at epoch {start_epoch} "
                    f"(best {tracker.metric_name}={tracker.best:.5f})")

    shard_rows = None  # (rows per data shard, real rows) with process_sharded
    if p_cfg.process_sharded:
        train_data, per, n_real = _device_train_data_process_sharded(train_buf, mesh, dev)
        shard_rows = (per, n_real)
    else:
        train_data = _device_train_data(train_buf, dev)
    # this rank's columns of each (n_b, B) index matrix
    mine = slice(None) if mesh is None else data_rows(t_cfg.batch_size, mesh)

    # ---- warm-up eval, logged under Pretrain_ ----------------------------
    warmup_res = protocol.evaluate(
        _eval_params_list(state, family)[0], val_buf, t_cfg.val_batch_size
    )
    pretrain_metrics = get_logging_dict_test(
        warmup_res, topk_hr_ndcg=m_cfg.topk_hr_ndcg, topk_cov=m_cfg.topk_cov,
        prefix="Pretrain_", name="Val",
    )
    if log_fn is not None and is_main:
        log_fn(pretrain_metrics, 0)

    if shard_rows is not None:
        n_b = -(-shard_rows[0] // (t_cfg.batch_size // mesh.size(DATA_AXIS)))
    else:
        n_b = num_batches(len(train_buf), t_cfg.batch_size)
    boundaries = sorted({int(n_b * p) for p in t_cfg.eval_at} - {0})

    logs: List[Dict[str, float]] = []
    total_sessions = 0
    train_time = 0.0
    timing = {"idx_build": 0.0, "dispatch": 0.0, "sync": 0.0, "eval": 0.0}
    q_included = family not in ("gru4rec", "bidir_gru4rec")

    for epoch in range(start_epoch, t_cfg.epochs):
        t_idx = time.perf_counter()
        rng = np.random.default_rng(cfg.seed * 100_003 + epoch)
        if shard_rows is not None:
            idx_all, valid_all = _sharded_index_matrices(
                rng, shard_rows[1], shard_rows[0], mesh.size(DATA_AXIS), t_cfg.batch_size)
            idx_mine, valid_mine = (a[:, mesh.index(DATA_AXIS)] for a in (idx_all, valid_all))
        else:
            idx_all, valid_all = _window_index_matrices(
                rng.permutation(len(train_buf)).astype(np.int32), t_cfg.batch_size
            )
            idx_mine, valid_mine = idx_all[:, mine], valid_all[:, mine]
        timing["idx_build"] += time.perf_counter() - t_idx
        train_accum = protocol.init_accum()
        sup_sum = torch.zeros((), device=dev)
        q_sum = torch.zeros((), device=dev)
        n_win = 0

        # Train/eval spans: one per boundary, plus a train-only tail if the
        # last eval point is before the epoch end.
        spans = [(lo, hi, True) for lo, hi in zip([0] + boundaries, boundaries)]
        if boundaries and boundaries[-1] < n_b:
            spans.append((boundaries[-1], n_b, False))
        for span_i, (lo, hi, do_eval) in enumerate(spans):
            prof = None
            if (t_cfg.profile_dir is not None and epoch == start_epoch and span_i == 0
                    and is_main):
                acts = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            if hi > lo:
                t0 = time.perf_counter()
                idx_dev = torch.as_tensor(idx_mine[lo:hi], dtype=torch.int64).to(dev)
                valid_dev = torch.as_tensor(valid_mine[lo:hi]).to(dev)
                for i in range(hi - lo):
                    rows = idx_dev[i]
                    batch = {k: v.index_select(0, rows) for k, v in train_data.items()}
                    batch["valid"] = valid_dev[i]
                    state, metrics = step_fn(state, batch)
                    if m_cfg.train_metrics:
                        # metrics.train_metrics=false skips this per-batch
                        # full-catalog top-k; Train_* then finalize to 0
                        train_accum = protocol.update(
                            _eval_params_list(state, family)[0], train_accum,
                            batch["state"], batch["action"], batch["true_len"],
                            batch["valid"], batch.get("action_type"),
                        )
                    sup_sum = sup_sum + metrics["sup_loss"]
                    q_sum = q_sum + metrics["q_loss"]
                    n_win += 1
                t_disp = time.perf_counter()
                timing["dispatch"] += t_disp - t0
                win_sup, win_q = torch.stack([sup_sum, q_sum]).cpu().tolist()  # the sync
                timing["sync"] += time.perf_counter() - t_disp
                train_time += time.perf_counter() - t0
                total_sessions += int(valid_all[lo:hi].sum())
            if prof is not None:
                prof.stop()
                os.makedirs(t_cfg.profile_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(t_cfg.profile_dir, f"trace_epoch{epoch + 1}_span1.json"))
            if not do_eval:
                continue

            n = max(n_win, 1)
            t_ev = time.perf_counter()
            train_res = protocol.finalize(train_accum)
            nets = _eval_params_list(state, family)
            val_results = [protocol.evaluate(p, val_buf, t_cfg.val_batch_size) for p in nets]
            timing["eval"] += time.perf_counter() - t_ev
            log_dict = get_logging_dict_train(
                train_sup_loss=win_sup / n,
                train_q_loss=win_q / n,
                train_res=train_res,
                val_res=val_results[0],
                topk_hr_ndcg=m_cfg.topk_hr_ndcg,
                topk_cov=m_cfg.topk_cov,
                q_included=q_included,
            )
            if len(val_results) > 1:
                log_dict.update(get_logging_dict_train(
                    train_sup_loss=0.0,
                    train_q_loss=None,
                    train_res=train_res,
                    val_res=val_results[1],
                    topk_hr_ndcg=m_cfg.topk_hr_ndcg,
                    topk_cov=m_cfg.topk_cov,
                    q_included=False,
                    prefix="Sec_",
                ))
            if m_cfg.action_type_names:
                log_dict.update(get_logging_dict_by_type(train_res, m_cfg.topk_hr_ndcg,
                                                         name="Train"))
                log_dict.update(get_logging_dict_by_type(val_results[0], m_cfg.topk_hr_ndcg,
                                                         name="Val"))

            # Best-model bookkeeping: double-Q saves the winning net.
            metric_name = tracker.metric_name
            candidates = [(log_dict.get(metric_name, -np.inf), 1, nets[0])]
            if len(nets) > 1:
                candidates.append((log_dict.get(f"Sec_{metric_name}", -np.inf), 2, nets[1]))
            value, model_idx, winner = max(candidates, key=lambda c: c[0])
            # every rank reads the same metrics, so every rank takes the
            # same branch (on a mesh, a collective: the winner put together)
            if tracker.improved(value):
                tracker(value, epoch=log_counter, params=whole(winner), model_idx=model_idx,
                        dims=dims)
                # A copy: the next step's Adam moves the state's params in
                # place, and the best must not move with them.
                best_live = tree_map(torch.clone, winner)

            logs.append(log_dict)
            if log_fn is not None and is_main:
                log_fn(log_dict, log_counter)
            if progress:
                say(f"epoch {epoch + 1} batch {hi}/{n_b} "
                    f"{metric_name}={value:.5f} (best {tracker.best:.5f})")
            log_counter += 1
            # reset the training window (reference trainGRU.py:385-395)
            train_accum = protocol.init_accum()
            sup_sum = torch.zeros((), device=dev)
            q_sum = torch.zeros((), device=dev)
            n_win = 0

        if ckpt_mngr is not None:
            ckpt_mngr.save(epoch + 1, _ckpt_payload(best_live))

    # ---- test with the reloaded best model ------------------------------
    if best_live is not None:
        best_params = best_live
    elif mesh is None and os.path.exists(tracker.params_path):
        best_params = tracker.load_best(dev)
    else:
        best_params = _eval_params_list(state, family)[0]
    test_res = protocol.evaluate(best_params, test_buf, t_cfg.val_batch_size)
    best_params = whole(best_params)
    test_metrics = get_logging_dict_test(
        test_res, topk_hr_ndcg=m_cfg.topk_hr_ndcg, topk_cov=m_cfg.topk_cov,
        real_test=real_test,
    )
    if m_cfg.action_type_names:
        test_metrics.update(get_logging_dict_by_type(
            test_res, m_cfg.topk_hr_ndcg, name="Test" if real_test else "Best_Val"))
    if log_fn is not None and is_main:
        log_fn(test_metrics, log_counter)
    if is_main:
        with open(os.path.join(cfg.exp_dir, "test_metrics.json"), "w") as fh:
            json.dump(test_metrics, fh, indent=2)

    if cfg.experiment.save_pretrained_embeddings and is_main:
        np.save(os.path.join(cfg.exp_dir, "embedding_weights.npy"),
                best_params["backbone"]["embedding"].detach().cpu().numpy())

    throughput = total_sessions / train_time if train_time > 0 else 0.0
    return TrainOutcome(
        best_metric=float(tracker.best),
        best_epoch=tracker.best_epoch,
        test_metrics=test_metrics,
        logs=logs,
        best_params=best_params,
        throughput_sessions_per_sec=throughput,
        pretrain_metrics=pretrain_metrics,
        timing=dict(timing),
        state=state,
    )
