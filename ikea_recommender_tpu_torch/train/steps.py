"""Train steps: the supervised CE step of gru4rec and bidir_gru4rec, the
double-Q steps of sqn and smorl, and the self-bootstrapped step of sarm.

Port of ``ikea_recommender_tpu/train/steps.py`` (``RLStepConfig``,
``_masked_mean``, ``_ce_loss``, ``_fused_sup_ce``, ``_apply_grad_mask``,
``ce_train_step``, ``_double_q_run`` (``double_q_train_step``),
``sqn_train_step``, ``smorl_train_step``, ``sarm_train_step``, the lazy
optimizers' steps
(``LazyCfg``, ``ce_train_step_lazy``, ``_lazy_double_q_run``,
``_lazy_diff_parts``, ``_dense_part``, ``_q_from_rows``,
``_lazy_apply_updates`` and the three ``*_train_step_lazy``),
``TrainStep`` and ``make_train_step``).

The CE step (reference ``models/GRU4Rec/model.py:131-158``): embedding
gather, the GRU layers (B3 forward and B4 backward on the card), the
masked-mean CE over the catalog, the pad row's gradient mask and Adam.
Catalogs of at least ``FUSED_CE_MIN_ACTIONS`` take the fused CE (B1 forward
and B2 backward: the (B, A) logits are never written); smaller ones the
dense logits path over ``mask_pad_logits``. The step is split into
:func:`loss_and_grads` and the Adam update, so the gradients can be compared
on their own.

The double-Q steps (reference ``sqn_gru.py:183-252``, ``smorl_gru.py:233-330``)
train the main net of a (net0, net1) pair on the supervised CE plus a TD
loss whose target is the other (bootstrap) net's Q at the main net's best
next action. Each step a coin picks the main net; it is drawn on the host
from the state's CPU generator (one draw a step), or given to the step as
``coin``, so choosing the branch never waits on the device. On the fused
path nothing of size (B, A) is written: the supervised CE is B1/B2 (sqn,
and smorl with K = 1) or one blockwise pass that also yields the online
rewards' top-k (smorl, ``fused_softmax_ce_topk``, backward B2); the Q
values are row gathers; the target action is B5 (sqn) or B6 (smorl). Both
next-state forwards run under ``no_grad``, so a step runs B3 three times
and B4 once. :func:`double_q_loss_and_grads` gives one net's loss and
gradients on their own.

The sarm step (reference ``sarm.py:116-152``) trains one net of five Q
heads whose head 0 is also the supervised head: the CE on head 0 plus the
mean over heads of each head's masked-mean TD loss, where head k
bootstraps from its own max over the catalog on the same net's next state,
``r + sarm_gamma * max_a Q_k(s', a)``, zero at episode ends (the
reference's deliberate departure from the original, which never applied
its ``is_end`` mask). There is no coin, no second net and no ``alpha``. On
the fused path the CE is B1/B2 on head 0, Q(s, a) a row gather of every
head and the targets ``ops/fused_topk.py::blockwise_multihead_max``, plain
products over column blocks; the next-state forward runs under
``no_grad``, so a step runs B3 twice and B4 once.
:func:`sarm_loss_and_grads` gives the loss and gradients on their own.

The lazy steps (``optimizer: lazy_adam``, ``qhead_optimizer: lazy_adam``;
``train/lazy_adam.py``) share these losses: the embedding rows and/or the
trained net's Q-head rows at the batch's sorted actions are gathered
outside autograd and their gradients drive lazy Adam on those rows; dense
Adam owns the rest. An action-major head takes B5's or B6's action-major
form and sarm's target max ``blockwise_multihead_max_am`` for heads 1-4.

Batches are dicts of arrays: ``state`` (B, T) int, ``action`` (B,) int,
``true_len`` (B,) int and ``valid`` (B,) bool, the mask of a padded tail
batch; the double-Q and sarm steps also read ``reward`` (B,) float,
``next_state`` (B, T), ``true_next_len`` (B,) and ``is_end`` (B,) bool.
Every mean is a masked mean. The steps return their metrics as device tensors and never
wait on the device themselves.

On a (data, model) mesh (``mesh``, ``core/mesh.py``; ROADMAP A.9a) each
rank holds its slice of the params (``parallel/sharding.py``: embedding
rows, head columns) and, with ``data_axis``, its rows of the batch
(``core/distributed.py::local_rows``; without, every data rank takes the
whole batch). The losses are the same functions: the fused arm runs B1/B2
per shard (``parallel/fused_ce.py``), sqn's and smorl's target actions B5
and B6 per shard, the row gathers and sarm's target max per shard
(``parallel/q_kernels.py``), each merged over the model axis; the dense arm
takes each shard's logits (``apply_model(..., mesh=)``) through
``parallel/topk.py::sharded_softmax_ce``, ``sharded_top_k`` and
``parallel/q_kernels.py::sharded_argmax``/``sharded_take``. Every masked
mean divides by the global batch's valid rows (``n_valid``, summed over
the data axis): a padded tail split unevenly over the data ranks weighs
each row as the unsplit batch does. A data rank takes its rows of the
global batch's dropout mask, drawn from the state's generator, and every
rank draws the same coin. The ``*_loss_and_grads`` functions return the
global metrics and this rank's slice of the global gradients (summed over
the data axis in one collective, ``parallel/sharding.py::
allreduce_grads``), and Adam moves each slice. The lazy steps on a mesh
(all but sarm's) gather the embedding rows as the dense arm's backbone
does, keep the lazy Q head replicated (its target action from the
data-parallel islands, ``parallel/q_kernels.py::dp_*_am``), sum the dense
part's gradients over the data axis, and gather the lazy rows' ids and
gradients over it in one collective, so that every rank updates its rows
from the global batch's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ikea_recommender_tpu_torch.convert import tree_leaves, tree_map, tree_unflatten
from ikea_recommender_tpu_torch.core.device import resolve_device
from ikea_recommender_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, pvary
from ikea_recommender_tpu_torch.models import backbone
from ikea_recommender_tpu_torch.models.backbone import embedding_grad_mask, embedding_rows
from ikea_recommender_tpu_torch.models.families import (
    ModelConfig,
    apply_features,
    apply_model,
    mask_pad_logits,
)
from ikea_recommender_tpu_torch.models.heads import linear_apply
from ikea_recommender_tpu_torch.ops.fused_argmax import (
    fused_linear_argmax,
    fused_weighted_multihead_argmax,
    multihead_row_logit,
    row_logit,
)
from ikea_recommender_tpu_torch.ops.fused_ce import fused_softmax_ce, fused_softmax_ce_topk
from ikea_recommender_tpu_torch.ops.fused_topk import (
    blockwise_multihead_max,
    blockwise_multihead_max_am,
    topk_lowest_id,
)
from ikea_recommender_tpu_torch.ops.rewards import diversity_from_topk, novelty_from_topk
from ikea_recommender_tpu_torch.ops.rl import (
    gather_from_3d,
    get_max_action,
    get_weighted_q_target,
    weighted_q_loss,
)
from ikea_recommender_tpu_torch.parallel.fused_ce import (
    sharded_fused_softmax_ce,
    sharded_fused_softmax_ce_topk,
)
from ikea_recommender_tpu_torch.parallel.q_kernels import (
    dp_linear_argmax_am,
    dp_weighted_multihead_argmax_am,
    sharded_argmax,
    sharded_linear_argmax,
    sharded_multihead_max,
    sharded_multihead_row_logit,
    sharded_row_logit,
    sharded_take,
    sharded_weighted_multihead_argmax,
)
from ikea_recommender_tpu_torch.parallel.sharding import allreduce_grads
from ikea_recommender_tpu_torch.parallel.topk import (
    sharded_embedding_lookup,
    sharded_softmax_ce,
    sharded_top_k,
)
from ikea_recommender_tpu_torch.train.lazy_adam import (
    emb_adam_update,
    gather_qhead_rows,
    q_from_rows,
    qhead_row_adam_update,
    sort_batch_ids,
)
from ikea_recommender_tpu_torch.train.state import (
    QH_KEY,
    Adam,
    DoubleQState,
    LazyAdamState,
    TrainState,
    dense_part,
)

@dataclass(frozen=True)
class RLStepConfig:
    """The RL hyperparameters of the double-Q and sarm steps (the
    reference's)."""

    gamma: float = 0.5
    alpha: float = 1.0
    q_weights: Tuple[float, ...] = (1.0, 1.0, 1.0)
    topk_div: int = 1
    topk_nov: int = 1
    nov_rew_sig: float = 1.0
    padding_pos: str = "end"
    compat_boot_len_bug: bool = False  # quirk 2: bootstrap forward reads true_len
    compat_div_len_bug: bool = False  # quirk 3: diversity reads true_next_len
    sarm_gamma: float = 0.99  # hard-coded in the original (sarm.py:112)
    # One Adam over both nets instead of one per net: the reference's
    # 1-vs-2-optimizer ablation axis.
    single_optimizer: bool = False


def _masked_mean(x: torch.Tensor, valid: torch.Tensor, n: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """sum(x * valid) / max(n, 1), ``n`` the valid rows (default: of this
    batch; on a mesh split over data: of the global batch)."""
    w = valid.to(x.dtype)
    return torch.sum(x * w) / torch.clamp(torch.sum(w) if n is None else n, min=1.0)


def _ce_loss(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, mesh=None,
             n=None) -> torch.Tensor:
    if mesh is None:
        per = F.cross_entropy(logits, labels.long(), reduction="none")
    else:  # this rank's columns of the logits
        per = sharded_softmax_ce(logits, labels, mesh)
    return _masked_mean(per, valid, n)


def _fused_sup_ce(
    params: Dict, cfg: ModelConfig, h: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
    mesh=None, n=None,
) -> torch.Tensor:
    """Supervised CE through the fused kernels, the same masked mean as
    :func:`_ce_loss` over ``mask_pad_logits``-masked logits; on a mesh B1
    and B2 per shard of the head's columns."""
    head = params["sup_head"]
    if mesh is not None:
        per = sharded_fused_softmax_ce(
            h.to(torch.float32), head["kernel"], head["bias"], labels, mesh,
            cfg.action_dim, None, cfg.head_precision,
        )
    else:
        per = fused_softmax_ce(
            h.to(torch.float32), head["kernel"], head["bias"], labels,
            cfg.action_dim, cfg.head_precision,
        )
    return _masked_mean(per, valid, n)


def _count_valid(batch: Dict, mesh, data_axis) -> Dict:
    """``batch`` with ``n_valid``, the global batch's valid rows, where
    the batch is split over a mesh's data axis."""
    if mesh is None or data_axis is None:
        return batch
    n = mesh.all_reduce(batch["valid"].sum(dtype=torch.float32), "sum", DATA_AXIS)
    return {**batch, "n_valid": n}


def _keep_rows(cfg: ModelConfig, batch: Dict, generator, mesh, data_axis):
    """This data rank's rows of the global batch's dropout keep mask,
    drawn from ``generator`` as the unsplit batch draws it; None off a
    mesh or without dropout (the backbone draws its own)."""
    bb = cfg.backbone
    if mesh is None or bb.dropout == 0.0:
        return None
    B = batch["state"].shape[0]
    D = mesh.size(DATA_AXIS) if data_axis is not None else 1
    d = mesh.index(DATA_AXIS) if data_axis is not None else 0
    full = backbone.draw_keep_mask((B * D, bb.feature_dim), 1.0 - bb.dropout, generator,
                                   batch["state"].device)
    return full[d * B:(d + 1) * B]


def _over_data(metrics: Dict, grads, mesh, data_axis):
    """(metrics, grads) summed over the data axis where the batch is
    split over it: the loss metrics in one collective, the gradients in
    another."""
    if mesh is None or data_axis is None:
        return metrics, grads
    keys = [k for k in ("sup_loss", "q_loss") if k in metrics]
    sums = mesh.all_reduce(torch.stack([metrics[k] for k in keys]), "sum", DATA_AXIS)
    return {**metrics, **dict(zip(keys, sums.unbind(0)))}, allreduce_grads(grads, mesh)


def _apply_grad_mask(grads: Dict, model_cfg: ModelConfig, mesh=None) -> Dict:
    emb = grads["backbone"]["embedding"]
    mask = embedding_grad_mask(model_cfg.backbone, emb.device, mesh)
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
    mesh=None,
    data_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads) of the supervised CE step at ``params``, grads in the
    params' layout with the pad row's gradient masked. ``generator`` draws
    the dropout mask (needed only when ``model_cfg.backbone.dropout > 0``).
    On a ``mesh``, the global loss and this rank's slice of the gradients."""
    batch = _count_valid(batch, mesh, data_axis)
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = _sup_ce_loss(leaves, batch, model_cfg, generator, mesh=mesh, data_axis=data_axis)
        grads = _grads(loss, leaves)
    metrics, grads = _over_data({"sup_loss": loss.detach()}, _apply_grad_mask(grads, model_cfg, mesh),
                                mesh, data_axis)
    return metrics["sup_loss"], grads


def _sup_ce_loss(params, batch, model_cfg: ModelConfig, generator, x_emb=None, mesh=None,
                 data_axis=None):
    """The CE families' masked-mean CE; ``x_emb`` (B, T, E) replaces the
    table gather (the lazy embedding's rows)."""
    kw = dict(dropout_generator=generator, deterministic=model_cfg.backbone.dropout == 0.0,
              inputs_embeds=x_emb, mesh=mesh,
              keep_mask=_keep_rows(model_cfg, batch, generator, mesh, data_axis))
    n = batch.get("n_valid")
    h = apply_features(params, model_cfg, batch["state"], batch["true_len"], **kw)
    if model_cfg.fused_ce:
        return _fused_sup_ce(params, model_cfg, h, batch["action"], batch["valid"], mesh, n)
    offset = None
    if mesh is not None:  # this rank's columns, as apply_model(mesh=) takes them
        h = pvary(h, mesh, MODEL_AXIS)
        offset = mesh.index(MODEL_AXIS) * params["sup_head"]["bias"].shape[-1]
    logits = mask_pad_logits(model_cfg, linear_apply(params["sup_head"], h), offset)
    return _ce_loss(logits, batch["action"], batch["valid"], mesh, n)


def _grads(loss: torch.Tensor, leaves) -> Dict:
    """d loss / d leaves in ``leaves``' layout, zeros where it does not
    reach."""
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return tree_unflatten(leaves, [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(flat, grads)])


def ce_train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    model_cfg: ModelConfig,
    opt: Adam,
    mesh=None,
    data_axis: Optional[str] = None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One supervised CE step. Moves ``state``'s params and moments in
    place and returns it with the step advanced, and the metrics."""
    loss, grads = loss_and_grads(state.params, batch, model_cfg, state.generator, mesh, data_axis)
    opt.update(grads, state.opt_state, state.params)
    state.step += 1
    return state, {"sup_loss": loss, "q_loss": torch.zeros_like(loss)}


def _q_at(h, head, idx, lz=None) -> torch.Tensor:
    """(B, K) Q values of ``head`` at the actions ``idx``: from the lazy
    step's sorted rows of the trained head (``lz["rows"]``, taken back to
    batch order, so their gradient lands on the sorted rows), as a row
    gather of an action-major head, or as a column gather of a canonical
    one."""
    if lz is not None and "rows" in lz:
        w_rows, b_cols, inv = lz["rows"]
        return q_from_rows(h, w_rows[inv], b_cols[:, inv])
    if "kernel_am" in head:
        b = head["bias"]
        return q_from_rows(h, *gather_qhead_rows(head["kernel_am"], b, idx,
                                                 b.shape[0] if b.dim() == 2 else 1))
    if head["kernel"].dim() == 2:
        return row_logit(h, head["kernel"], head["bias"], idx)[:, None]
    return multihead_row_logit(h, head["kernel"], head["bias"], idx)


def _kernel(head) -> Tuple[torch.Tensor, bool]:
    """(W, action_major) of a canonical or action-major head, for B5/B6."""
    return (head["kernel_am"], True) if "kernel_am" in head else (head["kernel"], False)


def _sqn_loss(p_main, p_boot, batch, cfg: ModelConfig, rl: RLStepConfig, aux, lz=None,
              mesh=None):
    """(total, sup_loss, q_loss, target action) of the sqn step with
    ``p_main`` the trained net. On the lazy paths ``lz`` holds the
    embedding rows (``x_emb``) and/or the trained head's sorted rows
    (``rows``) that autograd differentiates; an action-major head takes
    B5's action-major form. On a ``mesh``, the sharded ops."""
    boot_len = batch["true_len"] if rl.compat_boot_len_bug else batch["true_next_len"]
    not_end = 1.0 - batch["is_end"].to(torch.float32)
    n = batch.get("n_valid")
    if cfg.fused_ce:
        h = apply_features(p_main, cfg, batch["state"], batch["true_len"],
                           inputs_embeds=None if lz is None else lz.get("x_emb"), mesh=mesh)
        sup_loss = _fused_sup_ce(p_main, cfg, h, batch["action"], batch["valid"], mesh, n)
        qh, qb = p_main["q_head"], p_boot["q_head"]
        # the head whole on this rank: no mesh, or the lazy head replicated
        whole = mesh is None or "kernel_am" in qh
        if whole:
            q = _q_at(h, qh, batch["action"], lz)[:, 0]
        else:
            q = sharded_row_logit(h, qh["kernel"], qh["bias"], batch["action"], mesh)
        with torch.no_grad():
            h_next = apply_features(p_main, cfg, batch["next_state"], batch["true_next_len"],
                                    mesh=mesh)
            h_next_boot = apply_features(p_boot, cfg, batch["next_state"], boot_len, mesh=mesh)
            if whole:
                w, am = _kernel(qh)
                if mesh is None:
                    max_a_next = fused_linear_argmax(
                        h_next, w, qh["bias"], cfg.action_dim, cfg.head_precision,
                        action_major=am
                    )
                else:  # the data-parallel island: B5 am on this rank's rows
                    max_a_next = dp_linear_argmax_am(h_next, w, qh["bias"], cfg.action_dim, mesh,
                                                     cfg.head_precision)
                q_next_boot = _q_at(h_next_boot, qb, max_a_next)[:, 0]
            else:
                max_a_next = sharded_linear_argmax(
                    h_next, qh["kernel"], qh["bias"], cfg.action_dim, mesh, cfg.head_precision
                )
                q_next_boot = sharded_row_logit(h_next_boot, qb["kernel"], qb["bias"],
                                                max_a_next, mesh)
    else:
        sup, q_out = apply_model(p_main, cfg, batch["state"], batch["true_len"], mesh=mesh)
        sup_loss = _ce_loss(sup, batch["action"], batch["valid"], mesh, n)
        q = _take(q_out, batch["action"], mesh)
        with torch.no_grad():
            # target: r + gamma Q_boot(s', argmax_a Q_main(s', a)), zero at ends
            q_next = apply_model(p_main, cfg, batch["next_state"], batch["true_next_len"],
                                 mesh=mesh)[1]
            max_a_next = torch.argmax(q_next, dim=1) if mesh is None else sharded_argmax(
                q_next, mesh)
            q_boot_all = apply_model(p_boot, cfg, batch["next_state"], boot_len, mesh=mesh)[1]
            q_next_boot = _take(q_boot_all, max_a_next, mesh)
    q_next_boot = q_next_boot * not_end
    td = batch["reward"] + rl.gamma * q_next_boot - q
    q_loss = _masked_mean(td**2, batch["valid"], n)
    return q_loss + sup_loss, sup_loss, q_loss, max_a_next


def _take(values: torch.Tensor, idx: torch.Tensor, mesh) -> torch.Tensor:
    """Each row's value at ``idx`` of (B, A) or (B, K, A) values (on a
    mesh, of this rank's column shard of them) -> (B,) or (B, K)."""
    if mesh is not None:
        return sharded_take(values, idx, mesh)
    if values.dim() == 2:
        return values.gather(1, idx.long()[:, None])[:, 0]
    return gather_from_3d(values, idx)


def _smorl_loss(p_main, p_boot, batch, cfg: ModelConfig, rl: RLStepConfig, aux, lz=None,
                mesh=None):
    """(total, sup_loss, q_loss, target action) of the smorl step with
    ``p_main`` the trained net: K reward heads, the accuracy reward from the
    batch and the diversity and novelty rewards from the supervised head's
    top-k (no gradient). ``lz`` as :func:`_sqn_loss`'s; an action-major
    head takes B6's action-major form. On a ``mesh``, the sharded ops."""
    K = cfg.num_q_heads
    w = aux["q_weights"]
    boot_len = batch["true_len"] if rl.compat_boot_len_bug else batch["true_next_len"]
    div_len = batch["true_next_len"] if rl.compat_div_len_bug else batch["true_len"]
    not_end = 1.0 - batch["is_end"].to(torch.float32)
    # the top-k width the online rewards read from the supervised head
    k_need = max(rl.topk_div if K >= 2 else 0, rl.topk_nov if K >= 3 else 0)
    top_i = None
    n = batch.get("n_valid")
    if cfg.fused_ce:
        h = apply_features(p_main, cfg, batch["state"], batch["true_len"],
                           inputs_embeds=None if lz is None else lz.get("x_emb"), mesh=mesh)
        sh = p_main["sup_head"]
        if k_need:
            h32 = h.to(torch.float32)
            if mesh is None:
                per_ce, top_i = fused_softmax_ce_topk(
                    h32, sh["kernel"], sh["bias"], batch["action"], k_need,
                    cfg.action_dim, cfg.head_precision,
                )
            else:
                per_ce, top_i = sharded_fused_softmax_ce_topk(
                    h32, sh["kernel"], sh["bias"], batch["action"], k_need, mesh,
                    cfg.action_dim, None, cfg.head_precision,
                )
            sup_loss = _masked_mean(per_ce, batch["valid"], n)
        else:
            sup_loss = _fused_sup_ce(p_main, cfg, h, batch["action"], batch["valid"], mesh, n)
        qh, qb = p_main["q_heads"], p_boot["q_heads"]
        whole = mesh is None or "kernel_am" in qh  # as in _sqn_loss
        if whole:
            q = _q_at(h, qh, batch["action"], lz)  # (B, K)
        else:
            q = sharded_multihead_row_logit(h, qh["kernel"], qh["bias"], batch["action"], mesh)
        with torch.no_grad():
            h_next = apply_features(p_main, cfg, batch["next_state"], batch["true_next_len"],
                                    mesh=mesh)
            h_next_boot = apply_features(p_boot, cfg, batch["next_state"], boot_len, mesh=mesh)
            if whole:
                wk, am = _kernel(qh)
                if mesh is None:
                    max_a_next = fused_weighted_multihead_argmax(
                        h_next, wk, qh["bias"], w, cfg.action_dim, cfg.head_precision,
                        action_major=am
                    )
                else:  # the data-parallel island: B6 am on this rank's rows
                    max_a_next = dp_weighted_multihead_argmax_am(
                        h_next, wk, qh["bias"], w, cfg.action_dim, mesh, cfg.head_precision)
                q_next_boot = _q_at(h_next_boot, qb, max_a_next)
            else:
                max_a_next = sharded_weighted_multihead_argmax(
                    h_next, qh["kernel"], qh["bias"], w, cfg.action_dim, mesh,
                    cfg.head_precision
                )
                q_next_boot = sharded_multihead_row_logit(h_next_boot, qb["kernel"], qb["bias"],
                                                          max_a_next, mesh)
    else:
        sup, q_all = apply_model(p_main, cfg, batch["state"], batch["true_len"], mesh=mesh)
        sup_loss = _ce_loss(sup, batch["action"], batch["valid"], mesh, n)
        if k_need:
            top_i = (topk_lowest_id(sup.detach(), k_need) if mesh is None
                     else sharded_top_k(sup, k_need, mesh))[1]
        q = _take(q_all, batch["action"], mesh)  # (B, K)
        with torch.no_grad():
            # a* maximizes the main net's weighted head sum on s'
            q_out_next = apply_model(p_main, cfg, batch["next_state"], batch["true_next_len"],
                                     mesh=mesh)[1]
            weighted = get_weighted_q_target(q_out_next, w)
            max_a_next = get_max_action(weighted) if mesh is None else sharded_argmax(
                weighted, mesh)
            q_out_boot = apply_model(p_boot, cfg, batch["next_state"], boot_len, mesh=mesh)[1]
            q_next_boot = _take(q_out_boot, max_a_next, mesh)  # (B, K)
    q_next_boot = q_next_boot * not_end[:, None]

    rewards = [batch["reward"]]
    if K >= 2:
        rewards.append(diversity_from_topk(
            batch["state"], top_i[:, : rl.topk_div], div_len, rl.padding_pos,
            aux["div_embedding"], out_to_in=aux["out_to_in"],
        ))
    if K >= 3:
        rewards.append(novelty_from_topk(
            top_i[:, : rl.topk_nov], aux["unpopular_mask"], rl.nov_rew_sig
        ))
    r = torch.stack(rewards, dim=1).to(torch.float32)  # (B, K)

    td = (r + rl.gamma * q_next_boot - q) ** 2  # (B, K)
    q_loss = _masked_mean(weighted_q_loss(td, w), batch["valid"], n)
    return sup_loss + rl.alpha * q_loss, sup_loss, q_loss, max_a_next


def double_q_loss_and_grads(
    params: Tuple[Dict, Dict],
    batch: Dict[str, torch.Tensor],
    model_cfg: ModelConfig,
    rl: RLStepConfig,
    main: int,
    aux: Dict,
    mesh=None,
    data_axis: Optional[str] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(metrics, grads) of the sqn or smorl step with net ``main`` of the
    pair trained and the other one the bootstrap: ``sup_loss``, ``q_loss``
    and ``target_action`` (the main net's best next action, (B,)), and the
    main net's gradients with the pad row's masked. ``aux`` holds the
    device tensors that :func:`make_train_step` prepares. On a ``mesh``,
    the global losses and this rank's slice of the gradients."""
    loss_fn = _sqn_loss if model_cfg.family == "sqn" else _smorl_loss
    batch = _count_valid(batch, mesh, data_axis)
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params[main])
    with torch.enable_grad():
        total, sup_loss, q_loss, target = loss_fn(
            leaves, params[1 - main], batch, model_cfg, rl, aux, mesh=mesh
        )
        grads = _grads(total, leaves)
    metrics = {"sup_loss": sup_loss.detach(), "q_loss": q_loss.detach(), "target_action": target}
    return _over_data(metrics, _apply_grad_mask(grads, model_cfg, mesh), mesh, data_axis)


def _main_net(state, model_cfg: ModelConfig, coin: Optional[int]) -> int:
    """This step's main net: ``coin`` when given, else the state
    generator's draw; the generator advances one draw either way."""
    if not isinstance(state, DoubleQState):
        raise TypeError(f"the {model_cfg.family} step takes a DoubleQState, got {type(state).__name__}")
    drawn = int(torch.randint(0, 2, (), generator=state.generator))
    if coin is None:
        coin = drawn
    if coin not in (0, 1):
        raise ValueError(f"coin must be 0 or 1, got {coin!r}")
    return int(coin)


def double_q_train_step(
    state: DoubleQState,
    batch: Dict[str, torch.Tensor],
    model_cfg: ModelConfig,
    opt: Adam,
    rl: RLStepConfig,
    aux: Dict,
    coin: Optional[int] = None,
    mesh=None,
    data_axis: Optional[str] = None,
) -> Tuple[DoubleQState, Dict[str, torch.Tensor]]:
    """One sqn or smorl step (the reference's ``_double_q_run``). The coin
    (0 or 1: the main net) is ``coin`` when given, else the state
    generator's draw; the generator advances one draw every step either way,
    so later coins do not depend on which ones were given. With two
    optimizers only the main net's params and moments move; with one over
    the pair the other net takes zero gradients and still moves under its
    moments, as in the reference."""
    main = _main_net(state, model_cfg, coin)
    metrics, grads = double_q_loss_and_grads(state.params, batch, model_cfg, rl, main, aux,
                                             mesh, data_axis)
    if rl.single_optimizer:
        zeros = tree_map(torch.zeros_like, state.params[1 - main])
        pair = (grads, zeros) if main == 0 else (zeros, grads)
        opt.update(pair, state.opt_state, state.params)
    else:
        opt.update(grads, state.opt_state[main], state.params[main])
    state.step += 1
    return state, metrics


def _sarm_loss(params, batch, cfg: ModelConfig, rl: RLStepConfig, lz=None, mesh=None):
    """(total, sup_loss, q_loss) of the sarm step: the CE on head 0 plus
    the mean over the heads of each head's masked-mean TD loss. On the lazy
    Q-head layout head 0 is ``kernel0`` (dense: the CE's gradient reaches
    every column) and heads 1-4 are action-major rows: Q(s, a) their sorted
    rows from ``lz``, the target max :func:`blockwise_multihead_max` on
    head 0 joined with :func:`blockwise_multihead_max_am` on the rest. On a
    ``mesh``, the sharded ops."""
    not_end = 1.0 - batch["is_end"].to(torch.float32)
    n = batch.get("n_valid")
    if cfg.fused_ce:
        h = apply_features(params, cfg, batch["state"], batch["true_len"],
                           inputs_embeds=None if lz is None else lz.get("x_emb"), mesh=mesh)
        qh = params["q_heads"]
        lazy_qh = "kernel0" in qh
        k0, b0 = (qh["kernel0"], qh["bias0"]) if lazy_qh else (qh["kernel"][0], qh["bias"][0])
        h32 = h.to(torch.float32)
        if mesh is None:
            per = fused_softmax_ce(h32, k0, b0, batch["action"], cfg.action_dim,
                                   cfg.head_precision)
        else:
            per = sharded_fused_softmax_ce(h32, k0, b0, batch["action"], mesh, cfg.action_dim,
                                           None, cfg.head_precision)
        sup_loss = _masked_mean(per, batch["valid"], n)
        rest = {"kernel_am": qh["kernel_am"], "bias": qh["bias_rest"]} if lazy_qh else None
        if lazy_qh:
            q = torch.cat([row_logit(h, k0, b0, batch["action"])[:, None],
                           _q_at(h, rest, batch["action"], lz)], dim=1)
        elif mesh is not None:
            q = sharded_multihead_row_logit(h, qh["kernel"], qh["bias"], batch["action"], mesh)
        else:
            q = multihead_row_logit(h, qh["kernel"], qh["bias"], batch["action"])  # (B, 5)
        with torch.no_grad():
            h_next = apply_features(params, cfg, batch["next_state"], batch["true_next_len"],
                                    mesh=mesh)
            if mesh is not None:
                q_next = sharded_multihead_max(h_next, qh["kernel"], qh["bias"], cfg.action_dim,
                                               mesh, precision=cfg.head_precision)
            elif lazy_qh:
                q_next = torch.cat([
                    blockwise_multihead_max(h_next, k0[None], b0[None], cfg.action_dim,
                                            precision=cfg.head_precision),
                    blockwise_multihead_max_am(h_next, rest["kernel_am"], rest["bias"],
                                               cfg.action_dim, precision=cfg.head_precision),
                ], dim=1)
            else:
                q_next = blockwise_multihead_max(
                    h_next, qh["kernel"], qh["bias"], cfg.action_dim,
                    precision=cfg.head_precision
                )  # (B, 5)
    else:
        outs = apply_model(params, cfg, batch["state"], batch["true_len"], mesh=mesh)
        sup_loss = _ce_loss(outs[0], batch["action"], batch["valid"], mesh, n)
        q = _take(torch.stack(outs, dim=1), batch["action"], mesh)  # (B, 5)
        with torch.no_grad():
            outs_next = apply_model(params, cfg, batch["next_state"], batch["true_next_len"],
                                    mesh=mesh)
            q_next = torch.stack(outs_next, dim=1).amax(dim=2)  # (B, 5)
            if mesh is not None:
                q_next = mesh.all_reduce(q_next, "max", MODEL_AXIS)
    # each head bootstraps from its own max, zero at episode ends
    q_next = q_next * not_end[:, None]
    td = (batch["reward"][:, None] + rl.sarm_gamma * q_next - q) ** 2
    valid = batch["valid"]
    n = torch.clamp(valid.sum() if n is None else n, min=1)
    q_loss = torch.mean((td * valid[:, None].to(td.dtype)).sum(dim=0) / n)
    return sup_loss + q_loss, sup_loss, q_loss


def sarm_loss_and_grads(
    params: Dict, batch: Dict[str, torch.Tensor], model_cfg: ModelConfig, rl: RLStepConfig,
    mesh=None, data_axis: Optional[str] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(metrics, grads) of the sarm step at ``params``: ``sup_loss`` and
    ``q_loss``, and the gradients with the pad row's masked. Head 0 takes
    the CE's gradient (B2 on the card) and its Q gather's in one leaf. On a
    ``mesh``, the global losses and this rank's slice of the gradients."""
    batch = _count_valid(batch, mesh, data_axis)
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        total, sup_loss, q_loss = _sarm_loss(leaves, batch, model_cfg, rl, mesh=mesh)
        grads = _grads(total, leaves)
    metrics = {"sup_loss": sup_loss.detach(), "q_loss": q_loss.detach()}
    return _over_data(metrics, _apply_grad_mask(grads, model_cfg, mesh), mesh, data_axis)


def sarm_train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    model_cfg: ModelConfig,
    opt: Adam,
    rl: RLStepConfig,
    mesh=None,
    data_axis: Optional[str] = None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One sarm step. Moves ``state``'s params and moments in place and
    returns it with the step advanced, and the metrics."""
    metrics, grads = sarm_loss_and_grads(state.params, batch, model_cfg, rl, mesh, data_axis)
    opt.update(grads, state.opt_state, state.params)
    state.step += 1
    return state, metrics


# ---------------------------------------------------------------------------
# The lazy optimizers' steps (train/lazy_adam.py; reference
# ``ce_train_step_lazy``, ``_lazy_double_q_run``, ``_lazy_diff_parts``,
# ``_dense_part``, ``_q_from_rows``, ``_lazy_apply_updates`` and the three
# ``*_train_step_lazy``)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LazyCfg:
    """Which parts take lazy Adam, at which learning rate."""

    emb_lr: Optional[float] = None  # lazy-row embedding Adam
    qh_lr: Optional[float] = None  # lazy-row Q-head Adam, action-major

    @property
    def on(self) -> bool:
        return self.emb_lr is not None or self.qh_lr is not None


def _lazy_diff(p: Dict, model_cfg: ModelConfig, lazy: LazyCfg, batch, mesh=None
               ) -> Tuple[Dict, Dict]:
    """(diff, pieces) of one net on the lazy paths. ``diff`` holds the
    leaves autograd differentiates, fresh: ``dense`` (the tree dense Adam
    owns, ``train.state.dense_part``), and the rows gathered outside
    autograd whose gradients drive the sparse updates: ``x_emb`` (B, T, E)
    embedding rows, and ``w_rows`` (B, K, F) / ``b_cols`` (K, B) of the Q
    head at the batch's actions in sorted order. ``pieces`` keeps the
    embedding ids, the sorted actions, the inverse permutation and the
    gathered rows. On a ``mesh`` whose model axis splits the table, the
    rows are the owner-masked gather summed over the model axis, as the
    dense arm's backbone gathers them; the lazy Q head is replicated, so
    its rows are this rank's own."""
    family = model_cfg.family
    lazy_emb, lazy_qh = lazy.emb_lr is not None, lazy.qh_lr is not None
    dense = dense_part(p, family, lazy_emb, lazy_qh)
    diff = {"dense": tree_map(lambda t: t.detach().requires_grad_(), dense)}
    pieces: Dict = {}
    if lazy_emb:
        table, states = p["backbone"]["embedding"], batch["state"]
        with torch.no_grad():
            if embedding_rows(model_cfg.backbone, mesh)[0] < model_cfg.backbone.num_embeddings:
                x = sharded_embedding_lookup(table, states, mesh)
            else:
                x = table[states.long()]
        diff["x_emb"] = x.detach().requires_grad_()
        pieces["emb_ids"] = states.reshape(-1)
    if lazy_qh:
        qh = p[QH_KEY[family]]
        b = qh["bias_rest"] if family == "sarm" else qh["bias"]
        sids, inv = sort_batch_ids(batch["action"])
        w_rows, b_cols = gather_qhead_rows(qh["kernel_am"], b, sids,
                                           b.shape[0] if b.dim() == 2 else 1)
        diff["w_rows"] = w_rows.detach().requires_grad_()
        diff["b_cols"] = b_cols.detach().requires_grad_()
        pieces.update(sids=sids, inv=inv, w_rows=w_rows, b_cols=b_cols)
    return diff, pieces


def _lazy_view(p: Dict, diff: Dict, pieces: Dict, family: str) -> Tuple[Dict, Dict]:
    """(params, lz) for the loss functions: ``p`` with its dense leaves
    replaced by ``diff``'s (the embedding table and the action-major head
    stay as they are, read without gradient by the next-state forwards, B5,
    B6 and the target max), and ``lz``: the differentiated rows, ``x_emb``
    and ``rows`` (the head's sorted rows and the permutation back to batch
    order)."""
    dense = diff["dense"]
    view = dict(dense["rest"])
    lz: Dict = {}
    if "x_emb" in diff:
        view["backbone"] = {**view["backbone"], "embedding": p["backbone"]["embedding"]}
        lz["x_emb"] = diff["x_emb"]
    if "w_rows" in diff:
        key = QH_KEY[family]
        view[key] = dict(p[key])
        if family == "sarm":
            view[key].update(kernel0=dense["h0"]["kernel"], bias0=dense["h0"]["bias"])
        lz["rows"] = (diff["w_rows"], diff["b_cols"], pieces["inv"])
    return view, lz


def _lazy_grads(total, diff, lazy: LazyCfg, model_cfg: ModelConfig, mesh=None) -> Dict:
    grads = _grads(total, diff)
    if lazy.emb_lr is None:  # the table is dense: its pad row's gradient masked
        grads["dense"]["rest"] = _apply_grad_mask(grads["dense"]["rest"], model_cfg, mesh)
    return grads


def _as_f32(ids: torch.Tensor) -> torch.Tensor:
    """int ids as float32 bits, so that they cross in one buffer with the
    gradients (a collective copies bits; :func:`_as_ids` reads them back)."""
    return ids.to(torch.int32).view(torch.float32)


def _as_ids(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).long()


def _lazy_over_data(metrics: Dict, grads: Dict, pieces: Dict, mesh, data_axis
                    ) -> Tuple[Dict, Dict, Dict]:
    """(metrics, grads, pieces) of the global batch where it is split over
    a mesh's data axis: the loss metrics and the dense gradients summed
    over it (``_over_data``), and the lazy rows' ids and gradients gathered
    over it in one collective, in data-index order, so that the row
    updates see the global batch's rows in its own order. The embedding's
    (ids, row gradients) travel as (B T, 1 + E) and the Q head's (batch
    actions, weight rows, bias entries) as (B, 1 + K F + K), both in batch
    order; the Q head's are sorted again after the gather."""
    metrics, dense = _over_data(metrics, grads["dense"], mesh, data_axis)
    grads = {**grads, "dense": dense}
    if mesh is None or data_axis is None or mesh.size(DATA_AXIS) == 1:
        return metrics, grads, pieces
    parts = {}
    if "x_emb" in grads:
        g = grads["x_emb"]
        parts["emb"] = torch.cat([_as_f32(pieces["emb_ids"])[:, None],
                                  g.reshape(-1, g.shape[-1]).to(torch.float32)], dim=1)
    K = 0
    if "w_rows" in grads:
        inv, gw, gb = pieces["inv"], grads["w_rows"], grads["b_cols"]
        B, K, Fd = gw.shape
        actions = pieces["sids"][inv]  # batch order
        parts["qh"] = torch.cat([_as_f32(actions)[:, None], gw[inv].reshape(B, K * Fd),
                                 gb[:, inv].T], dim=1)
    flat = mesh.gather(torch.cat([x.reshape(-1) for x in parts.values()]), DATA_AXIS)  # (D, n)
    pieces, at = dict(pieces), 0
    for kind, x in parts.items():
        w = x.shape[1]
        rows = flat[:, at:at + x.numel()].reshape(-1, w)  # the global batch's, in order
        at += x.numel()
        if kind == "emb":
            pieces["emb_ids"] = _as_ids(rows[:, 0])
            grads["x_emb"] = rows[:, 1:]
        else:
            sids, order = torch.sort(_as_ids(rows[:, 0]), stable=True)
            rows = rows[order]
            grads["w_rows"] = rows[:, 1:w - K].reshape(len(sids), K, -1)
            grads["b_cols"] = rows[:, w - K:].T
            # the update gathers the global sorted rows from the replicated head
            pieces.update(sids=sids, w_rows=None, b_cols=None)
    return metrics, grads, pieces


def lazy_apply_updates(p: Dict, grads: Dict, pieces: Dict, opt_state: LazyAdamState, opt: Adam,
                       family: str, model_cfg: ModelConfig, lazy: LazyCfg, mesh=None) -> None:
    """Dense Adam on the dense part, lazy Adam on the touched embedding rows
    and/or Q-head rows (bias-corrected with the net's count before this
    update), in place; then the count advances. On a ``mesh`` each rank
    updates the rows of its block of the table (the frozen pad row on its
    owner) and the whole replicated Q head, from the global batch's rows
    (:func:`_lazy_over_data`), so the Q head's replicas stay bit-equal."""
    lazy_emb, lazy_qh = lazy.emb_lr is not None, lazy.qh_lr is not None
    opt.update(grads["dense"], opt_state.rest, dense_part(p, family, lazy_emb, lazy_qh))
    if lazy_emb:
        bb = model_cfg.backbone
        g_x = grads["x_emb"]
        rows, first = embedding_rows(bb, mesh)
        emb_adam_update(p["backbone"]["embedding"], opt_state.emb, pieces["emb_ids"],
                        g_x.reshape(-1, g_x.shape[-1]), opt_state.count, lazy.emb_lr,
                        frozen_row=None if bb.train_pad_embed else bb.padding_idx,
                        row_offset=None if rows == bb.num_embeddings else first)
    if lazy_qh:
        qh = p[QH_KEY[family]]
        qhead_row_adam_update(
            qh["kernel_am"], qh["bias_rest"] if family == "sarm" else qh["bias"], opt_state.qh,
            pieces["sids"], grads["w_rows"], grads["b_cols"], opt_state.count, lazy.qh_lr,
            w_rows=pieces["w_rows"], b_cols=pieces["b_cols"],
        )
    opt_state.count += 1


def lazy_loss_and_grads(params: Dict, batch, model_cfg: ModelConfig, lazy: LazyCfg,
                        rl: Optional[RLStepConfig] = None, generator=None, *, boot=None,
                        aux: Optional[Dict] = None, mesh=None, data_axis: Optional[str] = None
                        ) -> Tuple[Dict, Dict, Dict]:
    """(metrics, grads, pieces) of one net's lazy step: the CE families'
    (``generator`` draws dropout), sarm's, or with ``boot`` (the other net
    of the pair) sqn's and smorl's. ``grads`` is in ``_lazy_diff``'s
    layout: ``dense`` (with the pad row's gradient masked where the table
    is dense), ``x_emb``, ``w_rows``, ``b_cols``. On a ``mesh`` with
    ``data_axis``, the global losses, the dense gradients summed over the
    data axis and the global batch's lazy rows (:func:`_lazy_over_data`)."""
    fam = model_cfg.family
    batch = _count_valid(batch, mesh, data_axis)
    diff, pieces = _lazy_diff(params, model_cfg, lazy, batch, mesh)
    view, lz = _lazy_view(params, diff, pieces, fam)
    with torch.enable_grad():
        if fam in ("gru4rec", "bidir_gru4rec"):
            sup_loss = total = _sup_ce_loss(view, batch, model_cfg, generator, lz.get("x_emb"),
                                            mesh, data_axis)
            metrics = {"sup_loss": sup_loss.detach(), "q_loss": torch.zeros_like(sup_loss)}
        elif fam == "sarm":
            total, sup_loss, q_loss = _sarm_loss(view, batch, model_cfg, rl, lz)
            metrics = {"sup_loss": sup_loss.detach(), "q_loss": q_loss.detach()}
        else:
            loss_fn = _sqn_loss if fam == "sqn" else _smorl_loss
            total, sup_loss, q_loss, target = loss_fn(view, boot, batch, model_cfg, rl, aux, lz,
                                                      mesh)
            metrics = {"sup_loss": sup_loss.detach(), "q_loss": q_loss.detach(),
                       "target_action": target}
        grads = _lazy_grads(total, diff, lazy, model_cfg, mesh)
    return _lazy_over_data(metrics, grads, pieces, mesh, data_axis)


def ce_train_step_lazy(state: TrainState, batch, model_cfg: ModelConfig, opt: Adam,
                       lr: float, mesh=None, data_axis: Optional[str] = None
                       ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The CE step with lazy embedding Adam (``optimizer: lazy_adam``): the
    table's rows are gathered outside autograd, and only the touched rows'
    param and moments are read or written; dense Adam owns the rest. On a
    ``mesh``, each rank updates its block of the table's rows."""
    lazy = LazyCfg(emb_lr=lr)
    metrics, grads, pieces = lazy_loss_and_grads(state.params, batch, model_cfg, lazy,
                                                 generator=state.generator, mesh=mesh,
                                                 data_axis=data_axis)
    lazy_apply_updates(state.params, grads, pieces, state.opt_state, opt, model_cfg.family,
                       model_cfg, lazy, mesh)
    state.step += 1
    return state, metrics


def lazy_double_q_train_step(state: DoubleQState, batch, model_cfg: ModelConfig, opt: Adam,
                             rl: RLStepConfig, aux: Dict, lazy: LazyCfg,
                             coin: Optional[int] = None, mesh=None,
                             data_axis: Optional[str] = None):
    """One sqn or smorl step with lazy embedding rows and/or lazy
    action-major Q-head rows: the loss of :func:`double_q_train_step`, the
    coin drawn the same way. Only the main net moves. The reference writes
    the other net's gathered rows back unchanged (``selected=False``, an
    identity write kept out of its ``lax.cond``); skipping that net leaves
    it bit for bit the same, since ``w - 0.0`` is ``w`` and a moment cast to
    fp32 and back to bf16 is unchanged. Only the main net's count
    advances. On a ``mesh`` the lazy Q head is replicated and its target
    action comes from the data-parallel island (B5 or B6 action-major on
    this rank's rows)."""
    main = _main_net(state, model_cfg, coin)
    p_main = state.params[main]
    metrics, grads, pieces = lazy_loss_and_grads(p_main, batch, model_cfg, lazy, rl,
                                                 boot=state.params[1 - main], aux=aux,
                                                 mesh=mesh, data_axis=data_axis)
    lazy_apply_updates(p_main, grads, pieces, state.opt_state[main], opt, model_cfg.family,
                       model_cfg, lazy, mesh)
    state.step += 1
    return state, metrics


def sqn_train_step(state: DoubleQState, batch, model_cfg: ModelConfig, opt: Adam,
                   rl: RLStepConfig, mesh=None, data_axis: Optional[str] = None,
                   coin: Optional[int] = None):
    """One sqn step (reference ``sqn_train_step``): :func:`double_q_train_step`
    with no aux. ``coin`` as that function takes it."""
    return double_q_train_step(state, batch, model_cfg, opt, rl, {}, coin, mesh, data_axis)


def smorl_train_step(state: DoubleQState, batch, model_cfg: ModelConfig, opt: Adam,
                     rl: RLStepConfig, div_embedding, unpopular_mask, out_to_in=None,
                     mesh=None, data_axis: Optional[str] = None, coin: Optional[int] = None):
    """One smorl step (reference ``smorl_train_step``): the frozen diversity
    embedding (V_in, E), the unpopular mask (A,) and ``out_to_in`` as
    arrays or tensors, then :func:`double_q_train_step`."""
    aux = _smorl_aux(model_cfg, rl, div_embedding, unpopular_mask, out_to_in,
                     tree_leaves(state.params)[0].device)
    return double_q_train_step(state, batch, model_cfg, opt, rl, aux, coin, mesh, data_axis)


def sqn_train_step_lazy(state, batch, model_cfg, opt, rl, lazy, coin=None, mesh=None,
                        data_axis=None):
    """The sqn step with lazy parts (reference ``sqn_train_step_lazy``)."""
    return lazy_double_q_train_step(state, batch, model_cfg, opt, rl, {}, lazy, coin, mesh,
                                    data_axis)


def smorl_train_step_lazy(state, batch, model_cfg, opt, rl, lazy, aux, coin=None, mesh=None,
                          data_axis=None):
    """The smorl step with lazy parts (reference ``smorl_train_step_lazy``);
    ``aux`` as :func:`make_train_step` prepares it."""
    return lazy_double_q_train_step(state, batch, model_cfg, opt, rl, aux, lazy, coin, mesh,
                                    data_axis)


def sarm_train_step_lazy(state: TrainState, batch, model_cfg: ModelConfig, opt: Adam,
                         rl: RLStepConfig, lazy: LazyCfg):
    """The sarm step with lazy embedding rows and/or lazy Q-head rows: head
    0 stays under dense Adam (the ``h0`` leaf), heads 1-4 take lazy rows.
    The loss of :func:`sarm_train_step`."""
    metrics, grads, pieces = lazy_loss_and_grads(state.params, batch, model_cfg, lazy, rl)
    lazy_apply_updates(state.params, grads, pieces, state.opt_state, opt, "sarm", model_cfg,
                       lazy)
    state.step += 1
    return state, metrics


def _smorl_aux(model_cfg: ModelConfig, rl: RLStepConfig, div_embedding, unpopular_mask,
               out_to_in, dev) -> Dict:
    """The device tensors the smorl step reads besides the batch."""
    if div_embedding is None or unpopular_mask is None:
        raise ValueError("SMORL needs div_embedding and unpopular_mask")
    K = model_cfg.num_q_heads
    if len(rl.q_weights) < K:
        raise ValueError(f"q_weights {rl.q_weights} has fewer than the {K} heads")
    return {
        "q_weights": torch.tensor(rl.q_weights[:K], dtype=torch.float32, device=dev),
        "div_embedding": torch.as_tensor(div_embedding, dtype=torch.float32, device=dev),
        "unpopular_mask": torch.as_tensor(unpopular_mask, device=dev).to(torch.bool),
        "out_to_in": None if out_to_in is None else torch.as_tensor(out_to_in, device=dev),
    }


class TrainStep:
    """``step(state, batch) -> (state, metrics)`` on one device. The
    batch's arrays (numpy or tensors) are copied to the device; the state
    must already lie there. The double-Q steps also take ``coin=``.
    ``aux`` holds the device tensors the step reads besides the batch."""

    def __init__(self, raw: Callable, device: torch.device, aux: Optional[Dict] = None):
        self.raw = raw
        self.device = device
        self.aux = {} if aux is None else aux

    def __call__(self, state, batch, **kw):
        leaf = tree_leaves(state.params)[0]
        if leaf.device.type != self.device.type:
            raise ValueError(f"the state lies on {leaf.device}, the step runs on {self.device}")
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        return self.raw(state, batch, **kw)


def make_train_step(
    model_cfg: ModelConfig,
    opt: Adam,
    rl: Optional[RLStepConfig] = None,
    *,
    div_embedding=None,
    unpopular_mask=None,
    out_to_in=None,
    lazy_embedding_lr: Optional[float] = None,
    lazy_qhead_lr: Optional[float] = None,
    mesh=None,
    data_axis: Optional[str] = None,
    device="cuda",
) -> TrainStep:
    """Build ``step(state, batch) -> (state, metrics)`` for the family on
    ``device`` (raises without CUDA unless ``device="cpu"``): the CE step of
    gru4rec and bidir_gru4rec and the sarm step on a :class:`TrainState`,
    the double-Q step of sqn and smorl on a :class:`DoubleQState`. ``rl`` defaults to
    ``RLStepConfig()``. smorl needs ``div_embedding`` (V_in, E), the frozen
    embedding of the diversity reward, and ``unpopular_mask`` (A,) bool;
    ``out_to_in`` (A,) maps output ids to input ids for the diversity reward.
    They are arrays or tensors and are copied to the device once.

    ``lazy_embedding_lr``: lazy embedding Adam at this learning rate;
    ``lazy_qhead_lr``: lazy action-major Q-head Adam (sqn, smorl, sarm).
    Both take the states of the matching lazy builders
    (``train/state.py``); on the Q families they need the fused path and
    two optimizers.

    ``mesh`` (``core/mesh.py``): the step on this rank's slice of the
    params (``parallel/sharding.py::shard_state``), the model built with
    ``model_config_from_train(..., align=n_model)`` so that the model axis
    divides the padded action dim; with ``data_axis="data"`` the batch is
    this rank's rows of a batch split over the data axis. ``device`` must
    be the mesh's. The lazy optimizers run on a mesh for every family but
    sarm, whose lazy layout splits off a densely updated head 0 (the
    reference's "mesh + lazy is not supported for sarm")."""
    dev = resolve_device(device)
    fam = model_cfg.family
    rl = RLStepConfig() if rl is None else rl
    lazy = LazyCfg(emb_lr=lazy_embedding_lr, qh_lr=lazy_qhead_lr)
    if lazy_qhead_lr is not None and fam not in QH_KEY:
        raise ValueError("qhead_optimizer='lazy_adam' needs a Q family")
    if mesh is not None:
        _check_mesh(model_cfg, mesh, data_axis, dev, lazy)
    if lazy.on and fam in QH_KEY:
        if not model_cfg.fused_ce:
            raise ValueError("lazy optimizers require the fused train path")
        if rl.single_optimizer and fam != "sarm":
            raise ValueError("lazy optimizers need double_q_optimizers=2")
    if fam in ("gru4rec", "bidir_gru4rec"):
        if lazy.on:
            return TrainStep(lambda state, batch: ce_train_step_lazy(
                state, batch, model_cfg, opt, lazy_embedding_lr, mesh, data_axis), dev)
        return TrainStep(lambda state, batch: ce_train_step(
            state, batch, model_cfg, opt, mesh, data_axis), dev)
    if fam == "sarm":
        if lazy.on:
            return TrainStep(lambda state, batch: sarm_train_step_lazy(
                state, batch, model_cfg, opt, rl, lazy), dev)
        return TrainStep(
            lambda state, batch: sarm_train_step(state, batch, model_cfg, opt, rl, mesh,
                                                 data_axis), dev
        )
    aux: Dict = {}
    if fam == "smorl":
        aux = _smorl_aux(model_cfg, rl, div_embedding, unpopular_mask, out_to_in, dev)
    if lazy.on and fam == "sqn":
        return TrainStep(lambda state, batch, coin=None: sqn_train_step_lazy(
            state, batch, model_cfg, opt, rl, lazy, coin, mesh, data_axis), dev, aux)
    if lazy.on:
        return TrainStep(lambda state, batch, coin=None: smorl_train_step_lazy(
            state, batch, model_cfg, opt, rl, lazy, aux, coin, mesh, data_axis), dev, aux)
    return TrainStep(
        lambda state, batch, coin=None: double_q_train_step(
            state, batch, model_cfg, opt, rl, aux, coin, mesh, data_axis
        ),
        dev,
        aux,
    )


# the dtypes of the batch columns every step takes, as the trainer feeds them
_BATCH_DTYPES = {
    "state": torch.int32,
    "action": torch.int32,
    "reward": torch.float32,
    "next_state": torch.int32,
    "true_len": torch.int32,
    "true_next_len": torch.int32,
    "is_end": torch.bool,
    "valid": torch.bool,
}


def batch_to_device_dict(batch, device="cuda") -> Dict[str, torch.Tensor]:
    """``data.replay_buffer.Batch`` -> the dict of tensors on ``device``
    (raises without CUDA unless ``device="cpu"``) that the steps take."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(getattr(batch, k)).to(device=dev, dtype=dt)
            for k, dt in _BATCH_DTYPES.items()}


def _check_mesh(model_cfg: ModelConfig, mesh, data_axis, dev: torch.device, lazy: LazyCfg):
    """Raises for a step the mesh cannot take."""
    if lazy.on and model_cfg.family == "sarm":
        raise ValueError("mesh + lazy is not supported for sarm")
    if data_axis not in (None, DATA_AXIS):
        raise ValueError(f"data_axis must be None or {DATA_AXIS!r}, got {data_axis!r}")
    if mesh.device.type != dev.type:
        raise ValueError(f"the mesh lies on {mesh.device}, the step runs on {dev}")
    n = mesh.size(MODEL_AXIS)
    if model_cfg.padded_action_dim % n:
        raise ValueError(
            f"padded action dim {model_cfg.padded_action_dim} not divisible by model axis {n}: "
            "build the model with model_config_from_train(..., align=n_model)")
