"""Train steps: the supervised CE step of gru4rec and bidir_gru4rec, the
double-Q steps of sqn and smorl, and the self-bootstrapped step of sarm.

Port of ``ikea_recommender_tpu/train/steps.py`` (``RLStepConfig``,
``_masked_mean``, ``_ce_loss``, ``_fused_sup_ce``, ``_apply_grad_mask``,
``ce_train_step``, ``_double_q_run``, ``sqn_train_step``,
``smorl_train_step``, ``sarm_train_step``, ``TrainStep`` and
``make_train_step``).

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

Batches are dicts of arrays: ``state`` (B, T) int, ``action`` (B,) int,
``true_len`` (B,) int and ``valid`` (B,) bool, the mask of a padded tail
batch; the double-Q and sarm steps also read ``reward`` (B,) float,
``next_state`` (B, T), ``true_next_len`` (B,) and ``is_end`` (B,) bool.
Every mean is a masked mean. The steps return their metrics as device tensors and never
wait on the device themselves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ikea_recommender_tpu_torch.convert import tree_leaves, tree_map, tree_unflatten
from ikea_recommender_tpu_torch.core.device import resolve_device
from ikea_recommender_tpu_torch.models.backbone import embedding_grad_mask
from ikea_recommender_tpu_torch.models.families import (
    ModelConfig,
    apply_features,
    apply_model,
)
from ikea_recommender_tpu_torch.ops.fused_argmax import (
    fused_linear_argmax,
    fused_weighted_multihead_argmax,
    multihead_row_logit,
    row_logit,
)
from ikea_recommender_tpu_torch.ops.fused_ce import fused_softmax_ce, fused_softmax_ce_topk
from ikea_recommender_tpu_torch.ops.fused_topk import blockwise_multihead_max, topk_lowest_id
from ikea_recommender_tpu_torch.ops.rewards import diversity_from_topk, novelty_from_topk
from ikea_recommender_tpu_torch.ops.rl import (
    gather_from_3d,
    get_max_action,
    get_weighted_q_target,
    weighted_q_loss,
)
from ikea_recommender_tpu_torch.train.state import Adam, DoubleQState, TrainState

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


def _masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    w = valid.to(x.dtype)
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)


def _ce_loss(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    per = F.cross_entropy(logits, labels.long(), reduction="none")
    return _masked_mean(per, valid)


def _fused_sup_ce(
    params: Dict, cfg: ModelConfig, h: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Supervised CE through the fused kernels, the same masked mean as
    :func:`_ce_loss` over ``mask_pad_logits``-masked logits."""
    head = params["sup_head"]
    per = fused_softmax_ce(
        h.to(torch.float32), head["kernel"], head["bias"], labels,
        cfg.action_dim, cfg.head_precision,
    )
    return _masked_mean(per, valid)


def _apply_grad_mask(grads: Dict, model_cfg: ModelConfig) -> Dict:
    emb = grads["backbone"]["embedding"]
    mask = embedding_grad_mask(model_cfg.backbone, emb.device)
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
) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads) of the supervised CE step at ``params``, grads in the
    params' layout with the pad row's gradient masked. ``generator`` draws
    the dropout mask (needed only when ``model_cfg.backbone.dropout > 0``)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    deterministic = model_cfg.backbone.dropout == 0.0
    kw = dict(dropout_generator=generator, deterministic=deterministic)
    with torch.enable_grad():
        if model_cfg.fused_ce:
            h = apply_features(leaves, model_cfg, batch["state"], batch["true_len"], **kw)
            loss = _fused_sup_ce(leaves, model_cfg, h, batch["action"], batch["valid"])
        else:
            logits = apply_model(leaves, model_cfg, batch["state"], batch["true_len"], **kw)[0]
            loss = _ce_loss(logits, batch["action"], batch["valid"])
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), _apply_grad_mask(tree_unflatten(leaves, grads), model_cfg)


def ce_train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    model_cfg: ModelConfig,
    opt: Adam,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One supervised CE step. Moves ``state``'s params and moments in
    place and returns it with the step advanced, and the metrics."""
    loss, grads = loss_and_grads(state.params, batch, model_cfg, state.generator)
    opt.update(grads, state.opt_state, state.params)
    state.step += 1
    return state, {"sup_loss": loss, "q_loss": torch.zeros_like(loss)}


def _sqn_loss(p_main, p_boot, batch, cfg: ModelConfig, rl: RLStepConfig, aux):
    """(total, sup_loss, q_loss, target action) of the sqn step with
    ``p_main`` the trained net."""
    boot_len = batch["true_len"] if rl.compat_boot_len_bug else batch["true_next_len"]
    not_end = 1.0 - batch["is_end"].to(torch.float32)
    if cfg.fused_ce:
        h = apply_features(p_main, cfg, batch["state"], batch["true_len"])
        sup_loss = _fused_sup_ce(p_main, cfg, h, batch["action"], batch["valid"])
        qh, qb = p_main["q_head"], p_boot["q_head"]
        q = row_logit(h, qh["kernel"], qh["bias"], batch["action"])
        with torch.no_grad():
            h_next = apply_features(p_main, cfg, batch["next_state"], batch["true_next_len"])
            max_a_next = fused_linear_argmax(
                h_next, qh["kernel"], qh["bias"], cfg.action_dim, cfg.head_precision
            )
            h_next_boot = apply_features(p_boot, cfg, batch["next_state"], boot_len)
            q_next_boot = row_logit(h_next_boot, qb["kernel"], qb["bias"], max_a_next)
    else:
        sup, q_out = apply_model(p_main, cfg, batch["state"], batch["true_len"])
        sup_loss = _ce_loss(sup, batch["action"], batch["valid"])
        q = q_out.gather(1, batch["action"].long()[:, None])[:, 0]
        with torch.no_grad():
            # target: r + gamma Q_boot(s', argmax_a Q_main(s', a)), zero at ends
            max_a_next = torch.argmax(
                apply_model(p_main, cfg, batch["next_state"], batch["true_next_len"])[1], dim=1
            )
            q_boot_all = apply_model(p_boot, cfg, batch["next_state"], boot_len)[1]
            q_next_boot = q_boot_all.gather(1, max_a_next[:, None])[:, 0]
    q_next_boot = q_next_boot * not_end
    td = batch["reward"] + rl.gamma * q_next_boot - q
    q_loss = _masked_mean(td**2, batch["valid"])
    return q_loss + sup_loss, sup_loss, q_loss, max_a_next


def _smorl_loss(p_main, p_boot, batch, cfg: ModelConfig, rl: RLStepConfig, aux):
    """(total, sup_loss, q_loss, target action) of the smorl step with
    ``p_main`` the trained net: K reward heads, the accuracy reward from the
    batch and the diversity and novelty rewards from the supervised head's
    top-k (no gradient)."""
    K = cfg.num_q_heads
    w = aux["q_weights"]
    boot_len = batch["true_len"] if rl.compat_boot_len_bug else batch["true_next_len"]
    div_len = batch["true_next_len"] if rl.compat_div_len_bug else batch["true_len"]
    not_end = 1.0 - batch["is_end"].to(torch.float32)
    # the top-k width the online rewards read from the supervised head
    k_need = max(rl.topk_div if K >= 2 else 0, rl.topk_nov if K >= 3 else 0)
    top_i = None
    if cfg.fused_ce:
        h = apply_features(p_main, cfg, batch["state"], batch["true_len"])
        sh = p_main["sup_head"]
        if k_need:
            per_ce, top_i = fused_softmax_ce_topk(
                h.to(torch.float32), sh["kernel"], sh["bias"], batch["action"], k_need,
                cfg.action_dim, cfg.head_precision,
            )
            sup_loss = _masked_mean(per_ce, batch["valid"])
        else:
            sup_loss = _fused_sup_ce(p_main, cfg, h, batch["action"], batch["valid"])
        qh, qb = p_main["q_heads"], p_boot["q_heads"]
        q = multihead_row_logit(h, qh["kernel"], qh["bias"], batch["action"])  # (B, K)
        with torch.no_grad():
            h_next = apply_features(p_main, cfg, batch["next_state"], batch["true_next_len"])
            max_a_next = fused_weighted_multihead_argmax(
                h_next, qh["kernel"], qh["bias"], w, cfg.action_dim, cfg.head_precision
            )
            h_next_boot = apply_features(p_boot, cfg, batch["next_state"], boot_len)
            q_next_boot = multihead_row_logit(h_next_boot, qb["kernel"], qb["bias"], max_a_next)
    else:
        sup, q_all = apply_model(p_main, cfg, batch["state"], batch["true_len"])
        sup_loss = _ce_loss(sup, batch["action"], batch["valid"])
        if k_need:
            top_i = topk_lowest_id(sup.detach(), k_need)[1]
        q = gather_from_3d(q_all, batch["action"])  # (B, K)
        with torch.no_grad():
            # a* maximizes the main net's weighted head sum on s'
            q_out_next = apply_model(p_main, cfg, batch["next_state"], batch["true_next_len"])[1]
            max_a_next = get_max_action(get_weighted_q_target(q_out_next, w))
            q_out_boot = apply_model(p_boot, cfg, batch["next_state"], boot_len)[1]
            q_next_boot = gather_from_3d(q_out_boot, max_a_next)  # (B, K)
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
    q_loss = _masked_mean(weighted_q_loss(td, w), batch["valid"])
    return sup_loss + rl.alpha * q_loss, sup_loss, q_loss, max_a_next


def double_q_loss_and_grads(
    params: Tuple[Dict, Dict],
    batch: Dict[str, torch.Tensor],
    model_cfg: ModelConfig,
    rl: RLStepConfig,
    main: int,
    aux: Dict,
) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(metrics, grads) of the sqn or smorl step with net ``main`` of the
    pair trained and the other one the bootstrap: ``sup_loss``, ``q_loss``
    and ``target_action`` (the main net's best next action, (B,)), and the
    main net's gradients with the pad row's masked. ``aux`` holds the
    device tensors that :func:`make_train_step` prepares."""
    loss_fn = _sqn_loss if model_cfg.family == "sqn" else _smorl_loss
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params[main])
    with torch.enable_grad():
        total, sup_loss, q_loss, target = loss_fn(
            leaves, params[1 - main], batch, model_cfg, rl, aux
        )
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(total, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    metrics = {"sup_loss": sup_loss.detach(), "q_loss": q_loss.detach(), "target_action": target}
    return metrics, _apply_grad_mask(tree_unflatten(leaves, grads), model_cfg)


def double_q_train_step(
    state: DoubleQState,
    batch: Dict[str, torch.Tensor],
    model_cfg: ModelConfig,
    opt: Adam,
    rl: RLStepConfig,
    aux: Dict,
    coin: Optional[int] = None,
) -> Tuple[DoubleQState, Dict[str, torch.Tensor]]:
    """One sqn or smorl step (the reference's ``_double_q_run``). The coin
    (0 or 1: the main net) is ``coin`` when given, else the state
    generator's draw; the generator advances one draw every step either way,
    so later coins do not depend on which ones were given. With two
    optimizers only the main net's params and moments move; with one over
    the pair the other net takes zero gradients and still moves under its
    moments, as in the reference."""
    if not isinstance(state, DoubleQState):
        raise TypeError(f"the {model_cfg.family} step takes a DoubleQState, got {type(state).__name__}")
    drawn = int(torch.randint(0, 2, (), generator=state.generator))
    if coin is None:
        coin = drawn
    if coin not in (0, 1):
        raise ValueError(f"coin must be 0 or 1, got {coin!r}")
    main = int(coin)
    metrics, grads = double_q_loss_and_grads(state.params, batch, model_cfg, rl, main, aux)
    if rl.single_optimizer:
        zeros = tree_map(torch.zeros_like, state.params[1 - main])
        pair = (grads, zeros) if main == 0 else (zeros, grads)
        opt.update(pair, state.opt_state, state.params)
    else:
        opt.update(grads, state.opt_state[main], state.params[main])
    state.step += 1
    return state, metrics


def _sarm_loss(params, batch, cfg: ModelConfig, rl: RLStepConfig):
    """(total, sup_loss, q_loss) of the sarm step: the CE on head 0 plus
    the mean over the heads of each head's masked-mean TD loss."""
    not_end = 1.0 - batch["is_end"].to(torch.float32)
    if cfg.fused_ce:
        h = apply_features(params, cfg, batch["state"], batch["true_len"])
        qh = params["q_heads"]
        per = fused_softmax_ce(
            h.to(torch.float32), qh["kernel"][0], qh["bias"][0], batch["action"],
            cfg.action_dim, cfg.head_precision,
        )
        sup_loss = _masked_mean(per, batch["valid"])
        q = multihead_row_logit(h, qh["kernel"], qh["bias"], batch["action"])  # (B, 5)
        with torch.no_grad():
            h_next = apply_features(params, cfg, batch["next_state"], batch["true_next_len"])
            q_next = blockwise_multihead_max(
                h_next, qh["kernel"], qh["bias"], cfg.action_dim, precision=cfg.head_precision
            )  # (B, 5)
    else:
        outs = apply_model(params, cfg, batch["state"], batch["true_len"])
        sup_loss = _ce_loss(outs[0], batch["action"], batch["valid"])
        q = gather_from_3d(torch.stack(outs, dim=1), batch["action"])  # (B, 5)
        with torch.no_grad():
            outs_next = apply_model(params, cfg, batch["next_state"], batch["true_next_len"])
            q_next = torch.stack(outs_next, dim=1).amax(dim=2)  # (B, 5)
    # each head bootstraps from its own max, zero at episode ends
    q_next = q_next * not_end[:, None]
    td = (batch["reward"][:, None] + rl.sarm_gamma * q_next - q) ** 2
    valid = batch["valid"]
    n = torch.clamp(valid.sum(), min=1)
    q_loss = torch.mean((td * valid[:, None].to(td.dtype)).sum(dim=0) / n)
    return sup_loss + q_loss, sup_loss, q_loss


def sarm_loss_and_grads(
    params: Dict, batch: Dict[str, torch.Tensor], model_cfg: ModelConfig, rl: RLStepConfig
) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(metrics, grads) of the sarm step at ``params``: ``sup_loss`` and
    ``q_loss``, and the gradients with the pad row's masked. Head 0 takes
    the CE's gradient (B2 on the card) and its Q gather's in one leaf."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        total, sup_loss, q_loss = _sarm_loss(leaves, batch, model_cfg, rl)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(total, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    metrics = {"sup_loss": sup_loss.detach(), "q_loss": q_loss.detach()}
    return metrics, _apply_grad_mask(tree_unflatten(leaves, grads), model_cfg)


def sarm_train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    model_cfg: ModelConfig,
    opt: Adam,
    rl: RLStepConfig,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One sarm step. Moves ``state``'s params and moments in place and
    returns it with the step advanced, and the metrics."""
    metrics, grads = sarm_loss_and_grads(state.params, batch, model_cfg, rl)
    opt.update(grads, state.opt_state, state.params)
    state.step += 1
    return state, metrics


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
    device="cuda",
) -> TrainStep:
    """Build ``step(state, batch) -> (state, metrics)`` for the family on
    ``device`` (raises without CUDA unless ``device="cpu"``): the CE step of
    gru4rec and bidir_gru4rec and the sarm step on a :class:`TrainState`,
    the double-Q step of sqn and smorl on a :class:`DoubleQState`. ``rl`` defaults to
    ``RLStepConfig()``. smorl needs ``div_embedding`` (V_in, E), the frozen
    embedding of the diversity reward, and ``unpopular_mask`` (A,) bool;
    ``out_to_in`` (A,) maps output ids to input ids for the diversity reward.
    They are arrays or tensors and are copied to the device once. The lazy
    optimizers and ``mesh`` raise, naming their ROADMAP item."""
    dev = resolve_device(device)
    fam = model_cfg.family
    rl = RLStepConfig() if rl is None else rl
    if lazy_embedding_lr is not None or lazy_qhead_lr is not None:
        raise NotImplementedError(
            "lazy optimizers come with the presets and lazy-optimizers slice (ROADMAP A.8)"
        )
    if mesh is not None:
        raise NotImplementedError("a mesh comes with the multi-GPU slice (ROADMAP A.9)")
    if fam in ("gru4rec", "bidir_gru4rec"):
        return TrainStep(lambda state, batch: ce_train_step(state, batch, model_cfg, opt), dev)
    if fam == "sarm":
        return TrainStep(
            lambda state, batch: sarm_train_step(state, batch, model_cfg, opt, rl), dev
        )
    aux: Dict = {}
    if fam == "smorl":
        if div_embedding is None or unpopular_mask is None:
            raise ValueError("SMORL needs div_embedding and unpopular_mask")
        K = model_cfg.num_q_heads
        if len(rl.q_weights) < K:
            raise ValueError(f"q_weights {rl.q_weights} has fewer than the {K} heads")
        aux = {
            "q_weights": torch.tensor(rl.q_weights[:K], dtype=torch.float32, device=dev),
            "div_embedding": torch.as_tensor(div_embedding, dtype=torch.float32, device=dev),
            "unpopular_mask": torch.as_tensor(unpopular_mask, device=dev).to(torch.bool),
            "out_to_in": None if out_to_in is None else torch.as_tensor(out_to_in, device=dev),
        }
    return TrainStep(
        lambda state, batch, coin=None: double_q_train_step(
            state, batch, model_cfg, opt, rl, aux, coin
        ),
        dev,
        aux,
    )
