"""The evaluation protocol, on the device.

Port of ``ikea_recommender_tpu/eval/protocol.py`` (reference
``evaluate/eval_protocol.py:123-263``). Over an eval buffer it computes

- the mean CE loss, as the mean of the batch means: a padded tail batch
  counts as a whole batch (the reference's normalization, quirk 8);
- HR@k and NDCG@k for each k, over the samples;
- catalog coverage CV@k over all items and over the unpopular set,
  accumulated across the pass (``ops/coverage.py``);
- the mean diversity reward (1 - cosine similarity to the state's last item
  in a frozen embedding) and novelty reward (top-k ∩ unpopular);
- the repetition counts R@k (top-k predictions already in the state);
- with ``type_names``, HR/NDCG per action type.

Each batch is one :meth:`EvalProtocol.update` whose running totals stay on
the device; :meth:`EvalProtocol.finalize` reads them back in one copy and
normalizes on the host. At catalogs of ``FUSED_CE_MIN_ACTIONS`` and up the
head is scored blockwise (``ops/fused_topk.py::blockwise_head_topk_ce``),
one scan giving the top-k ids and each sample's CE, so the (B, A) logits
never exist; below, the dense logits give both. The backbone's recurrence
is the B3 kernel on the card (``ops/gru_cuda.py``).

On a (data, model) mesh (``mesh``, ``core/mesh.py``) each rank holds its
slice of the params (``parallel/sharding.py``) and scores its rows of each
batch (``core/distributed.py::local_rows``): a model-sharded head takes the
fused arm by default, the blockwise scan over the rank's columns merged by
``parallel/topk.py::sharded_head_topk_ce``, which the reference calls
without ``eval_precision``, so on a mesh the scan runs at fp32 products
whatever ``eval_precision`` says (ROADMAP C.6); the dense arm takes the
shard's logits through ``sharded_softmax_ce`` and ``sharded_top_k``. A
batch's mean CE divides by its valid rows over all data ranks, and
:meth:`EvalProtocol.finalize` sums the totals over the data axis (coverage:
a max).

Not ported: the reference's ``evaluate_device`` / ``_scanned_update``, the
TPU's one-dispatch ``lax.scan`` over a device-resident buffer.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ikea_recommender_tpu_torch.convert import tree_map
from ikea_recommender_tpu_torch.core.device import resolve_device
from ikea_recommender_tpu_torch.core.distributed import local_rows
from ikea_recommender_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS
from ikea_recommender_tpu_torch.data.replay_buffer import eval_batches
from ikea_recommender_tpu_torch.models.families import (
    FUSED_CE_MIN_ACTIONS,
    ModelConfig,
    apply_features,
    apply_model,
)
from ikea_recommender_tpu_torch.ops.coverage import init_coverage, update_coverage_from_topk
from ikea_recommender_tpu_torch.ops.fused_topk import (
    blockwise_head_topk_ce,
    eval_head,
    topk_lowest_id,
)
from ikea_recommender_tpu_torch.ops.ranking import hr_ndcg_by_type_from_topk, hr_ndcg_from_topk
from ikea_recommender_tpu_torch.ops.rewards import (
    diversity_from_topk,
    novelty_from_topk,
    repetitions_from_topk,
)
from ikea_recommender_tpu_torch.parallel.topk import (
    shard_width,
    sharded_head_topk_ce,
    sharded_softmax_ce,
    sharded_top_k,
)


@dataclass
class EvalAccum:
    """Running totals over batches, on the device."""

    loss_sum: torch.Tensor  # () float32, sum of the batch means of CE
    n_batches: torch.Tensor  # () int32
    n_samples: torch.Tensor  # () int32
    hits: torch.Tensor  # (n_k,) float32
    ndcg: torch.Tensor  # (n_k,) float32
    reps: torch.Tensor  # (n_k,) float32
    div_rew_sum: torch.Tensor  # () float32
    nov_rew_sum: torch.Tensor  # () float32
    covered: torch.Tensor  # (n_cov_k, A) bool
    type_hits: torch.Tensor  # (n_types, n_k) float32; n_types 0 when off
    type_ndcg: torch.Tensor  # (n_types, n_k) float32
    type_count: torch.Tensor  # (n_types,) int32


@dataclass
class EvalResult:
    """Normalized metrics; the field names follow the reference's 7-tuple."""

    loss: float
    hr: np.ndarray  # (n_k,)
    ndcg: np.ndarray  # (n_k,)
    coverage: Dict[int, Tuple[float, float]]  # k -> (unpopular cov, all cov)
    div_rew: float
    nov_rew: float
    reps: np.ndarray  # (n_k,)
    # type name -> {"hr": (n_k,), "ndcg": (n_k,), "count": int} with
    # type_names (the old generation's per-action-type dicts); the total is
    # the standard hr/ndcg.
    by_type: Optional[Dict[str, Dict[str, Any]]] = None


_NUMPY_DTYPES = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}


def _to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The tensors as numpy arrays, through one device-to-host copy of
    their bytes."""
    flat = [t.detach().contiguous().reshape(-1) for t in tensors]
    raw = torch.cat([t.view(torch.uint8) for t in flat]).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel() * f.element_size()
        out.append(raw[at : at + n].view(_NUMPY_DTYPES[t.dtype]).reshape(tuple(t.shape)))
        at += n
    return out


class EvalProtocol:
    """The metric configuration and the per-batch update, on ``device``."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        *,
        topk_hr_ndcg: Sequence[int] = (5, 10, 20),
        topk_cov: Sequence[int] = (1, 5, 10),
        topk_div: int = 1,
        topk_nov: int = 1,
        nov_rew_sig: float = 1.0,
        padding_pos: str = "end",
        div_embedding=None,
        unpopular_mask=None,
        out_to_in=None,
        head_idx: int = 0,
        mesh=None,
        fused: Optional[bool] = None,
        type_names: Optional[Sequence[str]] = None,
        eval_precision: Optional[str] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"the mesh lies on {mesh.device}, the protocol on {self.device}")
        self.mesh = mesh
        self.model_cfg = model_cfg
        # None = fp32 head products, the dense path's numbers; "high" and
        # "default" trade precision for speed (ops/fused_ce.py::_dot).
        self.eval_precision = eval_precision
        # type id i in the buffer's action_type column is type_names[i]
        self.type_names = tuple(type_names or ())
        self.num_types = len(self.type_names)
        self.topk_hr_ndcg = tuple(topk_hr_ndcg)
        self.topk_cov = tuple(topk_cov)
        self.topk_div = topk_div
        self.topk_nov = topk_nov
        self.nov_rew_sig = nov_rew_sig
        self.padding_pos = padding_pos
        self.num_actions = model_cfg.action_dim
        self.head_idx = head_idx
        if div_embedding is None:
            # a constant embedding: the diversity reward is 0
            div_embedding = np.ones((model_cfg.backbone.num_items + 1, 1), np.float32)
        self.div_embedding = self._on_device(div_embedding, torch.float32)
        if unpopular_mask is None:
            unpopular_mask = np.zeros((self.num_actions,), dtype=bool)
        self.unpopular_mask = self._on_device(unpopular_mask, torch.bool)
        self._unpop_host = self.unpopular_mask.cpu().numpy()  # for finalize
        self.out_to_in = None if out_to_in is None else self._on_device(out_to_in, torch.int64)

        # Only single linear heads are scored blockwise (not smorl's
        # stacked Q heads).
        fam = model_cfg.family
        can_fuse = fam == "sarm" or head_idx == 0 or (fam == "sqn" and head_idx == 1)
        self._model_sharded = mesh is not None and mesh.size(MODEL_AXIS) > 1
        if mesh is not None:
            shard_width(model_cfg.padded_action_dim, mesh)  # raises where it does not divide
        if fused is None:
            fused = self._model_sharded or self.num_actions >= FUSED_CE_MIN_ACTIONS
        self.fused = bool(fused) and can_fuse
        # the widest top-k any metric reads, computed once per batch
        self._max_k = max(max(self.topk_hr_ndcg), max(self.topk_cov), topk_div, topk_nov)

    # -- accumulators ------------------------------------------------------
    def init_accum(self) -> EvalAccum:
        n_k, dev = len(self.topk_hr_ndcg), self.device

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return EvalAccum(
            loss_sum=zeros(),
            n_batches=zeros(dtype=torch.int32),
            n_samples=zeros(dtype=torch.int32),
            hits=zeros(n_k),
            ndcg=zeros(n_k),
            reps=zeros(n_k),
            div_rew_sum=zeros(),
            nov_rew_sum=zeros(),
            covered=init_coverage(self.num_actions, len(self.topk_cov), device=dev),
            type_hits=zeros(self.num_types, n_k),
            type_ndcg=zeros(self.num_types, n_k),
            type_count=zeros(self.num_types, dtype=torch.int32),
        )

    # -- one batch ---------------------------------------------------------
    @torch.inference_mode()
    def topk_ce(
        self, params, state, true_len, action, k: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(top-k values (B, k), top-k ids (B, k) int64, per-sample CE (B,))
        of the scored head, ``k`` defaulting to the widest top-k the metrics
        read. The fused arm scans the head blockwise; the dense arm takes
        the full logits, CE as logsumexp minus the label's logit (optax's
        ``softmax_cross_entropy_with_integer_labels``)."""
        k = self._max_k if k is None else k
        state, true_len, action = (self._on_device(x) for x in (state, true_len, action))
        mesh = self.mesh
        if self.fused:
            h = apply_features(params, self.model_cfg, state, true_len, mesh=mesh)
            kernel, bias = eval_head(params, self.model_cfg, self.head_idx)
            if self._model_sharded:
                return sharded_head_topk_ce(h, kernel, bias, k, self.num_actions, mesh,
                                            labels=action)
            return blockwise_head_topk_ce(
                h, kernel, bias, k, self.num_actions, labels=action,
                precision=self.eval_precision,
            )
        preds = apply_model(params, self.model_cfg, state, true_len, mesh=mesh)[self.head_idx]
        if mesh is not None:  # this rank's columns
            vals, idx = sharded_top_k(preds, k, mesh)
            return vals, idx, sharded_softmax_ce(preds, action, mesh)
        label_logit = preds.gather(1, action.long()[:, None])[:, 0]
        per_ce = torch.logsumexp(preds, dim=1) - label_logit
        vals, idx = topk_lowest_id(preds, k)
        return vals, idx, per_ce

    def _on_device(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, dtype)

    @torch.inference_mode()
    def update(
        self, params, accum: EvalAccum, state, action, true_len, valid, action_type=None
    ) -> EvalAccum:
        """The totals after one batch (numpy arrays or tensors; ``valid``
        marks the real rows of a padded batch). On a mesh, this rank's rows
        of the batch; its mean CE is over the whole batch's valid rows."""
        state, action, true_len = (self._on_device(x) for x in (state, action, true_len))
        valid = self._on_device(valid, torch.bool)
        _, idx, per_ce = self.topk_ce(params, state, true_len, action)

        w = valid.to(per_ce.dtype)
        if self.mesh is None:
            batch_loss = (per_ce * w).sum() / torch.clamp(w.sum(), min=1.0)
        else:
            num, den = self.mesh.all_reduce(torch.stack([(per_ce * w).sum(), w.sum()]), "sum",
                                            DATA_AXIS)
            batch_loss = num / torch.clamp(den, min=1.0)
        div = diversity_from_topk(
            state, idx[:, : self.topk_div], true_len, self.padding_pos,
            self.div_embedding, out_to_in=self.out_to_in,
        )
        nov = novelty_from_topk(idx[:, : self.topk_nov], self.unpopular_mask, self.nov_rew_sig)
        hits, ndcg = hr_ndcg_from_topk(idx, action, self.topk_hr_ndcg, valid=valid)
        reps = repetitions_from_topk(
            state, idx, self.topk_hr_ndcg, out_to_in=self.out_to_in, valid=valid
        )
        covered = update_coverage_from_topk(accum.covered, idx, self.topk_cov, valid=valid)

        type_hits, type_ndcg, type_count = accum.type_hits, accum.type_ndcg, accum.type_count
        if self.num_types > 0 and action_type is not None:
            th, tn, tc = hr_ndcg_by_type_from_topk(
                idx, action, self._on_device(action_type), self.num_types,
                self.topk_hr_ndcg, valid=valid,
            )
            type_hits, type_ndcg = type_hits + th, type_ndcg + tn
            type_count = type_count + tc.to(torch.int32)

        return EvalAccum(
            loss_sum=accum.loss_sum + batch_loss,
            n_batches=accum.n_batches + 1,
            n_samples=accum.n_samples + valid.sum(dtype=torch.int32),
            hits=accum.hits + hits,
            ndcg=accum.ndcg + ndcg,
            reps=accum.reps + reps,
            div_rew_sum=accum.div_rew_sum + (div * w).sum(),
            nov_rew_sum=accum.nov_rew_sum + (nov * w).sum(),
            covered=covered,
            type_hits=type_hits,
            type_ndcg=type_ndcg,
            type_count=type_count,
        )

    # -- normalization -----------------------------------------------------
    def finalize(self, accum: EvalAccum) -> EvalResult:
        """Reads the totals back in one copy and normalizes them on the
        host, as the reference's ``finalize``; on a mesh, the totals over
        the data axis first."""
        if self.mesh is not None:
            accum = self._over_data(accum)
        a = dict(zip(
            [f.name for f in fields(EvalAccum)],
            _to_host([getattr(accum, f.name) for f in fields(EvalAccum)]),
        ))
        n = max(int(a["n_samples"]), 1)
        n_b = max(int(a["n_batches"]), 1)
        covered, unpop = a["covered"], self._unpop_host
        n_unpop = max(int(unpop.sum()), 1)
        unpop_cov = (covered & unpop[None, :]).sum(axis=1) / n_unpop
        all_cov = covered.sum(axis=1) / self.num_actions
        coverage = {
            k: (float(unpop_cov[i]), float(all_cov[i])) for i, k in enumerate(self.topk_cov)
        }
        by_type = None
        if self.num_types > 0:
            th, tn, tc = a["type_hits"], a["type_ndcg"], a["type_count"]
            by_type = {
                name: {
                    "hr": th[i] / max(int(tc[i]), 1),
                    "ndcg": tn[i] / max(int(tc[i]), 1),
                    "count": int(tc[i]),
                }
                for i, name in enumerate(self.type_names)
            }
        return EvalResult(
            loss=float(a["loss_sum"]) / n_b,
            hr=a["hits"] / n,
            ndcg=a["ndcg"] / n,
            coverage=coverage,
            div_rew=float(a["div_rew_sum"]) / n,
            nov_rew=float(a["nov_rew_sum"]) / n,
            reps=a["reps"] / n,
            by_type=by_type,
        )

    def _over_data(self, accum: EvalAccum) -> EvalAccum:
        """The data ranks' totals summed (coverage: any rank's), in two
        collectives; the batch losses are the whole batches' already."""
        mesh = self.mesh
        sums = ("n_samples", "hits", "ndcg", "reps", "div_rew_sum", "nov_rew_sum",
                "type_hits", "type_ndcg", "type_count")
        parts = [getattr(accum, f).to(torch.float32).reshape(-1) for f in sums]
        flat = mesh.all_reduce(torch.cat(parts), "sum", DATA_AXIS)
        out, at = {}, 0
        for f, p in zip(sums, parts):
            t = getattr(accum, f)  # the int32 counts are exact in float32 below 2^24
            out[f] = flat[at:at + p.numel()].reshape(t.shape).to(t.dtype)
            at += p.numel()
        covered = mesh.all_reduce(accum.covered.to(torch.uint8), "max", DATA_AXIS).bool()
        return EvalAccum(loss_sum=accum.loss_sum, n_batches=accum.n_batches, covered=covered,
                         **out)

    # -- the whole buffer --------------------------------------------------
    def evaluate(self, params, eval_buf, batch_size: int) -> EvalResult:
        """Every batch of ``eval_buf`` (:func:`eval_batches`, the tail
        padded; on a mesh, this rank's rows of each), then
        :meth:`finalize`."""
        params = tree_map(lambda t: t.to(self.device), params)
        accum = self.init_accum()
        for b in eval_batches(eval_buf, batch_size):
            cols = {f.name: getattr(b, f.name) for f in fields(b) if getattr(b, f.name) is not None}
            if self.mesh is not None:
                cols = local_rows(cols, self.mesh)
            accum = self.update(params, accum, **cols)
        return self.finalize(accum)
