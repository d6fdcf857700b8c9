"""Lazy (sparse-row) Adam for the embedding table and for the Q heads.

Port of ``ikea_recommender_tpu/train/lazy_adam.py``. Dense Adam reads and
writes every row of a table and of its two moments each step, while a batch
touches only its B*T embedding rows and its B actions' head columns. Lazy
Adam updates those rows alone:

- the rows are gathered outside autograd, so the gradient arrives per
  position ((B*T, E) embedding rows, (B, K, F) head rows) instead of as a
  dense (V, E) or (K, F, A) scatter;
- duplicate ids are merged by a stable sort and a sum per run of equal ids
  (the summed gradient equals the dense row's);
- the touched rows of the param and of the packed moments are gathered,
  Adam-updated in fp32 with the bias correction of the step count + 1, cast
  back to their storage dtype and written back.

Moments decay only on the steps that touch their row: this is not dense
Adam, as the reference says; it is the opt-in ``optimizer: lazy_adam`` and
``qhead_optimizer: lazy_adam`` (set by ``preset: fast``).

The Q heads are kept action-major, so the sparse updates are row updates:
``kernel_am`` (A, K*F) holds row a = every head's weight column of action
a, and the moments are packed (A, K*2*(F+1)) as ``[m_w, m_b, v_w, v_b]``.

The sums over duplicate ids are deterministic: the ids are sorted and each
run is summed by ``index_put_(accumulate=True)`` over its run index, which
on the card is a sorted, sequential sum (not ``index_add_``'s atomics).
Where the reference scatters a run's sum to its first slot and drops the
duplicates at a sentinel, every slot of a run here carries the run's sum,
so duplicate writes write the same values; the frozen pad row writes back
what it read. Both give the reference's result without a host sync.

The updates work in place on the params and the moment buffers, as
``train/state.py``'s Adam does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ikea_recommender_tpu_torch.train.state import _DTYPES, B1, B2, EPS


@dataclass
class EmbAdamState:
    """The embedding's moments, packed (V, 2E) as ``[m | v]``."""

    mv: torch.Tensor

    @property
    def m(self) -> torch.Tensor:
        return self.mv[:, : self.mv.shape[1] // 2]

    @property
    def v(self) -> torch.Tensor:
        return self.mv[:, self.mv.shape[1] // 2 :]


@dataclass
class ColAdamState:
    """The action-major Q heads' moments, (A, K*2*(F+1)) packed
    ``[m_w, m_b, v_w, v_b]`` per head."""

    mv: torch.Tensor


def _dtype(mv_dtype, like: torch.Tensor) -> torch.dtype:
    return like.dtype if mv_dtype is None else _DTYPES[mv_dtype]


def init_emb_adam(embedding: torch.Tensor, mv_dtype: Optional[str] = None) -> EmbAdamState:
    """Zero moments for ``embedding`` (V, E), stored in ``mv_dtype`` (e.g.
    "bfloat16"; the update math is fp32 either way)."""
    V, E = embedding.shape
    return EmbAdamState(torch.zeros((V, 2 * E), dtype=_dtype(mv_dtype, embedding),
                                    device=embedding.device))


def _segments(sids: torch.Tensor) -> torch.Tensor:
    """Run index of each slot of the sorted ids: 0, 0, 1, 2, 2, ..."""
    new = torch.ones_like(sids, dtype=torch.int64)
    new[0] = 0
    new[1:] = (sids[1:] != sids[:-1]).to(torch.int64)
    return torch.cumsum(new, 0)


def _run_sums(sids: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Every slot of a run of equal sorted ids receives the run's summed
    gradient, summed in slot order. g: (n, C) -> (n, C)."""
    seg = _segments(sids)
    gsum = torch.zeros_like(g).index_put_((seg,), g, accumulate=True)
    return gsum[seg]


def dedupe_row_grads(
    ids: torch.Tensor, grads: torch.Tensor, sentinel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's merge of duplicate ids, for comparison: (upd_ids,
    upd_grads) of the same length, sorted, where each id's first slot holds
    its summed gradient and every duplicate slot the id ``sentinel``.
    :func:`emb_adam_update` keeps the sum on every slot instead."""
    sids, order = torch.sort(ids, stable=True)
    g = _run_sums(sids, grads[order])
    first = torch.ones_like(sids, dtype=torch.bool)
    first[1:] = sids[1:] != sids[:-1]
    return torch.where(first, sids, torch.full_like(sids, sentinel)), g


def _adam_rows(g, mv_rows, t, lr):
    """(update, m, v) of packed fp32 moment rows ``mv_rows`` = [m | v] for
    gradient rows ``g``, at bias-correction step ``t`` (count + 1)."""
    C = g.shape[1]
    m = B1 * mv_rows[:, :C] + (1.0 - B1) * g
    v = B2 * mv_rows[:, C:] + (1.0 - B2) * g * g
    bc1 = 1.0 - torch.pow(torch.tensor(B1, device=g.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(B2, device=g.device), t)
    return lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS), m, v


@torch.no_grad()
def emb_adam_update(
    embedding: torch.Tensor,  # (V, E), updated in place
    state: EmbAdamState,  # updated in place
    ids: torch.Tensor,  # (N,) rows touched this step (duplicates ok)
    row_grads: torch.Tensor,  # (N, E) dL/d(gathered rows)
    step: torch.Tensor,  # int32 count before this update (bias corr uses + 1)
    lr: float,
    frozen_row: Optional[int] = None,
    row_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, EmbAdamState]:
    """Lazy Adam on the embedding rows ``ids``; ``frozen_row`` (the pad row
    when its embedding is frozen) keeps its param and moments. The
    reference's ``selected`` predication (an identity write for the
    double-Q net that a step does not train) has no counterpart: the steps
    skip that net, which leaves it bit for bit as the identity write
    does.

    ``row_offset``: ``embedding`` is the block of a table's rows that
    starts at this global id (a mesh's model shard), ``ids`` are global and
    may name rows of other blocks, which this update skips. Without a host
    sync: such an id joins the run of the block's last row with a zero
    gradient (adding 0.0 leaves the run's sum as it was), and a run that no
    id of the block reaches writes back what it read. The ids of the block
    keep their order in the stable sort, so each run is summed as one
    process sums it."""
    ids = ids.reshape(-1).long()
    g_in = row_grads.reshape(ids.shape[0], -1).to(torch.float32)
    owned = None
    if row_offset is not None:
        V = embedding.shape[0]
        ids = ids - row_offset
        owned = (ids >= 0) & (ids < V)
        ids = torch.where(owned, ids, V - 1)
        g_in = torch.where(owned[:, None], g_in, 0.0)
        if frozen_row is not None:
            frozen_row -= row_offset
    sids, order = torch.sort(ids, stable=True)
    g = _run_sums(sids, g_in[order])
    mv_rows = state.mv[sids].to(torch.float32)
    p_rows = embedding[sids].to(torch.float32)
    t = (step + 1).to(torch.float32)
    upd, m, v = _adam_rows(g, mv_rows, t, lr)
    p_new, mv_new = p_rows - upd, torch.cat([m, v], dim=1)
    keep = None if frozen_row is None else (sids == frozen_row)[:, None]
    if owned is not None:  # the runs no id of this block reaches
        reached = _run_sums(sids, owned[order].to(torch.float32)[:, None]) > 0
        keep = ~reached if keep is None else keep | ~reached
    if keep is not None:
        p_new = torch.where(keep, p_rows, p_new)
        mv_new = torch.where(keep, mv_rows, mv_new)
    embedding[sids] = p_new.to(embedding.dtype)
    state.mv[sids] = mv_new.to(state.mv.dtype)
    return embedding, state


def to_action_major(kernel: torch.Tensor) -> torch.Tensor:
    """(K, F, A) or (F, A) canonical head kernel -> (A, K*F) ``kernel_am``."""
    k3 = kernel if kernel.dim() == 3 else kernel[None]
    K, F, A = k3.shape
    return k3.reshape(K * F, A).T.contiguous()


def from_action_major(kernel_am: torch.Tensor, K: int) -> torch.Tensor:
    """(A, K*F) -> canonical (K, F, A)."""
    A, KF = kernel_am.shape
    return kernel_am.T.reshape(K, KF // K, A)


def init_col_adam(kernel_am: torch.Tensor, K: int, mv_dtype: Optional[str] = None) -> ColAdamState:
    A, KF = kernel_am.shape
    F = KF // K
    return ColAdamState(torch.zeros((A, K * 2 * (F + 1)), dtype=_dtype(mv_dtype, kernel_am),
                                    device=kernel_am.device))


def sort_batch_ids(idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted ids, the inverse permutation back to batch order), with
    ``jnp.argsort``'s stable order."""
    sids, order = torch.sort(idx.long(), stable=True)
    return sids, torch.argsort(order)


def gather_qhead_rows(
    kernel_am: torch.Tensor,  # (A, K*F)
    bias: torch.Tensor,  # (K, A) or (A,)
    ids: torch.Tensor,  # (n,) action ids, any order
    K: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """((n, K, F) weight rows, (K, n) bias entries) at the given actions."""
    b2 = bias if bias.dim() == 2 else bias[None]
    ids = ids.long()
    return kernel_am[ids].reshape(ids.shape[0], K, -1), b2[:, ids]


def q_from_rows(h: torch.Tensor, rows: torch.Tensor, b_cols: torch.Tensor) -> torch.Tensor:
    """(B, K) Q values from rows (B, K, F) gathered at each example's action."""
    return torch.einsum("bf,bkf->bk", h, rows) + b_cols.T


@torch.no_grad()
def qhead_row_adam_update(
    kernel_am: torch.Tensor,  # (A, K*F), updated in place
    bias: torch.Tensor,  # (K, A) or (A,), updated in place
    state: ColAdamState,  # updated in place
    sids: torch.Tensor,  # (B,) SORTED action ids (duplicates ok)
    g_wrows: torch.Tensor,  # (B, K, F) dL/d(sorted kernel rows)
    g_bcols: torch.Tensor,  # (K, B) dL/d(sorted bias entries)
    step: torch.Tensor,  # int32 count before this update (bias corr uses + 1)
    lr: float,
    *,
    w_rows: Optional[torch.Tensor] = None,  # pre-gathered (B, K, F) sorted rows
    b_cols: Optional[torch.Tensor] = None,  # (K, B)
) -> Tuple[torch.Tensor, torch.Tensor, ColAdamState]:
    """Lazy Adam on the action-major head rows ``sids``. Every slot of a
    run of equal ids carries the run's summed gradient, so their writes
    agree. No ``selected`` predication, as :func:`emb_adam_update`."""
    b2 = bias if bias.dim() == 2 else bias[None]
    B, K = sids.shape[0], b2.shape[0]
    F = kernel_am.shape[1] // K
    g = torch.cat([g_wrows, g_bcols.T[:, :, None]], dim=2).to(torch.float32)
    g = _run_sums(sids, g.reshape(B, K * (F + 1)))
    mv_rows = state.mv[sids].to(torch.float32)
    t = (step + 1).to(torch.float32)
    upd, m, v = _adam_rows(g, mv_rows, t, lr)
    if w_rows is None or b_cols is None:
        w_rows, b_cols = gather_qhead_rows(kernel_am, b2, sids, K)
    upd = upd.reshape(B, K, F + 1)
    new_w = w_rows.to(torch.float32) - upd[:, :, :F]
    new_b = b_cols.to(torch.float32) - upd[:, :, F].T
    kernel_am[sids] = new_w.reshape(B, K * F).to(kernel_am.dtype)
    b2[:, sids] = new_b.to(b2.dtype)
    state.mv[sids] = torch.cat([m, v], dim=1).to(state.mv.dtype)
    return kernel_am, bias, state
