"""Head + top-k + softmax-CE over column blocks: the (B, A) logits never
exist whole.

Port of ``ikea_recommender_tpu/ops/fused_topk.py`` (``blockwise_head_topk_ce``,
``blockwise_multihead_max``, ``blockwise_multihead_max_am`` and
``eval_head``). The reference runs a
``lax.scan`` over 4096-column blocks of the head, not a Pallas kernel; here
it is a loop over the same blocks, each one head product. Per sample it
keeps an exact running top-k, a running logsumexp and the label logit, or
(sarm's bootstrap target) each head's running max.

``precision`` names the head product's precision as the fused CE does
(``ops/fused_ce.py::_dot``): None or ``"highest"`` is fp32, ``"high"`` the
bf16x3 split, ``"default"`` one bf16 pass. The reference maps the names to
XLA's ``Precision``; XLA on the CPU computes ``Precision.HIGH`` and
``DEFAULT`` in full fp32, so there the two packages agree only for None and
``"highest"``.

Tie order is explicit. ``lax.top_k`` puts the lower index first among equal
values, and the reference's merge keeps the carry (lower ids) ahead of the
new block. ``torch.topk`` leaves the order of equal values unspecified, so
every candidate is ranked by one unique int64 key, (value desc, id asc):
the float's bits mapped to an order-preserving int32 in the high word and
the complement of the global id in the low word.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ikea_recommender_tpu_torch.ops.fused_ce import _bf16, _dot, _split
from ikea_recommender_tpu_torch.train.lazy_adam import from_action_major

# Masked (padded / not-yet-seen) logit sentinel. Finite so the running-max
# rescale exp(m_old - m_new) never sees inf - inf.
_NEG = -1e30

DEFAULT_BLOCK_COLS = 4096

_ID_SPAN = 2**31 - 1  # global ids must lie in [0, 2**31 - 1]


def order_keys(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 keys whose descending order is (value desc, id asc); ``ids``
    broadcasts against ``values``."""
    v = values.to(torch.float32) + 0.0  # -0.0 -> +0.0: top_k ranks them equal
    bits = v.view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    return ordered.to(torch.int64) * 2**32 + (_ID_SPAN - ids.to(torch.int64))


def decode_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`order_keys` -> (values float32, ids int64)."""
    ordered = (keys >> 32).to(torch.int32)
    bits = torch.where(ordered >= 0, ordered, ordered ^ 0x7FFFFFFF)
    return bits.view(torch.float32), _ID_SPAN - (keys & 0xFFFFFFFF)


def topk_lowest_id(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: (values, ids), equal values in
    ascending id order."""
    ids = torch.arange(values.shape[-1], device=values.device)
    top = order_keys(values, ids).topk(k, dim=-1).values
    return decode_keys(top)


def blockwise_head_topk_ce(
    h: torch.Tensor,  # (B, F) backbone features
    kernel: torch.Tensor,  # (F, A_pad) head weights (may carry padded columns)
    bias: torch.Tensor,  # (A_pad,)
    k: int,
    action_dim: int,  # REAL catalog size; cols >= action_dim are masked
    labels: Optional[torch.Tensor] = None,  # (B,) global action ids, for CE
    block_cols: int = DEFAULT_BLOCK_COLS,
    col_offset: int = 0,  # global id of kernel column 0
    raw_pieces: bool = False,  # return (top_v, top_i, max, sumexp, label_logit)
    precision: Optional[str] = None,  # None = fp32, as "highest"
) -> Tuple[torch.Tensor, ...]:
    """-> (top_vals (B, k), top_idx (B, k) int64, per_sample_ce (B,) or None).

    Same values, ids and tie order as the reference's dense ``lax.top_k``
    over ``mask_pad_logits``-masked logits; the CE agrees to accumulation
    order. ``k`` may exceed ``block_cols``: unfilled slots keep the -1e30
    sentinel (id 0). The last block is padded to ``block_cols`` masked
    columns as the reference pads the head, so ``raw_pieces`` agree too."""
    B, F = h.shape
    A_pad = kernel.shape[1]
    block_cols = min(block_cols, A_pad)
    n_blocks = -(-A_pad // block_cols)
    dev = h.device
    want_ce = labels is not None
    # The logsumexp and label logit are only read for CE or raw pieces;
    # serving asks for neither and skips their work.
    need_lse = want_ce or raw_pieces
    if not want_ce:
        labels = torch.zeros((B,), dtype=torch.int64, device=dev)
    labels = labels.to(torch.int64)

    top = order_keys(
        torch.full((B, k), _NEG, device=dev), torch.zeros((k,), device=dev)
    )
    m = torch.full((B,), _NEG, device=dev)
    s = torch.zeros((B,), device=dev)
    lbl = torch.full((B,), _NEG, device=dev)
    local = torch.arange(block_cols, device=dev)
    for j in range(n_blocks):
        start = j * block_cols
        stop = min(start + block_cols, A_pad)
        logits = _dot(h, kernel[:, start:stop], precision or "highest") + bias[start:stop]
        if stop - start < block_cols:
            logits = torch.nn.functional.pad(
                logits, (0, block_cols - (stop - start)), value=_NEG
            )
        cols = col_offset + start + local
        ok = (cols < action_dim) & (start + local < A_pad)
        logits = torch.where(ok[None, :], logits, _NEG)

        cand = order_keys(logits, cols)
        top = torch.cat([top, cand], dim=1).topk(k, dim=1).values
        if not need_lse:
            continue

        new_m = torch.maximum(m, logits.max(dim=1).values)
        s = s * torch.exp(m - new_m) + torch.exp(logits - new_m[:, None]).sum(dim=1)
        m = new_m

        loc = labels - (col_offset + start)
        in_blk = (loc >= 0) & (loc < block_cols)
        picked = logits.gather(1, loc.clamp(0, block_cols - 1)[:, None])[:, 0]
        lbl = torch.where(in_blk, picked, lbl)

    top_v, top_i = decode_keys(top)
    if raw_pieces:
        return top_v, top_i, m, s, lbl
    per_ce = (m + torch.log(s)) - lbl if want_ce else None
    return top_v, top_i, per_ce


def blockwise_multihead_max(
    h: torch.Tensor,  # (B, F)
    kernel: torch.Tensor,  # (K, F, A_pad) stacked head kernel
    bias: torch.Tensor,  # (K, A_pad)
    action_dim: int,  # REAL catalog size; cols >= action_dim are masked
    block_cols: int = DEFAULT_BLOCK_COLS,
    precision: Optional[str] = None,  # None = fp32, as "highest"
) -> torch.Tensor:
    """(B, K): each head's max over the masked ``h @ kernel[k] + bias[k]``,
    never writing the (B, K, A) values: sarm's self-bootstrapped target
    (reference ``sarm.py:143-146``). Forward only. The operands are split
    into ``_dot``'s bf16 pieces once; each block is one product per piece
    batched over the K heads, added to the block's bias and the pieces
    before it in the product's own accumulate (``baddbmm``, in place after
    the first): ``_dot`` plus the bias, summed in another order. Masked
    columns count as -1e30, as in the reference; the last block stops at
    the real catalog instead of being padded with columns that the mask
    would set to -1e30, and a block with no real column is skipped:
    neither can change a max."""
    return _multihead_max(h, kernel, bias, action_dim, block_cols, precision, False)


def blockwise_multihead_max_am(
    h: torch.Tensor,  # (B, F)
    kernel_am: torch.Tensor,  # (A_pad, K*F) action-major (train/lazy_adam.py)
    bias: torch.Tensor,  # (K, A_pad)
    action_dim: int,
    block_cols: int = DEFAULT_BLOCK_COLS,
    precision: Optional[str] = None,
) -> torch.Tensor:
    """:func:`blockwise_multihead_max` over the lazy optimizers' action-major
    kernel: each block is (BLK, K*F) rows of it, taken by a transposed
    product, so the head is never laid out again. The same pieces, order
    and masking."""
    K = bias.shape[0]
    F = kernel_am.shape[1] // K
    # (K, F, A_pad) as a view of the (A_pad, K F) rows: no copy
    kernel = kernel_am.detach().view(kernel_am.shape[0], K, F).permute(1, 2, 0)
    return _multihead_max(h, kernel, bias, action_dim, block_cols, precision, True)


def _multihead_max(h, kernel, bias, action_dim, block_cols, precision, action_major):
    h, kernel, bias = h.detach(), kernel.detach(), bias.detach()
    K, _, A_pad = kernel.shape
    block_cols = min(block_cols, A_pad)
    precision = precision or "highest"
    m = torch.full((K, h.shape[0]), _NEG, device=h.device)
    whole = None if action_major else _pieces(h, kernel, precision)
    for start in range(0, min(action_dim, A_pad), block_cols):
        stop = min(start + block_cols, A_pad, action_dim)
        # the canonical form splits the whole head once, the action-major
        # form each block's rows as it takes them
        if action_major:
            pieces, cols = _pieces(h, kernel[:, :, start:stop], precision), slice(None)
        else:
            pieces, cols = whole, slice(start, stop)
        (a, w), rest = pieces[0], pieces[1:]
        logits = torch.baddbmm(bias[:, None, start:stop], a.expand(K, -1, -1), w[:, :, cols])
        for a, w in rest:  # (K, B, W), accumulated in place
            logits.baddbmm_(a.expand(K, -1, -1), w[:, :, cols])
        m = torch.maximum(m, logits.amax(dim=2))
    return m.T


def _pieces(h, kernel, precision):
    """``_dot``'s operand pieces of h and the kernel, in its order."""
    if precision == "highest":
        return [(h, kernel)]
    if precision == "default":
        return [(_bf16(h), _bf16(kernel))]
    (h_hi, h_lo), (w_hi, w_lo) = _split(h), _split(kernel)  # "high"
    return [(h_hi, w_hi), (h_hi, w_lo), (h_lo, w_hi)]


def eval_head(params: Dict, model_cfg, head_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kernel (F, A_pad), bias (A_pad,)) of the head that serving and the
    eval protocol score with. On a lazily trained sarm, head 0 is
    ``kernel0`` as it is; heads 1-4 are transposed out of ``kernel_am``."""
    fam = model_cfg.family
    if fam == "sarm":
        mh = params["q_heads"]
        if "kernel0" in mh:  # the lazy action-major sarm layout
            if head_idx == 0:
                return mh["kernel0"], mh["bias0"]
            krest = from_action_major(mh["kernel_am"], mh["bias_rest"].shape[0])
            return krest[head_idx - 1].contiguous(), mh["bias_rest"][head_idx - 1]
        return mh["kernel"][head_idx], mh["bias"][head_idx]
    if head_idx == 0:
        return params["sup_head"]["kernel"], params["sup_head"]["bias"]
    if fam == "sqn" and head_idx == 1:
        qh = params["q_head"]
        if "kernel_am" in qh:
            return from_action_major(qh["kernel_am"], 1)[0].contiguous(), qh["bias"]
        return qh["kernel"], qh["bias"]
    raise ValueError(
        f"fused eval supports single linear heads; family={fam} head_idx={head_idx}"
    )
