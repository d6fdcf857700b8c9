"""Fused full-catalog softmax cross-entropy: the B1 forward and B2 backward
kernels and their plain twins.

Port of ``ikea_recommender_tpu/ops/fused_ce.py`` (``fused_softmax_ce``, its
TPU kernels ``_fwd_kernel`` and ``_bwd_kernel``, and ``_dot``/``_dot3``).
The per-example CE of ``h @ w + b`` over the catalog, with columns at or
past ``valid_dim`` masked, is computed without writing the (B, A) logits to
device memory: the forward keeps a logsumexp and the label logit per row,
and the backward recomputes the logits to form ``dlogits`` and the three
gradients.

On CUDA tensors the forward and backward launch ``csrc/fused_ce.cu``, whose
header says what bounds each and how it is laid out; both take any head
width F in every precision, as the reference's kernels do (past F = 256 on
routes that go over F in slices). On CPU tensors they run
:func:`fused_ce_fwd_plain` and :func:`fused_ce_bwd_plain`, which compute
the same functions with dense torch products. There is no fallback from one
to the other.

``precision`` names the precision of the head products, as in the reference:
``"highest"`` is IEEE fp32; ``"high"`` splits each fp32 operand into a
bf16 high part and a bf16 residual and sums three bf16 products in fp32
(``_dot3``); ``"default"`` is one product of bf16-rounded operands summed in
fp32. Products of bf16 values are exact in fp32, so the twins, the kernels
and the reference compute the same function up to the order of the sums.

:func:`fused_softmax_ce_topk` (smorl's supervised head) takes the CE and the
logits' top-k ids from one blockwise pass (``ops/fused_topk.py``) instead
of B1, and its backward is B2.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ikea_recommender_tpu_torch.ops import build

_NEG = -1e30
PRECISIONS = ("highest", "high", "default")

# Launches of each CUDA kernel, counted where it is launched and nowhere else.
LAUNCHES = 0  # B1, the forward
BWD_LAUNCHES = 0  # B2, the backward

_FNS = None


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _dot(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in fp32 at a named precision (the reference's ``_dot``)."""
    if precision == "highest":
        return a @ b
    if precision == "default":
        return _bf16(a) @ _bf16(b)
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def _split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 high part and bf16 residual of ``x``, as fp32: "high"'s
    operands."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _masked_logits(h, w, b, valid_dim, precision):
    logits = _dot(h, w, precision) + b
    col = torch.arange(w.shape[1], device=h.device)
    return logits, col < valid_dim


def fused_ce_fwd_plain(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (F, A)
    b: torch.Tensor,  # (A,)
    labels: torch.Tensor,  # (B,) int
    valid_dim: int,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse (B,), label_logit (B,)) of the masked logits, as the reference's
    forward kernel leaves them; the label logit is 0 where the label is not
    a valid column."""
    logits, ok = _masked_logits(h, w, b, valid_dim, precision)
    logits = torch.where(ok, logits, _NEG)
    m = logits.max(dim=1).values
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=1))
    hit = (torch.arange(w.shape[1], device=h.device) == labels[:, None].long()) & ok
    return lse, torch.where(hit, logits, 0.0).sum(dim=1)


def fused_ce_bwd_plain(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (F, A)
    b: torch.Tensor,  # (A,)
    labels: torch.Tensor,  # (B,) int
    lse: torch.Tensor,  # (B,)
    ct: torch.Tensor,  # (B,) cotangent of the per-example CE
    valid_dim: int,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dh (B, F), dw (F, A), db (A,)), as the reference's backward kernel
    computes them: dlogits = (softmax - onehot) * ct, zero at masked
    columns, and W's masked columns read as zero for dh."""
    logits, ok = _masked_logits(h, w, b, valid_dim, precision)
    p = torch.where(ok, torch.exp(logits - lse[:, None]), 0.0)
    onehot = (torch.arange(w.shape[1], device=h.device) == labels[:, None].long()) & ok
    dlogits = (p - onehot.float()) * ct[:, None]
    dw = _dot(h.T, dlogits, precision)
    db = dlogits.sum(dim=0)
    dh = _dot(dlogits, torch.where(ok, w, 0.0).T, precision)
    return dh, dw, db


def _check(h, w, b, labels, valid_dim, precision) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    tensors = (h, w, b, labels)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"fused_softmax_ce: inputs on different devices {[str(t.device) for t in tensors]}"
        )
    for t in (h, w, b):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_softmax_ce takes float32 h, w, b, got {t.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    if h.dim() != 2 or w.dim() != 2 or w.shape[0] != h.shape[1]:
        raise ValueError(f"h must be (B, F) and w (F, A), got {tuple(h.shape)} {tuple(w.shape)}")
    B, A = h.shape[0], w.shape[1]
    if tuple(b.shape) != (A,) or tuple(labels.shape) != (B,):
        raise ValueError(f"b must be {(A,)} and labels {(B,)}, got {tuple(b.shape)} {tuple(labels.shape)}")
    if not 0 <= int(valid_dim) <= A:
        raise ValueError(f"valid_dim must lie in [0, {A}], got {valid_dim}")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_softmax_ce runs on cpu or cuda tensors, got {h.device}")


def _kernel_fns():
    global _FNS
    if _FNS is None:
        lib = build.load("fused_ce")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fwd = lib.fused_ce_fwd
        fwd.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        fwd.restype = i32
        bwd = lib.fused_ce_bwd
        bwd.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
        bwd.restype = i32
        fwd_scratch = lib.fused_ce_fwd_scratch
        fwd_scratch.argtypes = [i32] * 4
        fwd_scratch.restype = i64
        bwd_scratch = lib.fused_ce_bwd_scratch
        bwd_scratch.argtypes = [i32, i32, i32]
        bwd_scratch.restype = i64
        _FNS = fwd, bwd, fwd_scratch, bwd_scratch
    return _FNS


def _cuda_inputs(h, w, b, labels):
    for t in (h, w, b):
        if not t.is_contiguous():
            raise ValueError("fused_softmax_ce takes contiguous h, w, b on CUDA")
    return labels.to(torch.int64).contiguous()


def _launch_fwd(h, w, b, labels, valid_dim, precision):
    global LAUNCHES
    labels = _cuda_inputs(h, w, b, labels)
    (B, F), A = h.shape, w.shape[1]
    fwd, _, fwd_scratch, _ = _kernel_fns()
    dev = h.device
    lse = torch.empty((B,), dtype=torch.float32, device=dev)
    lbl = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        scratch = torch.empty(
            (fwd_scratch(B, F, A, PRECISIONS.index(precision)),), dtype=torch.float32, device=dev
        )
        err = fwd(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), lbl.data_ptr(), scratch.data_ptr(),
            B, F, A, int(valid_dim), PRECISIONS.index(precision),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_ce_fwd kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return lse, lbl


def _launch_bwd(h, w, b, labels, lse, ct, valid_dim, precision):
    global BWD_LAUNCHES
    labels = _cuda_inputs(h, w, b, labels)
    (B, F), A = h.shape, w.shape[1]
    _, bwd, _, bwd_scratch = _kernel_fns()
    dev = h.device
    dh = torch.empty((B, F), dtype=torch.float32, device=dev)
    dw = torch.empty((F, A), dtype=torch.float32, device=dev)
    db = torch.empty((A,), dtype=torch.float32, device=dev)
    lse, ct = lse.contiguous(), ct.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        scratch = torch.empty((bwd_scratch(B, F, A),), dtype=torch.float32, device=dev)
        err = bwd(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), ct.data_ptr(), dw.data_ptr(), db.data_ptr(),
            dh.data_ptr(), scratch.data_ptr(),
            B, F, A, int(valid_dim), PRECISIONS.index(precision),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_ce_bwd kernel launch failed with CUDA error {err}")
    BWD_LAUNCHES += 1
    return dh, dw, db


def fused_ce_fwd(h, w, b, labels, valid_dim, precision="highest"):
    """B1: (lse, label_logit). CPU tensors take the twin; CUDA tensors
    launch the kernel or raise."""
    _check(h, w, b, labels, valid_dim, precision)
    if h.device.type == "cpu":
        return fused_ce_fwd_plain(h, w, b, labels, valid_dim, precision)
    return _launch_fwd(h, w, b, labels, valid_dim, precision)


def fused_ce_bwd(h, w, b, labels, lse, ct, valid_dim, precision="highest"):
    """B2: (dh, dw, db). CPU tensors take the twin; CUDA tensors launch
    the kernel or raise."""
    _check(h, w, b, labels, valid_dim, precision)
    if h.device.type == "cpu":
        return fused_ce_bwd_plain(h, w, b, labels, lse, ct, valid_dim, precision)
    return _launch_bwd(h, w, b, labels, lse, ct, valid_dim, precision)


class _FusedSoftmaxCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, labels, valid_dim, precision):
        lse, lbl = fused_ce_fwd(h, w, b, labels, valid_dim, precision)
        ctx.valid_dim, ctx.precision = valid_dim, precision
        ctx.save_for_backward(h, w, b, labels, lse)
        return lse - lbl

    @staticmethod
    def backward(ctx, ct):
        h, w, b, labels, lse = ctx.saved_tensors
        dh, dw, db = fused_ce_bwd(h, w, b, labels, lse, ct, ctx.valid_dim, ctx.precision)
        return dh, dw, db, None, None, None


def fused_softmax_ce(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (F, A) head kernel
    b: torch.Tensor,  # (A,) head bias
    labels: torch.Tensor,  # (B,) int
    valid_dim: int,  # real (unpadded) actions; columns >= valid_dim are masked
    precision: str = "highest",
) -> torch.Tensor:
    """Per-example CE (-log softmax at the label) of ``h @ w + b``, (B,)
    fp32, differentiable in h, w and b. ``valid_dim`` is a plain int
    that the kernels take at run time."""
    return _FusedSoftmaxCE.apply(h, w, b, labels, int(valid_dim), precision)


class _FusedSoftmaxCETopk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, labels, k, valid_dim, precision):
        from ikea_recommender_tpu_torch.ops.fused_topk import blockwise_head_topk_ce

        _check(h, w, b, labels, valid_dim, precision)
        _, top_i, m, s, lbl = blockwise_head_topk_ce(
            h, w, b, k, valid_dim, labels=labels, raw_pieces=True, precision=precision
        )
        lse = m + torch.log(s)
        ctx.valid_dim, ctx.precision = valid_dim, precision
        ctx.save_for_backward(h, w, b, labels, lse)
        ctx.mark_non_differentiable(top_i)
        return lse - lbl, top_i

    @staticmethod
    def backward(ctx, ct, _top_i_ct):
        h, w, b, labels, lse = ctx.saved_tensors
        dh, dw, db = fused_ce_bwd(h, w, b, labels, lse, ct, ctx.valid_dim, ctx.precision)
        return dh, dw, db, None, None, None, None


def fused_softmax_ce_topk(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (F, A) head kernel
    b: torch.Tensor,  # (A,) head bias
    labels: torch.Tensor,  # (B,) int
    k: int,
    valid_dim: int,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-example CE (B,) fp32, top-k ids (B, k) int64) of ``h @ w + b``
    from one blockwise pass (``blockwise_head_topk_ce`` with ``raw_pieces``;
    no B1). Differentiable in h, w and b through the CE only, whose backward
    is B2 on the card; the ids take no gradient."""
    return _FusedSoftmaxCETopk.apply(h, w, b, labels, int(k), int(valid_dim), precision)
