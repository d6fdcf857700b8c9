"""Fused head argmax: the B5 and B6 kernels, their plain twins, and the
one-logit-per-row gathers of the double-Q steps.

Port of ``ikea_recommender_tpu/ops/fused_argmax.py``. The double-Q target
needs only ``argmax_a Q_main(s', a)`` and one gathered Q value per row, so
neither the (B, A) nor the (B, K, A) Q logits are written to device memory:

- :func:`fused_linear_argmax` (B5): argmax over the masked ``h @ w + b``,
  sqn's target action;
- :func:`fused_weighted_multihead_argmax` (B6): argmax over the masked
  ``sum_k q_weights[k] * (h @ w[k] + b[k])``, smorl's scalarized target
  action;
- :func:`row_logit` and :func:`multihead_row_logit`: ``(h @ w + b)[i,
  idx[i]]`` per row (and per head) as a column gather and a dot.

Both argmaxes are forward only (their consumers take no gradient through
them) and break ties to the lowest action id, as ``jnp.argmax`` does; columns
at or past ``valid_dim`` (a runtime int) are masked to -1e30 before any
comparison, so they never win and NaN there never reaches the result. On
CUDA tensors they launch ``csrc/fused_argmax.cu``, whose header says what
bounds it and how it is laid out; it takes any head width F and any head
count K in every precision, as the reference's kernels do (past F = 128 or
K = 5 on the wide head walk of ``csrc/mma_tile.cuh``); on CPU tensors they run
:func:`fused_linear_argmax_plain` and :func:`fused_weighted_multihead_argmax_plain`,
which form the dense masked logits with the same ``_dot`` as the fused CE's
twins. There is no fallback from one to the other. ``precision`` is the
fused CE's (``ops/fused_ce.py``). With ``action_major`` W is the lazy
optimizers' layout (``train/lazy_adam.py``): (A, F) for B5 and (A, K·F) for
B6, head k's columns ``[:, k·F:(k+1)·F]``. On the card that launches the
kernels' action-major form, which reads W's rows where it stages them and
is counted apart (``AM_LAUNCHES``, ``WEIGHTED_AM_LAUNCHES``); W is never
laid out again on the card.

``row_logit`` and ``multihead_row_logit`` are plain differentiable torch: a
column gather, a dot and the bias gather; autograd's scatter-add forms dW
and db (accumulating where a batch repeats an action). The reference's
``_onehot_colgrad`` is not ported: it only worked around slow minor-axis
scatters on the TPU, as its docstring says. Its ``take_cols_sorted`` is, as
:func:`take_cols_sorted`, a helper that replaces no kernel: ``row_logit``
gathers its columns directly.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from ikea_recommender_tpu_torch.ops import build
from ikea_recommender_tpu_torch.ops.fused_ce import PRECISIONS, _dot

_NEG = -1e30

# Launches of each CUDA kernel, counted where it is launched and nowhere else.
LAUNCHES = 0  # B5, fused_linear_argmax
WEIGHTED_LAUNCHES = 0  # B6, fused_weighted_multihead_argmax
AM_LAUNCHES = 0  # B5 on an action-major W
WEIGHTED_AM_LAUNCHES = 0  # B6 on an action-major W

_FNS = None


def _head(w: torch.Tensor, k: int, F: int, action_major: bool) -> torch.Tensor:
    """Head k's (F, A) kernel: a slice of the canonical (K, F, A) or (F, A)
    W, or the transpose of the action-major W's columns k F..(k+1) F."""
    if action_major:
        return w[:, k * F:(k + 1) * F].T
    return w if w.dim() == 2 else w[k]


def head_values_plain(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (F, A), or (K, F, A) with q_weights; action-major (A, K F)
    b: torch.Tensor,  # (A,), or (K, A)
    valid_dim: int,
    precision: str = "highest",
    q_weights: Optional[torch.Tensor] = None,  # (K,)
    action_major: bool = False,
) -> torch.Tensor:
    """The (B, A) values whose argmax B5 (``q_weights`` None: ``h @ w + b``)
    or B6 (``sum_k q_weights[k] * (h @ w[k] + b[k])``, summed in head order
    from 0 as the kernel and the reference's kernel sum it) takes, with
    columns >= ``valid_dim`` set to -1e30."""
    F = h.shape[1]
    if q_weights is None:
        v = _dot(h, _head(w, 0, F, action_major), precision) + b
    else:
        A = b.shape[1]
        v = torch.zeros((h.shape[0], A), dtype=torch.float32, device=h.device)
        for k in range(q_weights.shape[0]):
            v = v + q_weights[k] * (_dot(h, _head(w, k, F, action_major), precision) + b[k])
    col = torch.arange(v.shape[1], device=v.device)
    return torch.where(col < valid_dim, v, _NEG)


def fused_linear_argmax_plain(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (F, A); action-major (A, F)
    b: torch.Tensor,  # (A,)
    valid_dim: int,
    precision: str = "highest",
    action_major: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5's twin: (ids (B,) int64, max (B,)) of the masked ``h @ w + b``;
    ``argmax`` returns the first of equal maxima."""
    v = head_values_plain(h, w, b, valid_dim, precision, action_major=action_major)
    return v.argmax(dim=1), v.amax(dim=1)


def fused_weighted_multihead_argmax_plain(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (K, F, A); action-major (A, K F)
    b: torch.Tensor,  # (K, A)
    q_weights: torch.Tensor,  # (K,)
    valid_dim: int,
    precision: str = "highest",
    action_major: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6's twin: (ids, max) of the masked weighted head sum."""
    v = head_values_plain(h, w, b, valid_dim, precision, q_weights, action_major)
    return v.argmax(dim=1), v.amax(dim=1)


def _check(h, w, b, q_weights, valid_dim, precision, action_major) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    tensors = (h, w, b) if q_weights is None else (h, w, b, q_weights)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"fused argmax: inputs on different devices {[str(t.device) for t in tensors]}"
        )
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"fused argmax takes float32 inputs, got {t.dtype}")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused argmax runs on cpu or cuda tensors, got {h.device}")
    K = 1 if q_weights is None else q_weights.shape[0]
    F, A = h.shape[-1], w.shape[0] if action_major else w.shape[-1]
    if action_major:
        want_w = (A, K * F)
    else:
        want_w = (F, A) if q_weights is None else (K, F, A)
    want_b = (A,) if q_weights is None else (K, A)
    if h.dim() != 2 or tuple(w.shape) != want_w or tuple(b.shape) != want_b:
        raise ValueError(
            f"h must be (B, F), w {want_w} and b {want_b}"
            f"{' (action-major)' if action_major else ''}, got "
            f"{tuple(h.shape)} {tuple(w.shape)} {tuple(b.shape)}"
        )
    if q_weights is not None and (q_weights.dim() != 1 or K < 1):
        raise ValueError(f"q_weights must be (K,) with K >= 1, got {tuple(q_weights.shape)}")
    if not 0 <= int(valid_dim) <= A:
        raise ValueError(f"valid_dim must lie in [0, {A}], got {valid_dim}")


def _kernel_fns():
    global _FNS
    if _FNS is None:
        lib = build.load("fused_argmax")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = lib.fused_argmax
        fn.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
        fn.restype = i32
        scratch = lib.fused_argmax_scratch
        scratch.argtypes = [i32] * 6
        scratch.restype = ctypes.c_longlong
        _FNS = fn, scratch
    return _FNS


def _launch(h, w, b, q_weights, valid_dim, precision, action_major):
    for t in (h, w, b) if q_weights is None else (h, w, b, q_weights):
        if not t.is_contiguous():
            raise ValueError("fused argmax takes contiguous inputs on CUDA")
    (B, F), A = h.shape, w.shape[0] if action_major else w.shape[-1]
    K = 1 if q_weights is None else q_weights.shape[0]
    fn, scratch = _kernel_fns()
    dev = h.device
    idx = torch.empty((B,), dtype=torch.int64, device=dev)
    mx = torch.empty((B,), dtype=torch.float32, device=dev)
    p = PRECISIONS.index(precision)
    with torch.cuda.device(dev):
        n = scratch(B, F, A, K, int(q_weights is not None), p)
        part_max = torch.empty((n,), dtype=torch.float32, device=dev)
        part_idx = torch.empty((n,), dtype=torch.int32, device=dev)
        err = fn(
            h.data_ptr(), w.data_ptr(), b.data_ptr(),
            None if q_weights is None else q_weights.data_ptr(),
            idx.data_ptr(), mx.data_ptr(), part_max.data_ptr(), part_idx.data_ptr(),
            B, F, A, K, int(valid_dim), p, int(action_major),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_argmax kernel launch failed with CUDA error {err}")
    return idx, mx


def fused_linear_argmax(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (F, A) head kernel; action-major (A, F)
    b: torch.Tensor,  # (A,) head bias
    valid_dim: int,  # real actions; columns >= valid_dim are masked
    precision: str = "highest",
    with_max: bool = False,
    action_major: bool = False,
):
    """B5: argmax over the masked ``h @ w + b``, (B,) int64 ids, lowest id
    on ties; with ``with_max`` also the (B,) max. ``action_major``: w is
    (A, F). Not differentiable. CPU tensors take the twin; CUDA tensors
    launch the kernel or raise."""
    global LAUNCHES, AM_LAUNCHES
    h, w, b = h.detach(), w.detach(), b.detach()
    _check(h, w, b, None, valid_dim, precision, action_major)
    if h.device.type == "cpu":
        idx, mx = fused_linear_argmax_plain(h, w, b, valid_dim, precision, action_major)
    else:
        idx, mx = _launch(h, w, b, None, valid_dim, precision, action_major)
        if action_major:
            AM_LAUNCHES += 1
        else:
            LAUNCHES += 1
    return (idx, mx) if with_max else idx


def fused_weighted_multihead_argmax(
    h: torch.Tensor,  # (B, F)
    w: torch.Tensor,  # (K, F, A) stacked head kernel; action-major (A, K F)
    b: torch.Tensor,  # (K, A)
    q_weights: Union[torch.Tensor, Sequence[float]],  # (K,)
    valid_dim: int,
    precision: str = "highest",
    with_max: bool = False,
    action_major: bool = False,
):
    """B6: argmax over the masked ``sum_k q_weights[k] * (h @ w[k] + b[k])``,
    (B,) int64 ids, lowest id on ties; with ``with_max`` also the (B,) max.
    ``action_major``: w is (A, K F). Not differentiable. CPU tensors take
    the twin; CUDA tensors launch the kernel or raise."""
    global WEIGHTED_LAUNCHES, WEIGHTED_AM_LAUNCHES
    h, w, b = h.detach(), w.detach(), b.detach()
    q_weights = torch.as_tensor(q_weights, dtype=torch.float32, device=h.device)
    _check(h, w, b, q_weights, valid_dim, precision, action_major)
    if h.device.type == "cpu":
        idx, mx = fused_weighted_multihead_argmax_plain(
            h, w, b, q_weights, valid_dim, precision, action_major)
    else:
        idx, mx = _launch(h, w, b, q_weights, valid_dim, precision, action_major)
        if action_major:
            WEIGHTED_AM_LAUNCHES += 1
        else:
            WEIGHTED_LAUNCHES += 1
    return (idx, mx) if with_max else idx


def row_logit(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(h @ w + b)[i, idx[i]]`` (B,) without the (B, A) product, for w
    (F, A); differentiable in h, w and b."""
    idx = idx.long()
    return (h * w[:, idx].T).sum(dim=1) + b[idx]


def multihead_row_logit(
    h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """(B, K): every head's ``(h @ w[k] + b[k])[i, idx[i]]``, for w
    (K, F, A) and b (K, A); differentiable in h, w and b."""
    idx = idx.long()
    return torch.einsum("bf,kfb->bk", h, w[:, :, idx]) + b[:, idx].T


def take_cols_sorted(w: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.index_select(w, dim, idx)`` as the reference's
    ``take_cols_sorted``: the ids sorted, the gather, then the inverse
    permutation of the result. Exact: a permutation gather composed with
    its inverse."""
    idx = torch.as_tensor(idx, device=w.device).long()
    order = torch.argsort(idx)
    inv = torch.argsort(order)
    return torch.index_select(torch.index_select(w, dim, idx[order]), dim, inv)
