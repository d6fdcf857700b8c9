"""Length-masked GRU recurrence: the B3 forward and B4 backward kernels and
their plain twins.

:func:`gru_scan` replaces ``ikea_recommender_tpu/ops/gru_pallas.py::
gru_scan_pallas``, forward (the TPU kernel ``_fwd_kernel``) and backward
(``_bwd_kernel``, behind its custom VJP). Given the hoisted input projection
``xw = x W_i + b_i`` it runs the recurrence (gates r|z|n,
``n = tanh(xn + r * (h W_hn + b_hn))``, ``h_t = mask_t ? cand : h_{t-1}``,
``h_0 = 0``) and returns the output sequence and the final state. It is
differentiable in ``xw``, ``wh`` and ``bh``.

On CUDA tensors the forward launches ``csrc/gru_fwd.cu`` and the backward
``csrc/gru_bwd.cu``; each source's header says what bounds it and how it is
laid out. On CPU tensors the forward runs :func:`gru_scan_plain` and the
backward :func:`gru_scan_bwd_plain`, the same functions written out as
Python loops over T. There is no fallback from one to the other. Both
directions go through one ``torch.autograd.Function``, which saves
``(xw, wh, bh, mask, y)`` as the reference's ``_fused_fwd`` does: the
backward recomputes the gates from ``(xw_t, y_{t-1})``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ikea_recommender_tpu_torch.ops import build

# Launches of each CUDA kernel, counted where it is launched and nowhere else.
LAUNCHES = 0  # B3, gru_fwd
BWD_LAUNCHES = 0  # B4, gru_bwd

_FN = None
_BWD_FN = None


def gru_scan_plain(
    xw: torch.Tensor,  # (B, T, 3H) precomputed x W_i + b_i
    wh: torch.Tensor,  # (H, 3H)
    bh: torch.Tensor,  # (3H,)
    mask: Optional[torch.Tensor] = None,  # (B, T) float; None = no masking
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence as a plain loop over T, mirroring
    ``ikea_recommender_tpu/models/gru.py::_gru_scan``. Returns
    (output_seq (B, T, H), final_h (B, H))."""
    B, T, H3 = xw.shape
    H = H3 // 3
    h = xw.new_zeros((B, H))
    ys = [None] * T
    for t in reversed(range(T)) if reverse else range(T):
        hw = h @ wh + bh
        xr, xz, xn = xw[:, t].split(H, dim=-1)
        hr, hz, hn = hw.split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        if mask is not None:
            h_new = torch.where(mask[:, t, None] > 0, h_new, h)
        h = h_new
        ys[t] = h
    return torch.stack(ys, dim=1), h


def gru_scan_bwd_plain(
    xw: torch.Tensor,  # (B, T, 3H)
    wh: torch.Tensor,  # (H, 3H)
    bh: torch.Tensor,  # (3H,)
    mask: Optional[torch.Tensor],  # (B, T) float or None
    y: torch.Tensor,  # (B, T, H) the forward's output sequence
    gy: torch.Tensor,  # (B, T, H) cotangent of y
    g_hfin: torch.Tensor,  # (B, H) cotangent of the final state
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The adjoint recurrence as a plain loop, mirroring
    ``ikea_recommender_tpu/ops/gru_pallas.py::_bwd_kernel``: it walks the
    steps in the opposite order of the forward, recomputes the gates from
    ``(xw_t, h_prev)`` with ``h_prev`` the forward's previous output (zero at
    its first step), and routes ``dh`` past steps the mask froze. Returns
    (dxw (B, T, 3H), dwh (H, 3H), dbh (3H,))."""
    B, T, H3 = xw.shape
    H = H3 // 3
    dxw = torch.empty_like(xw)
    dwh = torch.zeros_like(wh)
    dbh = torch.zeros_like(bh)
    dh = g_hfin
    zero = xw.new_zeros((B, H))
    for t in range(T) if reverse else reversed(range(T)):
        first = t == (T - 1 if reverse else 0)  # the forward's first step
        h_prev = zero if first else y[:, t + 1 if reverse else t - 1]
        dh = dh + gy[:, t]

        hw = h_prev @ wh + bh
        xr, xz, xn = xw[:, t].split(H, dim=-1)
        hr, hz, hn = hw.split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)

        m = 1.0 if mask is None else mask[:, t, None]
        dh_t = dh * m
        dh_skip = dh * (1.0 - m)
        dn = dh_t * (1.0 - z)
        dz = dh_t * (h_prev - n)
        da_n = dn * (1.0 - n * n)
        dr = da_n * hn
        dhn = da_n * r
        da_z = dz * z * (1.0 - z)
        da_r = dr * r * (1.0 - r)

        dxw[:, t] = torch.cat([da_r, da_z, da_n], dim=1)
        dhw = torch.cat([da_r, da_z, dhn], dim=1)
        dwh += h_prev.T @ dhw
        dbh += dhw.sum(dim=0)
        dh = dh_t * z + dhw @ wh.T + dh_skip
    return dxw, dwh, dbh


def _check(xw, wh, bh, mask) -> None:
    tensors = [xw, wh, bh] + ([] if mask is None else [mask])
    if len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"gru_scan: inputs on different devices {[str(t.device) for t in tensors]}"
        )
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"gru_scan takes float32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("gru_scan takes contiguous tensors")
    if xw.dim() != 3 or xw.shape[2] % 3:
        raise ValueError(f"xw must be (B, T, 3H), got {tuple(xw.shape)}")
    B, T, H3 = xw.shape
    H = H3 // 3
    if B < 1 or T < 1:
        raise ValueError(f"gru_scan needs B >= 1 and T >= 1, got B={B} T={T}")
    if tuple(wh.shape) != (H, H3) or tuple(bh.shape) != (H3,):
        raise ValueError(
            f"wh must be {(H, H3)} and bh {(H3,)}, got {tuple(wh.shape)} {tuple(bh.shape)}"
        )
    if mask is not None and tuple(mask.shape) != (B, T):
        raise ValueError(f"mask must be {(B, T)}, got {tuple(mask.shape)}")
    device = xw.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"gru_scan runs on cpu or cuda tensors, got {device}")
    if device.type == "cuda" and H > 1024:
        raise ValueError(f"the gru kernels take H <= 1024, got H={H}")


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load("gru_fwd").gru_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bwd_kernel_fn():
    global _BWD_FN
    if _BWD_FN is None:
        fn = build.load("gru_bwd").gru_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BWD_FN = fn
    return _BWD_FN


def _launch(xw, wh, bh, mask, reverse):
    global LAUNCHES
    B, T, H3 = xw.shape
    H = H3 // 3
    fn = _kernel_fn()
    y = torch.empty((B, T, H), dtype=torch.float32, device=xw.device)
    hfin = torch.empty((B, H), dtype=torch.float32, device=xw.device)
    with torch.cuda.device(xw.device):
        err = fn(
            xw.data_ptr(), wh.data_ptr(), bh.data_ptr(),
            None if mask is None else mask.data_ptr(),
            y.data_ptr(), hfin.data_ptr(),
            B, T, H, int(reverse),
            torch.cuda.current_stream(xw.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gru_fwd kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return y, hfin


def _launch_bwd(xw, wh, bh, mask, y, gy, g_hfin, reverse):
    global BWD_LAUNCHES
    B, T, H3 = xw.shape
    H = H3 // 3
    fn = _bwd_kernel_fn()
    dev = xw.device
    dxw = torch.empty_like(xw)
    dhw = torch.empty_like(xw)  # scratch: the step adjoints [da_r, da_z, dhn]
    dwb = torch.empty((H + 1, H3), dtype=torch.float32, device=dev)  # [dW_h; db_h]
    with torch.cuda.device(dev):
        err = fn(
            xw.data_ptr(), wh.data_ptr(), bh.data_ptr(),
            None if mask is None else mask.data_ptr(),
            y.data_ptr(), gy.data_ptr(), g_hfin.data_ptr(),
            dxw.data_ptr(), dhw.data_ptr(), dwb.data_ptr(),
            B, T, H, int(reverse),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gru_bwd kernel launch failed with CUDA error {err}")
    BWD_LAUNCHES += 1
    return dxw, dwb[:H], dwb[H]


def _cotangent(g, like):
    return torch.zeros_like(like) if g is None else g.contiguous()


class _GruScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xw, wh, bh, mask, reverse):
        if xw.device.type == "cpu":
            y, hfin = gru_scan_plain(xw, wh, bh, mask, reverse)
        else:
            y, hfin = _launch(xw, wh, bh, mask, reverse)
        ctx.reverse = reverse
        ctx.save_for_backward(xw, wh, bh, mask, y)
        return y, hfin

    @staticmethod
    def backward(ctx, gy, g_hfin):
        xw, wh, bh, mask, y = ctx.saved_tensors
        gy, g_hfin = _cotangent(gy, y), _cotangent(g_hfin, y[:, 0])
        if xw.device.type == "cpu":
            grads = gru_scan_bwd_plain(xw, wh, bh, mask, y, gy, g_hfin, ctx.reverse)
        else:
            grads = _launch_bwd(xw, wh, bh, mask, y, gy, g_hfin, ctx.reverse)
        return (*grads, None, None)


def gru_scan(
    xw: torch.Tensor,  # (B, T, 3H) precomputed x W_i + b_i
    wh: torch.Tensor,  # (H, 3H)
    bh: torch.Tensor,  # (3H,)
    mask: Optional[torch.Tensor] = None,  # (B, T) float; None = no masking
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the recurrence; returns (output_seq (B, T, H), final_h (B, H)).

    All inputs are float32, contiguous and on one device. CPU tensors take
    the plain twins; CUDA tensors launch the kernels or raise. ``reverse``
    walks t from T-1 down to 0 and leaves y at its own t, as
    ``gru_scan_pallas(reverse=True)`` does by flipping. Gradients flow to
    ``xw``, ``wh`` and ``bh`` (never to ``mask``)."""
    _check(xw, wh, bh, mask)
    if mask is not None:
        mask = mask.detach()
    return _GruScan.apply(xw, wh, bh, mask, reverse)
