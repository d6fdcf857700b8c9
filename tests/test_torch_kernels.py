"""The port's CUDA kernels against their plain twins, on the card.

These tests are marked ``cuda`` and skip without a GPU. The file imports
neither JAX nor the reference package, so it also runs where JAX is not
installed (the repository's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Kernel and twin take the same inputs on the card and differ only in the
order of fp32 sums (the twins' products are cuBLAS fp32 with TF32 off) and
in expf/tanhf against torch's exp/sigmoid/tanh. Tolerances:
- B3 (gru_fwd): atol and rtol 1e-5 (outputs of order 1);
- B4 (gru_bwd) and B1/B2 (fused_ce): max |kernel - twin| at most 1e-5
  times max |twin| for each output. dW_h, dh and dW sum up to ~10^4 to
  ~10^5 terms, so the bound scales with the output's size. B2's dW and db
  are also held on the columns that no row labels, where only the softmax
  term lands (~1e-6 at the train point, against ~1e-2 at a label).
"""

import pytest
import torch
from _torch_parity import cuda_device, gru_inputs, to_torch  # noqa: F401

from ikea_recommender_tpu_torch.ops import fused_ce, gru_cuda
from ikea_recommender_tpu_torch.ops.fused_ce import (
    fused_ce_bwd,
    fused_ce_bwd_plain,
    fused_ce_fwd,
    fused_ce_fwd_plain,
    fused_softmax_ce,
)
from ikea_recommender_tpu_torch.ops.gru_cuda import (
    gru_scan,
    gru_scan_bwd_plain,
    gru_scan_plain,
)

SHAPES = [  # (B, T, H, masked, reverse): the serving point, then long, wide, odd
    (512, 10, 64, True, False),
    (256, 200, 64, True, True),
    (256, 50, 256, False, False),
    (37, 9, 8, True, False),
    (3, 4, 128, True, True),  # the widest W_h held in shared memory by B3
    (50, 6, 192, True, False),  # the narrowest W_h read from L2 by B3
    (64, 20, 512, True, True),
]

BWD_SHAPES = [  # (B, T, H, masked, reverse) of B4's three layouts
    (256, 10, 64, True, False),  # the train point: W_h and dW_h in shared memory
    (256, 200, 64, True, True),
    (256, 50, 256, False, False),  # W_h from L2, dW_h in per-block slices
    (37, 9, 8, True, False),
    (50, 6, 96, True, True),  # the widest H with W_h in shared memory
    (3, 4, 128, True, False),  # W_h from L2, dW_h in shared memory
    (9, 5, 1024, True, True),  # six rows per block
]

CE_SHAPES = [  # (B, F, A, valid, precision, nan_tail)
    (256, 64, 70852, 70852, "high", False),  # the train point
    (256, 64, 70852, 70852, "highest", False),
    (256, 64, 70912, 70852, "high", True),  # padded columns, NaN in them
    (37, 24, 1000, 777, "default", False),  # odd sizes
    (300, 128, 4096, 3000, "high", True),  # F = 128 in two row groups; blocks past valid
]


def _assert_close(got, want, name, tol=1e-5):
    err = (got - want).abs().max().item()
    bound = tol * want.abs().max().item()
    assert err <= bound, f"{name}: max abs err {err:.3g} > {bound:.3g}"


def _off_label(labels, A, valid):
    """The valid columns that no row labels."""
    off = torch.arange(A, device=labels.device) < valid
    off[labels] = False
    return off


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,masked,reverse", SHAPES)
def test_gru_fwd_matches_twin(cuda_device, B, T, H, masked, reverse):
    xw, wh, bh, mask = to_torch(
        *gru_inputs(B, T, H, seed=B + T, masked=masked), device=cuda_device
    )
    before = gru_cuda.LAUNCHES
    y, h = gru_scan(xw, wh, bh, mask, reverse=reverse)
    torch.cuda.synchronize()
    assert gru_cuda.LAUNCHES == before + 1
    y_p, h_p = gru_scan_plain(xw, wh, bh, mask, reverse=reverse)
    torch.testing.assert_close(y, y_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, h_p, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,masked,reverse", BWD_SHAPES)
def test_gru_bwd_matches_twin(cuda_device, B, T, H, masked, reverse):
    xw, wh, bh, mask = to_torch(
        *gru_inputs(B, T, H, seed=B + H, masked=masked), device=cuda_device
    )
    g = torch.Generator(device=cuda_device).manual_seed(T)
    gy = torch.randn(B, T, H, device=cuda_device, generator=g)
    ghf = torch.randn(B, H, device=cuda_device, generator=g)
    y, _ = gru_scan_plain(xw, wh, bh, mask, reverse=reverse)
    before = gru_cuda.BWD_LAUNCHES
    got = gru_cuda._launch_bwd(xw, wh, bh, mask, y, gy, ghf, reverse)
    torch.cuda.synchronize()
    assert gru_cuda.BWD_LAUNCHES == before + 1
    want = gru_scan_bwd_plain(xw, wh, bh, mask, y, gy, ghf, reverse)
    for a, w, name in zip(got, want, ("dxw", "dwh", "dbh")):
        _assert_close(a, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("masked,reverse", [(True, False), (False, True)])
def test_gru_scan_autograd_runs_both_kernels(cuda_device, masked, reverse):
    """B3 forward and B4 backward under autograd, against the twins'
    gradients on the same inputs."""
    B, T, H = 64, 12, 64
    xw, wh, bh, mask = to_torch(*gru_inputs(B, T, H, seed=3, masked=masked), device=cuda_device)
    gy = torch.randn(B, T, H, device=cuda_device)
    ghf = torch.randn(B, H, device=cuda_device)
    leaves = [t.clone().requires_grad_() for t in (xw, wh, bh)]
    before = (gru_cuda.LAUNCHES, gru_cuda.BWD_LAUNCHES)
    y, h = gru_scan(*leaves, mask, reverse=reverse)
    ((y * gy).sum() + (h * ghf).sum()).backward()
    torch.cuda.synchronize()
    assert (gru_cuda.LAUNCHES, gru_cuda.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    y_p, _ = gru_scan_plain(xw, wh, bh, mask, reverse=reverse)
    want = gru_scan_bwd_plain(xw, wh, bh, mask, y_p, gy, ghf, reverse)
    for leaf, w, name in zip(leaves, want, ("xw", "wh", "bh")):
        _assert_close(leaf.grad, w, name)


@pytest.mark.cuda
def test_gru_fwd_rejects_mixed_devices(cuda_device):
    xw, wh, bh, mask = to_torch(*gru_inputs(8, 4, 8, seed=1), device=cuda_device)
    with pytest.raises(ValueError, match="different devices"):
        gru_scan(xw, wh.cpu(), bh, mask)


def _ce_inputs(B, F, A, valid, nan_tail, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn(B, F, device=device, generator=g)
    w = torch.randn(F, A, device=device, generator=g) / F**0.5
    b = torch.randn(A, device=device, generator=g) * 0.1
    labels = torch.randint(0, valid, (B,), device=device, generator=g)
    ct = torch.rand(B, device=device, generator=g) / B
    if nan_tail:
        w[:, valid:] = float("nan")
    return h, w, b, labels, ct


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,A,valid,precision,nan_tail", CE_SHAPES)
def test_fused_ce_matches_twin(cuda_device, B, F, A, valid, precision, nan_tail):
    h, w, b, labels, ct = _ce_inputs(B, F, A, valid, nan_tail, cuda_device)
    before = (fused_ce.LAUNCHES, fused_ce.BWD_LAUNCHES)
    lse, lbl = fused_ce_fwd(h, w, b, labels, valid, precision)
    dh, dw, db = fused_ce_bwd(h, w, b, labels, lse, ct, valid, precision)
    torch.cuda.synchronize()
    assert (fused_ce.LAUNCHES, fused_ce.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    lse_p, lbl_p = fused_ce_fwd_plain(h, w, b, labels, valid, precision)
    dh_p, dw_p, db_p = fused_ce_bwd_plain(h, w, b, labels, lse_p, ct, valid, precision)
    for got, want, name in ((lse, lse_p, "lse"), (lbl, lbl_p, "label logit"),
                            (dh, dh_p, "dh"), (dw, dw_p, "dw"), (db, db_p, "db")):
        assert torch.isfinite(got).all(), name
        _assert_close(got, want, name)
    off = _off_label(labels, A, valid)
    _assert_close(dw[:, off], dw_p[:, off], "dw off-label")
    _assert_close(db[off], db_p[off], "db off-label")
    assert (dw[:, valid:] == 0).all() and (db[valid:] == 0).all()


@pytest.mark.cuda
def test_fused_softmax_ce_autograd_runs_both_kernels(cuda_device):
    B, F, A, valid = 128, 64, 5000, 4900
    h, w, b, labels, ct = _ce_inputs(B, F, A, valid, False, cuda_device, seed=1)
    leaves = [t.clone().requires_grad_() for t in (h, w, b)]
    before = (fused_ce.LAUNCHES, fused_ce.BWD_LAUNCHES)
    loss = fused_softmax_ce(*leaves, labels, valid, "high")
    (loss * ct).sum().backward()
    torch.cuda.synchronize()
    assert (fused_ce.LAUNCHES, fused_ce.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    lse_p, lbl_p = fused_ce_fwd_plain(h, w, b, labels, valid, "high")
    _assert_close(loss.detach(), lse_p - lbl_p, "ce")
    want = fused_ce_bwd_plain(h, w, b, labels, lse_p, ct, valid, "high")
    for leaf, wnt, name in zip(leaves, want, ("h", "w", "b")):
        _assert_close(leaf.grad, wnt, name)
    off = _off_label(labels, A, valid)
    _assert_close(leaves[1].grad[:, off], want[1][:, off], "w off-label")
