"""The port's CUDA kernels against their plain twins, on the card.

These tests are marked ``cuda`` and skip without a GPU. The file imports
neither JAX nor the reference package, so it also runs where JAX is not
installed (the repository's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Kernel and twin take the same inputs on the card and differ only in the
order of fp32 sums (the twins' products are cuBLAS fp32 with TF32 off) and
in expf/tanhf against torch's exp/sigmoid/tanh. Tolerances:
- B3 (gru_fwd): atol and rtol 1e-5 (outputs of order 1); where a block's rows
  are all masked, h carried bit for bit;
- B3 and B4 on bfloat16 tensors (``compute_dtype="bfloat16"``): both sides
  compute in fp32 and round only their outputs, so an output differs by at
  most one bf16 step where the two fp32 values straddle a rounding
  boundary: one step is at most 2 * 2^-8 (bf16's unit roundoff) of the
  value, and the fp32 gate's 1e-5 of the largest entry is added for values
  that cancel (y, h_fin, dxw elementwise; dW_h and db_h one step of the
  leaf's largest entry);
- B4 (gru_bwd) and B1/B2 (fused_ce): max |kernel - twin| at most 1e-5
  times max |twin| for each output. dW_h, dh and dW sum up to ~10^4 to
  ~10^5 terms, so the bound scales with the output's size. B2's dW and db
  are also held on the columns that no row labels, where only the softmax
  term lands (~1e-6 at the train point, against ~1e-2 at a label); in
  "default" at the gru4rec and bidir train points and at F = 200 and 250
  that dW is held to one bf16 step (DW_OFF_LABEL_TOL);
- B5/B6 (fused_argmax), canonical and action-major: the max within 1e-5
  of the twin's largest |max| everywhere; ids equal wherever the twin's top two values differ by more
  than that (the rows excluded are counted and must be few). On inputs of
  small integers every sum is exact in any order, so there the ids, ties
  included, must be equal everywhere and the lowest of the tied ids; on
  data whose weighted head sum rounds differently in head order than with
  q folded into W, B6's ids and maxima must equal the twin's bit for bit;
  the action-major forms equal the canonical forms bit for bit;
- the eval protocol (B3 in its backbone) on the card against the CPU: on
  rows whose top-21 scores are more than 1e-5 apart, HR, repetitions and
  coverage equal, NDCG within 1e-6, the loss and rewards within 1e-5.
"""

import pytest
import torch
from _torch_parity import (  # noqa: F401
    cuda_device,
    fold_sensitive_heads,
    folded_head_values,
    gru_inputs,
    to_torch,
)

from ikea_recommender_tpu_torch.ops import fused_argmax, fused_ce, gru_cuda
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

SHAPES = [  # (B, T, H, masked, reverse) over B3's layouts: W_h in registers up to
    # H = 64, in shared memory up to 128, read from L2 above; 1, 2 or 4 rows a
    # block (4 at the serving point); 16-byte copies where H % 4 == 0, else 4-byte
    (512, 10, 64, True, False),  # the serving point
    (256, 200, 64, True, True),
    (256, 50, 256, False, False),
    (37, 9, 8, True, False),
    (3, 4, 128, True, True),  # the widest W_h held in shared memory by B3
    (50, 6, 192, True, False),  # the narrowest W_h read from L2 by B3
    (64, 20, 512, True, True),
    (256, 10, 64, True, False),  # the train point
    (256, 10, 128, True, False),  # the bidir point, both directions
    (256, 10, 128, True, True),
    (37, 7, 50, True, True),  # H % 4 != 0: 4-byte copies, W_h in registers
    (9, 4, 126, True, False),  # H % 4 != 0, W_h in shared memory
    (7, 3, 130, True, False),  # H % 4 != 0, W_h from L2
    (64, 1, 64, True, False),  # T = 1: only the product-free first step
    (64, 1, 128, False, True),
    (2000, 10, 64, True, False),  # the eval batch: 500 blocks of 4 rows, ~3.8 waves
    (2000, 10, 128, True, True),  # the eval batch at the bidir point
    (5000, 10, 64, True, False),  # the IKEA eval batch: 1250 blocks of 4 rows
]

BWD_SHAPES = [  # (B, T, H, masked, reverse) over B4's layouts: 2 rows a block and W_h
    # in shared memory up to H = 128, 1 row and W_h from L2 above; 16-byte
    # copies where H % 4 == 0, else 4-byte
    (256, 10, 64, True, False),  # the train point
    (256, 10, 128, True, False),  # the bidir point, both directions: the widest
    (256, 10, 128, True, True),  # W_h in shared memory
    (256, 200, 64, True, True),  # long sequences, reverse direction
    (256, 50, 256, False, False),  # W_h from L2, unmasked
    (37, 9, 8, True, False),  # B odd: a block's second row is padding
    (50, 6, 96, True, True),
    (3, 4, 128, True, False),  # B odd at the widest W_h in shared memory
    (9, 5, 1024, True, True),  # the widest H the kernel takes
    (37, 7, 50, True, True),  # H % 4 != 0: 4-byte copies, W_h in shared memory
    (7, 3, 130, True, False),  # H % 4 != 0 with W_h from L2
    (64, 1, 64, True, False),  # T = 1: only the forward's first step
    (64, 1, 64, False, True),
]

CE_SHAPES = [  # (B, F, A, valid, precision, nan_tail)
    (256, 64, 70852, 70852, "high", False),  # the train point
    (256, 64, 70852, 70852, "default", False),
    (256, 64, 70852, 70852, "highest", False),
    (256, 64, 70912, 70852, "high", True),  # padded columns, NaN in them
    (37, 24, 1000, 777, "default", False),  # odd sizes
    (37, 24, 1000, 777, "high", False),  # F padded to a multiple of 16
    (64, 40, 4099, 4001, "high", True),  # A % 4 != 0: W's rows unaligned
    (300, 128, 4096, 3000, "high", True),  # F = 128 in row groups; blocks past valid
    (256, 256, 70852, 70852, "high", False),  # the bidir point (2 H at hidden 128)
    (256, 256, 70852, 70852, "default", False),
    (256, 256, 70852, 70852, "highest", False),
    (256, 256, 70912, 70852, "high", True),  # the bidir point, NaN-padded
    (100, 200, 4099, 4001, "high", True),  # F sliced 128 + 72, a ragged row tile
    (100, 200, 4099, 4001, "default", True),
    # F % 4 != 0: h's rows unaligned, so B1 stages them 4 bytes a copy; in
    # one slice, and in slices of 128 + 122
    (37, 90, 1000, 777, "high", False),
    (100, 250, 4099, 4001, "high", True),
    (100, 250, 4099, 4001, "default", True),
    (256, 64, 10000, 10000, "high", False),  # the IKEA train point: 10000 images
]

# B2's off-label dW where it is not held to 1e-5. In "default" B2 rounds dl
# to bf16 before the products, and two correct orders of the logits' sums
# differ by ~1e-3 on those columns at the train point
# (test_torch_fused_ce.py::test_default_off_label_dw_is_ill_conditioned), so
# there it is held to one bf16 step; at F = 200 the card showed 4.5e-4.
DW_OFF_LABEL_TOL = {
    **{(256, F, 70852, 70852, "default", False): 2.0**-8 for F in (64, 256)},
    **{(100, F, 4099, 4001, "default", True): 2.0**-8 for F in (200, 250)},
}


def _assert_close(got, want, name, tol=1e-5):
    err = (got - want).abs().max().item()
    bound = tol * want.abs().max().item()
    assert err <= bound, f"{name}: max abs err {err:.3g} > {bound:.3g}"


BF16_STEP = 2 * 2.0**-8  # one bf16 step, at most, relative to the value


def _assert_bf16_close(got, want, name, leaf=False):
    """Within one bf16 step of each value (``leaf``: of the largest entry),
    plus the fp32 gate's 1e-5 of the largest entry."""
    assert got.dtype == want.dtype == torch.bfloat16, name
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), name
    top = want.abs().max()
    bound = (BF16_STEP * (top if leaf else want.abs())) + 1e-5 * top
    excess = ((got - want).abs() - bound).max().item()
    assert excess <= 0, f"{name}: {excess:.3g} past one bf16 step"


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


# Lengths whose blocks of 2 and of 4 rows are all masked at some steps: rows
# 4-5 and 8-11 never step, 12-15 only twice.
FWD_MASKED_LENS = [2, 2, 6, 6, 0, 0, 3, 1, 0, 0, 0, 0, 2, 2, 2, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B", [264, 528])  # 2 and 4 rows a block on 132 SMs
def test_gru_fwd_blocks_masked_at_some_steps(cuda_device, B, reverse):
    """Where a block's rows are all masked at a step, h is carried: y equals
    the twin, and at a masked step it is the h of the row's last unmasked
    step bit for bit (zero where none came before)."""
    T, H = 6, 64
    xw, wh, bh, _ = to_torch(*gru_inputs(B, T, H, seed=B, masked=False), device=cuda_device)
    lens = torch.tensor(FWD_MASKED_LENS, device=cuda_device).repeat(B // 16 + 1)[:B]
    mask = (torch.arange(T, device=cuda_device)[None, :] < lens[:, None]).float()
    y, h = gru_scan(xw, wh, bh, mask, reverse=reverse)
    torch.cuda.synchronize()
    y_p, h_p = gru_scan_plain(xw, wh, bh, mask, reverse=reverse)
    torch.testing.assert_close(y, y_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, h_p, atol=1e-5, rtol=1e-5)
    for t in range(T):
        off = lens <= t  # masked at step t
        if reverse:  # walked first: nothing unmasked came before
            want = torch.zeros_like(y[off, t])
        else:
            last = (lens[off] - 1).clamp(min=0)
            want = torch.where(lens[off, None] > 0, y[off, last], 0.0)
        assert torch.equal(y[off, t], want), t


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T,H,masked,reverse",
    [(256, 10, 64, True, False), (512, 10, 64, True, False), (256, 10, 128, True, False),
     (256, 10, 128, True, True), (2000, 10, 64, True, False)],
)
def test_gru_fwd_is_bit_identical_over_two_launches(cuda_device, B, T, H, masked, reverse):
    """At the train, serving, bidir and eval points two launches on the same
    inputs give the same y and h_fin bit for bit: each product's pieces are
    added in a fixed order."""
    xw, wh, bh, mask = to_torch(*gru_inputs(B, T, H, seed=B + T, masked=masked),
                                device=cuda_device)
    first = gru_scan(xw, wh, bh, mask, reverse=reverse)
    again = gru_scan(xw, wh, bh, mask, reverse=reverse)
    torch.cuda.synchronize()
    for a, b, name in zip(first, again, ("y", "h_fin")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,masked,reverse", BWD_SHAPES)
def test_gru_bwd_matches_twin(cuda_device, B, T, H, masked, reverse):
    xw, wh, bh, mask, y, gy, ghf = _bwd_case(B, T, H, masked, reverse, cuda_device)
    before = gru_cuda.BWD_LAUNCHES
    got = gru_cuda._launch_bwd(xw, wh, bh, mask, y, gy, ghf, reverse)
    torch.cuda.synchronize()
    assert gru_cuda.BWD_LAUNCHES == before + 1
    want = gru_scan_bwd_plain(xw, wh, bh, mask, y, gy, ghf, reverse)
    for a, w, name in zip(got, want, ("dxw", "dwh", "dbh")):
        _assert_close(a, w, name)


def _bwd_case(B, T, H, masked, reverse, device):
    xw, wh, bh, mask = to_torch(*gru_inputs(B, T, H, seed=B + H, masked=masked), device=device)
    g = torch.Generator(device=device).manual_seed(T)
    gy = torch.randn(B, T, H, device=device, generator=g)
    ghf = torch.randn(B, H, device=device, generator=g)
    y, _ = gru_scan_plain(xw, wh, bh, mask, reverse=reverse)
    return xw, wh, bh, mask, y, gy, ghf


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_bwd_blocks_masked_at_some_steps(cuda_device, reverse):
    """Blocks whose rows are all masked at a step only carry dh there: rows
    0-1 run 2 steps, 2-3 all 6, 4-5 none, 6 (a block of its own) 3. The
    masked steps' dxw must be the twin's zeros, and all else the twin's."""
    B, T, H = 7, 6, 64
    xw, wh, bh, _, _, gy, ghf = _bwd_case(B, T, H, False, reverse, cuda_device)
    lens = torch.tensor([2, 2, 6, 6, 0, 0, 3], device=cuda_device)
    mask = (torch.arange(T, device=cuda_device)[None, :] < lens[:, None]).float()
    y, _ = gru_scan_plain(xw, wh, bh, mask, reverse=reverse)
    got = gru_cuda._launch_bwd(xw, wh, bh, mask, y, gy, ghf, reverse)
    torch.cuda.synchronize()
    want = gru_scan_bwd_plain(xw, wh, bh, mask, y, gy, ghf, reverse)
    for a, w, name in zip(got, want, ("dxw", "dwh", "dbh")):
        _assert_close(a, w, name)
    assert torch.equal(got[0][mask == 0], torch.zeros_like(got[0][mask == 0]))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T,H,masked,reverse",
    [(256, 10, 64, True, False), (256, 10, 128, True, False), (256, 10, 128, True, True)],
)
def test_gru_bwd_is_bit_identical_over_two_launches(cuda_device, B, T, H, masked, reverse):
    """At the train and bidir points two launches on the same inputs give the
    same dxw, dW_h and db_h bit for bit: no atomics, the sum order fixed."""
    case = _bwd_case(B, T, H, masked, reverse, cuda_device)
    first = gru_cuda._launch_bwd(*case, reverse)
    again = gru_cuda._launch_bwd(*case, reverse)
    torch.cuda.synchronize()
    for a, b, name in zip(first, again, ("dxw", "dwh", "dbh")):
        assert torch.equal(a, b), name


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


BF16_SHAPES = [  # (B, T, H, masked, reverse) on bfloat16 tensors: each layout of
    # B3 and B4, 16-byte copies where H % 8 == 0, plain 2-byte loads else
    (256, 10, 64, True, False),  # the train point
    (512, 10, 64, True, False),  # the serving point
    (2000, 10, 64, True, False),  # the eval batch
    (256, 20, 128, True, True),  # the bidir point at state 20, reverse
    (256, 20, 128, True, False),
    (256, 10, 64, False, False),  # unmasked
    (256, 50, 256, False, False),  # W_h from L2
    (37, 7, 60, True, True),  # H % 8 != 0 (H % 4 == 0): no 16-byte copy in bf16
    (9, 4, 100, True, False),  # H % 8 != 0, W_h in shared memory
    (7, 3, 37, True, False),  # 3H odd: rows end mid-word
    (5, 3, 131, True, True),  # 3H odd, W_h from L2
    (64, 1, 64, True, False),  # T = 1
]


def _bf16_case(B, T, H, masked, device):
    xw, wh, bh, mask = to_torch(*gru_inputs(B, T, H, seed=B + T + H, masked=masked),
                                device=device)
    return xw.bfloat16(), wh.bfloat16(), bh.bfloat16(), mask


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,masked,reverse", BF16_SHAPES)
def test_gru_bf16_matches_twin(cuda_device, B, T, H, masked, reverse):
    """B3 and B4 on bfloat16 tensors against the bfloat16 twins, the
    backward on the kernel forward's own y; counted on the bf16 counters
    only; two launches of each bit for bit."""
    xw, wh, bh, mask = _bf16_case(B, T, H, masked, cuda_device)
    before = (gru_cuda.LAUNCHES, gru_cuda.BWD_LAUNCHES, gru_cuda.LAUNCHES_BF16,
              gru_cuda.BWD_LAUNCHES_BF16)
    y, h = gru_scan(xw, wh, bh, mask, reverse=reverse)
    again = gru_scan(xw, wh, bh, mask, reverse=reverse)
    torch.cuda.synchronize()
    y_p, h_p = gru_scan_plain(xw, wh, bh, mask, reverse=reverse)
    _assert_bf16_close(y, y_p, "y")
    _assert_bf16_close(h, h_p, "h_fin")
    assert torch.equal(y, again[0]) and torch.equal(h, again[1])

    g = torch.Generator(device=cuda_device).manual_seed(T)
    gy = torch.randn(B, T, H, device=cuda_device, generator=g).bfloat16()
    ghf = torch.randn(B, H, device=cuda_device, generator=g).bfloat16()
    got = gru_cuda._launch_bwd(xw, wh, bh, mask, y, gy, ghf, reverse)
    twice = gru_cuda._launch_bwd(xw, wh, bh, mask, y, gy, ghf, reverse)
    torch.cuda.synchronize()
    want = gru_scan_bwd_plain(xw, wh, bh, mask, y, gy, ghf, reverse)
    for a, w, name in zip(got, want, ("dxw", "dwh", "dbh")):
        _assert_bf16_close(a, w, name, leaf=name != "dxw")
    for a, b, name in zip(got, twice, ("dxw", "dwh", "dbh")):
        assert torch.equal(a, b), name
    after = (gru_cuda.LAUNCHES, gru_cuda.BWD_LAUNCHES, gru_cuda.LAUNCHES_BF16,
             gru_cuda.BWD_LAUNCHES_BF16)
    assert after == (before[0], before[1], before[2] + 2, before[3] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("masked,reverse", [(True, False), (False, True)])
def test_gru_scan_bf16_autograd(cuda_device, masked, reverse):
    """bfloat16 leaves under autograd: both bf16 kernels run, the gradients
    come back in bfloat16 and match the twins'."""
    B, T, H = 64, 12, 64
    xw, wh, bh, mask = _bf16_case(B, T, H, masked, cuda_device)
    gy = torch.randn(B, T, H, device=cuda_device).bfloat16()
    ghf = torch.randn(B, H, device=cuda_device).bfloat16()
    leaves = [t.clone().requires_grad_() for t in (xw, wh, bh)]
    before = (gru_cuda.LAUNCHES_BF16, gru_cuda.BWD_LAUNCHES_BF16)
    y, h = gru_scan(*leaves, mask, reverse=reverse)
    torch.autograd.backward((y, h), (gy, ghf))
    torch.cuda.synchronize()
    assert (gru_cuda.LAUNCHES_BF16, gru_cuda.BWD_LAUNCHES_BF16) == (before[0] + 1, before[1] + 1)
    want = gru_scan_bwd_plain(xw, wh, bh, mask, y.detach(), gy, ghf, reverse)
    for leaf, w, name in zip(leaves, want, ("xw", "wh", "bh")):
        _assert_bf16_close(leaf.grad, w, name, leaf=name != "xw")


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
    lse_p, lbl_p = fused_ce_fwd_plain(h, w, b, labels, valid, precision)
    before = (fused_ce.LAUNCHES, fused_ce.BWD_LAUNCHES)
    lse, lbl = fused_ce_fwd(h, w, b, labels, valid, precision)
    # B2 and its twin on the same lse: in "default" dl is rounded to bf16, so
    # an lse one ulp off moves an entry of dl by a bf16 step (DW_OFF_LABEL_TOL)
    dh, dw, db = fused_ce_bwd(h, w, b, labels, lse_p, ct, valid, precision)
    torch.cuda.synchronize()
    assert (fused_ce.LAUNCHES, fused_ce.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    dh_p, dw_p, db_p = fused_ce_bwd_plain(h, w, b, labels, lse_p, ct, valid, precision)
    for got, want, name in ((lse, lse_p, "lse"), (lbl, lbl_p, "label logit"),
                            (dh, dh_p, "dh"), (dw, dw_p, "dw"), (db, db_p, "db")):
        assert torch.isfinite(got).all(), name
        _assert_close(got, want, name)
    off = _off_label(labels, A, valid)
    dw_off_tol = DW_OFF_LABEL_TOL.get((B, F, A, valid, precision, nan_tail), 1e-5)
    _assert_close(dw[:, off], dw_p[:, off], "dw off-label", tol=dw_off_tol)
    _assert_close(db[off], db_p[off], "db off-label")
    assert (dw[:, valid:] == 0).all() and (db[valid:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("F", [64, 256])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_fused_ce_fwd_is_deterministic(cuda_device, precision, F):
    """Two launches at the gru4rec (F = 64) and bidir (F = 256) train
    points give bit-identical lse and label logits: each block's partials
    and their merge are summed in a fixed order."""
    B, A, valid = 256, 70852, 70852
    h, w, b, labels, _ = _ce_inputs(B, F, A, valid, False, cuda_device, seed=2)
    first = fused_ce_fwd(h, w, b, labels, valid, precision)
    second = fused_ce_fwd(h, w, b, labels, valid, precision)
    torch.cuda.synchronize()
    for a, c, name in zip(first, second, ("lse", "label logit")):
        assert torch.equal(a, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("F", [64, 256])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_fused_ce_bwd_is_deterministic(cuda_device, precision, F):
    """Two launches at the gru4rec and bidir train points give bit-identical
    dh, dW and db: no atomics, dh's per-block parts are summed in block
    order, and row groups add into dW and db in launch order."""
    B, A, valid = 256, 70852, 70852
    h, w, b, labels, ct = _ce_inputs(B, F, A, valid, False, cuda_device, seed=2)
    lse, _ = fused_ce_fwd_plain(h, w, b, labels, valid, precision)
    first = fused_ce_bwd(h, w, b, labels, lse, ct, valid, precision)
    second = fused_ce_bwd(h, w, b, labels, lse, ct, valid, precision)
    torch.cuda.synchronize()
    for a, c, name in zip(first, second, ("dh", "dw", "db")):
        assert torch.equal(a, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("F", [64, 256])
def test_fused_softmax_ce_autograd_runs_both_kernels(cuda_device, F):
    B, A, valid = 128, 5000, 4900
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


ARGMAX_SHAPES = [  # (B, F, A, valid, K or None for B5, precision, nan_tail)
    (256, 64, 70852, 70852, None, "high", False),  # the sqn train point
    (256, 64, 70852, 70852, 3, "high", False),  # the smorl train point
    (256, 64, 70852, 70852, None, "highest", False),
    (256, 64, 70912, 70852, 3, "high", True),  # padded columns, NaN in them
    (1, 64, 70852, 70852, None, "high", False),  # one row
    (1, 64, 70852, 70852, 3, "default", False),
    (37, 24, 1000, 777, 2, "default", True),  # odd sizes
    (70, 128, 300, 300, 5, "highest", False),  # F = 128 in eight chunks; K = 5
    (256, 64, 70852, 70852, None, "default", False),
    (37, 24, 1000, 777, None, "high", True),  # F padded to a multiple of 16
    (100, 40, 4099, 4001, None, "high", True),  # A % 4 != 0
    (300, 128, 4096, 3000, None, "high", True),  # five row tiles, F = 128
    (256, 64, 70852, 70852, 3, "default", False),  # the smorl point in "default"
    (300, 128, 4096, 3000, 5, "high", True),  # the most B6 takes: 32-column blocks
    (100, 40, 4099, 4001, 3, "high", True),  # A % 4 != 0 with three heads
    (256, 64, 10000, 10000, 3, "high", False),  # the IKEA smorl point: 10000 images
]


def _argmax_inputs(B, F, A, valid, K, nan_tail, device, integer=False, seed=0):
    """(h, w, b, q_weights or None) on ``device``; with ``integer`` small
    integers (and weights 0.5, 0.25, ...), so every sum is exact."""
    g = torch.Generator(device=device).manual_seed(seed)
    heads = 1 if K is None else K
    if integer:
        h = torch.randint(-2, 3, (B, F), device=device, generator=g).float()
        w = torch.randint(-2, 3, (heads, F, A), device=device, generator=g).float()
        b = torch.randint(-4, 5, (heads, A), device=device, generator=g).float()
        q = 0.5 ** torch.arange(1, heads + 1, device=device, dtype=torch.float32)
    else:
        h = torch.randn(B, F, device=device, generator=g)
        w = torch.randn(heads, F, A, device=device, generator=g) / F**0.5
        b = torch.randn(heads, A, device=device, generator=g) * 0.1
        q = torch.linspace(0.5, 2.0, heads, device=device)
    if nan_tail:
        w[..., valid:] = float("nan")
        b[..., valid:] = float("nan")
    if K is None:
        return h, w[0], b[0], None
    return h, w, b, q


def _run_argmax(h, w, b, q, valid, precision):
    if q is None:
        return fused_argmax.fused_linear_argmax(h, w, b, valid, precision, with_max=True)
    return fused_argmax.fused_weighted_multihead_argmax(h, w, b, q, valid, precision,
                                                       with_max=True)


def _twin_argmax(h, w, b, q, valid, precision):
    """The twin's (ids, max) and the gap between its top two values."""
    v = fused_argmax.head_values_plain(h, w, b, valid, precision, q)
    top2 = v.topk(2, dim=1).values
    return v.argmax(dim=1), v.amax(dim=1), top2[:, 0] - top2[:, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,A,valid,K,precision,nan_tail", ARGMAX_SHAPES)
def test_fused_argmax_matches_twin(cuda_device, B, F, A, valid, K, precision, nan_tail):
    h, w, b, q = _argmax_inputs(B, F, A, valid, K, nan_tail, cuda_device)
    counter = "LAUNCHES" if K is None else "WEIGHTED_LAUNCHES"
    before = getattr(fused_argmax, counter)
    idx, mx = _run_argmax(h, w, b, q, valid, precision)
    torch.cuda.synchronize()
    assert getattr(fused_argmax, counter) == before + 1
    idx_p, mx_p, gap = _twin_argmax(h, w, b, q, valid, precision)
    assert torch.isfinite(mx).all() and (idx < valid).all() and idx.dtype == torch.int64
    scale = mx_p.abs().max().item()
    assert (mx - mx_p).abs().max().item() <= 1e-5 * scale
    clear = gap > 1e-5 * scale
    assert (~clear).sum().item() <= max(2, B // 50), f"{(~clear).sum().item()} near ties"
    assert torch.equal(idx[clear], idx_p[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("A,valid", [(70912, 70852), (10000, 10000)])  # the IKEA head
@pytest.mark.parametrize("K", [None, 3])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_fused_argmax_exact_ties(cuda_device, K, precision, A, valid):
    """Small integers: many rows tie at their max, and columns 127 and 128
    (the two sides of a kernel tile edge) and the last valid column are
    copies of column 127, made every row's largest. The lowest id wins."""
    B, F = 256, 64
    h, w, b, q = _argmax_inputs(B, F, A, valid, K, True, cuda_device, integer=True, seed=3)
    idx, mx = _run_argmax(h, w, b, q, valid, precision)
    torch.cuda.synchronize()
    idx_p, mx_p, gap = _twin_argmax(h, w, b, q, valid, precision)
    assert (gap == 0).any(), "no exact ties in the integer data"
    assert torch.equal(idx, idx_p) and torch.equal(mx, mx_p)
    for col in (128, valid - 1):  # plant the copies
        w[..., col] = w[..., 127]
        b[..., col] = b[..., 127]
    b[..., 127] = b[..., 128] = b[..., valid - 1] = 1000.0
    idx, _ = _run_argmax(h, w, b, q, valid, precision)
    torch.cuda.synchronize()
    assert (idx == 127).all()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [None, 3])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_fused_argmax_is_deterministic(cuda_device, precision, K):
    """B5 and B6 are pure functions of their inputs: two launches give the
    same ids and maxima, bit for bit."""
    B, F, A, valid = 256, 64, 70852, 70852
    h, w, b, q = _argmax_inputs(B, F, A, valid, K, False, cuda_device, seed=4)
    first = _run_argmax(h, w, b, q, valid, precision)
    second = _run_argmax(h, w, b, q, valid, precision)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_fused_wargmax_sums_heads_in_order(cuda_device, precision):
    """B6 sums the weighted heads in head order, rounding after each term:
    on data where that differs from folding q into W (every product exact),
    its ids and maxima equal the twin's bit for bit, and the folded argmax
    differs."""
    B, F, A, valid = 256, 64, 70912, 70852
    arrays = fold_sensitive_heads(B, F, A, seed=6)
    h, w, b, q = to_torch(*arrays, device=cuda_device)
    idx, mx = _run_argmax(h, w, b, q, valid, precision)
    torch.cuda.synchronize()
    v = fused_argmax.head_values_plain(h, w, b, valid, precision, q)
    assert torch.equal(idx, v.argmax(dim=1)) and torch.equal(mx, v.amax(dim=1))
    folded = folded_head_values(*arrays)[:, :valid]
    assert (folded.argmax(axis=1) != idx.cpu().numpy()).any()


ARGMAX_AM_SHAPES = [  # B5 and B6 on the action-major W: (A, F) and (A, K F)
    (256, 64, 70852, 70852, None, "default", False),  # the sqn fast point
    (256, 64, 70852, 70852, 3, "default", False),  # the smorl fast point
    (256, 64, 70852, 70852, None, "high", False),
    (256, 64, 70852, 70852, 3, "highest", False),
    (256, 64, 70912, 70852, 3, "high", True),  # padded rows, NaN in them
    (256, 90, 70852, 70852, 3, "default", False),  # F % 4 != 0: 4-byte copies
    (37, 24, 1000, 777, 2, "default", True),  # odd sizes
    (300, 128, 4096, 3000, 5, "high", True),  # the most B6 takes: 32-column blocks
    (70, 128, 300, 300, 5, "highest", False),
    (1, 64, 70852, 70852, None, "high", False),  # one row
]


def _action_major(w, K):
    """The same head values in the lazy optimizers' layout: (A, F) for B5,
    (A, K F) for B6."""
    return w.reshape(-1, w.shape[-1]).T.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,A,valid,K,precision,nan_tail", ARGMAX_AM_SHAPES)
def test_fused_argmax_action_major_matches_twin(cuda_device, B, F, A, valid, K, precision,
                                                nan_tail):
    """The action-major forms against their twins as the canonical ones
    are held, counted apart, giving the canonical form's bits on the same
    values, bit for bit over two launches."""
    h, w, b, q = _argmax_inputs(B, F, A, valid, K, nan_tail, cuda_device, seed=5)
    w_am = _action_major(w, K)
    counter = "AM_LAUNCHES" if K is None else "WEIGHTED_AM_LAUNCHES"
    before = (getattr(fused_argmax, counter), fused_argmax.LAUNCHES,
              fused_argmax.WEIGHTED_LAUNCHES)
    kw = dict(with_max=True, action_major=True)
    if K is None:
        idx, mx = fused_argmax.fused_linear_argmax(h, w_am, b, valid, precision, **kw)
        again = fused_argmax.fused_linear_argmax(h, w_am, b, valid, precision, **kw)
    else:
        idx, mx = fused_argmax.fused_weighted_multihead_argmax(h, w_am, b, q, valid, precision,
                                                               **kw)
        again = fused_argmax.fused_weighted_multihead_argmax(h, w_am, b, q, valid, precision,
                                                             **kw)
    torch.cuda.synchronize()
    assert (getattr(fused_argmax, counter), fused_argmax.LAUNCHES,
            fused_argmax.WEIGHTED_LAUNCHES) == (before[0] + 2, before[1], before[2])
    assert torch.equal(idx, again[0]) and torch.equal(mx, again[1])
    v = fused_argmax.head_values_plain(h, w_am, b, valid, precision, q, action_major=True)
    idx_p, mx_p = v.argmax(dim=1), v.amax(dim=1)
    top2 = v.topk(2, dim=1).values
    assert torch.isfinite(mx).all() and (idx < valid).all()
    scale = mx_p.abs().max().item()
    assert (mx - mx_p).abs().max().item() <= 1e-5 * scale
    clear = top2[:, 0] - top2[:, 1] > 1e-5 * scale
    assert (~clear).sum().item() <= max(2, B // 50)
    assert torch.equal(idx[clear], idx_p[clear])
    canon = _run_argmax(h, w, b, q, valid, precision)
    assert torch.equal(idx, canon[0]) and torch.equal(mx, canon[1])


@pytest.mark.cuda
@pytest.mark.parametrize("K", [None, 3])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_fused_argmax_action_major_exact_ties(cuda_device, K, precision):
    """The exact ties of test_fused_argmax_exact_ties on the action-major W:
    the lowest id, 127, wins."""
    B, F, A, valid = 256, 64, 70912, 70852
    h, w, b, q = _argmax_inputs(B, F, A, valid, K, True, cuda_device, integer=True, seed=3)
    for col in (128, valid - 1):
        w[..., col] = w[..., 127]
        b[..., col] = b[..., 127]
    b[..., 127] = b[..., 128] = b[..., valid - 1] = 1000.0
    w_am = _action_major(w, K)
    if K is None:
        idx = fused_argmax.fused_linear_argmax(h, w_am, b, valid, precision, action_major=True)
    else:
        idx = fused_argmax.fused_weighted_multihead_argmax(h, w_am, b, q, valid, precision,
                                                           action_major=True)
    torch.cuda.synchronize()
    assert (idx == 127).all()


WIDE_CE_SHAPES = [  # (B, F, A, valid): past F = 256, where B1 and B2 go over F in slices
    (70, 257, 1000, 950),  # one slice of 1 past two whole ones
    (300, 384, 4099, 4001),  # two launches of B2's rows (256 a launch), A % 4 != 0
    (5, 1000, 300, 300),
    (33, 2048, 700, 650),  # bidir_gru4rec's widest head (H = 1024)
]
WIDE_ARGMAX_SHAPES = [  # (B, F, A, valid, K or None): past F = 128 or K = 5
    (70, 129, 1000, 950, None),
    (300, 257, 4099, 4001, None),
    (37, 520, 700, 650, 3),
    (64, 64, 1000, 999, 6),  # K past 5 at a narrow F
    (5, 200, 300, 300, 8),
    (33, 2048, 500, 480, 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("B,F,A,valid", WIDE_CE_SHAPES)
def test_fused_ce_wide_matches_twin(cuda_device, B, F, A, valid, precision):
    """B1 and B2 past F = 256 (the wide head walk and B2's wide kernels) in
    every precision, NaN in the masked columns: held to the twins as
    test_fused_ce_matches_twin holds them, launched and counted, bit for
    bit over two launches."""
    h, w, b, labels, ct = _ce_inputs(B, F, A, valid, True, cuda_device, seed=F)
    lse_p, lbl_p = fused_ce_fwd_plain(h, w, b, labels, valid, precision)
    dh_p, dw_p, db_p = fused_ce_bwd_plain(h, w, b, labels, lse_p, ct, valid, precision)
    before = (fused_ce.LAUNCHES, fused_ce.BWD_LAUNCHES)
    got = [fused_ce_fwd(h, w, b, labels, valid, precision) for _ in range(2)]
    grads = [fused_ce_bwd(h, w, b, labels, lse_p, ct, valid, precision) for _ in range(2)]
    torch.cuda.synchronize()
    assert (fused_ce.LAUNCHES, fused_ce.BWD_LAUNCHES) == (before[0] + 2, before[1] + 2)
    for first, second in ((got[0], got[1]), (grads[0], grads[1])):
        assert all(torch.equal(x, y) for x, y in zip(first, second))
    (lse, lbl), (dh, dw, db) = got[0], grads[0]
    for a, want, name in ((lse, lse_p, "lse"), (lbl, lbl_p, "label logit"),
                          (dh, dh_p, "dh"), (dw, dw_p, "dw"), (db, db_p, "db")):
        assert torch.isfinite(a).all(), name
        _assert_close(a, want, name)
    off = _off_label(labels, A, valid)
    tol = 2.0**-8 if precision == "default" else 1e-5  # as DW_OFF_LABEL_TOL
    _assert_close(dw[:, off], dw_p[:, off], "dw off-label", tol=tol)
    _assert_close(db[off], db_p[off], "db off-label")
    assert (dw[:, valid:] == 0).all() and (db[valid:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("action_major", [False, True])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("B,F,A,valid,K", WIDE_ARGMAX_SHAPES)
def test_fused_argmax_wide_matches_twin(cuda_device, B, F, A, valid, K, precision,
                                        action_major):
    """B5 and B6 past F = 128 or K = 5 (the wide head walk in "high" and
    "default"), on both layouts of W: held to the twin as
    test_fused_argmax_matches_twin holds them, counted under the layout's
    counter, bit for bit over two launches; on small integers with columns
    127, 128 (a block edge) and valid - 1 made each row's largest, the
    lowest, 127, wins."""
    h, w, b, q = _argmax_inputs(B, F, A, valid, K, True, cuda_device, seed=F)
    w_run = _action_major(w, K) if action_major else w
    kw = dict(with_max=True, action_major=action_major)

    def run(w_run, b):
        if q is None:
            return fused_argmax.fused_linear_argmax(h, w_run, b, valid, precision, **kw)
        return fused_argmax.fused_weighted_multihead_argmax(h, w_run, b, q, valid, precision,
                                                            **kw)

    counter = ("WEIGHTED_" if K else "") + ("AM_LAUNCHES" if action_major else "LAUNCHES")
    before = getattr(fused_argmax, counter)
    idx, mx = run(w_run, b)
    again = run(w_run, b)
    torch.cuda.synchronize()
    assert getattr(fused_argmax, counter) == before + 2
    assert torch.equal(idx, again[0]) and torch.equal(mx, again[1])
    v = fused_argmax.head_values_plain(h, w_run, b, valid, precision, q, action_major)
    top2 = v.topk(2, dim=1).values
    scale = v.amax(dim=1).abs().max().item()
    assert torch.isfinite(mx).all() and (idx < valid).all()
    assert (mx - v.amax(dim=1)).abs().max().item() <= 1e-5 * scale
    clear = top2[:, 0] - top2[:, 1] > 1e-5 * scale
    assert (~clear).sum().item() <= max(2, B // 50)
    assert torch.equal(idx[clear], v.argmax(dim=1)[clear])

    h, w, b, q = _argmax_inputs(B, F, A, valid, K, True, cuda_device, integer=True, seed=F)
    for col in (128, valid - 1):
        w[..., col] = w[..., 127]
        b[..., col] = b[..., 127]
    b[..., 127] = b[..., 128] = b[..., valid - 1] = 1000.0
    idx, _ = run(_action_major(w, K) if action_major else w, b)
    torch.cuda.synchronize()
    assert (idx == 127).all()


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_eval_protocol_on_the_card_matches_the_cpu(cuda_device, fused):
    """``EvalProtocol.evaluate`` on the card (B3 in the backbone) against
    the same protocol on the CPU (the plain twin), gru4rec at a small width
    over two 4096-column blocks, 150 rows in batches of 64 (a padded tail).
    The buffer keeps the rows whose top 21 CPU scores are more than 1e-5
    apart, where both sides rank the same ids: then the loss and rewards
    agree within 1e-5, NDCG within 1e-6, and HR, repetitions and coverage
    exactly. Each batch launches B3 once."""
    import numpy as np

    from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
    from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
    from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer
    from ikea_recommender_tpu_torch.eval.protocol import EvalProtocol
    from ikea_recommender_tpu_torch.models.families import apply_model, model_config_from_train

    A, T, E, n_rows, batch = 5000, 5, 16, 150, 64
    mc = model_config_from_train(
        TrainConfig(embedding_size=E, hidden_state_size=E, state_size=T), DataConfig(num_items=A)
    )
    np_params = numpy_init_params(mc, seed=3)
    np_params["backbone"]["embedding"] *= 30.0  # sessions that differ in their top-k
    rs = np.random.RandomState(4)
    lens = rs.randint(1, T + 1, 2 * n_rows).astype(np.int32)
    states = np.full((2 * n_rows, T), A, np.int32)
    for i, n in enumerate(lens):
        states[i, :n] = rs.randint(0, A, n)
    cpu = params_from_numpy(np_params, "cpu")
    with torch.no_grad():
        scores = apply_model(cpu, mc, torch.as_tensor(states), torch.as_tensor(lens))[0]
    top = scores.topk(21, dim=1).values
    keep = ((top[:, :-1] - top[:, 1:]) > 1e-5).all(dim=1).nonzero().flatten().numpy()
    assert len(keep) >= 0.9 * len(lens)
    keep = keep[:n_rows]
    action = rs.randint(0, A, n_rows)
    half = rs.rand(n_rows) < 0.5  # labels in the top 20: hits at every k
    action[half] = scores[keep].topk(20, dim=1).indices.numpy()[half, rs.randint(0, 20, n_rows)[half]]
    buf = EvalBuffer(state=states[keep], action=action, true_len=lens[keep])
    kw = dict(topk_hr_ndcg=(5, 10, 20), topk_cov=(1, 5, 10, 20), fused=fused,
              div_embedding=rs.randn(A + 1, 4).astype(np.float32),
              unpopular_mask=np.arange(A) % 10 == 0)

    want = EvalProtocol(mc, device="cpu", **kw).evaluate(cpu, buf, batch)
    proto = EvalProtocol(mc, device=cuda_device, **kw)
    assert proto.fused == fused
    before = gru_cuda.LAUNCHES
    got = proto.evaluate(params_from_numpy(np_params, cuda_device), buf, batch)
    assert gru_cuda.LAUNCHES == before + 3
    assert abs(got.loss - want.loss) <= 1e-5
    assert abs(got.div_rew - want.div_rew) <= 1e-5
    assert abs(got.nov_rew - want.nov_rew) <= 1e-5
    np.testing.assert_array_equal(got.hr, want.hr)
    np.testing.assert_array_equal(got.reps, want.reps)
    np.testing.assert_allclose(got.ndcg, want.ndcg, atol=1e-6, rtol=0)
    assert got.coverage == want.coverage
    assert got.hr[-1] > 0.3


# -- the mesh's shard contract (parallel/; ROADMAP A.9a) --------------------
#
# On a (data, model) mesh each rank launches B1, B2, B5 and B6 on its
# columns of the head as they are: ``local_valid = clip(valid - r S, 0, S)``
# (0 for a shard of padding only), labels shifted by the shard's offset r S
# (negative past their owner, at least S before it), and B2 with the global
# logsumexp. Held to the same kernel on the whole head: lse and the label
# logit within 1e-5, dh and each shard's dW and db within 1e-5 of the
# leaf's largest entry, ids where the twin's two best differ by more than
# 1e-5 of the largest |max|, ties over a shard edge to the lower global id.

SHARD_CASES = [  # (B, F, A, valid, shards, precision)
    (256, 64, 70852, 70852, 4, "high"),  # shard width 17713: no tile's multiple
    (256, 64, 70852, 3 * 17713 - 100, 4, "high"),  # the last shard all padding
    (256, 64, 70852, 70852, 2, "high"),  # 35426
    (37, 24, 1000, 777, 2, "highest"),
]


def _shards(A, valid, n):
    """Per shard: (columns, local_valid, offset)."""
    S = A // n
    return [(slice(r * S, (r + 1) * S), min(max(valid - r * S, 0), S), r * S) for r in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,A,valid,n,precision", SHARD_CASES)
def test_fused_ce_per_shard_matches_the_whole_head(cuda_device, B, F, A, valid, n, precision):
    from ikea_recommender_tpu_torch.parallel.fused_ce import ce_from_shards

    h, w, b, labels, ct = _ce_inputs(B, F, A, valid, False, cuda_device)
    S = A // n
    edges = [e for r in range(1, n) for e in (r * S - 1, r * S) if e < valid]
    labels[: len(edges)] = torch.tensor(edges, device=cuda_device)
    lse_f, lbl_f = fused_ce_fwd(h, w, b, labels, valid, precision)
    dh_f, dw_f, db_f = fused_ce_bwd(h, w, b, labels, lse_f, ct, valid, precision)
    before = (fused_ce.LAUNCHES, fused_ce.BWD_LAUNCHES)
    parts = []
    for cols, lv, off in _shards(A, valid, n):
        ws, bs = w[:, cols].contiguous(), b[cols].contiguous()
        parts.append((ws, bs, labels - off, lv, cols) + fused_ce_fwd(h, ws, bs, labels - off, lv,
                                                                      precision))
    lse, lbl = ce_from_shards(torch.stack([p[5] for p in parts]),
                              torch.stack([p[6] for p in parts]))
    assert torch.isfinite(lse).all() and torch.isfinite(lbl).all()
    assert (lse - lse_f).abs().max().item() <= 1e-5
    assert (lbl - lbl_f).abs().max().item() <= 1e-5
    dh = torch.zeros_like(dh_f)
    for ws, bs, loc, lv, cols, *_ in parts:
        dh_s, dw_s, db_s = fused_ce_bwd(h, ws, bs, loc, lse, ct, lv, precision)
        assert torch.isfinite(dw_s).all() and torch.isfinite(db_s).all()
        assert (dw_s[:, lv:] == 0).all() and (db_s[lv:] == 0).all()
        for got, want, name in ((dw_s, dw_f[:, cols], "dW"), (db_s, db_f[cols], "db")):
            err = (got - want).abs().max().item()
            assert err <= 1e-5 * (dw_f if name == "dW" else db_f).abs().max().item(), name
        dh += dh_s
    torch.cuda.synchronize()
    assert (fused_ce.LAUNCHES, fused_ce.BWD_LAUNCHES) == (before[0] + n, before[1] + n)
    _assert_close(dh, dh_f, "dh")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_fused_ce_takes_labels_outside_the_columns_and_no_valid_column(cuda_device, precision):
    """Labels at -1 and past A match no column (label logit 0, no onehot in
    dl), as the twin has them; valid_dim 0 leaves lse at about -1e30, finite,
    and zero gradients."""
    B, F, A = 64, 64, 17713
    h, w, b, labels, ct = _ce_inputs(B, F, A, A, False, cuda_device)
    labels[::2] = -1
    labels[1::2] = A + 5
    lse, lbl = fused_ce_fwd(h, w, b, labels, A, precision)
    lse_p, lbl_p = fused_ce_fwd_plain(h, w, b, labels, A, precision)
    assert (lbl == 0).all() and (lbl_p == 0).all()
    _assert_close(lse, lse_p, "lse")
    dh, dw, db = fused_ce_bwd(h, w, b, labels, lse_p, ct, A, precision)
    dh_p, dw_p, db_p = fused_ce_bwd_plain(h, w, b, labels, lse_p, ct, A, precision)
    tol = 2.0**-8 if precision == "default" else 1e-5  # dl rounded to bf16, as DW_OFF_LABEL_TOL
    for got, want, name in ((dh, dh_p, "dh"), (dw, dw_p, "dw"), (db, db_p, "db")):
        _assert_close(got, want, name, tol)
    assert (db > 0).all()  # every column takes only its softmax term
    lse0, lbl0 = fused_ce_fwd(h, w, b, labels.abs() % A, 0, precision)
    assert torch.isfinite(lse0).all() and (lse0 < -1e29).all() and (lbl0 == 0).all()
    dh0, dw0, db0 = fused_ce_bwd(h, w, b, labels.abs() % A, lse0, ct, 0, precision)
    assert (dh0 == 0).all() and (dw0 == 0).all() and (db0 == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [None, 3])
@pytest.mark.parametrize("B,F,A,valid,n,precision", SHARD_CASES)
def test_fused_argmax_per_shard_matches_the_whole_head(cuda_device, B, F, A, valid, n, precision,
                                                       K):
    from ikea_recommender_tpu_torch.ops.fused_topk import order_keys
    from ikea_recommender_tpu_torch.parallel.q_kernels import argmax_from_shards

    h, w, b, q = _argmax_inputs(B, F, A, valid, K, False, cuda_device)
    idx_f, mx_f = _run_argmax(h, w, b, q, valid, precision)
    _, mx_p, gap = _twin_argmax(h, w, b, q, valid, precision)
    keys, maxima = [], []
    for cols, lv, off in _shards(A, valid, n):
        i_s, m_s = _run_argmax(h, w[..., cols].contiguous(), b[..., cols].contiguous(), q, lv,
                               precision)
        assert torch.isfinite(m_s).all()
        if lv == 0:  # every column masked: nothing of this shard can win
            assert (m_s == -1e30).all()
        keys.append(order_keys(m_s, i_s + off))
        maxima.append(m_s)
    ids = argmax_from_shards(torch.stack(keys))
    scale = mx_p.abs().max().item()
    _assert_close(torch.stack(maxima).amax(dim=0), mx_f, "max")
    clear = gap > 1e-5 * scale
    assert torch.equal(ids[clear], idx_f[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("K", [None, 3])
@pytest.mark.parametrize("n", [2, 4])
def test_fused_argmax_ties_over_a_shard_edge(cuda_device, K, n):
    """Small integers, the best columns of every row at S - 1, S and the
    last: merged over the shards, the lowest global id, S - 1."""
    from ikea_recommender_tpu_torch.ops.fused_topk import order_keys
    from ikea_recommender_tpu_torch.parallel.q_kernels import argmax_from_shards

    B, F, A = 256, 64, 70852
    S = A // n
    h, w, b, q = _argmax_inputs(B, F, A, A, K, False, cuda_device, integer=True)
    h = h.abs()
    for c in (S - 1, S, A - 1):
        w[..., c], b[..., c] = 9.0, 9.0
    for precision in ("highest", "high"):
        keys = []
        for cols, lv, off in _shards(A, A, n):
            i_s, m_s = _run_argmax(h, w[..., cols].contiguous(), b[..., cols].contiguous(), q,
                                   lv, precision)
            keys.append(order_keys(m_s, i_s + off))
        assert (argmax_from_shards(torch.stack(keys)) == S - 1).all(), precision
