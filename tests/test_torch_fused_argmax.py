"""The port's fused argmax (B5, B6), row gathers, RL ops, online rewards and
fused CE + top-k against the reference package.

The same numpy inputs go through the reference's functions (its Pallas
kernels in interpret mode on the CPU) and the port's, whose CPU path is the
plain twins. The argmax case matrix is that of ``tests/test_fused_argmax.py``:
exact, ragged and padded catalogs ((A, valid) in {(384, 384), (300, 300),
(384, 300)}), lowest-id ties across the reference's 128-column blocks,
``valid_dim`` as a runtime value, NaN in the padded columns, the three
precisions and ``with_max``; B6 also at K = 5 with F = 128, the most the
tensor-core kernel takes, and on data whose head-order sum rounds
differently from the sum with q folded into W.

Tolerances:
- argmax: the max within 1e-5 of the largest |max| (fp32 sums in other
  orders); ids equal wherever the reference's top two values differ by more
  than that (at these sizes no row is excluded, which the tests assert);
  exact ties, built from small integers so every sum is exact, pick the
  lowest id on both sides. "default" is one bf16 pass in the port and fp32 in
  XLA on the CPU, so it is held to the reference's "highest" on bf16-rounded
  h and W, the same function;
- row gathers: values atol 1e-6, gradients atol 1e-6 + rtol 1e-5 (a dot of
  F terms; dW and db sum repeated actions);
- rewards and RL ops: atol 1e-6;
- fused CE + top-k: CE atol 1e-5 (CE ~ 6), ids exact, gradients atol 1e-6 +
  rtol 1e-5, as tests/test_torch_fused_ce.py. In "high" the reference's
  forward (``Precision.HIGH``) is fp32 on the CPU and the port's the bf16x3
  split: CE atol 2e-5 there, ids exact where the top two differ by > 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import fold_sensitive_heads, folded_head_values  # also: TF32 off

from ikea_recommender_tpu.ops import fused_argmax as jfa
from ikea_recommender_tpu.ops import rewards as jrew
from ikea_recommender_tpu.ops import rl as jrl
from ikea_recommender_tpu.ops.fused_ce import fused_softmax_ce_topk as jax_ce_topk
from ikea_recommender_tpu.ops.fused_topk import blockwise_head_topk_ce as jax_blockwise
from ikea_recommender_tpu_torch.ops import fused_argmax, rewards, rl
from ikea_recommender_tpu_torch.ops.fused_ce import fused_softmax_ce_topk
from ikea_recommender_tpu_torch.ops.fused_topk import blockwise_head_topk_ce

TOL = 1e-5
SHAPES = [(384, 384), (300, 300), (384, 300)]  # (A, valid)
PRECISIONS = ["highest", "high", "default"]


def _bf(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _head(B, F, A, seed, K=None, nan_from=None):
    rs = np.random.RandomState(seed)
    h = rs.randn(B, F).astype(np.float32)
    wshape, bshape = ((F, A), (A,)) if K is None else ((K, F, A), (K, A))
    w = rs.randn(*wshape).astype(np.float32)
    b = rs.randn(*bshape).astype(np.float32)
    if nan_from is not None:
        w[..., nan_from:] = np.nan
        b[..., nan_from:] = np.nan
    return h, w, b


def _assert_argmax(got_i, got_m, want_i, want_m, dense, valid):
    """Max within TOL of the largest; ids equal where the reference's top
    two (of the dense masked values ``dense``) differ by more."""
    got_i, got_m = np.asarray(got_i), np.asarray(got_m)
    scale = max(1.0, np.abs(want_m).max())
    np.testing.assert_allclose(got_m, want_m, atol=TOL * scale, rtol=0)
    top2 = np.sort(np.where(np.arange(dense.shape[1]) < valid, dense, -np.inf), axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > TOL * scale
    assert clear.all(), f"{(~clear).sum()} rows with near-tied maxima"
    np.testing.assert_array_equal(got_i, np.asarray(want_i))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("A,valid", SHAPES)
def test_linear_argmax_matches_reference(A, valid, precision):
    h, w, b = _head(16, 8, A, seed=A + valid, nan_from=valid if valid < A else None)
    ref_prec = "highest" if precision == "default" else precision
    jh, jw = (_bf(h), _bf(w)) if precision == "default" else (h, w)
    want_i, want_m = jfa.fused_linear_argmax(
        jnp.asarray(jh), jnp.asarray(jw), jnp.asarray(b), valid, ref_prec, with_max=True)
    got_i, got_m = fused_argmax.fused_linear_argmax(
        torch.tensor(h), torch.tensor(w), torch.tensor(b), valid, precision, with_max=True)
    assert got_i.dtype == torch.int64 and np.isfinite(got_m.numpy()).all()
    dense = jh.astype(np.float64) @ np.nan_to_num(jw) + np.nan_to_num(b)
    _assert_argmax(got_i, got_m, want_i, want_m, dense, valid)
    assert torch.equal(fused_argmax.fused_linear_argmax(
        torch.tensor(h), torch.tensor(w), torch.tensor(b), valid, precision), got_i)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("A,valid", SHAPES)
def test_weighted_multihead_argmax_matches_reference(A, valid, precision):
    K = 3
    h, w, b = _head(8, 8, A, seed=A + valid + 1, K=K, nan_from=valid if valid < A else None)
    qw = np.asarray([1.0, 0.5, 2.0], np.float32)
    ref_prec = "highest" if precision == "default" else precision
    jh, jw = (_bf(h), _bf(w)) if precision == "default" else (h, w)
    want_i, want_m = jfa.fused_weighted_multihead_argmax(
        jnp.asarray(jh), jnp.asarray(jw), jnp.asarray(b), jnp.asarray(qw), valid, ref_prec,
        with_max=True)
    got_i, got_m = fused_argmax.fused_weighted_multihead_argmax(
        torch.tensor(h), torch.tensor(w), torch.tensor(b), torch.tensor(qw), valid, precision,
        with_max=True)
    dense = sum(qw[k] * (jh.astype(np.float64) @ np.nan_to_num(jw[k]) + np.nan_to_num(b[k]))
                for k in range(K))
    _assert_argmax(got_i, got_m, want_i, want_m, dense, valid)
    # a sequence of weights is taken as well as a tensor
    assert torch.equal(fused_argmax.fused_weighted_multihead_argmax(
        torch.tensor(h), torch.tensor(w), torch.tensor(b), [1.0, 0.5, 2.0], valid, precision),
        got_i)


@pytest.mark.parametrize("K", [1, 2, 5])
def test_weighted_argmax_head_counts(K):
    A, valid = 300, 297
    h, w, b = _head(8, 8, A, seed=K, K=K)
    qw = np.linspace(0.5, 1.5, K).astype(np.float32)
    want_i, want_m = jfa.fused_weighted_multihead_argmax(
        *(jnp.asarray(a) for a in (h, w, b, qw)), valid, with_max=True)
    got_i, got_m = fused_argmax.fused_weighted_multihead_argmax(
        *(torch.tensor(a) for a in (h, w, b, qw)), valid, with_max=True)
    dense = sum(qw[k] * (h.astype(np.float64) @ w[k] + b[k]) for k in range(K))
    _assert_argmax(got_i, got_m, want_i, want_m, dense, valid)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_weighted_argmax_at_the_tensor_core_limit(precision):
    """K = 5 heads at F = 128: the most heads at the widest F that the
    tensor-core kernel takes."""
    K, F, A, valid = 5, 128, 300, 280
    h, w, b = _head(8, F, A, seed=F + K, K=K, nan_from=valid)
    qw = np.linspace(0.5, 1.5, K).astype(np.float32)
    ref_prec = "highest" if precision == "default" else precision
    jh, jw = (_bf(h), _bf(w)) if precision == "default" else (h, w)
    want_i, want_m = jfa.fused_weighted_multihead_argmax(
        jnp.asarray(jh), jnp.asarray(jw), jnp.asarray(b), jnp.asarray(qw), valid, ref_prec,
        with_max=True)
    got_i, got_m = fused_argmax.fused_weighted_multihead_argmax(
        torch.tensor(h), torch.tensor(w), torch.tensor(b), torch.tensor(qw), valid, precision,
        with_max=True)
    dense = sum(qw[k] * (jh.astype(np.float64) @ np.nan_to_num(jw[k]) + np.nan_to_num(b[k]))
                for k in range(K))
    _assert_argmax(got_i, got_m, want_i, want_m, dense, valid)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_weighted_argmax_sums_heads_in_order(precision):
    """The heads' weighted sum is taken in head order with a rounding after
    each term, as the reference's kernel takes it; folding q into W first is
    another function. On data where the two differ (every product exact,
    the sums rounding differently), the twin equals the reference to the
    last bit, and the folded argmax differs from both."""
    h, w, b, q = fold_sensitive_heads(16, 8, 300, seed=5)
    valid = 290
    want_i, want_m = jfa.fused_weighted_multihead_argmax(
        *(jnp.asarray(a) for a in (h, w, b, q)), valid, precision, with_max=True)
    got_i, got_m = fused_argmax.fused_weighted_multihead_argmax(
        *(torch.tensor(a) for a in (h, w, b, q)), valid, precision, with_max=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    folded = folded_head_values(h, w, b, q)[:, :valid]
    assert (folded.argmax(axis=1) != got_i.numpy()).any()
    assert (folded.max(axis=1) != got_m.numpy()).any()


def _tied_head(A, F, dup_of, dups):
    """Small-integer h, W and b (every sum exact) whose column ``dup_of``
    is duplicated at ``dups`` and is each row's largest."""
    rs = np.random.RandomState(A)
    h = rs.randint(1, 3, (4, F)).astype(np.float32)
    w = rs.randint(-2, 3, (F, A)).astype(np.float32)
    b = rs.randint(-2, 3, (A,)).astype(np.float32)
    w[:, dup_of], b[dup_of] = 3.0, 8.0
    for d in dups:
        w[:, d], b[d] = w[:, dup_of], b[dup_of]
    return h, w, b


@pytest.mark.parametrize("dup_of,dups,valid", [
    (127, (128, 255), 384),  # both sides of the kernel's 128-column tile edge
    (200, (7,), 384),  # the lower id comes first in the catalog
    (40, (299,), 300),  # the duplicate is the last valid column
    (40, (300,), 300),  # ... or the first masked one: it must not win
])
def test_exact_ties_pick_the_lowest_id(dup_of, dups, valid):
    A, F = 384, 8
    h, w, b = _tied_head(A, F, dup_of, dups)
    b[valid:] = 20.0  # masked columns above every valid one never win
    lowest = min((dup_of,) + tuple(d for d in dups if d < valid))
    want = jfa.fused_linear_argmax(*(jnp.asarray(a) for a in (h, w, b)), valid)
    got = fused_argmax.fused_linear_argmax(*(torch.tensor(a) for a in (h, w, b)), valid)
    np.testing.assert_array_equal(np.asarray(want), lowest)
    np.testing.assert_array_equal(got.numpy(), lowest)
    # B6 over two copies of the head, weights (0.5, 0.5): the same ties
    w2, b2 = np.stack([w, w]), np.stack([b, b])
    want6 = jfa.fused_weighted_multihead_argmax(
        *(jnp.asarray(a) for a in (h, w2, b2)), jnp.asarray([0.5, 0.5]), valid)
    got6 = fused_argmax.fused_weighted_multihead_argmax(
        *(torch.tensor(a) for a in (h, w2, b2)), [0.5, 0.5], valid)
    np.testing.assert_array_equal(np.asarray(want6), lowest)
    np.testing.assert_array_equal(got6.numpy(), lowest)


def test_all_tied_and_all_masked_rows_pick_id_zero():
    B, F, A = 2, 4, 300
    h = np.ones((B, F), np.float32)
    w, b = np.zeros((F, A), np.float32), np.zeros((A,), np.float32)
    for valid in (A, 0):
        got, mx = fused_argmax.fused_linear_argmax(
            *(torch.tensor(a) for a in (h, w, b)), valid, with_max=True)
        want, wmx = jfa.fused_linear_argmax(*(jnp.asarray(a) for a in (h, w, b)), valid,
                                            with_max=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(mx.numpy(), np.asarray(wmx))
        assert (got == 0).all()


def test_valid_dim_is_a_runtime_value():
    """One head, several valid_dim values: the reference under ``jit`` with
    valid_dim traced, the port with a plain int each call."""
    A = 384
    h, w, b = _head(16, 8, A, seed=9)
    jitted = jax.jit(lambda h, w, b, v: jfa.fused_linear_argmax(h, w, b, v, with_max=True))
    for valid in (384, 257, 129, 1):
        want_i, want_m = jitted(*(jnp.asarray(a) for a in (h, w, b)), jnp.int32(valid))
        got_i, got_m = fused_argmax.fused_linear_argmax(
            *(torch.tensor(a) for a in (h, w, b)), valid, with_max=True)
        assert (got_i < valid).all()
        _assert_argmax(got_i, got_m, want_i, want_m, h.astype(np.float64) @ w + b, valid)


def test_cpu_tensors_take_the_twins():
    h, w, b = (torch.tensor(a) for a in _head(8, 8, 300, seed=2, K=3))
    before = (fused_argmax.LAUNCHES, fused_argmax.WEIGHTED_LAUNCHES)
    got = fused_argmax.fused_weighted_multihead_argmax(h, w, b, [1.0, 1.0, 1.0], 280, "high",
                                                      with_max=True)
    want = fused_argmax.fused_weighted_multihead_argmax_plain(h, w, b, torch.ones(3), 280, "high")
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    got5 = fused_argmax.fused_linear_argmax(h, w[0], b[0], 280, "high", with_max=True)
    want5 = fused_argmax.fused_linear_argmax_plain(h, w[0], b[0], 280, "high")
    assert all(torch.equal(g, x) for g, x in zip(got5, want5))
    assert (fused_argmax.LAUNCHES, fused_argmax.WEIGHTED_LAUNCHES) == before


def test_wrappers_reject_bad_inputs():
    h, w, b = (torch.tensor(a) for a in _head(4, 8, 32, seed=0))
    # the action-major forms take (A, F) and (A, K F), not the canonical W
    with pytest.raises(ValueError, match="action-major"):
        fused_argmax.fused_linear_argmax(h, w, b, 32, action_major=True)
    with pytest.raises(ValueError, match="action-major"):
        fused_argmax.fused_weighted_multihead_argmax(h, w[None], b[None], [1.0], 32,
                                                     action_major=True)
    with pytest.raises(ValueError, match="precision"):
        fused_argmax.fused_linear_argmax(h, w, b, 32, "tf32")
    with pytest.raises(ValueError, match="valid_dim"):
        fused_argmax.fused_linear_argmax(h, w, b, 33)
    with pytest.raises(TypeError):
        fused_argmax.fused_linear_argmax(h.double(), w, b, 32)
    with pytest.raises(ValueError, match="b must be|w"):
        fused_argmax.fused_linear_argmax(h, w, b[:-1], 32)
    with pytest.raises(ValueError, match="w"):
        fused_argmax.fused_weighted_multihead_argmax(h, w[None], b[None], [1.0, 1.0], 32)
    with pytest.raises(ValueError, match="different devices"):
        fused_argmax.fused_linear_argmax(h, w, b.to("meta"), 32)


# -- row gathers -------------------------------------------------------------


def _ct_grads(fn, args, ct):
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*leaves)
    (out * torch.tensor(ct)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax_ct_grads(fn, args, ct):
    args = [jnp.asarray(a) for a in args]
    value = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * ct), argnums=(0, 1, 2))(*args)
    return np.asarray(value), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("K", [None, 3])
def test_row_logits_values_and_gradients(K):
    """Against the reference's custom VJPs (one-hot matmul gradients),
    with actions repeated in the batch."""
    rs = np.random.RandomState(7)
    B, F, A = 12, 8, 64
    h, w, b = _head(B, F, A, seed=11, K=K)
    idx = rs.randint(0, A, B).astype(np.int32)
    idx[:4] = 5  # duplicates accumulate into dW and db
    ct = rs.randn(B, *(() if K is None else (K,))).astype(np.float32)
    j_fn, p_fn = ((jfa.row_logit, fused_argmax.row_logit) if K is None
                  else (jfa.multihead_row_logit, fused_argmax.multihead_row_logit))
    want, want_g = _jax_ct_grads(lambda h, w, b: j_fn(h, w, b, jnp.asarray(idx)), (h, w, b), ct)
    got, got_g = _ct_grads(lambda h, w, b: p_fn(h, w, b, torch.tensor(idx)), (h, w, b), ct)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for g, x, name in zip(got_g, want_g, ("dh", "dw", "db")):
        np.testing.assert_allclose(g, x, atol=1e-6, rtol=1e-5, err_msg=name)


def test_row_logit_duplicate_indices_accumulate():
    B, F, A = 4, 4, 16
    h, w = torch.ones(B, F), torch.ones(F, A)
    b = torch.zeros(A, requires_grad=True)
    fused_argmax.row_logit(h, w, b, torch.tensor([3, 3, 3, 5])).sum().backward()
    assert b.grad[3] == 3.0 and b.grad[5] == 1.0 and b.grad.sum() == 4.0


# -- RL ops and rewards --------------------------------------------------------


def test_rl_ops_match_reference():
    rs = np.random.RandomState(3)
    B, K, A = 6, 3, 20
    q = rs.randn(B, K, A).astype(np.float32)
    q[0, :, 4] = q[0, :, 9] = 5.0  # a tie: the lowest id wins
    idx = rs.randint(0, A, B).astype(np.int32)
    w = np.asarray([1.0, 0.5, 2.0], np.float32)
    tq, tidx, tw = torch.tensor(q), torch.tensor(idx), torch.tensor(w)
    np.testing.assert_allclose(rl.gather_from_3d(tq, tidx).numpy(),
                               np.asarray(jrl.gather_from_3d(jnp.asarray(q), jnp.asarray(idx))),
                               atol=1e-6)
    vals = q[:, :, 0]
    np.testing.assert_allclose(rl.weighted_q_loss(torch.tensor(vals), tw).numpy(),
                               np.asarray(jrl.weighted_q_loss(jnp.asarray(vals), jnp.asarray(w))),
                               atol=1e-6)
    target = rl.get_weighted_q_target(tq, tw)
    want = jrl.get_weighted_q_target(jnp.asarray(q), jnp.asarray(w))
    np.testing.assert_allclose(target.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(rl.get_max_action(target).numpy(),
                                  np.asarray(jrl.get_max_action(want)))
    assert rl.get_max_action(target)[0] == 4


def _reward_inputs(seed, remap):
    rs = np.random.RandomState(seed)
    B, T, A, E, k = 10, 5, 30, 6, 3
    states = rs.randint(0, A + 1, (B, T)).astype(np.int32)
    lens = rs.randint(1, T + 1, B).astype(np.int32)
    lens[:2] = (1, T)
    pred = rs.randint(0, A, (B, k)).astype(np.int32)
    emb = rs.randn(A + 1, E).astype(np.float32)
    emb[3] *= 1e-7  # |a| |b| < eps: the eps rule of the cosine
    pred[0, 0], states[1, T - 1] = 3, 3
    out_to_in = rs.permutation(A + 1)[:A].astype(np.int32) if remap else None
    mask = rs.rand(A) < 0.4
    return states, lens, pred, emb, out_to_in, mask


@pytest.mark.parametrize("remap", [False, True])
@pytest.mark.parametrize("padding_pos", ["end", "beg"])
def test_rewards_match_reference(padding_pos, remap):
    states, lens, pred, emb, out_to_in, mask = _reward_inputs(5, remap)
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    np.testing.assert_array_equal(
        rewards.get_last_action(t(states), t(lens), padding_pos).numpy(),
        np.asarray(jrew.get_last_action(j(states), j(lens), padding_pos)))
    for k in (1, 3):
        got = rewards.diversity_from_topk(t(states), t(pred[:, :k]), t(lens), padding_pos,
                                          t(emb), out_to_in=t(out_to_in))
        want = jrew.diversity_from_topk(j(states), j(pred[:, :k]), j(lens), padding_pos,
                                        j(emb), out_to_in=j(out_to_in))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
        got = rewards.novelty_from_topk(t(pred[:, :k]), t(mask), 2.0)
        want = jrew.novelty_from_topk(j(pred[:, :k]), j(mask), 2.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# -- blockwise top-k precision and the fused CE + top-k -----------------------


def _ce_inputs(B, F, A, seed):
    rs = np.random.RandomState(seed)
    h = rs.randn(B, F).astype(np.float32)
    w = (rs.randn(F, A) * 0.3).astype(np.float32)
    b = (rs.randn(A) * 0.1).astype(np.float32)
    labels = rs.randint(0, A - 3, B).astype(np.int32)
    weights = rs.rand(B).astype(np.float32)
    return h, w, b, labels, weights


@pytest.mark.parametrize("precision", [None, "highest", "high", "default"])
def test_blockwise_precision(precision):
    """None and "highest" are fp32 on both sides; "high" (bf16x3) is held to
    the reference's fp32 within the split's rounding, "default" to the
    reference on bf16-rounded h and W."""
    h, w, b, labels, _ = _ce_inputs(16, 8, 203, seed=1)
    jh, jw = (_bf(h), _bf(w)) if precision == "default" else (h, w)
    ref_prec = None if precision in (None, "high", "default") else precision
    want = jax_blockwise(jnp.asarray(jh), jnp.asarray(jw), jnp.asarray(b), 6, 200,
                         labels=jnp.asarray(labels), block_cols=64, precision=ref_prec)
    got = blockwise_head_topk_ce(torch.tensor(h), torch.tensor(w), torch.tensor(b), 6, 200,
                                 labels=torch.tensor(labels), block_cols=64, precision=precision)
    atol = 2e-5 if precision == "high" else 1e-5
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=atol, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=atol, rtol=0)


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("A,valid", [(300, 300), (384, 300)])
def test_fused_ce_topk_matches_reference(A, valid, precision):
    B, F, k = 8, 16, 3
    h, w, b, labels, weights = _ce_inputs(B, F, A, seed=A)
    w[:, valid:] = np.nan
    args = [jnp.asarray(a) for a in (h, w, b)]
    (want_ce, want_i) = jax_ce_topk(*args, jnp.asarray(labels), k, valid, precision)
    want_g = jax.grad(lambda h, w, b: jnp.sum(
        jax_ce_topk(h, w, b, jnp.asarray(labels), k, valid, precision)[0] * weights),
        argnums=(0, 1, 2))(*args)
    leaves = [torch.tensor(a, requires_grad=True) for a in (h, w, b)]
    ce, top_i = fused_softmax_ce_topk(*leaves, torch.tensor(labels), k, valid, precision)
    assert not top_i.requires_grad and top_i.shape == (B, k)
    (ce * torch.tensor(weights)).sum().backward()
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(want_ce),
                               atol=2e-5 if precision == "high" else 1e-5, rtol=0)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(want_i))
    for got, want, name in zip(leaves, want_g, ("dh", "dw", "db")):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5,
                                   err_msg=name)
    assert (leaves[1].grad[:, valid:] == 0).all() and (leaves[2].grad[valid:] == 0).all()
