"""The port's lazy optimizers and action-major Q heads against the reference.

The same numpy inputs go through the reference package (JAX on the CPU; its
Pallas kernels in interpret mode) and the port on ``device="cpu"``, where the
kernels' plain twins run:

- every function of ``train/lazy_adam.py``: the merge of duplicate ids, lazy
  embedding Adam (duplicates, the frozen pad row, bf16 moments) and lazy
  action-major Q-head Adam; the reference's ``selected=False`` is an
  identity, which is why the port's steps may skip the net they do not
  train;
- B5 and B6 with ``action_major=True`` in every precision, ``valid_dim`` a
  runtime value, K = 1..5 and exact ties to the lowest id, held as
  tests/test_torch_fused_argmax.py holds the canonical forms ("default" is
  one bf16 pass in the port and fp32 in XLA on the CPU, so it is held to
  the reference's "highest" on bf16-rounded h and W); the action-major form
  gives the canonical form's bits;
- ``blockwise_multihead_max_am``, ``canonicalize_qheads`` and ``eval_head``
  on the lazy layouts;
- the lazy steps, 3 of them with the reference's coins replayed: the CE step
  with lazy embedding rows, and sqn, smorl and sarm with lazy embedding
  rows, lazy Q-head rows or both, plus the fast preset's bf16 moments;
- the lazy first step equal to the dense one;
- the trainer with ``preset: fast`` against the reference's trainer, a lazy
  resume bit for bit, a reference lazy state continued in the port, and a
  lazily trained ``best_model.npz`` written by the reference served by the
  port.

Tolerances, fp32 with sums taken in other orders, as
tests/test_torch_double_q.py: losses atol 1e-5; dense and lazy moments atol
1e-8 + rtol 1e-4 (bf16 moments: one bf16 step, 2^-8 of the value, + 1e-8);
equal counts; params atol 1e-5 over the entries some step moved whose
gradient at each step is 0 or above 1e-6 in size (read back from the
reference's first moments: Adam moves an entry with a gradient near zero by
about +-lr whatever its size).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import as_jax_tree, assert_topk_match, deterministic, model_configs  # noqa: F401

from ikea_recommender_tpu.models import families as jax_families
from ikea_recommender_tpu.ops import fused_argmax as jfa
from ikea_recommender_tpu.ops import fused_topk as jax_topk
from ikea_recommender_tpu.run import checkpoints as jax_ckpt
from ikea_recommender_tpu.train import lazy_adam as jla
from ikea_recommender_tpu.train import state as jax_state
from ikea_recommender_tpu.train import steps as jax_steps
from ikea_recommender_tpu_torch.convert import (
    lazy_params_from_numpy,
    tree_map,
    lazy_state_from_numpy,
    numpy_init_double_q,
    numpy_init_params,
    params_from_numpy,
)
from ikea_recommender_tpu_torch.models import families
from ikea_recommender_tpu_torch.ops import fused_argmax
from ikea_recommender_tpu_torch.ops.fused_topk import (
    blockwise_multihead_max,
    blockwise_multihead_max_am,
    eval_head,
)
from ikea_recommender_tpu_torch.run import checkpoints as port_ckpt
from ikea_recommender_tpu_torch.train import lazy_adam as pla
from ikea_recommender_tpu_torch.train.state import (
    DoubleQState,
    TrainState,
    make_double_q_state,
    make_lazy_double_q_state,
    make_lazy_sarm_state,
    make_lazy_train_state,
    make_train_state,
)
from ikea_recommender_tpu_torch.train.steps import RLStepConfig, make_train_step

LR, B1 = 0.01, 0.9
A, B, T, E = 257, 16, 6, 8  # a ragged catalog: the kernels' tail masks run
BF16_STEP = 2.0**-8


def _bf(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, dtype=np.float32)


# -- 1. train/lazy_adam.py -------------------------------------------------------


def _rows(n, C, V, seed, pad=None):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, n).astype(np.int32)
    ids[: n // 4] = ids[0]  # a long run of one id
    if pad is not None:
        ids[-3:] = pad
    return ids, rs.randn(n, C).astype(np.float32)


def test_dedupe_row_grads_matches_reference():
    ids, g = _rows(40, 5, 12, seed=0)
    want_ids, want_g = jla.dedupe_row_grads(jnp.asarray(ids), jnp.asarray(g), sentinel=12)
    got_ids, got_g = pla.dedupe_row_grads(torch.tensor(ids).long(), torch.tensor(g), 12)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    first = np.asarray(want_ids) < 12  # the reference's duplicate slots are dropped
    np.testing.assert_allclose(got_g.numpy()[first], np.asarray(want_g)[first], atol=1e-6)


@pytest.mark.parametrize("mv_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("frozen", [None, 11])
def test_emb_adam_update_matches_reference(mv_dtype, frozen):
    V, Ed, n = 12, 6, 48
    ids, g = _rows(n, Ed, V, seed=1, pad=11)
    rs = np.random.RandomState(2)
    emb = rs.randn(V, Ed).astype(np.float32)
    mv0 = (0.01 * rs.rand(V, 2 * Ed)).astype(np.float32)
    jstate = jla.EmbAdamState(mv=jnp.asarray(mv0).astype(mv_dtype or jnp.float32))
    pstate = pla.init_emb_adam(torch.tensor(emb), mv_dtype)
    pstate.mv.copy_(torch.tensor(mv0))
    assert pstate.mv.dtype == (torch.bfloat16 if mv_dtype else torch.float32)
    want_e, want_s = jla.emb_adam_update(jnp.asarray(emb), jstate, jnp.asarray(ids),
                                         jnp.asarray(g), jnp.asarray(4, jnp.int32), lr=LR,
                                         frozen_row=frozen)
    got_e, got_s = pla.emb_adam_update(torch.tensor(emb), pstate, torch.tensor(ids),
                                       torch.tensor(g), torch.tensor(4, dtype=torch.int32),
                                       LR, frozen_row=frozen)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=1e-6, rtol=0)
    tol = dict(atol=1e-8, rtol=BF16_STEP if mv_dtype else 1e-5)
    np.testing.assert_allclose(_np(got_s.mv), _np(want_s.mv), **tol)
    untouched = np.setdiff1d(np.arange(V), ids)
    np.testing.assert_array_equal(got_e.numpy()[untouched], emb[untouched])
    if frozen is not None:
        np.testing.assert_array_equal(got_e.numpy()[frozen], emb[frozen])
        np.testing.assert_array_equal(_np(got_s.mv)[frozen], _np(jstate.mv)[frozen])


def test_unselected_update_is_an_identity():
    """The reference's ``selected=False`` (the double-Q net a step does not
    train) leaves the table, the bias and the moments bit for bit: so the
    port skips that net's update."""
    V, Ed = 12, 6
    ids, g = _rows(30, Ed, V, seed=3)
    rs = np.random.RandomState(4)
    emb = jnp.asarray(rs.randn(V, Ed).astype(np.float32))
    mv = jnp.asarray(rs.rand(V, 2 * Ed).astype(np.float32)).astype(jnp.bfloat16)
    e2, s2 = jla.emb_adam_update(emb, jla.EmbAdamState(mv=mv), jnp.asarray(ids), jnp.asarray(g),
                                 jnp.asarray(0), lr=LR, selected=jnp.asarray(False))
    assert np.array_equal(np.asarray(e2), np.asarray(emb))
    assert np.array_equal(np.asarray(s2.mv, np.float32), np.asarray(mv, np.float32))
    K, F = 3, 4
    kam = jnp.asarray(rs.randn(V, K * F).astype(np.float32))
    bias = jnp.asarray(rs.randn(K, V).astype(np.float32))
    sids = jnp.sort(jnp.asarray(rs.randint(0, V, 8)))
    col = jla.ColAdamState(mv=jnp.asarray(rs.rand(V, K * 2 * (F + 1)).astype(np.float32)))
    k2, b2, c2 = jla.qhead_row_adam_update(
        kam, bias, col, sids, jnp.ones((8, K, F)), jnp.ones((K, 8)), jnp.asarray(2), LR,
        selected=jnp.asarray(False))
    for x, y in ((k2, kam), (b2, bias), (c2.mv, col.mv)):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("K", [1, 3])
def test_action_major_layout_matches_reference(K):
    rs = np.random.RandomState(K)
    kern = rs.randn(K, 5, 11).astype(np.float32)
    canon = kern[0] if K == 1 else kern
    want = np.asarray(jla.to_action_major(jnp.asarray(canon)))
    got = pla.to_action_major(torch.tensor(canon))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pla.from_action_major(got, K).numpy(),
                                  np.asarray(jla.from_action_major(jnp.asarray(want), K)))
    np.testing.assert_array_equal(pla.from_action_major(got, K).numpy(), kern)
    for mv in (None, "bfloat16"):
        want_s = jla.init_col_adam(jnp.asarray(want), K, mv)
        got_s = pla.init_col_adam(got, K, mv)
        assert tuple(got_s.mv.shape) == want_s.mv.shape
        assert str(got_s.mv.dtype).split(".")[-1] == str(want_s.mv.dtype)
        assert not got_s.mv.any()


def test_sorted_rows_and_q_from_rows_match_reference():
    rs = np.random.RandomState(5)
    K, F, V = 3, 4, 13
    idx = rs.randint(0, V, 20).astype(np.int32)
    idx[:6] = idx[6]  # ties: the stable order must be argsort's
    got_s, got_inv = pla.sort_batch_ids(torch.tensor(idx))
    want_s, want_inv = jla.sort_batch_ids(jnp.asarray(idx))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_inv.numpy(), np.asarray(want_inv))
    kam = rs.randn(V, K * F).astype(np.float32)
    for bias in (rs.randn(K, V).astype(np.float32), rs.randn(V).astype(np.float32)):
        k = 1 if bias.ndim == 1 else K
        kk = kam[:, : k * F]
        got = pla.gather_qhead_rows(torch.tensor(kk), torch.tensor(bias), got_s, k)
        want = jla.gather_qhead_rows(jnp.asarray(kk), jnp.asarray(bias), want_s, k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        h = rs.randn(20, F).astype(np.float32)
        np.testing.assert_allclose(
            pla.q_from_rows(torch.tensor(h), *got).numpy(),
            np.asarray(jla.q_from_rows(jnp.asarray(h), *want)), atol=1e-6)


@pytest.mark.parametrize("K,bias_dim,mv_dtype", [(1, 1, None), (3, 2, None), (3, 2, "bfloat16"),
                                                  (4, 2, None)])
def test_qhead_row_adam_update_matches_reference(K, bias_dim, mv_dtype):
    rs = np.random.RandomState(K + bias_dim)
    F, V, n = 5, 14, 24
    kam = rs.randn(V, K * F).astype(np.float32)
    bias = rs.randn(V).astype(np.float32) if bias_dim == 1 else rs.randn(K, V).astype(np.float32)
    ids = rs.randint(0, V, n)
    ids[:5] = ids[5]
    sids = np.sort(ids).astype(np.int32)
    gw = rs.randn(n, K, F).astype(np.float32)
    gb = rs.randn(K, n).astype(np.float32)
    mv0 = (0.01 * rs.rand(V, K * 2 * (F + 1))).astype(np.float32)
    jcol = jla.ColAdamState(mv=jnp.asarray(mv0).astype(mv_dtype or jnp.float32))
    want = jla.qhead_row_adam_update(jnp.asarray(kam), jnp.asarray(bias), jcol, jnp.asarray(sids),
                                     jnp.asarray(gw), jnp.asarray(gb), jnp.asarray(3), LR)
    pcol = pla.init_col_adam(torch.tensor(kam), K, mv_dtype)
    pcol.mv.copy_(torch.tensor(mv0))
    got = pla.qhead_row_adam_update(torch.tensor(kam), torch.tensor(bias), pcol,
                                    torch.tensor(sids).long(), torch.tensor(gw), torch.tensor(gb),
                                    torch.tensor(3, dtype=torch.int32), LR)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(got[2].mv), _np(want[2].mv), atol=1e-8,
                               rtol=BF16_STEP if mv_dtype else 1e-5)
    untouched = np.setdiff1d(np.arange(V), sids)
    np.testing.assert_array_equal(_np(got[0])[untouched], kam[untouched])


# -- 2. B5 and B6 on the action-major layout --------------------------------------

SHAPES = [(384, 384), (300, 300), (384, 300)]  # (A, valid)
PRECISIONS = ["highest", "high", "default"]


def _am_head(B_, F, A_, K, seed, nan_from=None):
    rs = np.random.RandomState(seed)
    h = rs.randn(B_, F).astype(np.float32)
    w = rs.randn(K, F, A_).astype(np.float32)
    b = rs.randn(K, A_).astype(np.float32)
    if nan_from is not None:
        w[..., nan_from:] = np.nan
        b[..., nan_from:] = np.nan
    return h, w, b


def _assert_argmax(got_i, got_m, want_i, want_m, dense, valid, tol=1e-5):
    got_i, got_m = np.asarray(got_i), np.asarray(got_m)
    scale = max(1.0, np.abs(want_m).max())
    np.testing.assert_allclose(got_m, want_m, atol=tol * scale, rtol=0)
    top2 = np.sort(np.where(np.arange(dense.shape[1]) < valid, dense, -np.inf), axis=1)[:, -2:]
    assert ((top2[:, 1] - top2[:, 0]) > tol * scale).all()
    np.testing.assert_array_equal(got_i, np.asarray(want_i))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("A_,valid", SHAPES)
def test_linear_argmax_action_major_matches_reference(A_, valid, precision):
    h, w, b = _am_head(16, 8, A_, 1, seed=A_ + valid, nan_from=valid if valid < A_ else None)
    w, b = w[0], b[0]
    ref_prec = "highest" if precision == "default" else precision
    jh, jw = (_bf(h), _bf(w)) if precision == "default" else (h, w)
    w_am = np.ascontiguousarray(w.T)
    want_i, want_m = jfa.fused_linear_argmax(
        jnp.asarray(jh), jnp.asarray(np.ascontiguousarray(jw.T)), jnp.asarray(b), valid,
        ref_prec, with_max=True, action_major=True)
    got_i, got_m = fused_argmax.fused_linear_argmax(
        torch.tensor(h), torch.tensor(w_am), torch.tensor(b), valid, precision, with_max=True,
        action_major=True)
    dense = jh.astype(np.float64) @ np.nan_to_num(jw) + np.nan_to_num(b)
    _assert_argmax(got_i, got_m, want_i, want_m, dense, valid)
    canon = fused_argmax.fused_linear_argmax(torch.tensor(h), torch.tensor(w), torch.tensor(b),
                                             valid, precision, with_max=True)
    assert all(torch.equal(g, c) for g, c in zip((got_i, got_m), canon))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5])
def test_weighted_argmax_action_major_matches_reference(K, precision):
    A_, valid = 300, 290
    h, w, b = _am_head(8, 8, A_, K, seed=10 * K + len(precision), nan_from=valid)
    qw = np.linspace(0.5, 1.5, K).astype(np.float32)
    w_am = np.ascontiguousarray(w.reshape(K * 8, A_).T)
    ref_prec = "highest" if precision == "default" else precision
    jh, jw = (_bf(h), _bf(w)) if precision == "default" else (h, w)
    want_i, want_m = jfa.fused_weighted_multihead_argmax(
        jnp.asarray(jh), jnp.asarray(np.ascontiguousarray(jw.reshape(K * 8, A_).T)),
        jnp.asarray(b), jnp.asarray(qw), valid, ref_prec, with_max=True, action_major=True)
    got_i, got_m = fused_argmax.fused_weighted_multihead_argmax(
        torch.tensor(h), torch.tensor(w_am), torch.tensor(b), torch.tensor(qw), valid, precision,
        with_max=True, action_major=True)
    dense = sum(qw[k] * (jh.astype(np.float64) @ np.nan_to_num(jw[k]) + np.nan_to_num(b[k]))
                for k in range(K))
    _assert_argmax(got_i, got_m, want_i, want_m, dense, valid)
    canon = fused_argmax.fused_weighted_multihead_argmax(
        torch.tensor(h), torch.tensor(w), torch.tensor(b), torch.tensor(qw), valid, precision,
        with_max=True)
    assert all(torch.equal(g, c) for g, c in zip((got_i, got_m), canon))


@pytest.mark.parametrize("K", [None, 3])
def test_action_major_exact_ties_go_to_the_lowest_id(K):
    """Small integers, so every sum is exact: columns 127, 128 (the two
    sides of a reference block edge) and valid - 1 are copies and the
    largest of each row; both sides pick 127."""
    A_, valid, F = 384, 300, 8
    rs = np.random.RandomState(7)
    heads = K or 1
    h = rs.randint(-2, 3, (8, F)).astype(np.float32)
    w = rs.randint(-2, 3, (heads, F, A_)).astype(np.float32)
    b = rs.randint(-4, 5, (heads, A_)).astype(np.float32)
    for col in (128, valid - 1):
        w[..., col], b[..., col] = w[..., 127], b[..., 127]
    b[..., [127, 128, valid - 1]] = 1000.0
    w_am = np.ascontiguousarray(w.reshape(heads * F, A_).T)
    if K is None:
        want = jfa.fused_linear_argmax(jnp.asarray(h), jnp.asarray(w_am), jnp.asarray(b[0]),
                                       valid, action_major=True)
        got = fused_argmax.fused_linear_argmax(torch.tensor(h), torch.tensor(w_am),
                                               torch.tensor(b[0]), valid, action_major=True)
    else:
        qw = np.asarray([0.5, 0.25, 0.125], np.float32)
        want = jfa.fused_weighted_multihead_argmax(jnp.asarray(h), jnp.asarray(w_am),
                                                   jnp.asarray(b), jnp.asarray(qw), valid,
                                                   action_major=True)
        got = fused_argmax.fused_weighted_multihead_argmax(
            torch.tensor(h), torch.tensor(w_am), torch.tensor(b), torch.tensor(qw), valid,
            action_major=True)
    np.testing.assert_array_equal(np.asarray(want), 127)
    np.testing.assert_array_equal(got.numpy(), 127)


def test_action_major_shapes_are_checked():
    h = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="action-major"):
        fused_argmax.fused_linear_argmax(h, torch.zeros(8, 32), torch.zeros(32), 32,
                                         action_major=True)
    with pytest.raises(ValueError, match="action-major"):
        fused_argmax.fused_weighted_multihead_argmax(h, torch.zeros(32, 16), torch.zeros(3, 32),
                                                     [1.0, 1.0, 1.0], 32, action_major=True)
    with pytest.raises(ValueError, match="valid_dim"):
        fused_argmax.fused_linear_argmax(h, torch.zeros(32, 8), torch.zeros(32), 33,
                                         action_major=True)


# -- 3. the target max, canonicalization and the eval head on lazy layouts ----------


@pytest.mark.parametrize("K,A_,block", [(1, 300, 128), (4, 300, 128), (4, 257, 4096)])
def test_blockwise_multihead_max_am_matches_reference(K, A_, block):
    rs = np.random.RandomState(K + A_)
    F, valid = 8, A_ - 7
    h = rs.randn(12, F).astype(np.float32)
    w = rs.randn(K, F, A_).astype(np.float32)
    b = rs.randn(K, A_).astype(np.float32)
    w_am = np.ascontiguousarray(w.reshape(K * F, A_).T)
    want = jax_topk.blockwise_multihead_max_am(jnp.asarray(h), jnp.asarray(w_am), jnp.asarray(b),
                                               valid, block_cols=block, precision="highest")
    for precision in PRECISIONS:
        got = blockwise_multihead_max_am(torch.tensor(h), torch.tensor(w_am), torch.tensor(b),
                                         valid, block_cols=block, precision=precision)
        canon = blockwise_multihead_max(torch.tensor(h), torch.tensor(w), torch.tensor(b), valid,
                                        block_cols=block, precision=precision)
        np.testing.assert_allclose(got.numpy(), canon.numpy(), atol=1e-6, rtol=0)
        if precision == "highest":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _lazy_np(family, seed=0):
    """(port config, reference config, canonical numpy params, the
    reference's lazy params)."""
    mc, jmc = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T, model=family)
    np_params = numpy_init_params(mc, seed)
    jlazy = jax_state.lazy_qhead_params(as_jax_tree(np_params), family)
    return mc, jmc, np_params, jlazy


@pytest.mark.parametrize("family", ["sqn", "smorl", "sarm"])
def test_canonicalize_qheads_matches_reference(family):
    mc, jmc, np_params, jlazy = _lazy_np(family)
    plazy = lazy_params_from_numpy(np_params, family, "cpu")
    got = port_ckpt.flatten_params(plazy)
    want = jax_ckpt._flatten_params(jlazy)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    canon_got = port_ckpt.flatten_params(families.canonicalize_qheads(plazy, mc))
    canon_want = jax_ckpt._flatten_params(jax_families.canonicalize_qheads(jlazy, jmc))
    assert set(canon_got) == set(canon_want)
    for k in canon_want:
        np.testing.assert_array_equal(canon_got[k], canon_want[k])
    canonical = params_from_numpy(np_params, "cpu")
    assert families.canonicalize_qheads(canonical, mc) is canonical
    # the dense forward reads either layout alike
    states = torch.randint(0, A + 1, (4, T))
    lens = torch.full((4,), T)
    for x, y in zip(families.apply_model(plazy, mc, states, lens),
                    families.apply_model(canonical, mc, states, lens)):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


@pytest.mark.parametrize("head_idx", [0, 3])
def test_eval_head_on_lazy_sarm(head_idx):
    mc, jmc, np_params, jlazy = _lazy_np("sarm")
    plazy = lazy_params_from_numpy(np_params, "sarm", "cpu")
    k, b = eval_head(plazy, mc, head_idx)
    jk, jb = jax_topk.eval_head(jlazy, jmc, head_idx)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    if head_idx == 0:
        assert k is plazy["q_heads"]["kernel0"]  # no transpose for head 0


# -- 4. the lazy steps against the reference's -----------------------------------------


def _batches(n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        action = rs.randint(0, A, (B,)).astype(np.int32)
        action[:4] = action[4]  # a repeated action: its rows' gradients merge
        out.append({
            "state": rs.randint(0, A + 1, (B, T)).astype(np.int32),
            "action": action,
            "reward": rs.rand(B).astype(np.float32),
            "next_state": rs.randint(0, A + 1, (B, T)).astype(np.int32),
            "true_len": rs.randint(1, T + 1, (B,)).astype(np.int32),
            "true_next_len": rs.randint(1, T + 1, (B,)).astype(np.int32),
            "is_end": rs.rand(B) < 0.3,
            "valid": rs.rand(B) < 0.9,
        })
    return out


def _smorl_aux():
    rs = np.random.RandomState(4)
    return {"div_embedding": rs.randn(A + 1, E).astype(np.float32),
            "unpopular_mask": rs.rand(A) < 0.3}


def _jax_lazy_state(jmc, family, init, lazy_emb, lazy_qh, mv):
    opt = jax_state.make_optimizer(LR, mv)
    zero, key = jnp.zeros((), jnp.int32), jax.random.key(0)
    if family in ("gru4rec", "bidir_gru4rec"):
        params = as_jax_tree(init)
        emb, rest = jax_state.split_embedding(params)
        return opt, jax_state.TrainState(
            params=params, opt_state={"rest": opt.init(rest), "emb": jla.init_emb_adam(emb, mv)},
            step=zero, rng=key)
    nets = init if family in ("sqn", "smorl") else (init,)
    params = [as_jax_tree(p) for p in nets]
    if lazy_qh:
        params = [jax_state.lazy_qhead_params(p, family) for p in params]
    opts = [jax_state._lazy_net_opt_state(opt, p, family, lazy_emb, lazy_qh, mv) for p in params]
    if family == "sarm":
        return opt, jax_state.TrainState(params=params[0], opt_state=opts[0], step=zero, rng=key)
    return opt, jax_state.DoubleQState(params=tuple(params), opt_state=tuple(opts), step=zero,
                                       rng=key)


def _jax_run(jmc, family, init, batches, lazy_emb, lazy_qh, mv, aux):
    opt, st = _jax_lazy_state(jmc, family, init, lazy_emb, lazy_qh, mv)
    step = jax_steps.make_train_step(
        jmc, opt, jax_steps.RLStepConfig(), donate=False,
        lazy_embedding_lr=LR if lazy_emb else None, lazy_qhead_lr=LR if lazy_qh else None,
        **{k: jnp.asarray(v) for k, v in aux.items()})
    states, coins, losses = [st], [], []
    for b in batches:
        coins.append(int(jax.random.bernoulli(jax.random.fold_in(st.rng, st.step))))
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        states.append(st)
        losses.append((float(m["sup_loss"]), float(m["q_loss"])))
    return states, coins, losses


def _port_state(mc, family, init, lazy_emb, lazy_qh, mv):
    if family in ("gru4rec", "bidir_gru4rec"):
        return make_lazy_train_state(params_from_numpy(init, "cpu"), mc, LR, mv, device="cpu")
    if family == "sarm":
        return make_lazy_sarm_state(params_from_numpy(init, "cpu"), mc, LR, mv, lazy_emb=lazy_emb,
                                    lazy_qh=lazy_qh, device="cpu")
    return make_lazy_double_q_state([params_from_numpy(p, "cpu") for p in init], mc, LR, mv,
                                    lazy_emb=lazy_emb, lazy_qh=lazy_qh, device="cpu")


def _port_run(mc, family, init, batches, lazy_emb, lazy_qh, mv, aux, coins):
    state, opt = _port_state(mc, family, init, lazy_emb, lazy_qh, mv)
    step = make_train_step(mc, opt, RLStepConfig(), device="cpu",
                           lazy_embedding_lr=LR if lazy_emb else None,
                           lazy_qhead_lr=LR if lazy_qh else None, **aux)
    losses = []
    for b, coin in zip(batches, coins):
        if isinstance(state, DoubleQState):
            other = list(port_ckpt.flatten_params(state.params[1 - coin]).values())
            state, m = step(state, b, coin=coin)
            after = port_ckpt.flatten_params(state.params[1 - coin]).values()
            assert all(np.array_equal(x, y) for x, y in zip(other, after))
        else:
            state, m = step(state, b)
        losses.append((float(m["sup_loss"]), float(m["q_loss"])))
    return state, losses


def _jax_dense_adam(o):
    (adam,) = [s for s in jax.tree.leaves(o["rest"], is_leaf=lambda x: hasattr(x, "mu"))
               if hasattr(s, "mu")]
    return adam


def _flat(tree):
    """A port tree of any float dtype as flat fp32 numpy arrays."""
    return port_ckpt.flatten_params(tree_map(lambda t: t.float(), tree))


def _named_moments(opt_state, port: bool):
    """{param name: first moment} and {param name: second moment} of one
    net's lazy optimizer state, dense and lazy parts alike, and the
    count."""
    if port:
        mu, nu = (_flat(t) for t in (opt_state.rest.mu, opt_state.rest.nu))
        emb = None if opt_state.emb is None else _np(opt_state.emb.mv)
        qh = None if opt_state.qh is None else _np(opt_state.qh.mv)
        count = int(opt_state.count)
    else:
        adam = _jax_dense_adam(opt_state)
        mu, nu = (jax_ckpt._flatten_params(t) for t in (adam.mu, adam.nu))
        emb = _np(opt_state["emb"].mv) if "emb" in opt_state else None
        qh = _np(opt_state["qh"].mv) if "qh" in opt_state else None
        count = int(opt_state.get("count", -1))

    def rename(k):
        if k.startswith("h0/"):
            return "q_heads/" + k[3:] + "0"
        return k[5:] if k.startswith("rest/") else k

    m = {rename(k): v.astype(np.float32) for k, v in mu.items()}
    v = {rename(k): x.astype(np.float32) for k, x in nu.items()}
    if emb is not None:
        half = emb.shape[1] // 2
        m["backbone/embedding"], v["backbone/embedding"] = emb[:, :half], emb[:, half:]
    if qh is not None:
        half = qh.shape[1] // 2
        return m, v, count, qh[:, :half], qh[:, half:]
    return m, v, count, None, None


def _qh_split(packed, K):
    """Packed (A, K (F+1)) moments -> ((A, K F) kernel_am part, (K, A) bias)."""
    p = packed.reshape(packed.shape[0], K, -1)
    return p[:, :, :-1].reshape(packed.shape[0], -1), p[:, :, -1].T


def _moments_by_param(opt_state, port, K, key, family):
    m, v, count, qm, qv = _named_moments(opt_state, port)
    if qm is not None:
        bkey = "bias_rest" if family == "sarm" else "bias"
        for d, packed in ((m, qm), (v, qv)):
            d[f"{key}/kernel_am"], d[f"{key}/{bkey}"] = _qh_split(packed, K)
            if K == 1:
                d[f"{key}/{bkey}"] = d[f"{key}/{bkey}"][0]
    return m, v, count


def _compare_runs(jout, pout, family, mc, mv):
    (jstates, coins, j_losses), (state, p_losses) = jout, pout
    np.testing.assert_allclose(p_losses, j_losses, atol=1e-5, rtol=0)
    nets = (0, 1) if family in ("sqn", "smorl") else (None,)
    key = {"sqn": "q_head", "smorl": "q_heads", "sarm": "q_heads"}.get(family, "q_head")
    K = {"sqn": 1, "smorl": mc.num_q_heads, "sarm": 4}.get(family, 1)
    m_tol = dict(atol=1e-8, rtol=BF16_STEP if mv else 1e-4)
    compared = moved = 0
    for net in nets:
        def pick(tree):
            return tree if net is None else tree[net]

        jparams = [jax_ckpt._flatten_params(pick(s.params)) for s in jstates]
        jmoms = [_moments_by_param(pick(s.opt_state), False, K, key, family) for s in jstates]
        got_p = port_ckpt.flatten_params(pick(state.params))
        got_m, got_v, got_count = _moments_by_param(pick(state.opt_state), True, K, key, family)
        want_m, want_v, want_count = jmoms[-1]
        if want_count >= 0:
            assert got_count == want_count
        assert set(got_m) == set(want_m) and set(got_p) == set(jparams[-1])
        for name in want_m:
            np.testing.assert_allclose(got_m[name], want_m[name], **m_tol, err_msg=name)
            np.testing.assert_allclose(got_v[name], want_v[name], **m_tol, err_msg=name)
        for name, want in jparams[-1].items():
            if name not in want_m:  # not trained (sarm's dense head, say)
                continue
            gk = []
            for k in range(len(coins)):
                m0, m1 = jmoms[k][0][name], jmoms[k + 1][0][name]
                trained = net is None or coins[k] == net
                g = np.where(m1 == m0, 0.0, (m1 - B1 * m0) / (1 - B1))
                gk.append(g if trained else np.zeros_like(g))
            gk = np.stack(gk)
            mk = (gk != 0).any(axis=0)
            sure = mk & ((gk == 0) | (np.abs(gk) > 1e-6)).all(axis=0)
            np.testing.assert_allclose(got_p[name][sure], want.astype(np.float32)[sure],
                                       atol=1e-5, rtol=0, err_msg=name)
            compared, moved = compared + sure.sum(), moved + mk.sum()
    assert compared >= moved / 4, f"only {compared} of {moved} moved entries compared"


LAZY_CASES = {  # family: (lazy_emb, lazy_qh, mv_dtype, extra train config)
    "gru4rec-emb": ("gru4rec", True, False, None, {}),
    "gru4rec-emb-unfused": ("gru4rec", True, False, None, dict(fused_ce=False)),
    "sqn-emb": ("sqn", True, False, None, {}),
    "sqn-qh": ("sqn", False, True, None, {}),
    "sqn-both": ("sqn", True, True, None, {}),
    "sqn-fast": ("sqn", False, True, "bfloat16", dict(head_precision="highest")),
    "smorl-emb": ("smorl", True, False, None, {}),
    "smorl-qh": ("smorl", False, True, None, {}),
    "smorl-both": ("smorl", True, True, None, dict(train_padding_embed=False)),
    "smorl-fast": ("smorl", False, True, "bfloat16", dict(head_precision="highest")),
    "sarm-emb": ("sarm", True, False, None, {}),
    "sarm-qh": ("sarm", False, True, None, {}),
    "sarm-both": ("sarm", True, True, None, dict(train_padding_embed=False)),
    "sarm-fast": ("sarm", False, True, "bfloat16", dict(head_precision="highest")),
}


@pytest.mark.parametrize("case", list(LAZY_CASES))
def test_three_lazy_steps_match_reference(case):
    family, lazy_emb, lazy_qh, mv, kw = LAZY_CASES[case]
    mc, jmc = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T,
                            model=family, **kw)
    assert mc.fused_ce == kw.get("fused_ce", True)
    init = (numpy_init_double_q(mc, (1, 2)) if family in ("sqn", "smorl")
            else numpy_init_params(mc, 1))
    aux = _smorl_aux() if family == "smorl" else {}
    batches = _batches(3, seed=3)
    jout = _jax_run(jmc, family, init, batches, lazy_emb, lazy_qh, mv, aux)
    pout = _port_run(mc, family, init, batches, lazy_emb, lazy_qh, mv, aux, jout[1])
    _compare_runs(jout, pout, family, mc, mv)
    assert pout[0].step == 3


@pytest.mark.parametrize("family", ["sqn", "smorl", "sarm"])
def test_lazy_first_step_equals_dense(family):
    """From the same params all moments are zero, so dense Adam's untouched
    columns and rows take a zero update: the first lazy step (embedding
    and Q heads) equals the dense one."""
    mc, _ = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T, model=family)
    aux = _smorl_aux() if family == "smorl" else {}
    batch = _batches(1, seed=9)[0]
    if family == "sarm":
        init = numpy_init_params(mc, 2)
        dense, opt = make_train_state(params_from_numpy(init, "cpu"), mc, LR, device="cpu")
    else:
        init = numpy_init_double_q(mc, (2, 3))
        dense, opt = make_double_q_state([params_from_numpy(p, "cpu") for p in init], mc, LR,
                                         device="cpu")
    lazy, lopt = _port_state(mc, family, init, True, True, None)
    kw = dict(coin=1) if family != "sarm" else {}
    dense, md = make_train_step(mc, opt, device="cpu", **aux)(dense, batch, **kw)
    lazy, ml = make_train_step(mc, lopt, device="cpu", lazy_embedding_lr=LR, lazy_qhead_lr=LR,
                               **aux)(lazy, batch, **kw)
    for k in ("sup_loss", "q_loss"):
        np.testing.assert_allclose(float(ml[k]), float(md[k]), atol=1e-6)
    nets = [(dense.params, lazy.params)] if family == "sarm" else list(zip(dense.params,
                                                                           lazy.params))
    for d, lz in nets:
        got = port_ckpt.flatten_params(families.canonicalize_qheads(lz, mc))
        want = port_ckpt.flatten_params(d)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)


def test_reference_lazy_state_continues_in_the_port():
    """Two reference sqn steps with lazy embedding and Q-head rows and bf16
    moments, carried into the port (``lazy_state_from_numpy``): the next
    step matches the reference's."""
    mc, jmc = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T, model="sqn")
    init = numpy_init_double_q(mc, (4, 5))
    batches = _batches(3, seed=6)
    jstates, coins, losses = _jax_run(jmc, "sqn", init, batches, True, True, "bfloat16", {})
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    pair, opts = lazy_state_from_numpy(to_np(jstates[2].params), to_np(jstates[2].opt_state),
                                       device="cpu")
    assert "kernel_am" in pair[0]["q_head"] and opts[0].qh.mv.dtype == torch.bfloat16
    state, opt = make_lazy_double_q_state(
        [params_from_numpy(p, "cpu") for p in init], mc, LR, "bfloat16", lazy_emb=True,
        lazy_qh=True, device="cpu")
    state.params, state.opt_state = pair, opts
    step = make_train_step(mc, opt, device="cpu", lazy_embedding_lr=LR, lazy_qhead_lr=LR)
    state, m = step(state, batches[2], coin=coins[2])
    np.testing.assert_allclose((float(m["sup_loss"]), float(m["q_loss"])), losses[2], atol=1e-5)
    main = coins[2]
    got = port_ckpt.flatten_params(state.params[main])
    for k, w in jax_ckpt._flatten_params(jstates[3].params[main]).items():
        np.testing.assert_allclose(got[k], w, atol=1e-5, rtol=0, err_msg=k)
    # the CE families' lazy state counts with its step
    gmc, _ = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T)
    _, jst = _jax_lazy_state(gmc, "gru4rec", numpy_init_params(gmc, 0), True, False, None)
    params, ostate = lazy_state_from_numpy(to_np(jst.params), to_np(jst.opt_state), step=7,
                                           device="cpu")
    assert int(ostate.count) == 7 and "rest" in ostate.rest.mu
    with pytest.raises(ValueError, match="step"):
        lazy_state_from_numpy(to_np(jst.params), to_np(jst.opt_state), device="cpu")


def test_lazy_steps_check_their_inputs():
    mc, _ = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T, model="sqn")
    unfused, _ = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T,
                               model="sqn", fused_ce=False)
    gru, _ = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T)
    pair = [params_from_numpy(p, "cpu") for p in numpy_init_double_q(mc, (1, 2))]
    _, opt = make_lazy_double_q_state(pair, mc, LR, lazy_qh=True, device="cpu")
    with pytest.raises(ValueError, match="fused train path"):
        make_train_step(unfused, opt, device="cpu", lazy_qhead_lr=LR)
    with pytest.raises(ValueError, match="double_q_optimizers=2"):
        make_train_step(mc, opt, RLStepConfig(single_optimizer=True), device="cpu",
                        lazy_qhead_lr=LR)
    with pytest.raises(ValueError, match="Q family"):
        make_train_step(gru, opt, device="cpu", lazy_qhead_lr=LR)
    sarm, _ = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T,
                            model="sarm")
    # the reference's rule: sqn and smorl take the lazy arms on a mesh, sarm not
    with pytest.raises(ValueError, match=r"mesh \+ lazy is not supported for sarm"):
        make_train_step(sarm, opt, device="cpu", lazy_qhead_lr=LR, mesh=object())
    st, _ = make_lazy_sarm_state(params_from_numpy(numpy_init_params(sarm, 0), "cpu"), sarm,
                                 LR, lazy_qh=True, device="cpu")
    assert isinstance(st, TrainState) and set(st.params["q_heads"]) == {
        "kernel0", "bias0", "kernel_am", "bias_rest"}
    assert tuple(st.opt_state.qh.mv.shape) == (A, 4 * 2 * (E + 1))


# -- 5. the trainer with ``preset: fast`` ---------------------------------------------


@pytest.mark.parametrize("model", ["sqn", "smorl", "sarm"])
def test_fast_preset_trainer_matches_reference(monkeypatch, tmp_path, model):
    """One epoch of each Q family with ``preset: fast`` (bf16 moments, lazy
    action-major Q heads) on the fused path, "highest" set explicitly (XLA
    on the CPU runs "default" in fp32, the port's twins in one bf16 pass),
    held as tests/test_torch_trainer.py holds the dense runs; the best
    model is saved in the reference's lazy layout. The moments are stored
    in bf16: where the two sides' fp32 moments round to neighbouring bf16
    values, that step's update of the entry moves by up to one bf16 step
    of it (2^-8 lr for an update near lr). So the best params are held to
    a further steps x lr x 2^-8 (the run's 39 steps at lr 0.01: 1.5e-3;
    the embedding moves most, ~4e-4 here)."""
    from test_torch_trainer import _assert_runs_match, _run_both

    want, got, proto = _run_both(monkeypatch, tmp_path, model, 1, fused=True, preset="fast",
                                 head_precision="highest")
    n_steps = -(-1230 // 32)  # the trainer test's train rows and batch
    _assert_runs_match(want, got, proto, 2 if model != "sarm" else 1,
                       params_atol=n_steps * LR * BF16_STEP)
    keys = set(np.load(tmp_path / "port" / "best_model.npz").files)
    assert keys == set(np.load(tmp_path / "jax" / "best_model.npz").files)
    head = "q_head" if model == "sqn" else "q_heads"
    assert f"{head}/kernel_am" in keys and f"{head}/kernel" not in keys


def test_fast_preset_resume_is_bit_identical(tmp_path, deterministic):
    """sqn with ``preset: fast`` and lazy embedding rows: a 1-epoch run and
    a resume to epoch 2 give the uninterrupted run's epoch 2, best point
    and test metrics bit for bit (the checkpoint carries the lazy moment
    buffers and each net's count)."""
    from test_torch_trainer import _buffers, _cfg

    from ikea_recommender_tpu_torch.core import config as port_config
    from ikea_recommender_tpu_torch.data import synthetic as port_synth
    from ikea_recommender_tpu_torch.run import trainer as port_trainer

    def run(exp, epochs, **kw):
        train_buf, val_buf = _buffers(port_synth)
        cfg = _cfg(port_config, tmp_path / exp, "sqn", epochs, fused=True, preset="fast",
                   optimizer="lazy_adam", **kw)
        return port_trainer.train(cfg, train_buf=train_buf, val_buf=val_buf, device="cpu")

    full = run("full", 2)
    ckpt = str(tmp_path / "ckpt")
    run("leg1", 1, checkpoint_dir=ckpt)
    resumed = run("leg2", 2, checkpoint_dir=ckpt, resume=True)
    assert resumed.logs == full.logs[2:]
    assert (resumed.best_metric, resumed.best_epoch) == (full.best_metric, full.best_epoch)
    assert resumed.test_metrics == full.test_metrics
    payload = torch.load(os.path.join(ckpt, "ckpt_1.pt"), weights_only=True)["train"]
    # per net: Adam's count, mu, nu; the lazy count; the emb and qh buffers
    assert [len(o) for o in payload["opt_state"]] == [6, 6]


def test_reference_lazy_best_model_serves(tmp_path):
    """A sarm model trained with ``preset: fast`` by the reference's trainer
    writes ``best_model.npz`` in the lazy layout (``q_heads/kernel0``,
    ``q_heads/kernel_am``, ...). The port's batch CLI serves it from the
    same YAML with the reference Recommender's records over the same file
    (the reference's ``scripts/recommend.py`` builds a canonical template
    and cannot read a lazy file), and its top-1 is the argmax of the
    scored head's full scores."""
    from ikea_recommender_tpu.core import config as jax_config
    from ikea_recommender_tpu.data import synthetic as jax_synth
    from ikea_recommender_tpu.run import trainer as jax_trainer
    from ikea_recommender_tpu.run.serve import Recommender as JaxRecommender
    from ikea_recommender_tpu_torch.core import config as port_config
    from ikea_recommender_tpu_torch.run import recommend
    from ikea_recommender_tpu_torch.run.serve import Recommender

    A_, E_, T_, k = 50, 8, 5, 5
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "experiment.yaml").write_text(
        f"data:\n  num_items: {A_}\n"
        f"train:\n  model: sarm\n  embedding_size: {E_}\n  hidden_state_size: {E_}\n"
        f"  state_size: {T_}\n  head_idx: 3\n  batch_size: 32\n  epochs: 1\n"
        f"  learning_rate: 0.01\n  eval_at: [1.0]\n  preset: fast\n  fused_ce: true\n"
        f"  fused_ce_min_actions: 0\n  head_precision: highest\n")
    jcfg = jax_config.load_experiment_config(str(exp / "experiment.yaml"))
    train_buf, val_buf = jax_synth.synthetic_buffers(num_sessions=60, num_items=A_,
                                                     state_len=T_, seed=1)
    jax_trainer.train(jcfg, train_buf=train_buf, val_buf=val_buf)
    files = set(np.load(exp / "best_model.npz").files)
    assert {"q_heads/kernel0", "q_heads/kernel_am", "q_heads/bias_rest"} <= files

    rs = np.random.RandomState(2)
    rows = [{"state": rs.randint(0, A_, rs.randint(0, 2 * T_)).tolist()} for _ in range(20)]
    inp = tmp_path / "sessions.jsonl"
    inp.write_text("".join(json.dumps(r) + "\n" for r in rows))
    recommend.main(["-f", str(exp / "experiment.yaml"), "--input", str(inp), "--k", str(k + 1),
                    "--output", str(tmp_path / "got.jsonl"), "--device", "cpu"])
    got = [json.loads(line) for line in (tmp_path / "got.jsonl").read_text().splitlines()]

    jmc = jax_families.model_config_from_train(jcfg.train, jcfg.data)
    template = jax_state.lazy_qhead_params(jax_families.init_model(jax.random.key(0), jmc),
                                           "sarm")
    jparams = jax_ckpt.load_params_npz(template, str(exp / "best_model.npz"))
    pcfg = port_config.load_experiment_config(str(exp / "experiment.yaml"))
    states, lens = recommend.pad_batch(rows, T_, A_, pcfg.train.padding_position)
    wv, wi = JaxRecommender(jparams, jmc, head_idx=3).recommend(
        jnp.asarray(states), jnp.asarray(lens), k=k + 1)
    assert len(got) == len(rows)
    assert_topk_match([r["scores"] for r in got], [r["predictions"] for r in got],
                      np.asarray(wv), np.asarray(wi), k)
    mc = families.model_config_from_train(pcfg.train, pcfg.data)
    rec = Recommender(port_ckpt.load_params_npz(str(exp / "best_model.npz"), device="cpu"), mc,
                      head_idx=3, device="cpu")
    np.testing.assert_array_equal([r["predictions"][0] for r in got],
                                  rec.scores(states, lens).argmax(1).numpy())
