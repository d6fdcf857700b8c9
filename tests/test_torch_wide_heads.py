"""B1, B2, B5 and B6 at head widths and head counts past the port's first
routes, against the reference package.

The reference's kernels take any head width F and any head count K. The
port's tensor-core kernels take F up to 256 (B1, B2) and 128 (B5, B6) and
K up to 5 heads (B6) on their first routes; past them they go over F in
slices (``csrc/mma_tile.cuh``'s wide head walk, B2's wide kernels). On the
CPU the wrappers run the plain twins, which take any F and K: these cases
hold the port's functions to the reference's at F = 129, 257 and 520 (one
past each limit, and 520, which the wide routes take in slices of 128, 128,
128, 128 and 8) and K = 6 and 7, on both layouts of W (canonical and the
lazy optimizers' action-major), in all three precisions, with a ragged,
masked catalog (``valid_dim`` < A, NaN in W's and b's masked columns). The
reference runs its Pallas kernels in interpret mode, as
``tests/test_fused_ce.py`` and ``tests/test_fused_argmax.py`` run them; a
reference call costs 0.3-1 s there, so each width, head count, precision
and layout comes in some case rather than in every combination (their
product is held on the card by ``tests/test_torch_kernels.py`` and
``chip_smoke.py``'s kernel phase, the kernels against the same twins).

Tolerances, those of ``tests/test_torch_fused_ce.py`` and
``tests/test_torch_fused_argmax.py``:
- CE: "highest" and "high" compute the same products on both sides (bf16
  products are exact in fp32), so they differ only in summation order:
  value atol 1e-5, gradients atol 1e-6 + rtol 1e-5. "default" is one bf16
  pass in the port and fp32 in XLA on the CPU: the value is held to 1e-5 of
  the reference's "highest" on bf16-rounded h and W (the same function),
  the gradients to the reference with atol 2e-3 and rtol 5e-2;
- argmax: the max within 1e-5 of the largest |max|, ids equal where the
  reference's top two values differ by more (no row is excluded at these
  sizes, which the cases assert); "default" against the reference's
  "highest" on bf16-rounded h and W.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikea_recommender_tpu.ops import fused_argmax as jfa
from ikea_recommender_tpu.ops.fused_ce import fused_softmax_ce as jax_fused_softmax_ce
from ikea_recommender_tpu_torch.ops import fused_argmax
from ikea_recommender_tpu_torch.ops.fused_ce import fused_softmax_ce

TOL = 1e-5
B, A, VALID = 8, 400, 371  # a ragged catalog of 3 x 128 + 16 columns, its tail masked


def _bf(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _ce_inputs(F, seed):
    rs = np.random.RandomState(seed)
    h = rs.randn(B, F).astype(np.float32)
    w = (rs.randn(F, A) * 0.1).astype(np.float32)
    b = (rs.randn(A) * 0.1).astype(np.float32)
    labels = rs.randint(0, VALID, (B,)).astype(np.int32)
    weights = rs.rand(B).astype(np.float32)
    w[:, VALID:] = np.nan
    return h, w, b, labels, weights


@pytest.mark.parametrize("F,precision", [(257, "highest"), (520, "high"), (520, "default")])
def test_fused_softmax_ce_wide(F, precision):
    """B1's value and B2's gradients of sum(ce * weights) past F = 256
    (``tests/test_torch_train.py``'s bidir-wide case holds them at F = 272
    in "high" inside the step)."""
    h, w, b, labels, weights = _ce_inputs(F, seed=F)
    th, tw, tb = (torch.tensor(a, requires_grad=True) for a in (h, w, b))
    value = fused_softmax_ce(th, tw, tb, torch.tensor(labels), VALID, precision)
    (value * torch.tensor(weights)).sum().backward()
    got, grads = value.detach().numpy(), [t.grad.numpy() for t in (th, tw, tb)]

    def loss(h, w, b):
        return jnp.sum(jax_fused_softmax_ce(h, w, b, jnp.asarray(labels), VALID, precision)
                       * weights)

    args = [jnp.asarray(a) for a in (h, w, b)]
    want_grads = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]
    assert np.isfinite(got).all() and all(np.isfinite(g).all() for g in grads)
    if precision == "default":
        same_fn = jax_fused_softmax_ce(jnp.asarray(_bf(h)), jnp.asarray(_bf(w)), jnp.asarray(b),
                                       jnp.asarray(labels), VALID)
        np.testing.assert_allclose(got, np.asarray(same_fn), atol=TOL, rtol=0)
        for g, want in zip(grads, want_grads):
            np.testing.assert_allclose(g, want, atol=2e-3, rtol=5e-2)
    else:
        want = jax_fused_softmax_ce(*args, jnp.asarray(labels), VALID, precision)
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
        for g, wnt, name in zip(grads, want_grads, ("dh", "dw", "db")):
            np.testing.assert_allclose(g, wnt, atol=1e-6, rtol=1e-5, err_msg=name)
    assert (grads[1][:, VALID:] == 0).all() and (grads[2][VALID:] == 0).all()


def _head(F, K, seed):
    """(h, w, b): w (F, A) with K None, else (K, F, A); NaN past VALID."""
    rs = np.random.RandomState(seed)
    h = rs.randn(B, F).astype(np.float32)
    heads = 1 if K is None else K
    w = rs.randn(heads, F, A).astype(np.float32)
    b = rs.randn(heads, A).astype(np.float32)
    w[..., VALID:] = np.nan
    b[..., VALID:] = np.nan
    return (h, w[0], b[0]) if K is None else (h, w, b)


def _action_major(w):
    """The lazy optimizers' layout of the same head values: (A, F) for B5,
    (A, K F) for B6."""
    return np.ascontiguousarray(w.reshape(-1, A).T)


def _check(got_i, got_m, want_i, want_m, dense):
    got_i, got_m = got_i.numpy(), got_m.numpy()
    scale = max(1.0, np.abs(np.asarray(want_m)).max())
    np.testing.assert_allclose(got_m, np.asarray(want_m), atol=TOL * scale, rtol=0)
    top2 = np.sort(dense[:, :VALID], axis=1)[:, -2:]
    assert ((top2[:, 1] - top2[:, 0]) > TOL * scale).all(), "a row with near-tied maxima"
    np.testing.assert_array_equal(got_i, np.asarray(want_i))


@pytest.mark.parametrize("F,K,precision,action_major", [
    (129, None, "default", True), (257, None, "highest", False), (520, None, "high", True),  # B5
    (129, 7, "default", True), (257, 6, "highest", False), (520, 7, "high", True),  # B6
])
def test_fused_argmax_wide(F, K, precision, action_major):
    """B5 (K None) past F = 128, and B6 past F = 128 and past K = 5 heads,
    with the max, on the canonical and the action-major W
    (``tests/test_torch_double_q.py``'s sqn-wide and smorl-wide cases hold
    the canonical ones at F = 136 in "high" inside the step)."""
    h, w, b = _head(F, K, seed=F + (K or 0))
    q = None if K is None else np.linspace(0.5, 2.0, K).astype(np.float32)
    jh, jw = (_bf(h), _bf(w)) if precision == "default" else (h, w)
    ref_prec = "highest" if precision == "default" else precision
    if action_major:
        w, jw = _action_major(w), _action_major(jw)
    kw = dict(with_max=True, action_major=action_major)
    if K is None:
        want_i, want_m = jfa.fused_linear_argmax(jnp.asarray(jh), jnp.asarray(jw),
                                                 jnp.asarray(b), VALID, ref_prec, **kw)
        got_i, got_m = fused_argmax.fused_linear_argmax(
            torch.tensor(h), torch.tensor(w), torch.tensor(b), VALID, precision, **kw)
    else:
        want_i, want_m = jfa.fused_weighted_multihead_argmax(
            jnp.asarray(jh), jnp.asarray(jw), jnp.asarray(b), jnp.asarray(q), VALID, ref_prec,
            **kw)
        got_i, got_m = fused_argmax.fused_weighted_multihead_argmax(
            torch.tensor(h), torch.tensor(w), torch.tensor(b), torch.tensor(q), VALID,
            precision, **kw)
    dense = fused_argmax.head_values_plain(
        torch.tensor(jh), torch.tensor(jw), torch.tensor(b), VALID, ref_prec,
        None if q is None else torch.tensor(q), action_major).numpy()
    assert got_i.dtype == torch.int64 and np.isfinite(got_m.numpy()).all()
    _check(got_i, got_m, want_i, want_m, dense)
