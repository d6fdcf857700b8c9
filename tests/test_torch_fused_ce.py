"""The port's fused softmax CE (B1 forward, B2 backward) against the
reference package.

The same numpy inputs go through the reference's ``fused_softmax_ce``
(Pallas in interpret mode on the CPU) and the port's, whose CPU path is the
plain twins; value and gradients (dh, dw, db) of ``sum(ce * weights)``.
The case matrix is that of ``tests/test_fused_ce.py``: exact and ragged
tails, padded columns (``valid_dim < A``), a whole block past
``valid_dim``, NaN in the padded columns of W, and the three precisions;
the forward also at F = 128 and F = 24, the widest and a padded width of
its tensor-core kernel, and at F = 256 and F = 200, which it takes in
column slices of 128 (bidir_gru4rec's head at hidden 128).

Tolerances. "highest" and "high" compute the same products on both sides
(bf16 products are exact in fp32), so they differ only in summation order:
value atol 1e-5 (CE ~ 5), gradients atol 1e-6 + rtol 1e-5. "default" is
one bf16 pass on the TPU but full fp32 in XLA on the CPU, so the reference
run here is fp32 and the two differ by bf16 rounding (8 bits): the value is
held to 1e-5 of the reference's "highest" on bf16-rounded h and W, which is
the same function, and the gradients to the reference with atol 2e-3 and
rtol 5e-2, as ``tests/test_fused_ce.py`` holds its "default" path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikea_recommender_tpu.ops.fused_ce import _fwd as jax_fwd
from ikea_recommender_tpu.ops.fused_ce import fused_softmax_ce as jax_fused_softmax_ce
from ikea_recommender_tpu_torch.ops import fused_ce
from ikea_recommender_tpu_torch.ops.fused_ce import (
    fused_ce_bwd,
    fused_ce_bwd_plain,
    fused_ce_fwd,
    fused_ce_fwd_plain,
    fused_softmax_ce,
)

SHAPES = {  # (B, F, A, valid)
    "exact-tail": (8, 16, 384, 384),
    "ragged-tail": (8, 16, 300, 300),
    "padded": (8, 16, 384, 300),
    "block-past-valid": (8, 16, 768, 200),  # the reference's 2nd 512-block is all pad
    "nan-padded": (8, 16, 384, 300),
    "bidir-width": (8, 256, 300, 260),  # F = 2 H at hidden 128, ragged and padded
}


def _inputs(B, F, A, valid, nan_tail=False, seed=0):
    rs = np.random.RandomState(seed)
    h = rs.randn(B, F).astype(np.float32)
    w = (rs.randn(F, A) * 0.1).astype(np.float32)
    b = (rs.randn(A) * 0.1).astype(np.float32)
    labels = rs.randint(0, valid, (B,)).astype(np.int32)
    weights = rs.rand(B).astype(np.float32)
    if nan_tail:
        w[:, valid:] = np.nan
    return h, w, b, labels, weights


def _jax(h, w, b, labels, weights, valid, precision):
    def loss(h, w, b):
        return jnp.sum(jax_fused_softmax_ce(h, w, b, jnp.asarray(labels), valid, precision) * weights)

    args = [jnp.asarray(a) for a in (h, w, b)]
    value = jax_fused_softmax_ce(*args, jnp.asarray(labels), valid, precision)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return np.asarray(value), [np.asarray(g) for g in grads]


def _port(h, w, b, labels, weights, valid, precision):
    th, tw, tb = (torch.tensor(a, requires_grad=True) for a in (h, w, b))
    value = fused_softmax_ce(th, tw, tb, torch.tensor(labels), valid, precision)
    (value * torch.tensor(weights)).sum().backward()
    return value.detach().numpy(), [t.grad.numpy() for t in (th, tw, tb)]


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_matches_reference(shape, precision):
    B, F, A, valid = SHAPES[shape]
    h, w, b, labels, weights = _inputs(B, F, A, valid, nan_tail=shape == "nan-padded")
    value, grads = _port(h, w, b, labels, weights, valid, precision)
    want_value, want_grads = _jax(h, w, b, labels, weights, valid, precision)

    assert np.isfinite(value).all() and all(np.isfinite(g).all() for g in grads)
    if precision == "default":
        bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
        same_fn = jax_fused_softmax_ce(
            jnp.asarray(bf(h)), jnp.asarray(bf(w)), jnp.asarray(b), jnp.asarray(labels), valid
        )
        np.testing.assert_allclose(value, np.asarray(same_fn), atol=1e-5, rtol=0)
        for got, want in zip(grads, want_grads):
            np.testing.assert_allclose(got, want, atol=2e-3, rtol=5e-2)
    else:
        np.testing.assert_allclose(value, want_value, atol=1e-5, rtol=0)
        for got, want, name in zip(grads, want_grads, ("dh", "dw", "db")):
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5, err_msg=name)
    # padded columns receive exactly zero gradient
    assert (grads[1][:, valid:] == 0).all() and (grads[2][valid:] == 0).all()


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("F", [128, 24, 256, 200])
def test_forward_at_the_tensor_core_widths(F, precision):
    """B1's (lse, label logit) against the reference's forward kernel at the
    widths its tensor-core kernel must take: F = 128, the widest it stages
    whole, F = 24, which it pads with zeros to 32, and F = 256 (its limit)
    and F = 200, which it stages in slices of 128; a label at or past
    valid_dim counts 0."""
    B, A, valid = 8, 300, 260
    h, w, b, labels, _ = _inputs(B, F, A, valid, nan_tail=True, seed=F)
    labels[0] = 270
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    jh, jw = (bf(h), bf(w)) if precision == "default" else (h, w)
    want = jax_fwd(*(jnp.asarray(a) for a in (jh, jw, b, labels)), valid,
                   "highest" if precision == "default" else precision)
    got = fused_ce_fwd(*(torch.tensor(a) for a in (h, w, b, labels)), valid, precision)
    for g, x, name in zip(got, want, ("lse", "label logit")):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-5, rtol=0, err_msg=name)
    assert got[1][0] == 0


def test_twins_against_dense_cross_entropy():
    """The plain twins against torch's own CE and autograd on dense logits."""
    B, F, A, valid = 6, 8, 50, 41
    h, w, b, labels, weights = (torch.tensor(a) for a in _inputs(B, F, A, valid, seed=3))
    lse, lbl = fused_ce_fwd_plain(h, w, b, labels, valid)
    dense = (h @ w + b)[:, :valid]
    torch.testing.assert_close(lse - lbl, torch.nn.functional.cross_entropy(
        dense, labels.long(), reduction="none"), atol=1e-5, rtol=0)

    hh, ww, bb = (t.clone().requires_grad_() for t in (h, w, b))
    loss = torch.nn.functional.cross_entropy((hh @ ww + bb)[:, :valid], labels.long(), reduction="none")
    (loss * weights).sum().backward()
    dh, dw, db = fused_ce_bwd_plain(h, w, b, labels, lse, weights, valid)
    for got, want in ((dh, hh.grad), (dw, ww.grad), (db, bb.grad)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_out_of_range_label_counts_zero():
    """A label at or past valid_dim (a column owned by another shard in the
    sharded use) adds 0 to the label logit and no onehot to dlogits."""
    B, F, A, valid = 4, 8, 64, 40
    h, w, b, labels, weights = (torch.tensor(a) for a in _inputs(B, F, A, valid, seed=4))
    labels[0] = 50
    lse, lbl = fused_ce_fwd_plain(h, w, b, labels, valid)
    assert lbl[0] == 0
    _, dw, _ = fused_ce_bwd_plain(h, w, b, labels, lse, weights, valid)
    assert (dw[:, valid:] == 0).all()


def test_cpu_tensors_take_the_plain_twins():
    h, w, b, labels, weights = (torch.tensor(a) for a in _inputs(8, 16, 300, 280, seed=1))
    before = (fused_ce.LAUNCHES, fused_ce.BWD_LAUNCHES)
    lse, lbl = fused_ce_fwd(h, w, b, labels, 280, "high")
    lse_p, lbl_p = fused_ce_fwd_plain(h, w, b, labels, 280, "high")
    grads = fused_ce_bwd(h, w, b, labels, lse, weights, 280, "high")
    grads_p = fused_ce_bwd_plain(h, w, b, labels, lse, weights, 280, "high")
    assert (fused_ce.LAUNCHES, fused_ce.BWD_LAUNCHES) == before
    assert torch.equal(lse, lse_p) and torch.equal(lbl, lbl_p)
    assert all(torch.equal(a, c) for a, c in zip(grads, grads_p))


def test_wrapper_rejects_bad_inputs():
    h, w, b, labels, _ = (torch.tensor(a) for a in _inputs(4, 8, 32, 32))
    with pytest.raises(ValueError, match="precision"):
        fused_softmax_ce(h, w, b, labels, 32, "tf32")
    with pytest.raises(ValueError, match="valid_dim"):
        fused_softmax_ce(h, w, b, labels, 33)
    with pytest.raises(TypeError):
        fused_softmax_ce(h.double(), w, b, labels, 32)
    with pytest.raises(TypeError, match="labels"):
        fused_softmax_ce(h, w, b, labels.float(), 32)
    with pytest.raises(ValueError, match="b must be"):
        fused_softmax_ce(h, w, b[:-1], labels, 32)
    with pytest.raises(ValueError, match="different devices"):
        fused_softmax_ce(h, w, b.to("meta"), labels, 32)


def _bwd_logits_f64(h, w, b, labels, lse, ct, precision):
    """B2's function with the logits' products summed in float64 (then
    rounded to fp32): the same function as the twin, another order of sums."""
    def split(x):
        hi = x.to(torch.bfloat16).to(torch.float32)
        return hi, (x - hi).to(torch.bfloat16).to(torch.float32)

    def dot(a, c):
        (ah, al), (ch, cl) = split(a), split(c)
        out = ah.double() @ ch.double()
        if precision == "high":
            out += ah.double() @ cl.double() + al.double() @ ch.double()
        return out.float()

    logits = dot(h, w) + b
    onehot = torch.nn.functional.one_hot(labels.long(), w.shape[1]).float()
    dl = (torch.exp(logits - lse[:, None]) - onehot) * ct[:, None]
    return dot(h.T.contiguous(), dl), dl.sum(dim=0)


def test_default_off_label_dw_is_ill_conditioned():
    """In "default" B2 rounds dl to bf16 before its products. Where two
    correct orders of the logits' fp32 sums put an entry of dl on two sides
    of a bf16 rounding boundary, it moves by one bf16 step, and the dW
    columns that no row labels (sums of a few large terms) show that far
    above 1e-5 of their largest entry, though below one bf16 step (2^-8).
    In "high" the lo part takes up the step. This is why the card's gates
    hold "default"'s off-label dW to 2^-8 at the train point."""
    B, F, A = 128, 64, 20000
    g = torch.Generator().manual_seed(A)
    h = torch.randn(B, F, generator=g)
    w = torch.randn(F, A, generator=g) / F**0.5
    b = torch.randn(A, generator=g) * 0.1
    labels = torch.randint(0, A, (B,), generator=g)
    ct = torch.rand(B, generator=g) / B
    off = torch.ones(A, dtype=torch.bool)
    off[labels] = False
    err = {}
    for precision in ("high", "default"):
        lse, _ = fused_ce_fwd_plain(h, w, b, labels, A, precision)
        _, dw, db = fused_ce_bwd_plain(h, w, b, labels, lse, ct, A, precision)
        dw64, db64 = _bwd_logits_f64(h, w, b, labels, lse, ct, precision)
        for name, got, want in (("dw", dw64, dw), ("db", db64, db), ("dw off", dw64[:, off], dw[:, off])):
            err[precision, name] = ((got - want).abs().max() / want.abs().max()).item()
    assert err["high", "dw"] < 1e-5 and err["high", "dw off"] < 1e-5, err
    assert err["default", "dw"] < 1e-5 and err["default", "db"] < 1e-5, err
    assert 1e-5 < err["default", "dw off"] < 2.0**-8, err
