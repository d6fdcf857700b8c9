"""The port's GRU recurrence (B3 forward, B4 backward) against the
reference package.

The same numpy inputs go through the reference's ``_gru_scan`` (lax.scan)
and ``gru_scan_pallas`` (interpret mode on the CPU) and through the port's
``gru_scan``, whose CPU path is the plain twins; gradients through
``jax.grad``. Tolerance: atol 1e-5 (fp32, summation order only). The
kernels themselves are held against the twins on the card by
``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import ATOL, as_jax_tree, gru_inputs, to_torch

from ikea_recommender_tpu.models.backbone import BackboneConfig as JaxBackboneConfig
from ikea_recommender_tpu.models.backbone import apply_backbone as jax_apply_backbone
from ikea_recommender_tpu.models.gru import _gru_scan
from ikea_recommender_tpu.models.gru import gru_layer_apply as jax_gru_layer_apply
from ikea_recommender_tpu.ops.gru_pallas import gru_scan_pallas
from ikea_recommender_tpu_torch.models.backbone import BackboneConfig, apply_backbone
from ikea_recommender_tpu_torch.models.gru import gru_layer_apply
from ikea_recommender_tpu_torch.ops import gru_cuda
from ikea_recommender_tpu_torch.ops.gru_cuda import gru_scan, gru_scan_bwd_plain, gru_scan_plain


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize(
    "B,T,H,masked,reverse",
    [
        (16, 7, 8, True, False),
        (16, 7, 8, False, False),
        (16, 7, 8, True, True),
        (16, 7, 8, False, True),
        (16, 10, 64, True, False),
    ],
)
def test_scan_matches_reference(ref, B, T, H, masked, reverse):
    xw, wh, bh, mask = gru_inputs(B, T, H, seed=T + H, masked=masked)
    jargs = [jnp.asarray(a) for a in (xw, wh, bh)]
    jmask = None if mask is None else jnp.asarray(mask)
    if ref == "xla":
        y_ref, h_ref = _gru_scan(*jargs, jmask, reverse=reverse)
    else:
        y_ref, h_ref = gru_scan_pallas(*jargs, mask=jmask, reverse=reverse)
    y, h = gru_scan(*to_torch(xw, wh, bh, mask), reverse=reverse)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [True, False])
def test_layer_apply_matches_reference(masked):
    rs = np.random.RandomState(3)
    B, T, E, H = 16, 7, 12, 8
    b = 1.0 / np.sqrt(H)
    params = {
        "wi": rs.uniform(-b, b, (E, 3 * H)),
        "wh": rs.uniform(-b, b, (H, 3 * H)),
        "bi": rs.uniform(-b, b, (3 * H,)),
        "bh": rs.uniform(-b, b, (3 * H,)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rs.randn(B, T, E).astype(np.float32)
    lens = rs.randint(1, T + 1, size=(B,)).astype(np.int32) if masked else None

    y_ref, h_ref = jax_gru_layer_apply(
        as_jax_tree(params), jnp.asarray(x),
        None if lens is None else jnp.asarray(lens), scan_impl="xla",
    )
    y, h = gru_layer_apply(
        {k: torch.tensor(v) for k, v in params.items()}, torch.tensor(x),
        None if lens is None else torch.tensor(lens),
    )
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("head_layer", ["first", "last"])
def test_two_layer_bidirectional_backbone(head_layer):
    from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
    from ikea_recommender_tpu_torch.models.families import ModelConfig

    A, B, T = 30, 12, 6
    kw = dict(num_items=A, embedding_dim=8, hidden_dim=8, gru_layers=2,
              bidirectional=True, head_layer=head_layer)
    cfg = BackboneConfig(**kw)
    np_params = numpy_init_params(ModelConfig("bidir_gru4rec", cfg, A), seed=4)
    rs = np.random.RandomState(4)
    states = rs.randint(0, A + 1, (B, T)).astype(np.int32)
    lens = rs.randint(1, T + 1, (B,)).astype(np.int32)

    want = jax_apply_backbone(
        as_jax_tree(np_params["backbone"]), JaxBackboneConfig(**kw),
        jnp.asarray(states), jnp.asarray(lens),
    )
    got = apply_backbone(
        params_from_numpy(np_params, "cpu")["backbone"], cfg,
        torch.tensor(states), torch.tensor(lens),
    )
    assert got.shape == (B, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_twin():
    xw, wh, bh, mask = to_torch(*gru_inputs(4, 5, 8, seed=0))
    before = gru_cuda.LAUNCHES
    y, h = gru_scan(xw, wh, bh, mask)
    y_p, h_p = gru_scan_plain(xw, wh, bh, mask)
    assert gru_cuda.LAUNCHES == before
    assert torch.equal(y, y_p) and torch.equal(h, h_p)


def test_wrapper_rejects_bad_inputs():
    xw, wh, bh, mask = to_torch(*gru_inputs(4, 5, 8, seed=0))
    with pytest.raises(TypeError):
        gru_scan(xw.double(), wh, bh, mask)
    with pytest.raises(ValueError, match="contiguous"):
        gru_scan(xw.transpose(0, 1), wh, bh, mask)
    with pytest.raises(ValueError, match="wh must be"):
        gru_scan(xw, wh[:, :-3].contiguous(), bh, mask)
    with pytest.raises(ValueError, match="mask must be"):
        gru_scan(xw, wh, bh, mask[:, :-1].contiguous())
    with pytest.raises(ValueError, match="different devices"):
        gru_scan(xw, wh, bh, mask.to("meta"))


# --- B4, the backward -------------------------------------------------------
# The port's autograd gradient (which runs gru_scan_bwd_plain on the CPU) and
# gru_scan_bwd_plain itself, against jax.grad through gru_scan_pallas (its
# B4 kernel in interpret mode) of sum(y * gy) + sum(h_fin * g_hfin), and
# against torch autograd through gru_scan_plain. Tolerance atol 1e-5: fp32
# gradients of order 1 summed in other orders.

BWD_CASES = [  # (B, T, H, masked, reverse): gru_inputs covers lengths 1 and T
    (16, 7, 8, True, False),
    (16, 7, 8, False, False),
    (16, 7, 8, True, True),
    (16, 7, 8, False, True),
    (16, 10, 64, True, False),
]


def _cotangents(B, T, H, seed, zero_gy=False):
    rs = np.random.RandomState(seed)
    gy = np.zeros((B, T, H), np.float32) if zero_gy else rs.randn(B, T, H).astype(np.float32)
    return gy, rs.randn(B, H).astype(np.float32)


@pytest.mark.parametrize("zero_gy", [False, True], ids=["gy", "hfin-only"])
@pytest.mark.parametrize("B,T,H,masked,reverse", BWD_CASES)
def test_backward_matches_reference(B, T, H, masked, reverse, zero_gy):
    xw, wh, bh, mask = gru_inputs(B, T, H, seed=T + H, masked=masked)
    gy, ghf = _cotangents(B, T, H, seed=B + T, zero_gy=zero_gy)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(xw, wh, bh):
        y, h = gru_scan_pallas(xw, wh, bh, mask=jmask, reverse=reverse)
        return jnp.sum(y * gy) + jnp.sum(h * ghf)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (xw, wh, bh)))

    txw, twh, tbh = (torch.tensor(a, requires_grad=True) for a in (xw, wh, bh))
    tmask = None if mask is None else torch.tensor(mask)
    y, h = gru_scan(txw, twh, tbh, tmask, reverse=reverse)
    ((y * torch.tensor(gy)).sum() + (h * torch.tensor(ghf)).sum()).backward()
    for got, w in zip((txw.grad, twh.grad, tbh.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL, rtol=0)

    y, h = gru_scan_plain(*to_torch(xw, wh, bh, mask), reverse=reverse)
    plain = gru_scan_bwd_plain(*to_torch(xw, wh, bh, mask), y, *to_torch(gy, ghf), reverse)
    for got, w in zip(plain, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked,reverse", [(True, False), (False, True), (True, True)])
def test_backward_plain_matches_autograd_of_plain(masked, reverse):
    B, T, H = 12, 9, 16
    xw, wh, bh, mask = gru_inputs(B, T, H, seed=7, masked=masked)
    gy, ghf = _cotangents(B, T, H, seed=8)
    leaves = [torch.tensor(a, requires_grad=True) for a in (xw, wh, bh)]
    tmask = None if mask is None else torch.tensor(mask)
    y, h = gru_scan_plain(*leaves, tmask, reverse=reverse)
    ((y * torch.tensor(gy)).sum() + (h * torch.tensor(ghf)).sum()).backward()
    got = gru_scan_bwd_plain(*to_torch(xw, wh, bh), tmask, y.detach(), *to_torch(gy, ghf), reverse)
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, atol=ATOL, rtol=0)


def test_backward_through_two_layers_matches_reference():
    """Gradients through a 2-layer bidirectional backbone, where y (and so
    gy) of the first layer feeds the second, against jax.grad."""
    from ikea_recommender_tpu_torch.convert import (
        numpy_init_params,
        params_from_numpy,
        tree_leaves,
    )
    from ikea_recommender_tpu_torch.models.families import ModelConfig

    A, B, T = 30, 12, 6
    kw = dict(num_items=A, embedding_dim=8, hidden_dim=8, gru_layers=2, bidirectional=True)
    np_params = numpy_init_params(ModelConfig("bidir_gru4rec", BackboneConfig(**kw), A), seed=5)
    rs = np.random.RandomState(5)
    states = rs.randint(0, A + 1, (B, T)).astype(np.int32)
    lens = rs.randint(1, T + 1, (B,)).astype(np.int32)
    weights = rs.randn(B, 16).astype(np.float32)

    def jloss(p):
        h = jax_apply_backbone(p, JaxBackboneConfig(scan_impl="pallas", **kw),
                               jnp.asarray(states), jnp.asarray(lens))
        return jnp.sum(h * weights)

    want = jax.tree.leaves(jax.grad(jloss)(as_jax_tree(np_params["backbone"])))
    params = params_from_numpy(np_params, "cpu")["backbone"]
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    h = apply_backbone(params, BackboneConfig(**kw), torch.tensor(states), torch.tensor(lens))
    (h * torch.tensor(weights)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=ATOL, rtol=0)
