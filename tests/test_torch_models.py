"""The port's ``apply_model`` against the reference package, all families.

Both packages build their config from the same TrainConfig fields and read
the same numpy params (``numpy_init_params``); the reference runs JAX on
the CPU, the port ``device="cpu"`` (plain twins). ``align > 1`` pads vocab
rows and head columns, so the -1e9 pad-logit mask is exercised.
Tolerance: atol 1e-5 (fp32, summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import ATOL, as_jax_tree

from ikea_recommender_tpu.core import config as jax_config
from ikea_recommender_tpu.models import families as jax_families
from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
from ikea_recommender_tpu_torch.core import config
from ikea_recommender_tpu_torch.models import families
from ikea_recommender_tpu_torch.ops.fused_topk import eval_head

A, B, T = 37, 10, 6


def _configs(align=1, **train_kw):
    kw = dict(embedding_size=8, hidden_state_size=8, state_size=T, **train_kw)
    mc = families.model_config_from_train(
        config.TrainConfig(**kw), config.DataConfig(num_items=A), align
    )
    jmc = jax_families.model_config_from_train(
        jax_config.TrainConfig(**kw), jax_config.DataConfig(num_items=A), align
    )
    return mc, jmc


def _batch(seed):
    rs = np.random.RandomState(seed)
    states = rs.randint(0, A + 1, (B, T)).astype(np.int32)
    lens = rs.randint(1, T + 1, (B,)).astype(np.int32)
    return states, lens


CASES = [
    dict(model="gru4rec"),
    dict(model="bidir_gru4rec"),
    dict(model="sqn"),
    dict(model="smorl"),
    dict(model="sarm"),
    dict(model="gru4rec", gru_layers=2, compat_first_layer_head=True,
         train_padding_embed=False),
    dict(model="gru4rec", gru_layers=2, use_packed_seq=False),
    dict(model="bidir_gru4rec", gru_layers=2, compat_first_layer_head=True,
         use_packed_seq=False),
    dict(model="smorl", num_q_heads=4, train_padding_embed=False),
]


@pytest.mark.parametrize("align", [1, 4])
@pytest.mark.parametrize("train_kw", CASES, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_apply_model_matches_reference(train_kw, align):
    mc, jmc = _configs(align, **train_kw)
    np_params = numpy_init_params(mc, seed=len(train_kw) + align)
    states, lens = _batch(align)

    want = jax_families.apply_model(
        as_jax_tree(np_params), jmc, jnp.asarray(states), jnp.asarray(lens)
    )
    got = families.apply_model(
        params_from_numpy(np_params, "cpu"), mc, torch.tensor(states), torch.tensor(lens)
    )
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    if align > 1:
        assert mc.padded_action_dim > A
        assert (got[0][..., A:] == -1e9).all()


def test_numpy_init_matches_reference_shapes():
    import jax

    for model in families.FAMILIES:
        mc, jmc = _configs(4, model=model, gru_layers=2)
        ours = numpy_init_params(mc, 0)
        theirs = jax_families.init_model(jax.random.key(0), jmc)
        shapes = jax.tree.map(lambda a: a.shape, theirs)
        assert jax.tree.map(lambda a: a.shape, ours) == shapes


@pytest.mark.parametrize("model,head,key", [("sqn", "q_head", "kernel_am"),
                                            ("sarm", "q_heads", "kernel0")])
def test_lazy_action_major_heads_raise(model, head, key):
    """The lazy optimizers' action-major layout (``kernel_am``, and sarm's
    ``kernel0``) gives the canonical layout's outputs through
    ``canonicalize_qheads``, the dense forward and ``eval_head``, and the
    reference's canonicalization gives the same tree."""
    from ikea_recommender_tpu.train import state as jax_state
    from ikea_recommender_tpu_torch.train.state import lazy_qhead_params

    mc, jmc = _configs(model=model)
    np_params = numpy_init_params(mc, 0)
    params = params_from_numpy(np_params, "cpu")
    lazy = lazy_qhead_params(params, model)
    assert key in lazy[head]
    canon = families.canonicalize_qheads(lazy, mc)
    want = jax_families.canonicalize_qheads(
        jax_state.lazy_qhead_params(as_jax_tree(np_params), model), jmc)
    for name in ("kernel", "bias"):
        assert torch.equal(canon[head][name], params[head][name])
        np.testing.assert_array_equal(canon[head][name].numpy(), np.asarray(want[head][name]))
    states, lens = _batch(0)
    got = families.apply_model(lazy, mc, torch.tensor(states), torch.tensor(lens))
    ref = families.apply_model(params, mc, torch.tensor(states), torch.tensor(lens))
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    for k, b in zip(eval_head(lazy, mc, head_idx=1), eval_head(params, mc, head_idx=1)):
        assert torch.equal(k, b)


