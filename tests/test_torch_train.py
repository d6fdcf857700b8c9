"""The port's supervised CE train step against the reference package.

Both sides start from the same params (``numpy_init_params``) and take the
same numpy batches: the reference's ``make_train_step`` (JAX on the CPU,
its Pallas kernels in interpret mode: ``scan_impl="pallas"`` runs B3/B4 and
``fused_ce`` runs B1/B2) and the port's on ``device="cpu"``, where the
kernels' plain twins run.

Tolerances, all fp32 with sums taken in other orders:
- the loss, atol 1e-5 (losses near log(A) ~ 5.5);
- the first step's gradients, atol 1e-6 + rtol 1e-4; and the head's
  columns that no row of the first batch labels, where only the softmax
  term lands (~1e-7 at the bench width, under that atol), within 1e-4 of
  their own largest entry;
- Adam's moments after 3 steps, atol 1e-8 + rtol 1e-4 (bf16 moments:
  rtol 2**-7, one bf16 rounding step);
- the params after 3 steps, atol 1e-5. Adam turns a gradient entry near
  zero into a step of about +-lr whatever its size, so a difference of
  summation order there moves a param by up to lr. The params are compared
  over the entries some step moved (a nonzero reference gradient), where
  each step's reference gradient is 0 or above 1e-6 in magnitude; at least
  a quarter of the moved entries, and of the head kernel's, must qualify.
The reference's gradients are read back from its first moment:
g_k = (mu_k - b1 mu_{k-1}) / (1 - b1).
"""

import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import as_jax_tree, one_rank_mesh  # noqa: F401
from _torch_parity import jax_leaves as _leaves
from _torch_parity import model_configs as _configs
from _torch_parity import torch_leaves as _torch_leaves

from ikea_recommender_tpu.train import state as jax_state
from ikea_recommender_tpu.train import steps as jax_steps
from ikea_recommender_tpu_torch.convert import (
    numpy_init_params,
    opt_state_from_numpy,
    params_from_numpy,
)
from ikea_recommender_tpu_torch.models import families
from ikea_recommender_tpu_torch.models.backbone import (
    BackboneConfig,
    apply_backbone,
    apply_dropout,
    draw_keep_mask,
)
from ikea_recommender_tpu_torch.train.state import make_train_state
from ikea_recommender_tpu_torch.train.steps import loss_and_grads, make_train_step

B1 = 0.9
LR = 0.01


def _batches(n, B, A, T, seed):
    """Numpy batches; states include the pad id A, and some rows are padding."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        out.append({
            "state": rs.randint(0, A + 1, (B, T)).astype(np.int32),
            "action": rs.randint(0, A, (B,)).astype(np.int32),
            "true_len": rs.randint(1, T + 1, (B,)).astype(np.int32),
            "valid": rs.rand(B) < 0.9,
        })
    return out


def _jax_run(jmc, np_params, batches, mv_dtype=None, jstate=None):
    opt = jax_state.make_optimizer(LR, mv_dtype)
    step = jax_steps.make_train_step(jmc, opt, jax_steps.RLStepConfig(), donate=False)
    if jstate is None:
        params = as_jax_tree(np_params)
        jstate = jax_state.TrainState(
            params=params, opt_state=opt.init(params),
            step=jnp.zeros((), jnp.int32), rng=jax.random.key(0),
        )
    losses, mus = [], [jstate.opt_state[0].mu]
    for b in batches:
        jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["sup_loss"]))
        mus.append(jstate.opt_state[0].mu)
    return jstate, losses, mus


def _port_batch(b, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def _port_run(mc, np_params, batches, mv_dtype=None):
    params = params_from_numpy(np_params, "cpu")
    state, opt = make_train_state(params, mc, LR, mv_dtype, device="cpu")
    step = make_train_step(mc, opt, device="cpu")
    _, grads0 = loss_and_grads(state.params, _port_batch(batches[0]), mc)
    losses = []
    for b in batches:
        state, m = step(state, _port_batch(b))
        assert set(m) == {"sup_loss", "q_loss"} and float(m["q_loss"]) == 0.0
        losses.append(float(m["sup_loss"]))
    return state, losses, grads0


def _compare_runs(jout, pout, labels0, mv_dtype=None):
    """``labels0``: the first batch's actions."""
    (jstate, j_losses, mus), (state, losses, grads0) = jout, pout
    np.testing.assert_allclose(losses, j_losses, atol=1e-5, rtol=0)

    # the reference's per-step gradients, from its first moment
    mu = [_leaves(m) for m in mus]
    g = [[(m1 - B1 * m0) / (1 - B1) for m0, m1 in zip(mu[k], mu[k + 1])]
         for k in range(len(mu) - 1)]
    if mv_dtype is None:  # bf16 moments would blur the first step's gradient
        for got, want in zip(_torch_leaves(grads0), g[0]):
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4)
        off = np.ones(g[0][-1].shape[1], bool)  # the head kernel is the last leaf
        off[labels0] = False
        got, want = _torch_leaves(grads0)[-1][:, off], g[0][-1][:, off]
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    rtol = 2.0**-7 if mv_dtype else 1e-4
    opt = jstate.opt_state[0]
    for got, want in zip(_torch_leaves(state.opt_state.mu), _leaves(opt.mu)):
        np.testing.assert_allclose(got, want, atol=1e-8, rtol=rtol)
    for got, want in zip(_torch_leaves(state.opt_state.nu), _leaves(opt.nu)):
        np.testing.assert_allclose(got, want, atol=1e-8, rtol=rtol)
    assert int(state.opt_state.count) == int(opt.count) == len(losses)

    compared = moved = 0
    for k, (got, want) in enumerate(zip(_torch_leaves(state.params), _leaves(jstate.params))):
        gk = np.stack([step[k] for step in g])
        mk = (gk != 0).any(axis=0)
        sure = mk & ((gk == 0) | (np.abs(gk) > 1e-6)).all(axis=0)
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-5, rtol=0)
        compared, moved = compared + sure.sum(), moved + mk.sum()
    # at the bench width two thirds of the head's gradients are below 1e-6;
    # ``sure`` and ``mk`` are the last leaf's, the head kernel's
    assert compared >= moved / 4, f"only {compared} of {moved} moved entries compared"
    assert sure.sum() >= mk.sum() / 4, f"only {sure.sum()} of {mk.sum()} head entries compared"
    return state


A_SMALL, B, T = 257, 16, 6  # a ragged catalog: the kernels' tail masks run

CASES = {
    "gru4rec-fused": dict(model="gru4rec", fused_ce=True),
    "gru4rec-unfused": dict(model="gru4rec", fused_ce=False),
    "gru4rec-fused-align8": dict(model="gru4rec", fused_ce=True, align=8),
    "gru4rec-frozen-pad": dict(model="gru4rec", fused_ce=True, train_padding_embed=False),
    "bidir-2layers": dict(model="bidir_gru4rec", fused_ce=True, gru_layers=2, dropout=0.0),
    # hidden 128: the head input is F = 2 H = 256, the BidirGRU-128 width
    "bidir-h128": dict(model="bidir_gru4rec", fused_ce=True, hidden_state_size=128, dropout=0.0),
    # hidden 136: F = 272 > 256, B1 and B2 on their wide routes on the card
    "bidir-wide": dict(model="bidir_gru4rec", fused_ce=True, hidden_state_size=136, dropout=0.0),
    "gru4rec-bf16-moments": dict(model="gru4rec", fused_ce=True, mv_dtype="bfloat16"),
    "gru4rec-highest": dict(model="gru4rec", fused_ce=True, head_precision="highest"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_reference(case):
    kw = {"embedding_size": 8, "hidden_state_size": 8, **CASES[case]}
    align, mv_dtype = kw.pop("align", 1), kw.pop("mv_dtype", None)
    mc, jmc = _configs(A_SMALL, align, state_size=T, **kw)
    assert mc.fused_ce == jmc.fused_ce == kw["fused_ce"]
    np_params = numpy_init_params(mc, seed=1)
    batches = _batches(3, B, A_SMALL, T, seed=2)
    jout = _jax_run(jmc, np_params, batches, mv_dtype)
    pout = _port_run(mc, np_params, batches, mv_dtype)
    state = _compare_runs(jout, pout, batches[0]["action"], mv_dtype)
    if not mc.backbone.train_pad_embed:
        pad = mc.backbone.padding_idx
        assert (state.params["backbone"]["embedding"][pad] == 0).all()
        assert (state.opt_state.mu["backbone"]["embedding"][pad] == 0).all()


def test_one_step_at_the_bench_width():
    """One step at the operating point of bench.py (catalog 70852, E=H=64,
    T=10, B=256, fused CE in "high"). The reference runs its plain path
    (dense logits, lax.scan) here: its interpret-mode kernels would take
    minutes at this width, and tests/test_fused_ce_steps.py holds that path
    equal to the fused one."""
    A, Bb, Tb = 70852, 256, 10
    mc, _ = _configs(A, embedding_size=64, hidden_state_size=64, state_size=Tb,
                     fused_ce=True)
    _, jmc = _configs(A, embedding_size=64, hidden_state_size=64, state_size=Tb,
                      fused_ce=False)
    jmc = replace(jmc, backbone=replace(jmc.backbone, scan_impl="xla"))
    assert mc.fused_ce and mc.head_precision == "high"
    np_params = numpy_init_params(mc, seed=0)
    batches = _batches(1, Bb, A, Tb, seed=3)
    t0 = time.perf_counter()
    _compare_runs(_jax_run(jmc, np_params, batches), _port_run(mc, np_params, batches),
                  batches[0]["action"])
    print(f"bench-width step, both sides: {time.perf_counter() - t0:.1f} s")


def test_reference_state_continues_in_the_port():
    """Two reference steps, then its params and optax state carried into the
    port (``params_from_numpy``, ``opt_state_from_numpy``): the next step
    matches the reference's next step."""
    mc, jmc = _configs(A_SMALL, embedding_size=8, hidden_state_size=8, state_size=T,
                       model="gru4rec", fused_ce=True)
    np_params = numpy_init_params(mc, seed=4)
    batches = _batches(3, B, A_SMALL, T, seed=5)
    jstate, _, _ = _jax_run(jmc, np_params, batches[:2])
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    params = params_from_numpy(to_np(jstate.params), "cpu")
    state, opt = make_train_state(params, mc, LR, device="cpu")
    state.opt_state = opt_state_from_numpy(to_np(jstate.opt_state[0]), "cpu")
    jnext, j_losses, _ = _jax_run(jmc, None, batches[2:], jstate=jstate)
    state, m = make_train_step(mc, opt, device="cpu")(state, batches[2])
    np.testing.assert_allclose(float(m["sup_loss"]), j_losses[0], atol=1e-5)
    for got, want in zip(_torch_leaves(state.params), _leaves(jnext.params)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for got, want in zip(_torch_leaves(state.opt_state.nu), _leaves(jnext.opt_state[0].nu)):
        np.testing.assert_allclose(got, want, atol=1e-8, rtol=1e-4)


def test_bf16_moments_cross_as_bf16():
    opt = jax_state.make_optimizer(LR, "bfloat16")
    mc, _ = _configs(A_SMALL, embedding_size=8, hidden_state_size=8, model="gru4rec")
    params = as_jax_tree(numpy_init_params(mc, seed=0))
    st = jax.tree.map(np.asarray, opt.init(params)[0])
    st = st._replace(mu=jax.tree.map(lambda a: (a + 0.5).astype(a.dtype), st.mu))
    got = opt_state_from_numpy(st, "cpu")
    leaf = got.mu["sup_head"]["kernel"]
    assert leaf.dtype == torch.bfloat16 and (leaf == 0.5).all()
    assert int(got.count) == 0


def test_dropout_formula_and_rate():
    rs = np.random.RandomState(0)
    h = rs.randn(64, 16).astype(np.float32)
    mask = rs.rand(64, 16) < 0.7
    got = apply_dropout(torch.tensor(h), torch.tensor(mask), 0.7)
    np.testing.assert_allclose(got.numpy(), np.where(mask, h / 0.7, 0.0), rtol=1e-7)

    gen = torch.Generator().manual_seed(0)
    draws = draw_keep_mask((200, 500), 0.7, gen, "cpu")
    # 1e5 Bernoulli(0.7) draws: standard error 0.0014
    assert abs(draws.float().mean().item() - 0.7) < 0.01


def test_backbone_dropout_in_training_only():
    cfg = BackboneConfig(num_items=30, embedding_dim=8, hidden_dim=8, dropout=0.5)
    mc = families.ModelConfig("gru4rec", cfg, 30)
    params = params_from_numpy(numpy_init_params(mc, seed=0), "cpu")["backbone"]
    rs = np.random.RandomState(1)
    states = torch.tensor(rs.randint(0, 31, (32, 5)))
    lens = torch.tensor(rs.randint(1, 6, (32,)))
    plain = apply_backbone(params, cfg, states, lens)
    gen = torch.Generator().manual_seed(3)
    train = apply_backbone(params, cfg, states, lens, dropout_generator=gen, deterministic=False)
    kept = train != 0
    assert 0.3 < kept.float().mean().item() < 0.7
    torch.testing.assert_close(train[kept], plain[kept] / 0.5)
    again = apply_backbone(params, cfg, states, lens, deterministic=False,
                           dropout_generator=torch.Generator().manual_seed(3))
    assert torch.equal(train, again)


def test_train_state_holds_params_to_the_config():
    mc, _ = _configs(A_SMALL, embedding_size=8, hidden_state_size=8, model="gru4rec")
    wider, _ = _configs(A_SMALL + 1, embedding_size=8, hidden_state_size=8, model="gru4rec")
    params = params_from_numpy(numpy_init_params(wider, seed=0), "cpu")
    with pytest.raises(ValueError, match="model config"):
        make_train_state(params, mc, LR, device="cpu")


def test_lazy_and_mesh_name_their_slice(one_rank_mesh):
    """A lazy Q-head Adam on a family without Q heads raises as the
    reference's does. A mesh is taken: on a (1, 1) gloo mesh in this
    process the step is the plain step, bit for bit, and so is the lazy
    embedding step; sarm's lazy step on a mesh raises, as the reference's
    does. tests/test_torch_mesh.py and tests/test_torch_trainer_mesh*.py
    hold the steps and the trainer on (1, 2) and (2, 2) meshes to the
    reference's."""
    from ikea_recommender_tpu_torch.train.state import make_lazy_train_state

    mc, _ = _configs(A_SMALL, embedding_size=8, hidden_state_size=8, model="gru4rec",
                     fused_ce=True)
    np_params = numpy_init_params(mc, seed=0)
    _, opt = make_train_state(params_from_numpy(np_params, "cpu"), mc, LR, device="cpu")
    with pytest.raises(ValueError, match="needs a Q family"):
        make_train_step(mc, opt, lazy_qhead_lr=0.01, device="cpu")
    mesh = one_rank_mesh
    sarm, _ = _configs(A_SMALL, embedding_size=8, hidden_state_size=8, model="sarm",
                       fused_ce=True)
    with pytest.raises(ValueError, match=r"mesh \+ lazy is not supported for sarm"):
        make_train_step(sarm, opt, lazy_embedding_lr=0.01, mesh=mesh, device="cpu")
    batch = _batches(1, B, A_SMALL, T, seed=6)[0]
    for make, lazy in ((make_train_state, {}), (make_lazy_train_state,
                                                {"lazy_embedding_lr": LR})):
        runs = []
        for kw in ({}, {"mesh": mesh, "data_axis": "data"}):
            state, opt = make(params_from_numpy(np_params, "cpu"), mc, LR, device="cpu")
            state, m = make_train_step(mc, opt, device="cpu", **lazy, **kw)(state, batch)
            runs.append((float(m["sup_loss"]), _torch_leaves(state.params)))
        assert runs[0][0] == runs[1][0]
        for a, w in zip(runs[0][1], runs[1][1]):
            np.testing.assert_array_equal(a, w)
