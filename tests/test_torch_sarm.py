"""The port's sarm train step and its five-head target max against the
reference package.

Both sides start from the same params (``numpy_init_params``) and take the
same numpy batches: the reference's ``make_train_step`` (JAX on the CPU;
its fused path runs the Pallas kernels in interpret mode: B3/B4 for the
GRU, B1/B2 for the CE on head 0; its target is ``blockwise_multihead_max``,
a ``lax.scan`` of plain products) and the port's on ``device="cpu"``, where
the kernels' twins run.

Tolerances, fp32 with sums taken in other orders (as
tests/test_torch_double_q.py):
- the supervised and Q losses of each step, atol 1e-5;
- the first step's gradients, atol 1e-6 + rtol 1e-4, read back from the
  reference's first moment, g = (mu_1 - b1 mu_0) / (1 - b1);
- Adam's moments after 3 steps, atol 1e-8 + rtol 1e-4, and equal counts;
- the params after 3 steps, atol 1e-5, over the entries some step moved
  whose gradient at every step is 0 or above 1e-6 in size (at least a
  quarter of the moved entries).
"high" is the bf16x3 split in the port and, in the reference's target
max, ``Precision.HIGH``, which XLA on the CPU computes in fp32: they differ
by the split's rounding, at most 3 u^2 of each product |h_f w_fa| (u =
2^-8, bf16's unit roundoff); the steps stay inside the tolerances above.
"default" is one bf16 pass in the port and fp32 in the reference's CE and
target max on the CPU, so there the two differ by bf16 rounding, at most
(2 u + u^2) of each product. The target max is held to those bounds plus
1e-5; the "default" step to losses within 2e-3 and its gradients,
moments and params as tests/test_fused_ce.py holds its "default" path
(atol 2e-3, rtol 5e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import as_jax_tree, jax_leaves, model_configs, torch_leaves

from ikea_recommender_tpu.ops import fused_topk as jax_fused_topk
from ikea_recommender_tpu.train import state as jax_state
from ikea_recommender_tpu.train import steps as jax_steps
from ikea_recommender_tpu_torch.convert import (
    numpy_init_params,
    opt_state_from_numpy,
    params_from_numpy,
)
from ikea_recommender_tpu_torch.ops.fused_topk import blockwise_multihead_max
from ikea_recommender_tpu_torch.train.state import make_train_state
from ikea_recommender_tpu_torch.train.steps import (
    RLStepConfig,
    make_train_step,
    sarm_loss_and_grads,
)

LR, B1 = 0.01, 0.9
A, B, T, E = 257, 16, 6, 8  # a ragged catalog: the kernels' tail masks run
U = 2.0**-8  # bf16's unit roundoff


def _batches(n, seed):
    """Numpy batches; states include the pad id A, some rows are padding and
    some episodes end."""
    rs = np.random.RandomState(seed)
    return [{
        "state": rs.randint(0, A + 1, (B, T)).astype(np.int32),
        "action": rs.randint(0, A, (B,)).astype(np.int32),
        "reward": rs.rand(B).astype(np.float32),
        "next_state": rs.randint(0, A + 1, (B, T)).astype(np.int32),
        "true_len": rs.randint(1, T + 1, (B,)).astype(np.int32),
        "true_next_len": rs.randint(1, T + 1, (B,)).astype(np.int32),
        "is_end": rs.rand(B) < 0.3,
        "valid": rs.rand(B) < 0.9,
    } for _ in range(n)]


def _jax_run(jmc, rl, np_params, batches, jstate=None):
    opt = jax_state.make_optimizer(LR)
    step = jax_steps.make_train_step(jmc, opt, jax_steps.RLStepConfig(**rl), donate=False)
    if jstate is None:
        params = as_jax_tree(np_params)
        jstate = jax_state.TrainState(params=params, opt_state=opt.init(params),
                                      step=jnp.zeros((), jnp.int32), rng=jax.random.key(0))
    states, losses = [jstate], []
    for b in batches:
        jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        states.append(jstate)
        losses.append((float(m["sup_loss"]), float(m["q_loss"])))
    return states, losses


def _port_run(mc, rl, np_params, batches):
    state, opt = make_train_state(params_from_numpy(np_params, "cpu"), mc, LR, device="cpu")
    step = make_train_step(mc, opt, RLStepConfig(**rl), device="cpu")
    first = {k: torch.as_tensor(v) for k, v in batches[0].items()}
    _, grads0 = sarm_loss_and_grads(state.params, first, mc, RLStepConfig(**rl))
    losses = []
    for b in batches:
        state, m = step(state, b)
        assert set(m) == {"sup_loss", "q_loss"}
        losses.append((float(m["sup_loss"]), float(m["q_loss"])))
    return state, losses, grads0


def _compare(jout, pout, tol):
    (states, j_losses), (state, losses, grads0) = jout, pout
    np.testing.assert_allclose(losses, j_losses, atol=tol["loss"], rtol=0)
    mus = [jax_leaves(s.opt_state[0].mu) for s in states]
    g = [[(b - B1 * a) / (1 - B1) for a, b in zip(mus[k], mus[k + 1])]
         for k in range(len(states) - 1)]
    for got, want in zip(torch_leaves(grads0), g[0]):
        np.testing.assert_allclose(got, want, atol=tol["grad"], rtol=tol["rtol"])
    jopt = states[-1].opt_state[0]
    for got, want in zip(torch_leaves(state.opt_state.mu), jax_leaves(jopt.mu)):
        np.testing.assert_allclose(got, want, atol=tol["moment"], rtol=tol["rtol"])
    for got, want in zip(torch_leaves(state.opt_state.nu), jax_leaves(jopt.nu)):
        np.testing.assert_allclose(got, want, atol=tol["moment"], rtol=tol["rtol"])
    assert int(state.opt_state.count) == int(jopt.count) == len(losses) == state.step
    compared = moved = 0
    for k, (got, want) in enumerate(zip(torch_leaves(state.params),
                                        jax_leaves(states[-1].params))):
        gk = np.stack([step[k] for step in g])
        mk = (gk != 0).any(axis=0)
        sure = mk & ((gk == 0) | (np.abs(gk) > 1e-6)).all(axis=0)
        np.testing.assert_allclose(got[sure], want[sure], atol=tol["param"], rtol=0)
        compared, moved = compared + sure.sum(), moved + mk.sum()
    assert compared >= moved / 4, f"only {compared} of {moved} moved entries compared"


TIGHT = dict(loss=1e-5, grad=1e-6, rtol=1e-4, moment=1e-8, param=1e-5)
# "default": bf16 rounding on the port's side only (see the module docstring)
BF16 = dict(loss=2e-3, grad=2e-3, rtol=5e-2, moment=2e-3, param=2e-3)

CASES = {  # (train config, RL config, tolerances)
    "fused-high": (dict(), {}, TIGHT),
    "fused-highest": (dict(head_precision="highest"), {}, TIGHT),
    "fused-default": (dict(head_precision="default"), {}, BF16),
    "dense": (dict(fused_ce=False), {}, TIGHT),
    "gamma-0.5": (dict(), dict(sarm_gamma=0.5), TIGHT),
    "dense-gamma-0.5": (dict(fused_ce=False), dict(sarm_gamma=0.5), TIGHT),
}


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_reference(case):
    train_kw, rl, tol = CASES[case]
    mc, jmc = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T,
                            model="sarm", **train_kw)
    assert mc.fused_ce == jmc.fused_ce == train_kw.get("fused_ce", True)
    assert mc.num_q_heads == 5
    np_params = numpy_init_params(mc, seed=1)
    batches = _batches(3, seed=3)
    _compare(_jax_run(jmc, rl, np_params, batches), _port_run(mc, rl, np_params, batches), tol)


def test_reference_state_continues_in_the_port():
    """Two reference sarm steps, then its params and Adam state carried into
    the port: the next step matches the reference's."""
    mc, jmc = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T,
                            model="sarm")
    batches = _batches(3, seed=5)
    states, j_losses = _jax_run(jmc, {}, numpy_init_params(mc, seed=6), batches)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    state, opt = make_train_state(params_from_numpy(to_np(states[2].params), "cpu"), mc, LR,
                                  device="cpu")
    state.opt_state = opt_state_from_numpy(to_np(states[2].opt_state[0]), "cpu")
    state, m = make_train_step(mc, opt, device="cpu")(state, batches[2])
    np.testing.assert_allclose((float(m["sup_loss"]), float(m["q_loss"])), j_losses[2],
                               atol=1e-5)
    for got, want in zip(torch_leaves(state.params), jax_leaves(states[3].params)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for got, want in zip(torch_leaves(state.opt_state.nu), jax_leaves(states[3].opt_state[0].nu)):
        np.testing.assert_allclose(got, want, atol=1e-8, rtol=1e-4)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_episode_ends_zero_the_targets(fused):
    """With every row at an episode end the targets vanish, so gamma no
    longer matters, and the Q loss is the masked mean over rows and heads of
    (r - Q(s, a))^2."""
    mc, _ = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T, model="sarm",
                          fused_ce=fused)
    params = params_from_numpy(numpy_init_params(mc, seed=2), "cpu")
    b = {k: torch.as_tensor(v) for k, v in _batches(1, seed=4)[0].items()}
    b["is_end"] = torch.ones(B, dtype=torch.bool)
    got = [sarm_loss_and_grads(params, b, mc, RLStepConfig(sarm_gamma=g))[0]["q_loss"]
           for g in (0.99, 0.0)]
    assert torch.equal(got[0], got[1])
    from ikea_recommender_tpu_torch.models.families import apply_model

    with torch.no_grad():
        q = torch.stack(apply_model(params, mc, b["state"], b["true_len"]), dim=1)
    q = q[torch.arange(B), :, b["action"].long()]  # (B, 5)
    per_row = ((b["reward"][:, None] - q) ** 2).mean(dim=1)
    want = per_row[b["valid"]].mean()
    torch.testing.assert_close(got[0], want, atol=1e-6, rtol=1e-5)


# -- the five-head target max -------------------------------------------------


def _heads(K, F, A_pad, seed):
    rs = np.random.RandomState(seed)
    h = rs.randn(9, F).astype(np.float32)
    w = (rs.randn(K, F, A_pad) * 0.3).astype(np.float32)
    b = (rs.randn(K, A_pad) * 0.1).astype(np.float32)
    return h, w, b


MAX_CASES = {  # (K, F, A_pad, action_dim, block_cols)
    "one-block": (5, 8, 257, 257, 4096),
    "ragged-last-block": (5, 8, 300, 300, 128),  # blocks of 128, 128, 44
    "padded-catalog": (5, 8, 384, 300, 128),  # the third block is all masked
    "masked-inside-block": (5, 16, 384, 250, 100),
    "k1": (1, 8, 513, 513, 256),
    "k1-padded": (1, 8, 520, 513, 64),
}


@pytest.mark.parametrize("precision", [None, "highest", "high", "default"])
@pytest.mark.parametrize("case", list(MAX_CASES))
def test_multihead_max_matches_reference(case, precision):
    K, F, A_pad, action_dim, blk = MAX_CASES[case]
    h, w, b = _heads(K, F, A_pad, seed=A_pad + K)
    w[:, :, action_dim:] = 50.0  # padded columns that would win unmasked
    want = np.asarray(jax_fused_topk.blockwise_multihead_max(
        *(jnp.asarray(a) for a in (h, w, b)), action_dim, block_cols=blk, precision=precision))
    got = blockwise_multihead_max(*(torch.tensor(a) for a in (h, w, b)), action_dim,
                                  block_cols=blk, precision=precision)
    assert got.shape == (9, K) and got.dtype == torch.float32
    dense = np.einsum("bf,kfa->bka", h.astype(np.float64), w[:, :, :action_dim].astype(np.float64))
    dense = (dense + b[None, :, :action_dim]).max(axis=2)
    np.testing.assert_allclose(want, dense, atol=1e-5, rtol=0)  # the reference is fp32 here
    # each product's rounding in the port's split: none in fp32, the dropped
    # and rounded residuals in "high", each operand's bf16 rounding in "default"
    rel = {"high": 3 * U * U, "default": 2 * U + U * U}.get(precision, 0.0)
    scale = np.einsum("bf,kfa->bka", np.abs(h), np.abs(w[:, :, :action_dim])).max(axis=2)
    err = np.abs(got.numpy() - want)
    assert (err <= scale * rel + 1e-5).all(), (err.max(), (scale * rel).max())


def test_multihead_max_takes_no_gradient():
    h, w, b = (torch.tensor(a, requires_grad=True) for a in _heads(5, 8, 100, seed=0))
    out = blockwise_multihead_max(h, w, b, 90, block_cols=32)
    assert not out.requires_grad
