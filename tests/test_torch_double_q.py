"""The port's sqn and smorl double-Q train steps against the reference package.

Both sides start from the same pair of nets (``numpy_init_double_q``) and
take the same numpy batches: the reference's ``make_train_step`` (JAX on the
CPU; its fused paths run the Pallas kernels in interpret mode: B3/B4 for the
GRU, B1/B2 or the blockwise CE + top-k with B2 for the supervised head, B5 or
B6 for the target action) and the port's on ``device="cpu"``, where the
kernels' twins run. The reference draws each step's coin from
``bernoulli(fold_in(rng, step))``; the test replays those coins into the
port's step (``coin=``).

Tolerances, fp32 with sums taken in other orders (as tests/test_torch_train.py):
- the supervised and Q losses of each step, atol 1e-5;
- the first step's gradients of the main net, atol 1e-6 + rtol 1e-4; the
  reference's are read back from its first moment, g = (mu_k - b1 mu_{k-1}) /
  (1 - b1), over the steps where the net was the main one (or every step
  with one optimizer over the pair);
- Adam's moments after 3 steps, atol 1e-8 + rtol 1e-4, and equal counts;
- the params of both nets after 3 steps, atol 1e-5, over the entries some
  step moved whose gradient at every step is 0 or above 1e-6 in size (at
  least a quarter of the moved entries): Adam moves an entry with a
  gradient near zero by about +-lr whatever its size.
In the two-optimizer arm the net that a step does not train keeps its params
and moments bit for bit. In "high", smorl's blockwise CE forward is the
bf16x3 split in the port and ``Precision.HIGH`` in the reference, which XLA
on the CPU computes in fp32: the CE differs by the split's rounding (~1e-6
here), inside the loss tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import as_jax_tree, jax_leaves, model_configs, torch_leaves

from ikea_recommender_tpu.train import state as jax_state
from ikea_recommender_tpu.train import steps as jax_steps
from ikea_recommender_tpu_torch.convert import (
    double_q_from_numpy,
    numpy_init_double_q,
    params_from_numpy,
    tree_leaves,
)
from ikea_recommender_tpu_torch.train.state import make_double_q_state
from ikea_recommender_tpu_torch.train.steps import (
    RLStepConfig,
    double_q_loss_and_grads,
    make_train_step,
)

LR, B1 = 0.01, 0.9
A, B, T, E = 257, 16, 6, 8  # a ragged catalog: the kernels' tail masks run


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


def _smorl_inputs(seed, remap):
    """div_embedding (V_in, E), unpopular_mask (A,) and, with ``remap``, an
    output-to-input id table."""
    rs = np.random.RandomState(seed)
    aux = {"div_embedding": rs.randn(A + 1, E).astype(np.float32),
           "unpopular_mask": rs.rand(A) < 0.3}
    if remap:
        aux["out_to_in"] = rs.permutation(A + 1)[:A].astype(np.int32)
    return aux


def _adam(jstate, net, single):
    """The reference's Adam state of ``net``'s leaves: (count, mu, nu)."""
    if single:
        s = jstate.opt_state[0]
        return s.count, s.mu[net], s.nu[net]
    s = jstate.opt_state[net][0]
    return s.count, s.mu, s.nu


def _jax_run(jmc, rl, np_pair, batches, aux):
    opt = jax_state.make_optimizer(LR)
    step = jax_steps.make_train_step(
        jmc, opt, jax_steps.RLStepConfig(**rl), donate=False,
        **{k: jnp.asarray(v) for k, v in aux.items()},
    )
    params = tuple(as_jax_tree(p) for p in np_pair)
    single = rl.get("single_optimizer", False)
    opt_state = opt.init(params) if single else tuple(opt.init(p) for p in params)
    st = jax_state.DoubleQState(params=params, opt_state=opt_state,
                                step=jnp.zeros((), jnp.int32), rng=jax.random.key(0))
    states, coins, losses = [st], [], []
    for b in batches:
        coins.append(int(jax.random.bernoulli(jax.random.fold_in(st.rng, st.step))))
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        states.append(st)
        losses.append((float(m["sup_loss"]), float(m["q_loss"])))
    return states, coins, losses


def _snapshot(tree):
    return [t.clone() for t in tree_leaves(tree)]


def _port_run(mc, rl, np_pair, batches, aux, coins):
    pair = [params_from_numpy(p, "cpu") for p in np_pair]
    single = rl.get("single_optimizer", False)
    state, opt = make_double_q_state(pair, mc, LR, single_optimizer=single, device="cpu")
    step = make_train_step(mc, opt, RLStepConfig(**rl), device="cpu", **aux)
    first = {k: torch.as_tensor(v) for k, v in batches[0].items()}
    _, grads0 = double_q_loss_and_grads(state.params, first, mc, RLStepConfig(**rl),
                                        coins[0], step.aux)
    losses = []
    for b, coin in zip(batches, coins):
        other = 1 - coin
        if not single:
            kept = (state.params[other], state.opt_state[other].mu, state.opt_state[other].nu)
            before = [_snapshot(t) for t in kept]
        state, m = step(state, b, coin=coin)
        assert set(m) == {"sup_loss", "q_loss", "target_action"}
        assert m["target_action"].shape == (B,) and m["target_action"].dtype == torch.int64
        losses.append((float(m["sup_loss"]), float(m["q_loss"])))
        if not single:  # the net this step did not train is untouched
            for old, tree in zip(before, kept):
                assert all(torch.equal(a, c) for a, c in zip(old, tree_leaves(tree)))
    return state, losses, grads0


def _grad_history(states, coins, net, single):
    """The reference's per-step gradients of ``net``, from its first moment;
    zero at steps where the two-optimizer arm did not train it."""
    out = []
    for k, coin in enumerate(coins):
        if single or coin == net:
            m0 = jax_leaves(_adam(states[k], net, single)[1])
            m1 = jax_leaves(_adam(states[k + 1], net, single)[1])
            out.append([(b - B1 * a) / (1 - B1) for a, b in zip(m0, m1)])
        else:
            out.append([np.zeros_like(a) for a in jax_leaves(states[k].params[net])])
    return out


def _compare(jout, pout, single):
    (states, coins, j_losses), (state, losses, grads0) = jout, pout
    np.testing.assert_allclose(losses, j_losses, atol=1e-5, rtol=0)
    jend = states[-1]
    compared = moved = 0
    for net in (0, 1):
        g = _grad_history(states, coins, net, single)
        if net == coins[0]:
            for got, want in zip(torch_leaves(grads0), g[0]):
                np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4)
        count, mu, nu = _adam(jend, net, single)
        port_opt = state.opt_state if single else state.opt_state[net]
        port_mu = port_opt.mu[net] if single else port_opt.mu
        port_nu = port_opt.nu[net] if single else port_opt.nu
        for got, want in zip(torch_leaves(port_mu), jax_leaves(mu)):
            np.testing.assert_allclose(got, want, atol=1e-8, rtol=1e-4)
        for got, want in zip(torch_leaves(port_nu), jax_leaves(nu)):
            np.testing.assert_allclose(got, want, atol=1e-8, rtol=1e-4)
        assert int(port_opt.count) == int(count)
        for k, (got, want) in enumerate(zip(torch_leaves(state.params[net]),
                                            jax_leaves(jend.params[net]))):
            gk = np.stack([step[k] for step in g])
            mk = (gk != 0).any(axis=0)
            sure = mk & ((gk == 0) | (np.abs(gk) > 1e-6)).all(axis=0)
            np.testing.assert_allclose(got[sure], want[sure], atol=1e-5, rtol=0)
            compared, moved = compared + sure.sum(), moved + mk.sum()
    assert compared >= moved / 4, f"only {compared} of {moved} moved entries compared"
    assert state.step == len(coins)


CASES = {  # (train config, RL config, smorl inputs with the out_to_in table)
    "sqn-fused": (dict(model="sqn"), {}, None),
    "sqn-unfused": (dict(model="sqn", fused_ce=False), {}, None),
    "sqn-single-optimizer": (dict(model="sqn"), dict(single_optimizer=True), None),
    "sqn-boot-len-bug": (dict(model="sqn"), dict(compat_boot_len_bug=True), None),
    "sqn-highest": (dict(model="sqn", head_precision="highest"), {}, None),
    "smorl-k3-remap": (dict(model="smorl"), dict(q_weights=(1.0, 0.5, 2.0)), True),
    "smorl-k2": (dict(model="smorl", num_q_heads=2), dict(topk_div=2), False),
    "smorl-k1": (dict(model="smorl", num_q_heads=1), {}, False),  # no top-k: B1
    "smorl-unfused": (dict(model="smorl", fused_ce=False), dict(topk_nov=3), False),
    "smorl-div-len-bug": (dict(model="smorl"), dict(compat_div_len_bug=True), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_reference(case):
    train_kw, rl, remap = CASES[case]
    mc, jmc = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T, **train_kw)
    assert mc.fused_ce == jmc.fused_ce == train_kw.get("fused_ce", True)
    np_pair = numpy_init_double_q(mc, seeds=(1, 2))
    batches = _batches(3, seed=3)
    aux = {} if remap is None else _smorl_inputs(4, remap)
    jout = _jax_run(jmc, rl, np_pair, batches, aux)
    pout = _port_run(mc, rl, np_pair, batches, aux, jout[1])
    _compare(jout, pout, rl.get("single_optimizer", False))


@pytest.mark.parametrize("single", [False, True])
def test_reference_state_continues_in_the_port(single):
    """Two reference sqn steps, then its params pair and Adam state (one per
    net, or one over the pair) carried into the port
    (``double_q_from_numpy``): the next step matches the reference's."""
    mc, jmc = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T, model="sqn")
    rl = dict(single_optimizer=single)
    batches = _batches(3, seed=5)
    states, coins, j_losses = _jax_run(jmc, rl, numpy_init_double_q(mc, (6, 7)), batches, {})
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    pair, opt_state = double_q_from_numpy(to_np(states[2].params), to_np(states[2].opt_state), "cpu")
    assert isinstance(opt_state, tuple) != single
    state, opt = make_double_q_state(pair, mc, LR, single_optimizer=single, device="cpu")
    state.opt_state = opt_state
    step = make_train_step(mc, opt, RLStepConfig(**rl), device="cpu")
    state, m = step(state, batches[2], coin=coins[2])
    np.testing.assert_allclose((float(m["sup_loss"]), float(m["q_loss"])), j_losses[2], atol=1e-5)
    for net in (0, 1):
        for got, want in zip(torch_leaves(state.params[net]), jax_leaves(states[3].params[net])):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_coin_comes_from_the_host_generator():
    """Without ``coin`` the state's CPU generator draws one bit a step; a
    given coin still advances it, so later draws do not depend on it. Each
    net's Adam count shows which net each step trained."""
    mc, _ = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T, model="sqn")
    batches = _batches(4, seed=8)
    g = torch.Generator().manual_seed(11)
    draws = [int(torch.randint(0, 2, (), generator=g)) for _ in range(4)]
    for first in (None, 1 - draws[0]):
        pair = [params_from_numpy(p, "cpu") for p in numpy_init_double_q(mc, (1, 2))]
        state, opt = make_double_q_state(pair, mc, LR, seed=11, device="cpu")
        assert state.generator.device.type == "cpu"
        step = make_train_step(mc, opt, device="cpu")
        coins = draws if first is None else [first] + draws[1:]
        for k, b in enumerate(batches):
            state, _ = step(state, b, coin=first if k == 0 else None)
            want = [sum(c == net for c in coins[: k + 1]) for net in (0, 1)]
            assert [int(state.opt_state[net].count) for net in (0, 1)] == want


def test_double_q_inputs_are_checked():
    mc, _ = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T, model="smorl")
    pair = [params_from_numpy(p, "cpu") for p in numpy_init_double_q(mc, (1, 2))]
    state, opt = make_double_q_state(pair, mc, LR, device="cpu")
    with pytest.raises(ValueError, match="div_embedding"):
        make_train_step(mc, opt, device="cpu")
    with pytest.raises(ValueError, match="fewer than"):
        make_train_step(mc, opt, RLStepConfig(q_weights=(1.0, 1.0)), device="cpu",
                        **_smorl_inputs(0, False))
    step = make_train_step(mc, opt, device="cpu", **_smorl_inputs(0, False))
    with pytest.raises(ValueError, match="coin"):
        step(state, _batches(1, seed=0)[0], coin=2)
    with pytest.raises(ValueError, match="two param trees"):
        make_double_q_state(pair[:1], mc, LR, device="cpu")
    with pytest.raises(ValueError, match="two different seeds"):
        numpy_init_double_q(mc, (3, 3))


@pytest.mark.parametrize("model", ["sqn", "smorl"])
def test_named_steps_match_reference(model):
    """``sqn_train_step`` and ``smorl_train_step`` (the reference's
    signatures; smorl's takes the diversity embedding, the unpopular mask
    and the id table) against the reference's functions called directly:
    two steps with the reference's coins, the losses atol 1e-5 and every
    param after them atol 1e-5, as the steps above are held."""
    from ikea_recommender_tpu_torch.train.steps import smorl_train_step, sqn_train_step

    mc, jmc = model_configs(A, embedding_size=E, hidden_state_size=E, state_size=T,
                            model=model, fused_ce=True)
    np_pair = numpy_init_double_q(mc, (3, 4))
    batches = _batches(2, seed=12)
    aux = _smorl_inputs(5, True) if model == "smorl" else {}
    opt = jax_state.make_optimizer(LR)
    params = tuple(as_jax_tree(p) for p in np_pair)
    st = jax_state.DoubleQState(params=params, opt_state=tuple(opt.init(p) for p in params),
                                step=jnp.zeros((), jnp.int32), rng=jax.random.key(1))
    jaux = [jnp.asarray(aux[k]) for k in ("div_embedding", "unpopular_mask", "out_to_in")
            if model == "smorl"]
    state, popt = make_double_q_state([params_from_numpy(p, "cpu") for p in np_pair], mc, LR,
                                      device="cpu")
    rl = RLStepConfig()
    for b in batches:
        coin = int(jax.random.bernoulli(jax.random.fold_in(st.rng, st.step)))
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = {k: torch.as_tensor(v) for k, v in b.items()}
        if model == "sqn":
            st, jm = jax_steps.sqn_train_step(st, jb, jmc, opt, jax_steps.RLStepConfig())
            state, m = sqn_train_step(state, tb, mc, popt, rl, coin=coin)
        else:
            st, jm = jax_steps.smorl_train_step(st, jb, jmc, opt, jax_steps.RLStepConfig(),
                                                *jaux)
            state, m = smorl_train_step(state, tb, mc, popt, rl, aux["div_embedding"],
                                        aux["unpopular_mask"], aux["out_to_in"], coin=coin)
        np.testing.assert_allclose([float(m["sup_loss"]), float(m["q_loss"])],
                                   [float(jm["sup_loss"]), float(jm["q_loss"])], atol=1e-5)
    for net in (0, 1):
        for got, want in zip(torch_leaves(state.params[net]), jax_leaves(st.params[net])):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
