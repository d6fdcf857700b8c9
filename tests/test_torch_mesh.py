"""The port's train steps, serving and eval on a (data, model) mesh against
the reference package's.

The reference runs on the 8 virtual CPU devices of tests/conftest.py, on a
``MeshSpec`` of the same shape: its ``make_train_step(mesh=..., data_axis=
"data")`` (the fused arm's sharded kernels) or its plain step (the dense
arm, which it leaves to XLA's partitioner) under
``parallel/sharding.py::make_sharded_train_step``, ``Recommender(mesh=)``
and ``EvalProtocol(mesh=)``. The port runs as one gloo process per rank on
the CPU (``tests/_torch_mesh_worker.py``: a pool of 2 and one of 4 ranks,
spawned once for the file), each rank holding its slice of the params and
its rows of each batch; the params and moments it returns are gathered
from the slices. Both sides start from the same numpy params and batches;
the double-Q steps take the reference's coins (``coin=``, every rank the
same). The third batch's tail is padding, so the two data ranks of (2, 2)
hold different numbers of valid rows.

Tolerances, those of the single-device tests of the same steps
(tests/test_torch_train.py, test_torch_double_q.py, test_torch_sarm.py;
fp32 with sums in other orders):
- each step's losses, atol 1e-5;
- the first step's gradients of the trained net, atol 1e-6 + rtol 1e-4,
  both sides' read back from their first moments, g = (mu_k - b1
  mu_{k-1}) / (1 - b1);
- the first moments after 3 steps, atol 1e-8 + rtol 1e-4;
- the params after 3 steps, atol 1e-5, over the entries some step moved
  whose gradient at every step is 0 or above 1e-6 (at least a quarter of
  the moved entries); a net that no step trained, bit for bit.
Serving: the top-k values within 1e-5 and the ids equal wherever adjacent
values differ by more (``assert_topk_match``); eval: as
tests/test_torch_eval.py (HR, R@k, coverage exact; NDCG 1e-6; loss and
rewards 1e-5).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_mesh_worker as W
from _torch_parity import as_jax_tree, assert_topk_match, jax_leaves, model_configs

from ikea_recommender_tpu.core.mesh import DATA_AXIS, MeshSpec, make_mesh
from ikea_recommender_tpu.data import replay_buffer as jax_replay_buffer
from ikea_recommender_tpu.eval.protocol import EvalProtocol as JaxEvalProtocol
from ikea_recommender_tpu.parallel.sharding import make_sharded_train_step, shard_state
from ikea_recommender_tpu.run.serve import Recommender as JaxRecommender
from ikea_recommender_tpu.train import state as jax_state
from ikea_recommender_tpu.train import steps as jax_steps
from ikea_recommender_tpu_torch.convert import numpy_init_double_q, numpy_init_params

LR, B1 = 0.01, 0.9
A, ALIGN, B, T, E = 61, 4, 16, 5, 8  # 61 actions padded to 64: a padded last shard


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    store = tmp_path_factory.mktemp("store")
    made = {2: W.RankPool(2, store), 4: W.RankPool(4, store)}
    yield made
    for pool in made.values():
        pool.close()


def _batches(n, seed):
    rs = np.random.RandomState(seed)
    out = [{
        "state": rs.randint(0, A + 1, (B, T)).astype(np.int32),
        "action": rs.randint(0, A, (B,)).astype(np.int32),
        "reward": rs.rand(B).astype(np.float32),
        "next_state": rs.randint(0, A + 1, (B, T)).astype(np.int32),
        "true_len": rs.randint(1, T + 1, (B,)).astype(np.int32),
        "true_next_len": rs.randint(1, T + 1, (B,)).astype(np.int32),
        "is_end": rs.rand(B) < 0.3,
        "valid": rs.rand(B) < 0.9,
    } for _ in range(n)]
    out[-1]["valid"][B // 2 + 3:] = False  # a padded tail: 8 and 3 valid rows
    out[-1]["valid"][: B // 2] = True
    return out


def _smorl_aux(seed=7):
    rs = np.random.RandomState(seed)
    return {"div_embedding": rs.randn(A + 1, E).astype(np.float32),
            "unpopular_mask": rs.rand(A) < 0.3}


def _jax_run(jmc, np_params, batches, spec, fused, aux):
    """The reference's 3 steps on its mesh -> (losses, coins, trajectory)."""
    mesh = make_mesh(MeshSpec(*spec), devices=jax.devices()[: spec[0] * spec[1]])
    opt = jax_state.make_optimizer(LR)
    key = jax.random.key(0)
    zero = jnp.zeros((), jnp.int32)
    if isinstance(np_params, tuple):
        pair = tuple(as_jax_tree(p) for p in np_params)
        st = jax_state.DoubleQState(params=pair, opt_state=tuple(opt.init(p) for p in pair),
                                    step=zero, rng=key)
    else:
        p = as_jax_tree(np_params)
        st = jax_state.TrainState(params=p, opt_state=opt.init(p), step=zero, rng=key)
    kw = dict(mesh=mesh, data_axis=DATA_AXIS) if fused else {}
    raw = jax_steps.make_train_step(jmc, opt, jax_steps.RLStepConfig(), jit=False,
                                    **{k: jnp.asarray(v) for k, v in aux.items()}, **kw)
    step = make_sharded_train_step(raw, mesh, st, batches[0])
    st = shard_state(st, mesh)
    traj, losses, coins = [_jax_snapshot(st)], [], []
    for b in batches:
        coins.append(int(jax.random.bernoulli(jax.random.fold_in(st.rng, st.step))))
        st, m = step(st, b)
        losses.append((float(m["sup_loss"]), float(m["q_loss"])))
        traj.append(_jax_snapshot(st))
    return losses, coins, traj


def _jax_snapshot(st):
    nets = st.params if isinstance(st.params, tuple) else (st.params,)
    opts = st.opt_state if isinstance(st.params, tuple) else (st.opt_state,)
    return {"params": [jax_leaves(n) for n in nets], "mu": [jax_leaves(o[0].mu) for o in opts]}


def _grads(traj, coins, net):
    """Each step's gradient of ``net`` from its first moments (zero where
    it was not the trained net)."""
    out = []
    for k in range(len(traj) - 1):
        if coins is None or coins[k] == net:
            m0, m1 = traj[k]["mu"][net], traj[k + 1]["mu"][net]
            out.append([(b - B1 * a) / (1 - B1) for a, b in zip(m0, m1)])
        else:
            out.append([np.zeros_like(a) for a in traj[k]["params"][net]])
    return out


def _compare(jout, pout, coins):
    (j_losses, _, jtraj), got = jout, pout
    np.testing.assert_allclose(got["losses"], j_losses, atol=1e-5, rtol=0)
    ptraj = got["traj"]
    compared = moved = 0
    for net in range(len(jtraj[0]["params"])):
        gj, gp = _grads(jtraj, coins, net), _grads(ptraj, coins, net)
        if coins is None or coins[0] == net:
            for a, w in zip(gp[0], gj[0]):
                np.testing.assert_allclose(a, w, atol=1e-6, rtol=1e-4)
        for a, w in zip(ptraj[-1]["mu"][net], jtraj[-1]["mu"][net]):
            np.testing.assert_allclose(a, w, atol=1e-8, rtol=1e-4)
        if coins is not None and net not in coins:  # never trained: untouched
            for a, w in zip(ptraj[-1]["params"][net], ptraj[0]["params"][net]):
                np.testing.assert_array_equal(a, w)
        for k, (a, w) in enumerate(zip(ptraj[-1]["params"][net], jtraj[-1]["params"][net])):
            gk = np.stack([g[k] for g in gj])
            mk = (gk != 0).any(axis=0)
            sure = mk & ((gk == 0) | (np.abs(gk) > 1e-6)).all(axis=0)
            np.testing.assert_allclose(a[sure], w[sure], atol=1e-5, rtol=0)
            compared, moved = compared + sure.sum(), moved + mk.sum()
    assert compared >= moved / 4, f"only {compared} of {moved} moved entries compared"


STEP_CASES = [(fam, fused, spec)
              for fam in ("gru4rec", "bidir_gru4rec", "sqn", "smorl", "sarm")
              for fused, spec in ((True, (1, 2)), (True, (2, 2)), (False, (2, 2)))]


@pytest.mark.parametrize("family,fused,spec", STEP_CASES,
                         ids=[f"{f}-{'fused' if u else 'dense'}-{d}x{m}"
                              for f, u, (d, m) in STEP_CASES])
def test_three_steps_match_reference(pools, family, fused, spec):
    """3 steps on the mesh, the frozen pad row's gradient masked on the
    rank that holds it, against the reference's mesh step."""
    train_kw = dict(model=family, embedding_size=E, hidden_state_size=E, state_size=T,
                    fused_ce=fused, train_padding_embed=False, dropout=0.0)
    mc, jmc = model_configs(A, ALIGN, **train_kw)
    # the recurrence as lax.scan: the mesh's ops are the subject here, and
    # tests/test_torch_gru.py holds B3/B4's twins to the Pallas kernels
    jmc = replace(jmc, backbone=replace(jmc.backbone, scan_impl="xla"))
    assert mc.fused_ce == jmc.fused_ce == fused and mc.padded_action_dim == 64
    double_q = family in ("sqn", "smorl")
    np_params = numpy_init_double_q(mc) if double_q else numpy_init_params(mc, seed=1)
    aux = _smorl_aux() if family == "smorl" else {}
    batches = _batches(3, seed=2)
    jout = _jax_run(jmc, np_params, batches, spec, fused, aux)
    coins = jout[1] if double_q else None
    got = pools[spec[0] * spec[1]].run(
        W.train, spec, A=A, align=ALIGN, train_kw=train_kw, np_params=np_params,
        batches=batches, coins=coins, aux=aux)[0]
    _compare(jout, got, coins)
    pad = mc.backbone.padding_idx  # the frozen pad row, on the last model rank
    for net in got["traj"][-1]["params"]:
        assert (net[0][pad] == 0).all()  # leaf 0: backbone/embedding


@pytest.mark.parametrize("family", ["gru4rec", "sqn"])
def test_one_axis_and_single_rank_agree(pools, family):
    """The dense arm on (1, 2) and (1, 4), and bidir's dropout on (2, 2):
    equal to the port's own single-process step (the reference draws its
    dropout masks from another generator), so the data ranks' rows of the
    global keep mask are the unsplit batch's."""
    batches = _batches(3, seed=4)
    cases = [(dict(model=family, fused_ce=False), (1, 2)), (dict(model=family, fused_ce=False),
                                                            (1, 4))]
    if family == "gru4rec":
        cases.append((dict(model="bidir_gru4rec", fused_ce=True, dropout=0.35), (2, 2)))
    for kw, spec in cases:
        train_kw = dict(embedding_size=E, hidden_state_size=E, state_size=T, **kw)
        mc, _ = model_configs(A, ALIGN, **train_kw)
        double_q = kw["model"] in ("sqn", "smorl")
        np_params = numpy_init_double_q(mc) if double_q else numpy_init_params(mc, seed=3)
        coins = [1, 0, 1] if double_q else None
        args = dict(A=A, align=ALIGN, train_kw=train_kw, np_params=np_params, batches=batches,
                    coins=coins)
        want = _single_rank(np_params, mc, batches, coins, train_kw)
        got = pools[spec[0] * spec[1]].run(W.train, spec, **args)[0]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5, rtol=0)
        for pg, pw in zip(got["traj"][-1]["params"], want["traj"][-1]["params"]):
            for a, w in zip(pg, pw):
                np.testing.assert_allclose(a, w, atol=1e-5, rtol=0)
        for tg, tw in zip(got["targets"], want["targets"]):
            np.testing.assert_array_equal(tg, tw)


def _single_rank(np_params, mc, batches, coins, train_kw):
    """The port's own step in this process, on one device, as a trajectory."""
    from ikea_recommender_tpu_torch.convert import params_from_numpy, tree_leaves
    from ikea_recommender_tpu_torch.train.state import make_double_q_state, make_train_state
    from ikea_recommender_tpu_torch.train.steps import make_train_step

    if coins is not None:
        state, opt = make_double_q_state([params_from_numpy(p, "cpu") for p in np_params], mc,
                                         LR, device="cpu")
        nets = lambda s: s.params  # noqa: E731
    else:
        state, opt = make_train_state(params_from_numpy(np_params, "cpu"), mc, LR, device="cpu")
        nets = lambda s: (s.params,)  # noqa: E731
    step = make_train_step(mc, opt, device="cpu")
    losses, targets = [], []
    for k, b in enumerate(batches):
        state, m = step(state, b, **({} if coins is None else {"coin": coins[k]}))
        losses.append((float(m["sup_loss"]), float(m["q_loss"])))
        if "target_action" in m:
            targets.append(m["target_action"].numpy())
    params = [[x.detach().numpy() for x in tree_leaves(n)] for n in nets(state)]
    return {"losses": losses, "targets": targets, "traj": [{"params": params}]}


# -- serving and eval -----------------------------------------------------------

SERVE_CASES = [("gru4rec", None, 0), ("gru4rec", False, 0), ("sarm", None, 3), ("sqn", None, 1),
               ("smorl", None, 0)]


@pytest.mark.parametrize("family,fused,head_idx", SERVE_CASES,
                         ids=[f"{f}-{'dense' if u is False else 'auto'}-head{h}"
                              for f, u, h in SERVE_CASES])
def test_recommender_on_a_mesh_matches_reference(pools, family, fused, head_idx):
    """Recommender(mesh=(1, 2)): the model-sharded head takes the fused
    scan unless told otherwise; the same top-k on every rank, equal to the
    reference's Recommender on its (1, 2) mesh; the gathered scores its
    scores."""
    train_kw = dict(model=family, embedding_size=E, hidden_state_size=E, state_size=T)
    mc, jmc = model_configs(A, ALIGN, **train_kw)
    np_params = numpy_init_params(mc, seed=5)
    np_params["backbone"]["embedding"] *= 30.0  # sessions differ in their top-k
    rs = np.random.RandomState(6)
    states = rs.randint(0, A + 1, (24, T)).astype(np.int32)
    lens = rs.randint(1, T + 1, 24).astype(np.int32)
    k = 10
    mesh = make_mesh(MeshSpec(1, 2), devices=jax.devices()[:2])
    jrec = JaxRecommender(shard_state(as_jax_tree(np_params), mesh), jmc, head_idx=head_idx,
                          mesh=mesh, fused=fused)
    want_v, want_i = (np.asarray(x) for x in jrec.recommend(states, lens, k + 1))
    got = pools[2].run(W.serve, (1, 2), A=A, align=ALIGN, train_kw=train_kw,
                       np_params=np_params, states=states, lens=lens, k=k + 1,
                       head_idx=head_idx, fused=fused)
    assert got[0]["fused"] == jrec.fused
    for r in got:
        np.testing.assert_array_equal(r["ids"], got[0]["ids"])
        assert_topk_match(r["vals"], r["ids"], want_v, want_i, k)
    scores = np.asarray(jrec.scores(states, lens))
    np.testing.assert_allclose(got[0]["scores"], scores, atol=1e-5, rtol=0)


EVAL_CASES = [("gru4rec", None, (1, 2)), ("gru4rec", False, (1, 2)), ("sarm", None, (2, 2)),
              ("smorl", None, (2, 2))]


@pytest.mark.parametrize("family,fused,spec", EVAL_CASES,
                         ids=[f"{f}-{'dense' if u is False else 'auto'}-{d}x{m}"
                              for f, u, (d, m) in EVAL_CASES])
def test_eval_protocol_on_a_mesh_matches_reference(pools, family, fused, spec):
    """EvalProtocol(mesh=...).evaluate over 150 rows in batches of 64 (a
    tail of 22, split 22 / 0 over two data ranks) against the reference's
    protocol on its mesh: rows whose top 21 scores are more than 1e-5
    apart, half the labels in the row's top 20."""
    train_kw = dict(model=family, embedding_size=E, hidden_state_size=E, state_size=T)
    mc, jmc = model_configs(A, ALIGN, **train_kw)
    np_params = numpy_init_params(mc, seed=8)
    np_params["backbone"]["embedding"] *= 30.0
    rs = np.random.RandomState(9)
    n, n_cand = 150, 400
    lens = rs.randint(1, T + 1, n_cand).astype(np.int32)
    states = np.full((n_cand, T), A, np.int32)
    for i, m in enumerate(lens):
        states[i, :m] = rs.randint(0, A, m)
    scores = np.asarray(JaxRecommender(as_jax_tree(np_params), jmc).scores(states, lens))[:, :A]
    top = -np.sort(-scores, axis=1)[:, :21]
    keep = np.flatnonzero((np.abs(np.diff(top, axis=1)) > 1e-5).all(axis=1))[:n]
    assert len(keep) == n  # rows whose top 21 are more than 1e-5 apart
    states, lens, scores = states[keep], lens[keep], scores[keep]
    action = rs.randint(0, A, n).astype(np.int32)
    half = rs.rand(n) < 0.5  # labels inside the top 20
    top = np.argsort(-scores, axis=1, kind="stable")[:, :20]
    action[half] = top[half, rs.randint(0, 20, n)[half]]
    buf = dict(state=states, action=action, true_len=lens,
               action_type=rs.randint(0, 2, n).astype(np.int32))
    kw = dict(topk_hr_ndcg=(5, 10), topk_cov=(1, 5), topk_div=2, topk_nov=3, fused=fused,
              div_embedding=rs.randn(A + 1, 4).astype(np.float32),
              unpopular_mask=np.arange(A) % 10 == 0, type_names=("click", "buy"))
    mesh = make_mesh(MeshSpec(*spec), devices=jax.devices()[: spec[0] * spec[1]])
    jproto = JaxEvalProtocol(jmc, mesh=mesh, **{
        k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    want = jproto.evaluate(shard_state(as_jax_tree(np_params), mesh),
                           jax_replay_buffer.EvalBuffer(**buf), 64)
    got = pools[spec[0] * spec[1]].run(W.evaluate, spec, A=A, align=ALIGN, train_kw=train_kw,
                                       np_params=np_params, buf=buf, batch_size=64,
                                       proto_kw=kw)
    assert got[0]["fused"] == jproto.fused
    for r in got:
        assert abs(r["loss"] - want.loss) <= 1e-5, (r["loss"], want.loss)
        assert abs(r["div_rew"] - want.div_rew) <= 1e-5
        assert abs(r["nov_rew"] - want.nov_rew) <= 1e-5
        np.testing.assert_array_equal(r["hr"], want.hr)
        np.testing.assert_array_equal(r["reps"], want.reps)
        np.testing.assert_allclose(r["ndcg"], want.ndcg, atol=1e-6, rtol=0)
        assert r["coverage"] == want.coverage
        for name, w in want.by_type.items():
            np.testing.assert_array_equal(r["by_type"][name]["hr"], w["hr"])
            assert r["by_type"][name]["count"] == w["count"]
    assert got[0]["hr"][-1] > 0.2  # HR@10: about half the labels are in the top 20
