"""The port's eval slice against the reference package.

The same numpy inputs go through the reference (JAX on the CPU; its GRU
through the Pallas kernel in interpret mode) and the port on
``device="cpu"``, where the B3 kernel's plain twin runs:

- every function of ``ops/ranking.py``, ``ops/coverage.py`` and the eval
  functions of ``ops/rewards.py``, on scores with exact ties (the lower id
  first), ``valid`` masks, an output-to-input remap, per-type sums, and a
  coverage update where a padded row repeats a valid row's ids;
- ``data/item_frequency.py``, ``data/preprocessing.py``'s eval windows and
  ``data/replay_buffer.py``'s eval half: arrays equal;
- ``EvalProtocol.evaluate`` for gru4rec (fused arm forced, over two
  4096-column blocks, and dense), bidir_gru4rec, sqn (heads 0 and 1), smorl
  (head 0) and sarm, with an unpopular mask, a diversity embedding and a
  padded tail batch (and action types and a remap in some);
- ``get_logging_dict_test`` and the other logging dicts, key for key.

Tolerances (fp32, sums in other orders): the loss and the rewards within
1e-5 absolute; HR, repetitions and coverage exactly equal and NDCG within
1e-6. Those hold where every row's top-(max k + 1) scores are more than
1e-5 apart, so the two sides rank the same ids: each case's buffer keeps
the candidate rows whose scores the reference separates so, and the test
checks the separation on the buffer it evaluates.
"""

from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import as_jax_tree, model_configs, one_rank_mesh  # noqa: F401

from ikea_recommender_tpu.data import item_frequency as jax_item_frequency
from ikea_recommender_tpu.data import preprocessing as jax_preprocessing
from ikea_recommender_tpu.data import replay_buffer as jax_replay_buffer
from ikea_recommender_tpu.eval.protocol import EvalProtocol as JaxEvalProtocol
from ikea_recommender_tpu.models import families as jax_families
from ikea_recommender_tpu.ops import coverage as jax_coverage
from ikea_recommender_tpu.ops import ranking as jax_ranking
from ikea_recommender_tpu.ops import rewards as jax_rewards
from ikea_recommender_tpu.utils import logging_dicts as jax_logging_dicts
from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
from ikea_recommender_tpu_torch.data import item_frequency, preprocessing, replay_buffer
from ikea_recommender_tpu_torch.eval.protocol import EvalProtocol, EvalResult
from ikea_recommender_tpu_torch.ops import coverage, ranking, rewards
from ikea_recommender_tpu_torch.utils import logging_dicts

GAP = 1e-5  # the separation the exact comparisons need
TOPK_HR, TOPK_COV = (5, 10, 20), (1, 5, 10, 20)
MAX_K = 20


def _t(a):
    return torch.as_tensor(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


# -- ops: ranking, coverage, rewards ---------------------------------------


@pytest.fixture(scope="module")
def scored():
    """Integer scores with many exact ties, labels (a third of them at a
    top-20 id), a valid mask, action types, states and an output-to-input
    table."""
    rs = np.random.RandomState(0)
    B, A, T = 24, 40, 6
    preds = rs.randint(0, 6, (B, A)).astype(np.float32)
    labels = rs.randint(0, A, B).astype(np.int32)
    top = np.asarray(jax_ranking.topk_indices(_j(preds), 20))
    pick = rs.rand(B) < 0.33
    labels[pick] = top[pick, rs.randint(0, 20, B)[pick]]
    valid = rs.rand(B) < 0.8
    types = rs.randint(0, 3, B).astype(np.int32)
    states = rs.randint(0, A, (B, T)).astype(np.int32)
    out_to_in = rs.permutation(A).astype(np.int32)
    return dict(preds=preds, labels=labels, valid=valid, types=types, states=states,
                out_to_in=out_to_in, lengths=rs.randint(1, T + 1, B).astype(np.int32))


@pytest.mark.parametrize("k", [1, 7, 20])
def test_topk_indices_keep_the_lower_id_first_among_ties(scored, k):
    want = np.asarray(jax_ranking.topk_indices(_j(scored["preds"]), k))
    got = ranking.topk_indices(_t(scored["preds"]), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_hit_ranks(scored):
    idx = np.array(jax_ranking.topk_indices(_j(scored["preds"]), 20))
    labels = scored["labels"].copy()
    # a label twice in the list ranks at its first place
    idx[0, 3] = idx[0, 7] = labels[0] = 99
    hit, rank = jax_ranking.hit_ranks(_j(idx), _j(labels))
    got_hit, got_rank = ranking.hit_ranks(_t(idx), _t(labels))
    np.testing.assert_array_equal(got_hit.numpy(), np.asarray(hit))
    np.testing.assert_array_equal(got_rank.numpy(), np.asarray(rank))
    assert got_rank[0] == 4 and (got_rank == 0).any() and got_hit.any()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("from_scores", [False, True])
def test_hr_ndcg(scored, masked, from_scores):
    valid = scored["valid"] if masked else None
    jv = None if valid is None else _j(valid)
    tv = None if valid is None else _t(valid)
    if from_scores:
        want = jax_ranking.hr_ndcg_at_k(_j(scored["preds"]), _j(scored["labels"]), TOPK_HR, jv)
        got = ranking.hr_ndcg_at_k(_t(scored["preds"]), _t(scored["labels"]), TOPK_HR, tv)
    else:
        idx = np.asarray(jax_ranking.topk_indices(_j(scored["preds"]), 20))
        want = jax_ranking.hr_ndcg_from_topk(_j(idx), _j(scored["labels"]), TOPK_HR, jv)
        got = ranking.hr_ndcg_from_topk(_t(idx), _t(scored["labels"]), TOPK_HR, tv)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    assert got[0].dtype == torch.float32 and got[0].sum() > 0


@pytest.mark.parametrize("from_scores", [False, True])
def test_hr_ndcg_by_type(scored, from_scores):
    args = (scored["labels"], scored["types"])
    if from_scores:
        want = jax_ranking.hr_ndcg_by_action_type(
            _j(scored["preds"]), *map(_j, args), 3, TOPK_HR, _j(scored["valid"]))
        got = ranking.hr_ndcg_by_action_type(
            _t(scored["preds"]), *map(_t, args), 3, TOPK_HR, _t(scored["valid"]))
    else:
        idx = np.asarray(jax_ranking.topk_indices(_j(scored["preds"]), 20))
        want = jax_ranking.hr_ndcg_by_type_from_topk(
            _j(idx), *map(_j, args), 3, TOPK_HR, _j(scored["valid"]))
        got = ranking.hr_ndcg_by_type_from_topk(
            _t(idx), *map(_t, args), 3, TOPK_HR, _t(scored["valid"]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].sum() == scored["valid"].sum()


def test_coverage_keeps_a_valid_id_that_a_padded_row_repeats():
    """A padded tail row repeats a valid row's ids with valid False (as
    ``_pad_take`` pads): the id stays covered, as the reference's
    ``.at[ids].max`` keeps it."""
    A = 30
    idx = np.array([[3, 4, 5], [6, 7, 8], [3, 4, 5], [3, 4, 5]], np.int32)
    valid = np.array([True, False, False, False])
    start = np.zeros((2, A), bool)
    start[1, 29] = True  # covered by an earlier batch
    want = jax_coverage.update_coverage_from_topk(_j(start), _j(idx), (1, 3), _j(valid))
    got = coverage.update_coverage_from_topk(_t(start), _t(idx), (1, 3), _t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].nonzero().flatten().tolist() == [3]
    assert got[1].nonzero().flatten().tolist() == [3, 4, 5, 29]


@pytest.mark.parametrize("masked", [False, True])
def test_coverage(scored, masked):
    A = scored["preds"].shape[1]
    valid = scored["valid"] if masked else None
    want = jax_coverage.init_coverage(A, len(TOPK_COV))
    got = coverage.init_coverage(A, len(TOPK_COV))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    half = len(valid) // 2 if masked else None
    for rows in (slice(0, half), slice(half, None)):  # two batches
        jv = None if valid is None else _j(valid[rows])
        tv = None if valid is None else _t(valid[rows])
        want = jax_coverage.update_coverage(want, _j(scored["preds"][rows]), TOPK_COV, jv)
        got = coverage.update_coverage(got, _t(scored["preds"][rows]), TOPK_COV, tv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    unpop = np.arange(A) % 3 == 0
    want_r = jax_coverage.coverage_ratios(want, _j(unpop), A)
    got_r = coverage.coverage_ratios(got, _t(unpop), A)
    for g, w in zip(got_r, want_r):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == torch.float32


@pytest.mark.parametrize("remap", [False, True])
def test_diversity_rewards(scored, remap):
    A = scored["preds"].shape[1]
    emb = np.random.RandomState(1).randn(A + 1, 5).astype(np.float32)
    emb[2] = 0.0  # a zero row: the denominator's eps
    o2i = scored["out_to_in"] if remap else None
    for pad_pos in ("end", "beg"):
        want = jax_rewards.diversity_rewards(
            _j(scored["states"]), _j(scored["preds"]), _j(scored["lengths"]), pad_pos, 3,
            _j(emb), out_to_in=None if o2i is None else _j(o2i))
        got = rewards.diversity_rewards(
            _t(scored["states"]), _t(scored["preds"]), _t(scored["lengths"]), pad_pos, 3,
            _t(emb), out_to_in=None if o2i is None else _t(o2i))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_novelty_rewards(scored):
    unpop = np.arange(scored["preds"].shape[1]) % 4 == 1
    for k, sig in ((1, 1.0), (5, 0.5)):
        want = jax_rewards.novelty_rewards(_j(scored["preds"]), _j(unpop), sig, k)
        got = rewards.novelty_rewards(_t(scored["preds"]), _t(unpop), sig, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("remap", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_repetitions(scored, remap, masked):
    o2i = scored["out_to_in"] if remap else None
    valid = scored["valid"] if masked else None
    kw_j = dict(out_to_in=None if o2i is None else _j(o2i),
                valid=None if valid is None else _j(valid))
    kw_t = dict(out_to_in=None if o2i is None else _t(o2i),
                valid=None if valid is None else _t(valid))
    want = jax_rewards.repetition_counts(_j(scored["states"]), _j(scored["preds"]), TOPK_HR,
                                         **kw_j)
    got = rewards.repetition_counts(_t(scored["states"]), _t(scored["preds"]), TOPK_HR, **kw_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx = np.asarray(jax_ranking.topk_indices(_j(scored["preds"]), 20))
    want = jax_rewards.repetitions_from_topk(_j(scored["states"]), _j(idx), TOPK_HR, **kw_j)
    got = rewards.repetitions_from_topk(_t(scored["states"]), _t(idx), TOPK_HR, **kw_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[-1] > 0


# -- data -----------------------------------------------------------------


def _sessions(n_sessions, A, seed):
    """Interleaved session rows: (items, session ids), 1-7 events each."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(1, 8, n_sessions)
    sids = np.repeat(np.arange(n_sessions) * 7 + 3, lens)
    rs.shuffle(sids)  # sessions interleave; each keeps its order below
    return rs.randint(0, A, len(sids)).astype(np.int64), sids


def test_item_frequency_round_trip(tmp_path):
    items = np.random.RandomState(2).zipf(1.5, 400) % 50
    path = str(tmp_path / "unpop.json")
    item_frequency.save_unpopular_items(items, path, quantile=0.8)
    np.testing.assert_array_equal(
        item_frequency.get_low_frequency_items(items, 0.8),
        jax_item_frequency.get_low_frequency_items(items, 0.8),
    )
    got, want = item_frequency.load_unpopular_items(path), jax_item_frequency.load_unpopular_items(path)
    assert got == want and len(got) > 0
    np.testing.assert_array_equal(item_frequency.unpopular_mask(got, 40),
                                  jax_item_frequency.unpopular_mask(want, 40))


@pytest.mark.parametrize("pad_pos", ["end", "beg"])
def test_window_sessions(pad_pos):
    items, sids = _sessions(30, 50, seed=3)
    got = preprocessing.window_sessions(items, sids, 5, 50, pad_pos)
    want = jax_preprocessing.window_sessions(items, sids, 5, 50, pad_pos)
    for name, value in asdict(want).items():
        np.testing.assert_array_equal(getattr(got, name), value, err_msg=name)


def test_eval_buffers_and_batches(tmp_path):
    """An npz written by the reference, a raw session pickle and a prebuilt
    buffer pickle load to the same arrays; eval_batches pads the tail."""
    import pandas as pd

    items, sids = _sessions(25, 50, seed=4)
    raw = pd.DataFrame({"session_id": sids, "item_id": items})
    raw.to_pickle(tmp_path / "raw.df")
    kw = dict(padding_id=50, state_len=5)
    got = replay_buffer.load_eval_source(str(tmp_path / "raw.df"), **kw)
    want = jax_replay_buffer.load_eval_source(str(tmp_path / "raw.df"), **kw)
    pd.testing.assert_frame_equal(
        preprocessing.preprocess_val_data(raw, 50, 5),
        jax_preprocessing.preprocess_val_data(raw, 50, 5),
    )

    want.action_type = np.arange(len(want)) % 2
    want.save_npz(str(tmp_path / "buf.npz"))
    jax_preprocessing.preprocess_val_data(raw, 50, 5).to_pickle(tmp_path / "buf.df")
    loaded = [replay_buffer.load_eval_source(str(tmp_path / f), **kw)
              for f in ("buf.npz", "buf.df")] + [replay_buffer.EvalBuffer(str(tmp_path / "buf.npz"))]
    for buf in [got] + loaded:
        for name in ("state", "action", "true_len"):
            np.testing.assert_array_equal(getattr(buf, name), getattr(want, name), err_msg=name)
            assert getattr(buf, name).dtype == np.int32
    np.testing.assert_array_equal(loaded[0].action_type, want.action_type)
    loaded[0].save_npz(str(tmp_path / "port.npz"))  # and back into the reference
    back = jax_replay_buffer.EvalBuffer(str(tmp_path / "port.npz"))
    for name in ("state", "action", "true_len", "action_type"):
        np.testing.assert_array_equal(getattr(back, name), getattr(want, name), err_msg=name)

    n_rows = len(want)
    batch = 16
    assert n_rows % batch and replay_buffer.num_batches(n_rows, batch) == -(-n_rows // batch)
    for drop_last in (False, True):
        pairs = list(zip(replay_buffer.eval_batches(loaded[0], batch, drop_last),
                         jax_replay_buffer.eval_batches(want, batch, drop_last)))
        assert len(pairs) == jax_replay_buffer.num_batches(n_rows, batch, drop_last)
        for g, w in pairs:
            for name in ("state", "action", "true_len", "valid", "action_type"):
                np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        assert g.valid.all() == drop_last  # the last batch: the padded tail or a full one


# -- the protocol ----------------------------------------------------------

# (id, family, fused, head_idx, catalog, extras)
PROTOCOL_CASES = [
    ("gru4rec-fused", "gru4rec", True, 0, 5000, ("types", "remap")),
    ("gru4rec-dense", "gru4rec", False, 0, 5000, ("types", "remap")),
    ("bidir", "bidir_gru4rec", None, 0, 300, ()),
    ("sqn-head0", "sqn", None, 0, 300, ("types",)),
    ("sqn-head1", "sqn", True, 1, 300, ()),
    ("smorl-head0", "smorl", None, 0, 300, ()),
    ("sarm", "sarm", None, 0, 300, ("remap",)),
]
E, T, BATCH, N_ROWS = 8, 5, 64, 150  # 2 full batches and a tail of 22


def _scored_head(jmc, jparams, states, lens, head_idx):
    """The reference's dense scores of the evaluated head (B, A)."""
    outs = jax_families.apply_model(jparams, jmc, _j(states), _j(lens))
    return np.asarray(outs[head_idx])[:, : jmc.action_dim]


def _separated(scores):
    """Rows whose top-(MAX_K + 1) scores are pairwise more than GAP apart."""
    top = -np.sort(-scores, axis=1)[:, : MAX_K + 1]
    return (np.abs(np.diff(top, axis=1)) > GAP).all(axis=1)


def _protocol_case(family, fused, head_idx, A, extras):
    mc, jmc = model_configs(A, model=family, embedding_size=E, hidden_state_size=E,
                            state_size=T)
    np_params = numpy_init_params(mc, seed=A + head_idx)
    # embeddings of std 0.3, not 0.01: sessions differ in their top-k
    np_params["backbone"]["embedding"] *= 30.0
    jparams = as_jax_tree(np_params)
    rs = np.random.RandomState(len(family) + head_idx)
    n_cand = 2 * N_ROWS
    lens = rs.randint(1, T + 1, n_cand).astype(np.int32)
    states = np.full((n_cand, T), A, np.int32)  # pad id A
    for i, n in enumerate(lens):
        states[i, :n] = rs.randint(0, A, n)
    scores = _scored_head(jmc, jparams, states, lens, head_idx)
    keep = np.flatnonzero(_separated(scores))
    # ~96% of rows are separated; the few near ties are left out
    assert len(keep) >= 0.9 * n_cand, f"only {len(keep)} of {n_cand} rows separated"
    keep = keep[:N_ROWS]
    action = rs.randint(0, A, N_ROWS).astype(np.int32)
    top = np.argsort(-scores[keep], axis=1, kind="stable")[:, :MAX_K]
    half = rs.rand(N_ROWS) < 0.5  # labels inside the top 20: hits at every k
    action[half] = top[half, rs.randint(0, MAX_K, N_ROWS)[half]]
    buf = dict(state=states[keep], action=action, true_len=lens[keep])
    kw = dict(
        topk_hr_ndcg=TOPK_HR, topk_cov=TOPK_COV, topk_div=2, topk_nov=5, head_idx=head_idx,
        fused=fused,
        div_embedding=rs.randn(A + 1, 4).astype(np.float32),
        unpopular_mask=np.arange(A) % 10 == 0,
    )
    if "types" in extras:
        buf["action_type"] = rs.randint(0, 2, N_ROWS).astype(np.int32)
        kw["type_names"] = ("click", "buy")
    if "remap" in extras:
        kw["out_to_in"] = rs.permutation(A).astype(np.int32)
    return mc, jmc, np_params, jparams, buf, kw


def _assert_results_match(got: EvalResult, want):
    assert abs(got.loss - want.loss) <= 1e-5, (got.loss, want.loss)
    assert abs(got.div_rew - want.div_rew) <= 1e-5, (got.div_rew, want.div_rew)
    assert abs(got.nov_rew - want.nov_rew) <= 1e-5, (got.nov_rew, want.nov_rew)
    np.testing.assert_array_equal(got.hr, want.hr)
    np.testing.assert_array_equal(got.reps, want.reps)
    np.testing.assert_allclose(got.ndcg, want.ndcg, atol=1e-6, rtol=0)
    assert got.coverage == want.coverage
    assert (got.by_type is None) == (want.by_type is None)
    for name, w in (want.by_type or {}).items():
        g = got.by_type[name]
        np.testing.assert_array_equal(g["hr"], w["hr"])
        np.testing.assert_allclose(g["ndcg"], w["ndcg"], atol=1e-6, rtol=0)
        assert g["count"] == w["count"]


@pytest.mark.parametrize(
    "family,fused,head_idx,A,extras", [c[1:] for c in PROTOCOL_CASES],
    ids=[c[0] for c in PROTOCOL_CASES],
)
def test_evaluate_matches_reference(family, fused, head_idx, A, extras):
    mc, jmc, np_params, jparams, buf, kw = _protocol_case(family, fused, head_idx, A, extras)
    # the separation the exact comparisons rest on, on this buffer
    scores = _scored_head(jmc, jparams, buf["state"], buf["true_len"], head_idx)
    assert _separated(scores).all()

    jax_kw = {k: (_j(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    want_proto = JaxEvalProtocol(jmc, **jax_kw)
    want = want_proto.evaluate(jparams, jax_replay_buffer.EvalBuffer(**buf), BATCH)
    proto = EvalProtocol(mc, device="cpu", **kw)
    assert proto.fused == want_proto.fused == (fused is True)
    got = proto.evaluate(params_from_numpy(np_params, "cpu"), replay_buffer.EvalBuffer(**buf),
                         BATCH)
    _assert_results_match(got, want)
    assert got.hr[-1] > 0.3 and got.div_rew > 0 and got.nov_rew > 0
    assert np.asarray(got.hr).dtype == np.float32


def test_default_div_embedding_gives_zero_diversity():
    mc, jmc, np_params, jparams, buf, kw = _protocol_case("gru4rec", None, 0, 300, ())
    del kw["div_embedding"]
    want = JaxEvalProtocol(jmc, **{k: (_j(v) if isinstance(v, np.ndarray) else v)
                                   for k, v in kw.items()}).evaluate(
        jparams, jax_replay_buffer.EvalBuffer(**buf), BATCH)
    got = EvalProtocol(mc, device="cpu", **kw).evaluate(
        params_from_numpy(np_params, "cpu"), replay_buffer.EvalBuffer(**buf), BATCH)
    _assert_results_match(got, want)
    assert got.div_rew == want.div_rew == 0.0


def test_protocol_refuses_a_mesh_and_the_cpu_unless_asked(monkeypatch, one_rank_mesh):
    """A mesh is taken: on a (1, 1) gloo mesh in this process a pass equals
    the pass without one (tests/test_torch_mesh.py holds (1, 2) and (2, 2)
    meshes to the reference's protocol). The CPU only when asked."""
    mc, jmc, np_params, _, buf, kw = _protocol_case("gru4rec", None, 0, 300, ())
    params = params_from_numpy(np_params, "cpu")
    results = [EvalProtocol(mc, device="cpu", mesh=mesh, **kw).evaluate(
        params, replay_buffer.EvalBuffer(**buf), BATCH)
        for mesh in (None, one_rank_mesh)]
    _assert_results_match(results[1], results[0])
    assert results[1].loss == results[0].loss
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EvalProtocol(mc)
    assert EvalProtocol(mc, device="cpu").device.type == "cpu"


# -- logging dicts ----------------------------------------------------------


def _results():
    """A (port, reference) pair of equal EvalResults with per-type dicts."""
    from ikea_recommender_tpu.eval.protocol import EvalResult as JaxEvalResult

    rs = np.random.RandomState(5)
    fields = dict(
        loss=2.5, hr=rs.rand(3).astype(np.float32), ndcg=rs.rand(3).astype(np.float32),
        coverage={k: (float(rs.rand()), float(rs.rand())) for k in TOPK_COV},
        div_rew=0.75, nov_rew=0.125, reps=rs.rand(3).astype(np.float32),
        by_type={t: {"hr": rs.rand(3), "ndcg": rs.rand(3), "count": 4} for t in ("click", "buy")},
    )
    return EvalResult(**fields), JaxEvalResult(**fields)


@pytest.mark.parametrize("prefix", ["", "Sec_"])
@pytest.mark.parametrize("real_test", [False, True])
def test_logging_dicts_match_reference(prefix, real_test):
    got, want = _results()
    assert logging_dicts.get_logging_dict_test(got, TOPK_HR, TOPK_COV, real_test, prefix) == \
        jax_logging_dicts.get_logging_dict_test(want, TOPK_HR, TOPK_COV, real_test, prefix)
    assert logging_dicts.get_logging_dict_by_type(got, TOPK_HR, "Val", prefix) == \
        jax_logging_dicts.get_logging_dict_by_type(want, TOPK_HR, "Val", prefix)
    assert logging_dicts.get_logging_dict_train(1.0, 0.5, got, got, TOPK_HR, TOPK_COV,
                                                True, prefix) == \
        jax_logging_dicts.get_logging_dict_train(1.0, 0.5, want, want, TOPK_HR, TOPK_COV,
                                                 True, prefix)
    d = logging_dicts.get_logging_dict_test(got, TOPK_HR, TOPK_COV, name="Val")
    assert d["Val_NDCG@10"] == float(got.ndcg[1])

