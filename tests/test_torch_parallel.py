"""The port's sharded ops (``ikea_recommender_tpu_torch/parallel/``) against
the reference package's.

The reference's ``parallel/{fused_ce,q_kernels,topk,sharding}.py`` run on
the 8 virtual CPU devices of tests/conftest.py, on a mesh of the same
shape ((1, 2), (2, 2) or (1, 4)), their Pallas kernels in interpret mode.
The port runs as one gloo process per rank on the CPU
(``tests/_torch_mesh_worker.py``: a pool of 2 and one of 4 ranks, spawned
once for the file), each rank given its columns (rows) of the head
(table) and, with ``data_axis``, its rows of the batch; the test joins
the ranks' pieces. On the CPU the wrappers take the kernels' plain twins,
at the shard's ``local_valid`` and shifted labels, exactly as the card's
kernels take them.

The cases follow tests/test_sharded_fused_ce.py, test_sharded_q_kernels.py
and test_sharding.py: values and gradients; a label on every shard (at the
shard edges); ties placed on both sides of a shard edge, which the lower
global id must win; a shard that is all padding (``local_valid`` 0: its
logsumexp must vanish in the merge, and no NaN); an action dim the model
axis does not divide, which raises.

Tolerances, those of the single-device tests of the same ops
(tests/test_torch_fused_ce.py, test_torch_fused_argmax.py): CE values atol
1e-5, their gradients atol 1e-6 + rtol 1e-5; row logits atol 1e-6, their
gradients atol 1e-6 + rtol 1e-5; maxima atol 1e-6; ids exact, tie order
included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import _torch_mesh_worker as W

from ikea_recommender_tpu.core.mesh import DATA_AXIS, MeshSpec, make_mesh
from ikea_recommender_tpu.parallel import fused_ce as jax_pce
from ikea_recommender_tpu.parallel import q_kernels as jax_pq
from ikea_recommender_tpu.parallel import sharding as jax_sharding
from ikea_recommender_tpu.parallel import topk as jax_ptopk
from ikea_recommender_tpu_torch.convert import numpy_init_double_q

B, F, K = 16, 8, 3


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    store = tmp_path_factory.mktemp("store")
    made = {2: W.RankPool(2, store), 4: W.RankPool(4, store)}
    yield made
    for pool in made.values():
        pool.close()


def _run(pools, case, spec, **kw):
    return pools[spec[0] * spec[1]].run(case, spec, **kw)


def _jmesh(spec):
    return make_mesh(MeshSpec(*spec), devices=jax.devices()[: spec[0] * spec[1]])


def _data_rows(results, key, spec):
    """A batch-split output joined over the data ranks (model index 0)."""
    return np.concatenate([results[d * spec[1]][key] for d in range(spec[0])])


def _model_cols(results, key, spec):
    """A column-sharded output joined over the model ranks (data index 0)."""
    return np.concatenate([results[m][key] for m in range(spec[1])], axis=-1)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_ranks_import_no_jax(pools):
    for world, spec in ((2, (1, 2)), (4, (2, 2))):
        assert pools[world].run(W.loaded_forbidden, spec) == [[]] * world


# (spec, data split, precision, A, valid): (1, 4) at valid 40 of 64 leaves
# shard 3 (48-63) all padding and shard 2 with 8 real columns
CE_CASES = [((1, 2), None, "highest", 64, 61), ((2, 2), DATA_AXIS, "high", 64, 61),
            ((1, 4), None, "highest", 64, 40), ((2, 2), DATA_AXIS, "highest", 72, 72)]


def _ce_inputs(A, valid, seed):
    rs = np.random.RandomState(seed)
    h = rs.randn(B, F).astype(np.float32)
    w = (rs.randn(F, A) * 0.3).astype(np.float32)
    b = (rs.randn(A) * 0.1).astype(np.float32)
    w[:, valid:] = np.nan  # padded columns never reach a result
    labels = rs.randint(0, valid, B).astype(np.int32)
    labels[:4] = [0, A // 2 - 1, A // 2, valid - 1]  # shard edges
    return h, w, b, labels, rs.rand(B).astype(np.float32)


@pytest.mark.parametrize("k", [0, 3], ids=["ce", "ce_topk"])
@pytest.mark.parametrize("spec,data_axis,precision,A,valid", CE_CASES,
                         ids=[f"{d}x{m}-{p}-valid{v}" for (d, m), _, p, _, v in CE_CASES])
def test_sharded_fused_ce_matches_reference(pools, spec, data_axis, precision, A, valid, k):
    """sharded_fused_softmax_ce (k = 0; B1/B2 per shard) and
    sharded_fused_softmax_ce_topk (the blockwise scan, B2): per-sample CE,
    ids, and dh, dW, db of sum(CE * weights)."""
    h, w, b, labels, wt = _ce_inputs(A, valid, seed=A + valid)
    mesh = _jmesh(spec)

    def loss(h, w, b):
        if k:
            per, ids = jax_pce.sharded_fused_softmax_ce_topk(
                h, w, b, jnp.asarray(labels), k, mesh, valid, data_axis, precision)
        else:
            per, ids = jax_pce.sharded_fused_softmax_ce(
                h, w, b, jnp.asarray(labels), mesh, valid, data_axis, precision), None
        return jnp.sum(per * wt), (per, ids)

    (_, (per, ids)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *_j(h, np.nan_to_num(w, nan=0.0), b))
    # the reference's gradient at the NaN columns: its inputs carry zeros there
    got = _run(pools, W.fused_ce, spec, h=h, w=w, b=b, labels=labels, valid=valid, weights=wt,
               data_axis=data_axis, precision=precision, k=k)
    rows = (lambda key: _data_rows(got, key, spec)) if data_axis else (lambda key: got[0][key])
    assert np.isfinite(rows("per")).all()
    np.testing.assert_allclose(rows("per"), np.asarray(per), atol=1e-5, rtol=0)
    if k:
        np.testing.assert_array_equal(rows("ids"), np.asarray(ids))
    np.testing.assert_allclose(rows("dh"), np.asarray(grads[0]), atol=1e-6, rtol=1e-5)
    for key, want in (("dw", grads[1]), ("db", grads[2])):
        joined = _model_cols(got, key, spec)
        np.testing.assert_allclose(joined[..., :valid], np.asarray(want)[..., :valid],
                                   atol=1e-6, rtol=1e-5, err_msg=key)
        assert (joined[..., valid:] == 0).all(), f"{key}: padded columns take gradient"
    if data_axis:  # the head's gradient is the whole batch's on every data rank
        for d in range(spec[0]):
            for m in range(spec[1]):
                np.testing.assert_array_equal(got[d * spec[1] + m]["dw"], got[m]["dw"])


def _tied_head(A, edge, seed, multi=False):
    """Integer h and head (products exact) whose best column is repeated at
    ``edge - 1`` and ``edge`` (both sides of a shard edge) and at the last
    valid column; the lower global id must win."""
    rs = np.random.RandomState(seed)
    h = rs.randint(0, 3, (B, F)).astype(np.float32)
    shape = (K, F, A) if multi else (F, A)
    w = rs.randint(-2, 3, shape).astype(np.float32)
    b = rs.randint(-2, 3, shape[:-2] + (A,) if multi else (A,)).astype(np.float32)
    w[..., edge - 1] = w[..., edge] = w[..., A - 4] = 9.0
    b[..., edge - 1] = b[..., edge] = b[..., A - 4] = 5.0
    return h, w, b


@pytest.mark.parametrize("spec", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
@pytest.mark.parametrize("multi", [False, True], ids=["B5", "B6"])
def test_sharded_argmax_matches_reference(pools, spec, multi):
    """B5 (sqn) or B6 (smorl, weights (1, 0.5, 2)) per shard with its max,
    merged: the ids equal the reference's, the ties at the shard edge to the
    lower global id, on random heads and on tied integer heads."""
    A, valid = 64, 61
    edge = A // spec[1]
    mesh = _jmesh(spec)
    qw = np.asarray([1.0, 0.5, 2.0], np.float32) if multi else None
    rs = np.random.RandomState(3)
    random_head = (rs.randn(B, F).astype(np.float32),
                   rs.randn(*((K, F, A) if multi else (F, A))).astype(np.float32),
                   rs.randn(*((K, A) if multi else (A,))).astype(np.float32))
    for h, w, b in (random_head, _tied_head(A, edge, seed=4, multi=multi)):
        if multi:
            want = jax_pq.sharded_weighted_multihead_argmax(*_j(h, w, b, qw), valid, mesh)
        else:
            want = jax_pq.sharded_linear_argmax(*_j(h, w, b), valid, mesh)
        got = _run(pools, W.argmax, spec, h=h, w=w, b=b, valid=valid, q_weights=qw)
        for r in got:
            np.testing.assert_array_equal(r, np.asarray(want))
    assert (got[0] == edge - 1).all()  # the tied heads: every row's best is the edge pair


@pytest.mark.parametrize("spec,data_axis", [((1, 2), None), ((2, 2), DATA_AXIS)],
                         ids=["1x2", "2x2-data"])
@pytest.mark.parametrize("multi", [False, True], ids=["row", "multihead"])
def test_sharded_row_logit_values_and_grads(pools, spec, data_axis, multi):
    rs = np.random.RandomState(5)
    A = 64
    h = rs.randn(B, F).astype(np.float32)
    w = rs.randn(*((K, F, A) if multi else (F, A))).astype(np.float32)
    b = rs.randn(*((K, A) if multi else (A,))).astype(np.float32)
    idx = rs.randint(0, A, B).astype(np.int32)
    idx[:3] = [A // 2 - 1, A // 2, A - 1]
    ct = rs.randn(*((B, K) if multi else (B,))).astype(np.float32)
    mesh = _jmesh(spec)
    fn = jax_pq.sharded_multihead_row_logit if multi else jax_pq.sharded_row_logit

    def loss(h, w, b):
        vals = fn(h, w, b, jnp.asarray(idx), mesh, data_axis)
        return jnp.sum(vals * ct), vals

    (_, vals), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *_j(h, w, b))
    got = _run(pools, W.row_logit, spec, h=h, w=w, b=b, idx=idx, ct=ct, data_axis=data_axis)
    rows = (lambda key: _data_rows(got, key, spec)) if data_axis else (lambda key: got[0][key])
    np.testing.assert_allclose(rows("vals"), np.asarray(vals), atol=1e-6, rtol=0)
    np.testing.assert_allclose(rows("dh"), np.asarray(grads[0]), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(_model_cols(got, "dw", spec), np.asarray(grads[1]), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(_model_cols(got, "db", spec), np.asarray(grads[2]), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("spec,valid", [((1, 2), 61), ((1, 4), 40)], ids=["1x2", "1x4-pad-shard"])
def test_sharded_multihead_max_matches_reference(pools, spec, valid):
    """sarm's target max per shard, "high", with a shard of padding only
    on (1, 4)."""
    rs = np.random.RandomState(6)
    h = rs.randn(B, F).astype(np.float32)
    w = rs.randn(5, F, 64).astype(np.float32)
    b = rs.randn(5, 64).astype(np.float32)
    want = jax_pq.sharded_multihead_max(*_j(h, w, b), valid, _jmesh(spec), precision="highest")
    got = _run(pools, W.multihead_max, spec, h=h, w=w, b=b, valid=valid, precision="highest")
    for r in got:
        np.testing.assert_allclose(r, np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("spec", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_sharded_head_topk_ce_matches_reference(pools, spec):
    """The eval/serving scan per shard: top-k values and global ids (ties
    across the shard edge to the lower id), the per-sample CE, and
    sharded_sup_topk's ids."""
    A, valid, k = 64, 61, 6
    edge = A // spec[1]
    h, w, b = _tied_head(A, edge, seed=7)
    w[:, edge + 1] = w[:, edge - 2] = 9.0  # four equal values over the edge
    b[edge + 1] = b[edge - 2] = 5.0
    labels = np.random.RandomState(8).randint(0, valid, B).astype(np.int32)
    mesh = _jmesh(spec)
    want_v, want_i, want_ce = jax_ptopk.sharded_head_topk_ce(
        *_j(h, w, b), k, valid, mesh, labels=jnp.asarray(labels))
    got = _run(pools, W.head_topk_ce, spec, h=h, w=w, b=b, k=k, valid=valid, labels=labels)
    for r in got:
        np.testing.assert_allclose(r["vals"], np.asarray(want_v), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(r["ids"], np.asarray(want_i))
        np.testing.assert_array_equal(r["sup_ids"], np.asarray(want_i))
        np.testing.assert_allclose(r["ce"], np.asarray(want_ce), atol=1e-5, rtol=0)
    assert (got[0]["ids"][:, :5] == [edge - 2, edge - 1, edge, edge + 1, A - 4]).all()


@pytest.mark.parametrize("spec", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_dense_arm_ops_match_reference(pools, spec):
    """The dense arm's ops over a shard's logits: sharded_top_k and
    sharded_softmax_ce against the reference's, the CE's gradient against
    the dense CE's (the reference's is not differentiable: its pmax has no
    derivative rule), sharded_argmax and sharded_take against numpy."""
    A, k = 64, 5
    edge = A // spec[1]
    rs = np.random.RandomState(9)
    logits = rs.randint(-20, 20, (B, A)).astype(np.float32) / 4.0
    logits[:, edge - 1] = logits[:, edge] = 10.0  # a tie over the shard edge
    labels = rs.randint(0, A, B).astype(np.int32)
    ct = rs.randn(B).astype(np.float32)
    values3 = rs.randn(B, K, A).astype(np.float32)
    mesh = _jmesh(spec)
    want_v, want_i = jax_ptopk.sharded_top_k(jnp.asarray(logits), k, mesh)
    want_ce = jax_ptopk.sharded_softmax_ce(*_j(logits, labels), mesh)
    dense_grad = jax.grad(lambda x: jnp.sum(
        optax.softmax_cross_entropy_with_integer_labels(x, jnp.asarray(labels)) * ct))(
        jnp.asarray(logits))
    got = _run(pools, W.dense_ops, spec, logits=logits, labels=labels, ct=ct, k=k,
               values3=values3)
    for r in got:
        np.testing.assert_allclose(r["vals"], np.asarray(want_v), atol=0, rtol=0)
        np.testing.assert_array_equal(r["ids"], np.asarray(want_i))
        np.testing.assert_allclose(r["per"], np.asarray(want_ce), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(r["argmax"], np.argmax(logits, axis=1))
        np.testing.assert_array_equal(r["take"], logits[np.arange(B), labels])
        np.testing.assert_array_equal(r["take3"], values3[np.arange(B), :, labels])
    assert (got[0]["ids"][:, 0] == edge - 1).all() and (got[0]["argmax"] == edge - 1).all()
    np.testing.assert_allclose(_model_cols(got, "dlogits", spec), np.asarray(dense_grad),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("spec,data_axis", [((1, 2), None), ((2, 2), DATA_AXIS), ((1, 4), None)],
                         ids=["1x2", "2x2-data", "1x4"])
def test_sharded_embedding_lookup_matches_reference(pools, spec, data_axis):
    rs = np.random.RandomState(10)
    V, E = 24, 5
    table = rs.randn(V, E).astype(np.float32)
    ids = rs.randint(0, V, (B, 4)).astype(np.int32)
    ids[0] = [0, V // 2 - 1, V // 2, V - 1]
    ct = rs.randn(B, 4, E).astype(np.float32)
    mesh = _jmesh(spec)

    def loss(t):
        vecs = jax_ptopk.sharded_embedding_lookup(t, jnp.asarray(ids), mesh, data_axis)
        return jnp.sum(vecs * ct), vecs

    (_, vecs), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(table))
    got = _run(pools, W.embedding, spec, table=table, ids=ids, ct=ct, data_axis=data_axis)
    rows = _data_rows(got, "vecs", spec) if data_axis else got[0]["vecs"]
    np.testing.assert_array_equal(rows, np.asarray(vecs))
    dtable = np.concatenate([got[m]["dtable"] for m in range(spec[1])])
    np.testing.assert_allclose(dtable, np.asarray(grad), atol=1e-6, rtol=1e-5)


def test_what_the_mesh_cannot_take_raises(pools):
    """An action dim the model axis does not divide raises where the
    reference's sharded ops raise (``not divisible``), in every entry point
    that takes a mesh, the lazy steps' too; sarm's lazy step on a mesh
    raises as the reference's does; nccl refuses CPU tensors."""
    with pytest.raises(ValueError, match="not divisible"):
        jax_pce.sharded_fused_softmax_ce(jnp.zeros((2, 4)), jnp.zeros((4, 66)),
                                         jnp.zeros((66,)), jnp.zeros((2,), jnp.int32),
                                         _jmesh((1, 4)), 66)
    got = _run(pools, W.raises, (1, 4), A=66)
    for r in got:
        for name in ("shard_width", "make_train_step", "EvalProtocol", "Recommender",
                     "lazy_gru4rec"):
            assert r[name] is not None and "not divisible by model axis 4" in r[name], name
        assert r["lazy"] == "ValueError: mesh + lazy is not supported for sarm"
        assert r["nccl_on_cpu"].startswith("ValueError") and "CUDA" in r["nccl_on_cpu"]


@pytest.mark.parametrize("layout", ["canonical", "lazy"])
def test_shard_and_gather_follow_the_reference_rules(pools, layout):
    """Each leaf splits where the reference's ``state_shardings`` puts the
    model axis (embedding rows, head columns; a leaf the axis does not
    divide stays whole; in the lazy action-major layout the whole Q head,
    its bias too, stays whole), and the gathered slices are the tree, bit
    for bit."""
    from ikea_recommender_tpu.train import state as jax_state
    from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
    from ikea_recommender_tpu_torch.models.families import model_config_from_train

    spec = (2, 2)
    # 70 items: 71 embedding rows (odd, stays whole); 70 actions (2 divides)
    mc = model_config_from_train(TrainConfig(model="smorl", embedding_size=4,
                                             hidden_state_size=4), DataConfig(num_items=70))
    pair = tuple(jax.tree.map(jnp.asarray, p) for p in numpy_init_double_q(mc))
    if layout == "lazy":
        pair = tuple(jax_state.lazy_qhead_params(p, "smorl") for p in pair)
    want = jax_sharding.state_shardings(pair, _jmesh(spec))
    pair = tuple(jax.tree.map(np.asarray, p) for p in pair)
    want_dims = [None if "model" not in s.spec else list(s.spec).index("model")
                 for s in jax.tree.leaves(want, is_leaf=lambda x: hasattr(x, "spec"))]
    got = _run(pools, W.shard_roundtrip, spec, tree=pair)
    from ikea_recommender_tpu_torch.convert import tree_leaves

    full = tree_leaves(pair)
    for r in got:
        assert r["dims"] == want_dims
        for a, w in zip(r["back"], full):
            np.testing.assert_array_equal(a, w)
    # 2 nets x sup (and, canonical, q) kernel and bias
    assert sum(d is not None for d in want_dims) == (8 if layout == "canonical" else 4)
    half = [s for s, d in zip(got[1]["shapes"], want_dims) if d is not None]
    assert all(s[-1] == 35 for s in half)


@pytest.mark.parametrize("model,pool,specs", [
    ("gru4rec", 4, [(1, 1), (2, 1), (2, 2)]),  # tests/test_serve_analysis.py's case
    ("smorl", 2, [(1, 1), (2, 1), (1, 2)]),  # chip_smoke.py's points
])
def test_scaling_bench_smoke(pools, model, pool, specs):
    """``run_scaling_bench`` at tests/test_serve_analysis.py's tiny width on
    a pool's gloo ranks: every rank gets the same points, one a spec, with
    the reference's meshes and global batches (its bench on the virtual
    devices); the first point's efficiency is 1, and on the CPU no card is
    used or shared."""
    from ikea_recommender_tpu.parallel.scaling_bench import run_scaling_bench as jax_bench

    kw = dict(model=model, per_device_batch=8, catalog=32, state_len=4, emb=8, hidden=8,
              warmup=1, iters=3)
    ranks = _run(pools, W.scaling_bench, (pool, 1), specs=specs, **kw)
    pts = ranks[0]
    assert all(r == pts for r in ranks[1:])
    want = jax_bench(mesh_specs=[MeshSpec(*s) for s in specs], **kw)
    assert [(p["mesh"], p["global_batch"]) for p in pts] == [
        (dict(w.mesh), w.global_batch) for w in want]
    assert pts[0]["efficiency"] == 1.0
    assert all(p["sessions_per_sec"] > 0 and p["steps_per_sec"] > 0 for p in pts)
    assert all(p["cards"] == 0 and not p["shared_card"] for p in pts)
