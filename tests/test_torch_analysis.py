"""The port's analysis modules and A.9c's public functions against the
reference package.

``analysis/{embeddings,trajectories,visualize}.py`` on ``device="cpu"``
(through the port's ``Recommender``) against the reference's functions
(JAX on the CPU, through its ``Recommender``) from the same numpy params
and buffers: the cases of ``tests/test_serve_analysis.py`` on both
packages. Similarities within atol 1e-6 (fp32, summation order), ids,
rows, trajectories, records and the HTML text equal. Then
``core/config.py::save_experiment_config`` read back by both loaders,
``train/state.py::select_net``, ``train/steps.py::batch_to_device_dict``
and ``ops/fused_argmax.py::take_cols_sorted``, exactly.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import as_jax_tree

from ikea_recommender_tpu.analysis import embeddings as jax_embeddings
from ikea_recommender_tpu.analysis import trajectories as jax_trajectories
from ikea_recommender_tpu.analysis import visualize as jax_visualize
from ikea_recommender_tpu.core import config as jax_config
from ikea_recommender_tpu.data import replay_buffer as jax_replay_buffer
from ikea_recommender_tpu.data import synthetic as jax_synthetic
from ikea_recommender_tpu.models import families as jax_families
from ikea_recommender_tpu.run.serve import Recommender as JaxRecommender
from ikea_recommender_tpu_torch.analysis import embeddings, trajectories, visualize
from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
from ikea_recommender_tpu_torch.core import config
from ikea_recommender_tpu_torch.data import replay_buffer, synthetic
from ikea_recommender_tpu_torch.models import families
from ikea_recommender_tpu_torch.run.serve import Recommender

A, T = 20, 5
SIM_ATOL = 1e-6


def _recommenders(model="gru4rec", seed=0):
    """The port's and the reference's recommender on the same numpy params."""
    kw = dict(model=model, embedding_size=8, hidden_state_size=8, state_size=T)
    mc = families.model_config_from_train(config.TrainConfig(**kw),
                                          config.DataConfig(num_items=A))
    jmc = jax_families.model_config_from_train(jax_config.TrainConfig(**kw),
                                               jax_config.DataConfig(num_items=A))
    np_params = numpy_init_params(mc, seed)
    return (Recommender(params_from_numpy(np_params, "cpu"), mc, device="cpu"),
            JaxRecommender(as_jax_tree(np_params), jmc))


def _buffers(num_sessions, seed):
    """The same synthetic train buffer in both packages' classes."""
    buf, _ = synthetic.synthetic_buffers(num_sessions=num_sessions, num_items=A, state_len=T,
                                         seed=seed)
    jbuf, _ = jax_synthetic.synthetic_buffers(num_sessions=num_sessions, num_items=A,
                                              state_len=T, seed=seed)
    for col in ("state", "action", "reward", "next_state", "true_len", "true_next_len",
                "is_end"):
        np.testing.assert_array_equal(getattr(buf, col), getattr(jbuf, col))
    return buf, jbuf


# -- embeddings -----------------------------------------------------------------


@pytest.mark.parametrize("case", ["reference", "ties"])
def test_embedding_analysis(case):
    """The reference's case, and one whose query has three neighbours of
    similarity 1 and two of 0: equal similarities go to the lower id, as
    ``lax.top_k`` orders them."""
    if case == "reference":
        emb = np.asarray([[1.0, 0.0], [0.9, 0.1], [0.0, 1.0], [-1.0, 0.0]], np.float32)
        k, queries = 2, [0]
    else:
        emb = np.asarray([[2.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 3.0], [3.0, 0.0],
                          [1.0, 0.0]], np.float32)
        k, queries = 5, [0, 3]
    sims = embeddings.cosine_similarity_matrix(emb, device="cpu")
    assert isinstance(sims, torch.Tensor) and sims.shape == (len(emb), len(emb))
    np.testing.assert_allclose(sims.numpy(), np.asarray(
        jax_embeddings.cosine_similarity_matrix(jnp.asarray(emb))), atol=SIM_ATOL)
    np.testing.assert_allclose(np.diag(sims.numpy()), 1.0, atol=1e-5)
    ids, vals = embeddings.nearest_neighbors(emb, queries, k=k, device="cpu")
    want_ids, want_vals = jax_embeddings.nearest_neighbors(jnp.asarray(emb),
                                                           jnp.asarray(queries), k=k)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(vals, want_vals, atol=SIM_ATOL)
    if case == "reference":
        assert ids[0, 0] == 1 and ids[0, 1] == 2  # e_x's closest is (0.9, 0.1)
    else:
        np.testing.assert_array_equal(ids, [[2, 4, 5, 1, 3], [1, 0, 2, 4, 5]])


# -- trajectories ---------------------------------------------------------------


def test_sample_trajectories():
    """The same ``rng`` gives the reference's trajectories."""
    rec, jrec = _recommenders()
    kw = dict(start_items=[1, 2, 7], steps=4, state_len=T, pad_id=A)
    got = trajectories.sample_trajectories(rec, rng=np.random.default_rng(5), **kw)
    want = jax_trajectories.sample_trajectories(jrec, rng=np.random.default_rng(5), **kw)
    assert got == want
    assert len(got) == 3 and all(len(t) == 5 for t in got)
    assert all(0 <= x < A for t in got for x in t[1:])
    # the default generator too
    assert (trajectories.sample_trajectories(rec, **kw)
            == jax_trajectories.sample_trajectories(jrec, **kw))


def test_trajectory_mining():
    buf, jbuf = _buffers(20, seed=0)
    for items in ([3], [3, 11], [A + 5]):
        rows = trajectories.find_action_rows(buf, items)
        np.testing.assert_array_equal(rows, jax_trajectories.find_action_rows(jbuf, items))
        assert np.isin(buf.action[rows], items).all()
        rows_s = trajectories.find_state_rows(buf, items)
        np.testing.assert_array_equal(rows_s, jax_trajectories.find_state_rows(jbuf, items))
        assert np.isin(buf.state[rows_s], items).any(axis=1).all()
    assert len(trajectories.find_action_rows(buf, [3]))  # the case is not empty


def test_predict_and_describe_with_pluggable_lookup():
    rec, jrec = _recommenders("sqn", seed=1)
    rs = np.random.RandomState(1)
    n = 6
    cols = dict(
        state=rs.randint(0, A, (n, T)),
        action=rs.randint(0, A, n),
        reward=rs.rand(n),
        next_state=rs.randint(0, A, (n, T)),
        true_len=rs.randint(1, T + 1, n),
        true_next_len=rs.randint(1, T + 1, n),
        is_end=rs.rand(n) < 0.5,
    )
    buf, jbuf = replay_buffer.ReplayBuffer(**cols), jax_replay_buffer.ReplayBuffer(**cols)
    lookup = lambda ids: {i: f"url://item/{i}" for i in ids}  # noqa: E731
    out = trajectories.predict_and_describe(rec, buf, rows=[0, 3], k=3, lookup_fn=lookup)
    assert out == jax_trajectories.predict_and_describe(jrec, jbuf, rows=[0, 3], k=3,
                                                        lookup_fn=lookup)
    assert len(out) == 2 and out[1]["row"] == 3 and len(out[0]["predictions"]) == 3
    for p in out[0]["predictions"]:
        assert p["meta"] == f"url://item/{p['item']}"
    # the metadata lookup is optional
    out2 = trajectories.predict_and_describe(rec, buf, rows=[1], k=2)
    assert out2 == jax_trajectories.predict_and_describe(jrec, jbuf, rows=[1], k=2)
    assert out2[0]["predictions"][0]["meta"] is None


# -- visualize ------------------------------------------------------------------


def test_find_hits_and_html_report(tmp_path):
    """The same hit rows (one batched pass a block: 7 rows a block here),
    records, HTML text and records JSON as the reference's."""
    rec, jrec = _recommenders()
    buf, jbuf = _buffers(30, seed=3)
    all_rows = visualize.find_hits(rec, buf, k=A, batch_size=7)
    np.testing.assert_array_equal(all_rows, np.arange(len(buf)))  # k = the catalog
    for k, kw in ((3, {}), (3, dict(batch_size=7, min_state_len=2)), (5, dict(max_rows=40))):
        got = visualize.find_hits(rec, buf, k=k, **kw)
        np.testing.assert_array_equal(got, jax_visualize.find_hits(jrec, jbuf, k=k, **kw))
        assert 0 < len(got) < len(buf)

    rows = list(range(3))
    lookup = lambda ids: {  # noqa: E731
        int(i): {"name": f"item {i}", "image_url": f"img/{i}.png"} for i in ids
    }
    records = trajectories.predict_and_describe(rec, buf, rows, k=4, lookup_fn=lookup)
    assert records == jax_trajectories.predict_and_describe(jrec, jbuf, rows, k=4,
                                                            lookup_fn=lookup)
    text = open(visualize.render_predictions_html(records, str(tmp_path / "a.html"))).read()
    want = open(jax_visualize.render_predictions_html(records, str(tmp_path / "b.html"))).read()
    assert text == want and "img/" in text and "row 0" in text
    assert (open(visualize.save_records_json(records, str(tmp_path / "a.json"))).read()
            == open(jax_visualize.save_records_json(records, str(tmp_path / "b.json"))).read())
    fig_path = visualize.plot_stream_and_predictions(records[0],
                                                     save_to=str(tmp_path / "preds.png"))
    assert os.path.getsize(fig_path) > 0


# -- A.9c's public functions ----------------------------------------------------


def test_save_experiment_config_round_trips(tmp_path):
    """Both packages' loaders read the port's file back to the Config
    written (exp_dir: the file's directory)."""
    cfg = config.Config(
        experiment=config.ExperimentConfig(exp_name="rr", seed=7,
                                           save_pretrained_embeddings=True),
        data=config.DataConfig(num_items=123, train_path="t.npz"),
        train=config.TrainConfig(model="smorl", batch_size=64, eval_at=[0.5, 1.0],
                                 q_weights=[1.0, 0.5, 2.0], preset="fast"),
        metrics=config.MetricsConfig(topk_hr_ndcg=[5, 10], action_type_names=["click", "buy"]),
        parallel=config.ParallelConfig(data=2, model=2),
        exp_dir=str(tmp_path),
    )
    path = str(tmp_path / "exp.yaml")
    config.save_experiment_config(cfg, path)
    assert config.load_experiment_config(path) == cfg
    want = jax_config.load_experiment_config(path)
    assert dataclasses.asdict(want) == dataclasses.asdict(cfg)
    # and the reference's writer's file reads back to the same Config
    jax_config.save_experiment_config(want, str(tmp_path / "ref.yaml"))
    assert open(path).read() == open(tmp_path / "ref.yaml").read()


def test_select_net():
    from ikea_recommender_tpu_torch.train.state import select_net

    pair = ({"w": torch.zeros(2)}, {"w": torch.ones(2)})

    assert select_net(pair, 0) is pair[0] and select_net(pair, 1) is pair[1]


def test_batch_to_device_dict():
    """The eight keys, with the dtypes the trainer feeds its steps."""
    from ikea_recommender_tpu_torch.train.steps import batch_to_device_dict

    buf, _ = _buffers(10, seed=2)
    batch = next(replay_buffer.train_batches(buf, 16, rng=np.random.default_rng(0)))
    got = batch_to_device_dict(batch, device="cpu")
    want = {"state": torch.int32, "action": torch.int32, "reward": torch.float32,
            "next_state": torch.int32, "true_len": torch.int32, "true_next_len": torch.int32,
            "is_end": torch.bool, "valid": torch.bool}
    assert {k: v.dtype for k, v in got.items()} == want
    for k, v in got.items():
        assert v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), getattr(batch, k))
    batch.state = batch.state.astype(np.int64)  # cast, as the steps take int32
    assert batch_to_device_dict(batch, device="cpu")["state"].dtype == torch.int32


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_take_cols_sorted(dim):
    """Equal to ``torch.index_select``, bit for bit, with duplicate and
    unsorted ids; and to the reference's."""
    from ikea_recommender_tpu.ops.fused_argmax import take_cols_sorted as jax_take
    from ikea_recommender_tpu_torch.ops.fused_argmax import take_cols_sorted

    rs = np.random.RandomState(dim)
    w = rs.randn(5, 6, 7).astype(np.float32)
    idx = np.asarray([3, 0, 3, w.shape[dim] - 1, 1, 0, 2], np.int32)[: w.shape[dim] + 2]
    got = take_cols_sorted(torch.as_tensor(w), torch.as_tensor(idx), dim)
    want = torch.index_select(torch.as_tensor(w), dim, torch.as_tensor(idx).long())
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_take(jnp.asarray(w),
                                                                    jnp.asarray(idx), dim)))
