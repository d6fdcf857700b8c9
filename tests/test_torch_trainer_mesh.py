"""The port's trainer on a (data, model) mesh against the reference's.

The reference's ``run/trainer.py::train`` runs with ``ParallelConfig(data,
model)`` on the 8 virtual CPU devices of tests/conftest.py; the port's
``run/trainer.py::train`` runs with the same ``parallel:`` section as one
gloo process per rank on the CPU (``tests/_torch_mesh_worker.py``: a pool
of 2 and one of 4 ranks, spawned once for the file), each rank calling
``train`` with the same arguments. Both start from the reference's own
init at ``align = model``, drawn as tests/test_torch_trainer.py draws it
and passed to the port as ``init_params``; the reference's sqn and smorl
coins are drawn here and replayed inside each rank through ``coin=``.

The case matrix is the reference's tests/test_trainer_mesh.py, on (1, 2)
and (2, 2): every family's dense arm (the fused CE, one epoch, eval at 0.5
and 1), ``sharded_ce`` against the reference's, the ``parallel:`` YAML
section and the guards. tests/test_torch_trainer_mesh_lazy.py holds the
lazy arms, ``process_sharded: true`` and per-rank resume.

Tolerances, those of tests/test_torch_trainer.py (``_assert_runs_match``):
every loss rtol 1e-4; HR, NDCG, repetitions, coverage and the rewards
exactly but for what the valid rows near a tie can move (each rank counts
its rows within ``GAP`` of a tie, per train window and eval pass, and the
data ranks' counts add up); the best eval point exactly; the best params
1e-4 of each leaf's largest. Port only: after a run each leaf of the state
is bit-equal on the data ranks of one model index, and a replicated leaf
on every rank.
"""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import _torch_mesh_worker as W
from test_torch_trainer import A, E, GAP, _assert_runs_match, _buffers, _cfg, _smorl_inputs

from ikea_recommender_tpu.core import config as jax_config
from ikea_recommender_tpu.data import synthetic as jax_synth
from ikea_recommender_tpu.models.families import model_config_from_train as jax_mcft
from ikea_recommender_tpu.run import trainer as jax_trainer
from ikea_recommender_tpu.train import state as jax_state
from ikea_recommender_tpu_torch.convert import unflatten
from ikea_recommender_tpu_torch.core import config as port_config
from ikea_recommender_tpu_torch.data import synthetic as port_synth
from ikea_recommender_tpu_torch.data.item_frequency import unpopular_mask
from ikea_recommender_tpu_torch.run import trainer as port_trainer

DOUBLE_Q = ("sqn", "smorl")


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    store = tmp_path_factory.mktemp("store")
    made = {2: W.RankPool(2, store), 4: W.RankPool(4, store)}
    yield made
    for pool in made.values():
        pool.close()


def mesh_cfg(C, exp_dir, model, spec, epochs=1, **train_kw):
    """tests/test_torch_trainer.py's config (A 50, E 16, batch 32, 1230
    train rows) on the fused path, on a ``spec`` mesh."""
    if model == "bidir_gru4rec":
        train_kw.setdefault("dropout", 0.0)  # the two sides' masks come from different PRNGs
    if model == "sarm":
        train_kw.setdefault("sarm_gamma", 0.5)  # the reference's test's stable arm
    train_kw.setdefault("fused", True)
    par = {k: train_kw.pop(k) for k in ("sharded_ce", "process_sharded") if k in train_kw}
    cfg = _cfg(C, exp_dir, model, epochs, **train_kw)
    cfg.parallel = C.ParallelConfig(data=spec[0], model=spec[1], **par)
    return cfg


def jax_init(cfg, spec):
    """The reference trainer's init at ``align = model`` (its
    ``_build_state``), as numpy, and the sqn/smorl coins of ``n_steps``."""
    jmc = jax_mcft(cfg.train, cfg.data, align=spec[1])
    key = jax.random.key(cfg.seed)
    lr = cfg.train.learning_rate
    if cfg.train.model in DOUBLE_Q:
        st = jax_state.make_double_q_state(key, jmc, lr)[0]
        init = tuple(jax.tree.map(np.asarray, p) for p in st.params)
        return init, st.rng
    return jax.tree.map(np.asarray, jax_state.make_train_state(key, jmc, lr)[0].params), None


def coins_of(rng, n):
    return [int(jax.random.bernoulli(jax.random.fold_in(rng, s))) for s in range(n)]


def run_both(pools, tmp_path, model, spec, epochs=1, extra_ranks=None, **train_kw):
    """(reference outcome, each rank's result) of the same run."""
    jcfg = mesh_cfg(jax_config, tmp_path / "jax", model, spec, epochs, **train_kw)
    pcfg = mesh_cfg(port_config, tmp_path / "port", model, spec, epochs, **train_kw)
    extra = _smorl_inputs() if model == "smorl" else {}
    jtrain, jval = _buffers(jax_synth)
    want = jax_trainer.train(jcfg, train_buf=jtrain, val_buf=jval, **extra)
    init, rng = jax_init(jcfg, spec)
    ptrain, pval = _buffers(port_synth)
    n_steps = epochs * -(-len(ptrain) // pcfg.train.batch_size)
    got = pools[spec[0] * spec[1]].run(
        W.trainer, spec, cfg=pcfg, bufs=dict(train_buf=ptrain, val_buf=pval), init=init,
        coins=None if rng is None else coins_of(rng, n_steps), extra=extra, gap=GAP,
        **(extra_ranks or {}))
    return want, got, extra


def as_outcome(ranks, spec, extra):
    """Rank 0's outcome with its best params as tensors, and a protocol
    stand-in whose windows add the data ranks' near ties."""
    r0 = ranks[0]
    leads = [r for i, r in enumerate(ranks) if i % spec[1] == 0]  # model index 0
    windows = [tuple(map(sum, zip(*w))) for w in zip(*(r["windows"] for r in leads))]
    best = {k: torch.from_numpy(v) for k, v in r0["best_params"].items()}
    got = SimpleNamespace(logs=r0["logs"], pretrain_metrics=r0["pretrain"],
                          test_metrics=r0["test"], best_metric=r0["best_metric"],
                          best_epoch=r0["best_epoch"], best_params=unflatten(best))
    proto = SimpleNamespace(windows=windows,
                            unpopular_mask=unpopular_mask(extra.get("unpopular", set()), A))
    return got, proto


def assert_replicas(ranks, spec):
    """Every leaf bit-equal on the data ranks of one model index; a leaf
    that no rank splits, on every rank."""
    D, M = spec
    for name, (leaf, dim) in ranks[0]["leaves"].items():
        for r, out in enumerate(ranks):
            other, d = out["leaves"][name]
            assert d == dim, name
            if r % M == 0 or dim is None:
                np.testing.assert_array_equal(other, leaf, err_msg=f"rank {r} {name}")
        for m in range(M):
            for d_ in range(1, D):
                np.testing.assert_array_equal(ranks[d_ * M + m]["leaves"][name][0],
                                              ranks[m]["leaves"][name][0],
                                              err_msg=f"data ranks of model {m}: {name}")


def assert_ranks_agree(ranks):
    """Every rank logged, picked and tested the same numbers."""
    for out in ranks[1:]:
        for key in ("logs", "pretrain", "test", "best_metric", "best_epoch"):
            assert out[key] == ranks[0][key], key


# (spec, family): the reference's case matrix on both shapes of mesh
CASES = [((1, 2), f) for f in ("gru4rec", "bidir_gru4rec", "sqn", "smorl", "sarm")] + [
    ((2, 2), "gru4rec"), ((2, 2), "smorl")]


@pytest.mark.parametrize("spec,model", CASES, ids=[f"{m}-{s[0]}x{s[1]}" for s, m in CASES])
def test_mesh_train_matches_reference(pools, tmp_path, spec, model):
    """Every family's dense arm (the fused CE, the sharded heads) for one
    epoch; the best model's files are rank 0's, of the gathered params."""
    want, ranks, extra = run_both(pools, tmp_path, model, spec)
    got, proto = as_outcome(ranks, spec, extra)
    _assert_runs_match(want, got, proto, 2 if model in DOUBLE_Q else 1)
    assert_ranks_agree(ranks)
    assert_replicas(ranks, spec)
    saved = np.load(tmp_path / "port" / "best_model.npz")
    assert set(saved.files) == set(ranks[0]["best_params"])
    for k in saved.files:
        np.testing.assert_array_equal(saved[k], ranks[0]["best_params"][k])
    assert json.loads((tmp_path / "port" / "test_metrics.json").read_text()) == got.test_metrics


@pytest.mark.parametrize("fused", [False, True], ids=["resolved-off", "resolved-on"])
def test_sharded_ce_matches_reference(pools, tmp_path, fused):
    """``sharded_ce: true`` on (1, 2), gru4rec: the reference's
    ``sharded_fused_ce_raw_step`` always takes the fused, action-sharded CE,
    and so does the port's, whatever ``fused_ce`` resolved to (with it off,
    the reference's dense mesh arm would differ; with it on, the port's
    step is the fused mesh step, bit for bit)."""
    want, ranks, extra = run_both(pools, tmp_path, "gru4rec", (1, 2), fused=fused,
                                  sharded_ce=True)
    got, proto = as_outcome(ranks, (1, 2), extra)
    _assert_runs_match(want, got, proto, 1)
    assert_replicas(ranks, (1, 2))
    if fused:
        cfg = mesh_cfg(port_config, tmp_path / "plain", "gru4rec", (1, 2))
        init, _ = jax_init(mesh_cfg(jax_config, tmp_path / "j", "gru4rec", (1, 2)), (1, 2))
        ptrain, pval = _buffers(port_synth)
        plain = pools[2].run(W.trainer, (1, 2), cfg=cfg, init=init,
                             bufs=dict(train_buf=ptrain, val_buf=pval))
        assert plain[0]["logs"] == ranks[0]["logs"]
        assert plain[0]["test"] == ranks[0]["test"]


def test_parallel_config_from_yaml_and_the_cli(pools, tmp_path):
    """The ``parallel:`` section (both spellings) reaches the trainer from
    the YAML, and the CLI trains on a (1, 2) mesh of gloo ranks: rank 0
    alone writes the files; a batch the data axis does not divide raises
    before any rank is needed, as in the reference."""
    cfg = port_config.config_from_dict({"data": {"num_items": A},
                                        "train": {"model": "gru4rec", "batch_size": 16},
                                        "parallel": {"data": 4, "model": 2}})
    assert (cfg.parallel.data, cfg.parallel.model) == (4, 2)
    assert port_config.config_from_dict({"parallel": {"mesh": {"data": 2, "model": 1}}}
                                        ).parallel.data == 2
    bad = mesh_cfg(port_config, tmp_path / "bad", "gru4rec", (3, 1))
    train_buf, val_buf = _buffers(port_synth)
    with pytest.raises(ValueError, match="divide the data axis"):
        port_trainer.train(bad, train_buf=train_buf, val_buf=val_buf, device="cpu")

    exp = tmp_path / "exp"
    exp.mkdir()
    port_synth_buffers = _buffers(port_synth)
    port_synth_buffers[0].save_npz(str(exp / "train.npz"))
    port_synth_buffers[1].save_npz(str(exp / "val.npz"))
    (exp / "experiment.yaml").write_text(
        f"experiment:\n  seed: 0\n  save_pretrained_embeddings: true\n"
        f"data:\n  num_items: {A}\n  train_path: {exp}/train.npz\n  val_path: {exp}/val.npz\n"
        f"train:\n  model: gru4rec\n  batch_size: 32\n  val_batch_size: 64\n  epochs: 1\n"
        f"  embedding_size: {E}\n  hidden_state_size: {E}\n  state_size: 6\n"
        f"  eval_at: [0.5, 1.0]\n  fused_ce_min_actions: 0\n"
        f"parallel:\n  data: 1\n  model: 2\n")
    ranks = pools[2].run(W.trainer, (1, 2), cfg=None, bufs={},
                         cli_argv=["-f", str(exp / "experiment.yaml"), "--device", "cpu",
                                   "--backend", "gloo"])
    assert [r["seen"]["rc"] for r in ranks] == [0, 0]
    assert_ranks_agree(ranks)
    emb = np.load(exp / "embedding_weights.npy")
    assert emb.shape == (A + 2, E)  # 51 rows padded to the model axis
    np.testing.assert_array_equal(emb, ranks[0]["best_params"]["backbone/embedding"])
    assert json.loads((exp / "test_metrics.json").read_text()) == ranks[0]["test"]
    assert ranks[0]["logs"][-1]["Val_HR@10"] > ranks[0]["pretrain"]["Pretrain_Val_HR@10"]


@pytest.mark.parametrize("case", ["no_group", "wrong_world", "sharded_ce_family",
                                  "sarm_lazy", "no_backend"])
def test_mesh_guards(pools, tmp_path, monkeypatch, case):
    """A mesh config without a process group (or with one of another size)
    raises, naming torchrun and --backend; sharded_ce takes the CE families
    only; sarm's explicit lazy optimizer raises on a mesh, as the
    reference's does; the CLI under WORLD_SIZE > 1 wants --backend."""
    train_buf, val_buf = _buffers(port_synth)
    bufs = dict(train_buf=train_buf, val_buf=val_buf)
    if case == "no_group":
        with pytest.raises(RuntimeError, match=r"no process group.*torchrun.*--backend"):
            port_trainer.train(mesh_cfg(port_config, tmp_path, "gru4rec", (1, 2)),
                               device="cpu", **bufs)
    elif case == "wrong_world":
        got = pools[2].run(W.raises_in_train, (1, 2),
                           cfg=mesh_cfg(port_config, tmp_path, "gru4rec", (2, 2)), bufs=bufs)
        assert all("a process group of 2" in r and "torchrun" in r for r in got)
    elif case == "sharded_ce_family":
        with pytest.raises(ValueError, match="sharded_ce supports gru4rec/bidir_gru4rec only"):
            port_trainer.train(mesh_cfg(port_config, tmp_path, "sqn", (1, 2), sharded_ce=True),
                               device="cpu", **bufs)
    elif case == "sarm_lazy":
        with pytest.raises(ValueError, match="mesh \\+ lazy is not supported for sarm"):
            port_trainer.train(mesh_cfg(port_config, tmp_path, "sarm", (1, 2),
                                        optimizer="lazy_adam"), device="cpu", **bufs)
        got = pools[2].run(W.raises_in_train, (1, 2), bufs=bufs, cfg=mesh_cfg(
            port_config, tmp_path, "sarm", (1, 2), qhead_optimizer="lazy_adam"))
        assert all("unsupported here: sarm on a mesh" in r for r in got)
    else:
        from ikea_recommender_tpu_torch.run import cli

        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(SystemExit, match="--backend"):
            cli.main(["-f", str(tmp_path / "missing.yaml")])
