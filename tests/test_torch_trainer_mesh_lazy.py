"""The port's trainer on a (data, model) mesh with the lazy optimizers,
process-sharded train rows and per-rank resume, against the reference's.

As tests/test_torch_trainer_mesh.py: the reference's ``run/trainer.py::
train`` with ``ParallelConfig(data, model)`` on the 8 virtual CPU devices,
the port's as one gloo process per rank (a pool of 2 and one of 4 ranks,
spawned once for the file), both from the reference's init at ``align =
model``, the sqn and smorl coins replayed inside each rank.

The lazy arms follow the reference's tests/test_trainer_mesh.py (lazy Q
heads on a mesh, "the `preset: fast` arm's multi-chip path"): fp32 moments
and "highest" head products, as its lazy test holds them, on the fused
path. The cases: lazy embedding rows for gru4rec and bidir_gru4rec, lazy Q
heads for sqn and smorl, and both together, on (1, 2) and (2, 2); sarm's
``preset: fast`` falls back to dense Adam on a mesh. ``process_sharded:
true`` on (2, 2) against the reference's process-sharded run, each rank's
batches held to the reference's ``_sharded_index_matrices`` on the host.

Tolerances, those of tests/test_torch_trainer.py, as in the dense file.
Port only: the replicated leaves (the lazy Q head and its moments, the GRU
weights) bit-equal on every rank, each leaf bit-equal on the data ranks of
one model index; a resumed run bit-identical to the uninterrupted one on
every rank (under ``torch.use_deterministic_algorithms``); a checkpoint of
another mesh shape refused.
"""

import os

import numpy as np
import pytest
import _torch_mesh_worker as W
from test_torch_trainer import _assert_runs_match, _buffers
from test_torch_trainer_mesh import (
    DOUBLE_Q,
    as_outcome,
    assert_ranks_agree,
    assert_replicas,
    coins_of,
    jax_init,
    mesh_cfg,
    run_both,
)

from ikea_recommender_tpu.core import config as jax_config
from ikea_recommender_tpu.run import trainer as jax_trainer
from ikea_recommender_tpu_torch.core import config as port_config
from ikea_recommender_tpu_torch.data import synthetic as port_synth
from ikea_recommender_tpu_torch.run import trainer as port_trainer


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    store = tmp_path_factory.mktemp("store")
    made = {2: W.RankPool(2, store), 4: W.RankPool(4, store)}
    yield made
    for pool in made.values():
        pool.close()


EMB = dict(optimizer="lazy_adam")
QH = dict(qhead_optimizer="lazy_adam")
# (spec, family, lazy parts)
CASES = [
    ((2, 2), "gru4rec", EMB), ((1, 2), "bidir_gru4rec", EMB),
    ((2, 2), "sqn", QH), ((1, 2), "smorl", QH),
    ((1, 2), "sqn", {**EMB, **QH}), ((2, 2), "smorl", {**EMB, **QH}),
]


def _id(case):
    spec, model, lazy = case
    return f"{model}-{'+'.join(sorted(k.split('_')[0] for k in lazy))}-{spec[0]}x{spec[1]}"


@pytest.mark.parametrize("spec,model,lazy", CASES, ids=[_id(c) for c in CASES])
def test_lazy_mesh_train_matches_reference(pools, tmp_path, spec, model, lazy):
    """One epoch with lazy embedding rows (row-sharded with the table, the
    global batch's rows gathered over the data axis) and/or lazy Q heads
    (replicated, the target action from the data-parallel island); the
    best model saved in the lazy layout."""
    want, ranks, extra = run_both(pools, tmp_path, model, spec, head_precision="highest",
                                  **lazy)
    got, proto = as_outcome(ranks, spec, extra)
    _assert_runs_match(want, got, proto, 2 if model in DOUBLE_Q else 1)
    assert_ranks_agree(ranks)
    assert_replicas(ranks, spec)
    leaves = ranks[0]["leaves"]
    if "qhead_optimizer" in lazy:
        head = "q_head" if model == "sqn" else "q_heads"
        assert f"{head}/kernel_am" in ranks[0]["best_params"]
        # the lazy Q head and its moments stay whole on every rank
        assert all(leaves[f"net0/{head}/{k}"][1] is None for k in ("kernel_am", "bias"))
        assert leaves["opt0/qh_mv"][1] is None
    if "optimizer" in lazy:
        assert leaves["net0/backbone/embedding"][1] == 0 and leaves["opt0/emb_mv"][1] == 0


def test_sarm_preset_fast_falls_back_on_a_mesh(pools, tmp_path):
    """sarm's lazy layout splits off a densely updated head 0: on a mesh the
    ``preset: fast`` setting falls back to dense Adam with the reference's
    ``[trainer]`` line (rank 0 alone prints it), and trains."""
    cfg = mesh_cfg(port_config, tmp_path, "sarm", (1, 2), preset="fast",
                   head_precision="highest")
    train_buf, val_buf = _buffers(port_synth)
    ranks = pools[2].run(W.trainer, (1, 2), cfg=cfg,
                         bufs=dict(train_buf=train_buf, val_buf=val_buf))
    line = ("[trainer] sarm on a mesh (head-0 dense split): preset-fast qhead_optimizer "
            "falls back to dense Adam")
    assert line in ranks[0]["printed"] and line not in ranks[1]["printed"]
    assert all(np.isfinite(v) for v in ranks[0]["logs"][-1].values())
    assert "q_heads/kernel" in ranks[0]["best_params"]


def test_sharded_index_matrices_match_reference():
    for n, D, B in ((1230, 2, 32), (7, 4, 8), (64, 2, 16)):
        per = -(-n // D)
        got = port_trainer._sharded_index_matrices(np.random.default_rng(n), n, per, D, B)
        want = jax_trainer._sharded_index_matrices(np.random.default_rng(n), n, per, D, B)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def test_process_sharded_matches_reference(pools, tmp_path):
    """``process_sharded: true`` on (2, 2), gru4rec: each rank holds only
    its data index's block of ``ceil(n / D)`` rows, its batches are the rows
    the reference's ``_sharded_index_matrices`` names for its data index,
    and the run is the reference's process-sharded one."""
    want, ranks, extra = run_both(pools, tmp_path, "gru4rec", (2, 2), process_sharded=True,
                                  extra_ranks=dict(hook="batch_rows"))
    got, proto = as_outcome(ranks, (2, 2), extra)
    _assert_runs_match(want, got, proto, 1)
    assert_ranks_agree(ranks)
    assert_replicas(ranks, (2, 2))
    train_buf, _ = _buffers(port_synth)
    n, D, B = len(train_buf), 2, 32
    per = -(-n // D)
    idx, valid = port_trainer._sharded_index_matrices(np.random.default_rng(0), n, per, D, B)
    state = np.zeros((D * per, train_buf.state.shape[1]), train_buf.state.dtype)
    state[:n] = train_buf.state
    row_bytes = sum(np.asarray(getattr(train_buf, c))[:1].nbytes for c in (
        "state", "action", "reward", "next_state", "true_len", "true_next_len", "is_end"))
    for r, out in enumerate(ranks):
        d = r // 2
        assert out["seen"]["train_bytes"] == per * row_bytes
        batches = out["seen"]["batches"]
        assert len(batches) == len(idx)
        for i, (rows, ok) in enumerate(batches):
            np.testing.assert_array_equal(rows, state[d * per + idx[i, d]])
            np.testing.assert_array_equal(ok, valid[i, d])


def _port_runs(pools, tmp_path, spec, model, lazy):
    """``run(sub, epochs, **train_kw)``: the port's trainer on ``spec``
    from the reference's init, its coins replayed, deterministic."""
    init, rng = jax_init(mesh_cfg(jax_config, tmp_path / "jax", model, spec), spec)
    train_buf, val_buf = _buffers(port_synth)
    coins = None if rng is None else coins_of(rng, 2 * -(-len(train_buf) // 32))

    def run(sub, epochs, **kw):
        c = mesh_cfg(port_config, tmp_path / sub, model, spec, epochs=epochs,
                     head_precision="highest", **lazy, **kw)
        return pools[spec[0] * spec[1]].run(
            W.trainer, spec, cfg=c, init=init, coins=coins, deterministic=True,
            bufs=dict(train_buf=train_buf, val_buf=val_buf))

    return run


def test_resume_per_rank_is_bit_identical(pools, tmp_path):
    """sqn with lazy embedding rows and lazy Q heads on (2, 2): a 1-epoch run
    with per-rank checkpoints and a resume to epoch 2 give the
    uninterrupted run's epoch 2, best point, test metrics, best model and
    every rank's final slice bit for bit. A (1, 2) mesh refuses those
    checkpoints, naming both shapes."""
    spec, model, lazy = (2, 2), "sqn", {**EMB, **QH}
    run = _port_runs(pools, tmp_path, spec, model, lazy)
    full = run("full", 2)
    ckpt = str(tmp_path / "ckpt")
    run("leg1", 1, checkpoint_dir=ckpt)
    assert sorted(os.listdir(ckpt)) == [f"ckpt_1.rank{r}-of-4.pt" for r in range(4)]
    resumed = run("leg2", 2, checkpoint_dir=ckpt, resume=True)
    assert sorted(os.listdir(ckpt)) == sorted(f"ckpt_{s}.rank{r}-of-4.pt"
                                              for s in (1, 2) for r in range(4))
    for f, r in zip(full, resumed):
        assert r["logs"] == f["logs"][2:]
        assert (r["best_metric"], r["best_epoch"], r["test"]) == (
            f["best_metric"], f["best_epoch"], f["test"])
        for name, (leaf, _) in f["leaves"].items():
            np.testing.assert_array_equal(r["leaves"][name][0], leaf, err_msg=name)
    for k, v in full[0]["best_params"].items():
        np.testing.assert_array_equal(resumed[0]["best_params"][k], v)
    saved = [np.load(tmp_path / sub / "best_model.npz") for sub in ("full", "leg2")]
    assert all(np.array_equal(saved[0][k], saved[1][k]) for k in saved[0].files)

    cfg = mesh_cfg(port_config, tmp_path / "other", model, (1, 2), epochs=2,
                   head_precision="highest", checkpoint_dir=ckpt, resume=True, **lazy)
    train_buf, val_buf = _buffers(port_synth)
    got = pools[2].run(W.raises_in_train, (1, 2), cfg=cfg,
                       bufs=dict(train_buf=train_buf, val_buf=val_buf))
    assert all("(2, 2) mesh" in r and "(1, 2) mesh" in r for r in got), got
