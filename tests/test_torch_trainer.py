"""The port's trainer, CLI, checkpoints and train data against the reference.

The same numpy inputs go through the reference package (JAX on the CPU;
its fused arm runs the Pallas kernels in interpret mode) and the port on
``device="cpu"``, where the kernels' plain twins run. Both trainers start
from the JAX trainer's own init: the test draws it as the reference's
``_build_state`` does (``jax.random.key(cfg.seed)``) and passes it to the
port as ``init_params``. For sqn and smorl the reference's coins,
``bernoulli(fold_in(rng, step))``, are replayed into the port's step
through ``coin=`` by wrapping ``make_train_step`` as the trainer module
sees it.

Tolerances, fp32 with sums taken in other orders:
- every loss in the log dicts and the test metrics, rtol 1e-4;
- HR and NDCG (+1e-6), repetitions and coverage, and the rewards (+1e-5),
  exactly but for what the rows near a tie can move, as
  tests/test_torch_eval.py and chip_smoke.py bound them: a valid row whose
  top (max k + 1) scores under the port's params lie within ``GAP`` of
  each other may rank differently (each pass and each train window counts
  its own, through a recording subclass of the port's ``EvalProtocol``);
- the best eval point exactly; ``best_params`` per leaf, max abs diff at
  most 1e-4 of the leaf's largest entry.
The buffers, the synthetic data and the index matrices are held bit-equal.
Resume is held bit-identical on the port alone.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ikea_recommender_tpu.core import config as jax_config
from ikea_recommender_tpu.data import replay_buffer as jax_rb
from ikea_recommender_tpu.data import split as jax_split
from ikea_recommender_tpu.data import synthetic as jax_synth
from ikea_recommender_tpu.models.families import model_config_from_train as jax_mcft
from ikea_recommender_tpu.run import checkpoints as jax_ckpt
from ikea_recommender_tpu.run import trainer as jax_trainer
from ikea_recommender_tpu.train import state as jax_state
from ikea_recommender_tpu_torch.core import config as port_config
from ikea_recommender_tpu_torch.data import replay_buffer as port_rb
from ikea_recommender_tpu_torch.data import split as port_split
from ikea_recommender_tpu_torch.data import synthetic as port_synth
from ikea_recommender_tpu_torch.eval.protocol import EvalProtocol
from ikea_recommender_tpu_torch.run import checkpoints as port_ckpt
from ikea_recommender_tpu_torch.run import cli, logging_sinks
from ikea_recommender_tpu_torch.run import trainer as port_trainer

from _torch_parity import deterministic, jax_trainer_init, replay_jax_coins  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
A, E, T = 50, 16, 6
TOPK_HR, TOPK_COV = (5, 10), (1, 5)
GAP = 1e-4  # well above the two sides' score differences (~1e-6 here)


def _cfg(C, exp_dir, model="gru4rec", epochs=2, fused=False, train_metrics=True, **train_kw):
    kw = dict(fused_ce=fused, best_model_metric="Val_NDCG@10")
    if fused:
        kw["fused_ce_min_actions"] = 0  # the kernels' path at a catalog of 50
    kw.update(train_kw)
    return C.Config(
        experiment=C.ExperimentConfig(seed=0, save_pretrained_embeddings=True),
        data=C.DataConfig(num_items=A),
        train=C.TrainConfig(
            model=model, batch_size=32, val_batch_size=64, epochs=epochs, learning_rate=0.01,
            embedding_size=E, hidden_state_size=E, state_size=T,
            eval_at=[0.5, 1.0], **kw,
        ),
        metrics=C.MetricsConfig(topk_cov=list(TOPK_COV), topk_hr_ndcg=list(TOPK_HR), topk_div=1,
                                topk_nov=1, train_metrics=train_metrics),
        exp_dir=str(exp_dir),
    )


def _buffers(synth):
    """(train, val): 1230 train rows (38 full batches of 32 and a tail of
    14), 325 val rows (5 full batches of 64 and a tail of 5)."""
    train_buf, _ = synth.synthetic_buffers(num_sessions=150, num_items=A, state_len=T, seed=1)
    _, val_buf = synth.synthetic_buffers(num_sessions=40, num_items=A, state_len=T, seed=2)
    return train_buf, val_buf


def _smorl_inputs():
    rs = np.random.RandomState(0)
    return dict(div_embedding=rs.randn(A + 1, E).astype(np.float32),
                unpopular=set(range(0, A, 3)))


class _NearTies(EvalProtocol):
    """The port's protocol, recording for each finalize (a train window or
    an eval pass, in call order) (valid rows near a tie, valid rows)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.windows, self._near, self._n = [], 0, 0

    def update(self, params, accum, state, action, true_len, valid, action_type=None):
        vals = self.topk_ce(params, state, true_len, action, k=self._max_k + 1)[0]
        ok = torch.as_tensor(valid, dtype=torch.bool)
        self._near += int((ok & ((vals[:, :-1] - vals[:, 1:]) <= GAP).any(dim=1)).sum())
        self._n += int(ok.sum())
        return super().update(params, accum, state, action, true_len, valid, action_type)

    def finalize(self, accum):
        self.windows.append((self._near, self._n))
        self._near = self._n = 0
        return super().finalize(accum)


def _limit(key, near, n, proto):
    """How far the metric ``key`` may move for ``near`` of ``n`` rows."""
    n = max(n, 1)
    if "Loss" in key or key in ("Supervised Train Loss", "Q-Modification-Signal"):
        return None  # held by rtol
    k = int(key.rsplit("@", 1)[1].split("[")[0]) if "@" in key else 1
    if "_CV@" in key:
        total = max(int(proto.unpopular_mask.sum()), 1) if "NOV_CV" in key else A
        return near * k / total
    if "Div_Reward" in key:
        return 1e-5 + 2 * near / n
    if "Nov_Reward" in key:
        return 1e-5 + near / n
    if "_R@" in key:
        return near * k / n
    return (1e-6 if "NDCG" in key else 0.0) + near / n


def _assert_dict_close(got, want, windows, proto, what):
    """``windows`` maps a key's kind ("train", "val", "sec") to its (near, n)."""
    assert set(got) == set(want), what
    for key, w in want.items():
        g = got[key]
        kind = "sec" if key.startswith("Sec_") else (
            "train" if key.startswith("Train_") else "val")
        lim = _limit(key, *windows[kind], proto)
        if lim is None:
            assert g == pytest.approx(w, rel=1e-4), (what, key, g, w)
        else:
            assert abs(g - w) <= lim, (what, key, g, w, windows[kind])


def _run_both(monkeypatch, tmp_path, model, epochs, fused=False, train_metrics=True,
              **train_kw):
    jcfg = _cfg(jax_config, tmp_path / "jax", model, epochs, fused, train_metrics, **train_kw)
    pcfg = _cfg(port_config, tmp_path / "port", model, epochs, fused, train_metrics, **train_kw)
    extra = _smorl_inputs() if model == "smorl" else {}
    jtrain, jval = _buffers(jax_synth)
    want = jax_trainer.train(jcfg, train_buf=jtrain, val_buf=jval, **extra)
    init, rng = jax_trainer_init(jcfg)
    if rng is not None:
        replay_jax_coins(monkeypatch, rng)
    protos = []

    def recording(*args, **kw):
        protos.append(_NearTies(*args, **kw))
        return protos[-1]

    monkeypatch.setattr(port_trainer, "EvalProtocol", recording)
    ptrain, pval = _buffers(port_synth)
    got = port_trainer.train(pcfg, train_buf=ptrain, val_buf=pval, init_params=init,
                             device="cpu", **extra)
    return want, got, protos[0]


def _assert_runs_match(want, got, proto, n_nets, params_atol=0.0):
    """Every eval point's log dict, the best point, the test metrics and
    the best params (``params_atol`` on top of their tolerance, for runs
    whose moments are stored in bf16)."""
    win = proto.windows  # pretrain, then per point: train, val net 0 (, net 1); test
    assert len(win) == 1 + len(want.logs) * (1 + n_nets) + 1
    assert len(got.logs) == len(want.logs)
    _assert_dict_close(got.pretrain_metrics, want.pretrain_metrics, {"val": win[0]}, proto,
                       "pretrain")
    for i, (g, w) in enumerate(zip(got.logs, want.logs)):
        at = 1 + i * (1 + n_nets)
        kinds = {"train": win[at], "val": win[at + 1], "sec": win[at + n_nets]}
        _assert_dict_close(g, w, kinds, proto, f"eval point {i}")
    assert got.best_epoch == want.best_epoch
    at = 1 + want.best_epoch * (1 + n_nets)
    near, n = max(win[at + 1 : at + 1 + n_nets])
    assert abs(got.best_metric - want.best_metric) <= 1e-6 + near / n
    _assert_dict_close(got.test_metrics, want.test_metrics, {"val": win[-1]}, proto, "test")
    gp = port_ckpt.flatten_params(got.best_params)
    wp = jax_ckpt._flatten_params(want.best_params)
    assert set(gp) == set(wp)
    for k, w in wp.items():
        err = np.abs(gp[k] - w).max()
        assert err <= 1e-4 * np.abs(w).max() + params_atol, (k, err)


# -- 1. buffers and synthetic data ---------------------------------------------


@pytest.mark.parametrize("pad_pos", ["end", "beg"])
def test_synthetic_data_matches_reference(pad_pos):
    got = port_synth.synthetic_sessions(300, 40, mean_len=6, p_successor=0.7, seed=3)
    want = jax_synth.synthetic_sessions(300, 40, mean_len=6, p_successor=0.7, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    (gt, ge), (wt, we) = (m.synthetic_buffers(120, 30, state_len=5, pad_pos=pad_pos, seed=4,
                                              reward=0.5) for m in (port_synth, jax_synth))
    for col in ("state", "action", "reward", "next_state", "true_len", "true_next_len",
                "is_end"):
        np.testing.assert_array_equal(getattr(gt, col), getattr(wt, col))
        assert getattr(gt, col).dtype == getattr(wt, col).dtype
    for col in ("state", "action", "true_len"):
        np.testing.assert_array_equal(getattr(ge, col), getattr(we, col))


@pytest.mark.parametrize("seed", [118, 5])
def test_train_test_split_ids_matches_reference(seed):
    sids = np.repeat(np.random.RandomState(seed).permutation(97), 3)
    for g, w in zip(port_split.train_test_split_ids(sids, seed=seed),
                    jax_split.train_test_split_ids(sids, seed=seed)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == bool


def _random_replay(rs, n, with_type):
    return dict(
        state=rs.randint(0, 31, (n, T)), action=rs.randint(0, 30, n), reward=rs.rand(n),
        next_state=rs.randint(0, 31, (n, T)), true_len=rs.randint(1, T + 1, n),
        true_next_len=rs.randint(1, T + 1, n), is_end=rs.rand(n) < 0.2,
        action_type=rs.randint(0, 2, n) if with_type else None,
    )


_TRAIN_COLS = ("state", "action", "reward", "next_state", "true_len", "true_next_len",
               "is_end", "action_type")


def _same_buffer(got, want, cols=_TRAIN_COLS):
    for col in cols:
        g, w = getattr(got, col), getattr(want, col)
        assert (g is None) == (w is None), col
        if g is not None:
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype, col


@pytest.mark.parametrize("with_type", [False, True])
def test_replay_buffer_npz_round_trip_both_ways(tmp_path, with_type):
    cols = _random_replay(np.random.RandomState(6), 57, with_type)
    port_buf, jax_buf = port_rb.ReplayBuffer(**cols), jax_rb.ReplayBuffer(**cols)
    _same_buffer(port_buf, jax_buf)
    port_buf.save_npz(str(tmp_path / "port.npz"))
    jax_buf.save_npz(str(tmp_path / "jax.npz"))
    _same_buffer(jax_rb.ReplayBuffer(str(tmp_path / "port.npz")), jax_buf)
    _same_buffer(port_rb.ReplayBuffer(str(tmp_path / "jax.npz")), jax_buf)
    assert len(port_rb.ReplayBuffer(str(tmp_path / "jax.npz"))) == 57
    _same_buffer(port_rb.EvalBuffer.from_replay_buffer(port_buf),
                 jax_rb.EvalBuffer.from_replay_buffer(jax_buf),
                 ("state", "action", "true_len", "action_type"))


def test_replay_buffer_from_pickled_dataframe(tmp_path):
    pd = pytest.importorskip("pandas")
    cols = _random_replay(np.random.RandomState(7), 23, False)
    df = pd.DataFrame({
        "state": list(cols["state"]), "action": cols["action"], "r_act": cols["reward"],
        "next_state": list(cols["next_state"]), "true_state_len": cols["true_len"],
        "true_next_state_len": cols["true_next_len"], "is_end": cols["is_end"],
    })
    path = str(tmp_path / "buf.df")
    df.to_pickle(path)
    _same_buffer(port_rb.ReplayBuffer(path), jax_rb.ReplayBuffer(path))
    _same_buffer(port_rb.ReplayBuffer.from_dataframe(df), jax_rb.ReplayBuffer.from_dataframe(df))


@pytest.mark.parametrize("drop_last", [False, True])
def test_train_batches_match_reference(drop_last):
    cols = _random_replay(np.random.RandomState(8), 70, False)
    got = list(port_rb.train_batches(port_rb.ReplayBuffer(**cols), 16,
                                     np.random.default_rng(3), drop_last=drop_last))
    want = list(jax_rb.train_batches(jax_rb.ReplayBuffer(**cols), 16,
                                     np.random.default_rng(3), drop_last=drop_last))
    assert len(got) == len(want) == (4 if drop_last else 5)
    for g, w in zip(got, want):
        _same_buffer(g, w, _TRAIN_COLS[:-1] + ("valid",))


@pytest.mark.parametrize("n", [64, 70, 5])
def test_window_index_matrices_match_reference(n):
    perm = np.random.default_rng(n).permutation(n).astype(np.int32)
    got = port_trainer._window_index_matrices(perm, 32)
    want = jax_trainer._window_index_matrices(perm, 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


# -- 2, 3. the trainers side by side ---------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("train_metrics", [True, False], ids=["metrics", "no-metrics"])
def test_gru4rec_train_matches_reference(monkeypatch, tmp_path, fused, train_metrics):
    want, got, proto = _run_both(monkeypatch, tmp_path, "gru4rec", 2, fused, train_metrics)
    _assert_runs_match(want, got, proto, 1)
    if not train_metrics:
        assert got.logs[-1]["Train_HR@10"] == 0.0 and proto.windows[1] == (0, 0)
    assert got.logs[-1]["Val_HR@10"] > got.pretrain_metrics["Pretrain_Val_HR@10"]
    assert set(got.timing) == {"idx_build", "dispatch", "sync", "eval"}
    assert got.throughput_sessions_per_sec > 0


@pytest.mark.parametrize("model", ["sqn", "smorl"])
def test_double_q_train_matches_reference(monkeypatch, tmp_path, model):
    want, got, proto = _run_both(monkeypatch, tmp_path, model, 1)
    _assert_runs_match(want, got, proto, 2)
    for log in got.logs:
        assert {"Sec_Val_HR@10", "Sec_Val_NDCG@10", "Q-Modification-Signal"} <= set(log)
    meta = json.loads((tmp_path / "port" / "best_model.json").read_text())
    assert meta["model_idx"] in (1, 2) and meta["metric_name"] == "Val_NDCG@10"
    if model == "smorl":
        assert got.logs[-1]["Val_Div_Reward"] > 0


@pytest.mark.parametrize("fused,gamma", [(False, 0.99), (True, 0.99), (True, 0.5)],
                         ids=["dense", "fused", "fused-gamma-0.5"])
def test_sarm_train_matches_reference(monkeypatch, tmp_path, fused, gamma):
    """sarm (one net of five Q heads, scored by head 0) for one epoch; the
    config's ``sarm_gamma`` must reach the step."""
    want, got, proto = _run_both(monkeypatch, tmp_path, "sarm", 1, fused, sarm_gamma=gamma)
    _assert_runs_match(want, got, proto, 1)
    for log in got.logs:
        assert "Q-Modification-Signal" in log and not any(k.startswith("Sec_") for k in log)
        assert all(np.isfinite(v) for v in log.values())
    meta = json.loads((tmp_path / "port" / "best_model.json").read_text())
    assert meta["model_idx"] == 1


# -- 4. resume --------------------------------------------------------------------


def _port_run(exp_dir, epochs, **kw):
    train_buf, val_buf = _buffers(port_synth)
    return port_trainer.train(_cfg(port_config, exp_dir, epochs=epochs, **kw),
                              train_buf=train_buf, val_buf=val_buf, device="cpu")


def test_resume_is_bit_identical(tmp_path, deterministic):
    """sqn: a 1-epoch run and a resume to epoch 2 give the uninterrupted
    run's epoch 2, best point and test metrics bit for bit (the payload
    carries the coin generator's state)."""
    full = _port_run(tmp_path / "full", 2, model="sqn")
    ckpt = str(tmp_path / "ckpt")
    _port_run(tmp_path / "leg1", 1, model="sqn", checkpoint_dir=ckpt)
    assert sorted(os.listdir(ckpt)) == ["ckpt_1.pt"]
    resumed = _port_run(tmp_path / "leg2", 2, model="sqn", checkpoint_dir=ckpt, resume=True)
    assert resumed.logs == full.logs[2:]
    assert (resumed.best_metric, resumed.best_epoch) == (full.best_metric, full.best_epoch)
    assert resumed.test_metrics == full.test_metrics
    assert sorted(os.listdir(ckpt)) == ["ckpt_1.pt", "ckpt_2.pt"]


def test_resume_keeps_an_earlier_best(tmp_path, deterministic):
    """The best point is epoch 1's first (the lowest Val_HR@10 in "min"
    mode); a resumed run still ships those params, not its last ones."""
    kw = dict(best_model_metric="Val_HR@10", best_model_mode="min")
    full = _port_run(tmp_path / "full", 3, **kw)
    assert full.best_epoch == 0
    ckpt = str(tmp_path / "ckpt")
    _port_run(tmp_path / "leg1", 2, checkpoint_dir=ckpt, **kw)
    resumed = _port_run(tmp_path / "leg2", 3, checkpoint_dir=ckpt, resume=True, **kw)
    assert (resumed.best_metric, resumed.best_epoch) == (full.best_metric, 0)
    assert resumed.test_metrics == full.test_metrics
    for k, v in port_ckpt.flatten_params(full.best_params).items():
        np.testing.assert_array_equal(port_ckpt.flatten_params(resumed.best_params)[k], v)
    # the fresh exp_dir got the restored best model's files
    assert json.loads((tmp_path / "leg2" / "best_model.json").read_text())["epoch"] == 0


# -- 5. the CLI -------------------------------------------------------------------


@pytest.mark.parametrize("stager", ["script", "port"])
def test_cli_trains_on_prepare_synthetic_output(tmp_path, monkeypatch, capsys, stager):
    """The port's CLI on the experiment that ``scripts/prepare_synthetic.py``
    or the port's ``run.prepare_synthetic`` (run with pandas and jax
    unimportable) writes."""
    if stager == "script":
        cmd = [sys.executable, str(REPO / "scripts" / "prepare_synthetic.py"), str(tmp_path)]
    else:
        cmd = [sys.executable, "-c", "import sys; sys.modules['pandas'] = sys.modules['jax'] = "
               "None; from ikea_recommender_tpu_torch.run.prepare_synthetic import main; "
               f"main({str(tmp_path)!r})"]
    subprocess.run(cmd, check=True, capture_output=True, timeout=300, cwd=REPO,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    yaml_path = tmp_path / "experiment.yaml"
    text = yaml_path.read_text()
    yaml_path.write_text(text.replace('model: "smorl"', 'model: "gru4rec"')
                         .replace("epochs: 3", "epochs: 1"))
    logged = []
    monkeypatch.setattr(cli, "make_log_sinks",
                        lambda cfg: (lambda d, step: logged.append(dict(d)), lambda: None))
    capsys.readouterr()
    assert cli.main(["-f", str(yaml_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    printed = json.loads(out[out.index("{"): out.rindex("\nbest ")])
    assert printed == json.loads((tmp_path / "test_metrics.json").read_text())
    assert "Test_HR@10" in printed  # test.npz differs from val.npz
    assert out.strip().splitlines()[-1].startswith("best Val_NDCG@10=")

    jcfg = jax_config.load_experiment_config(str(yaml_path))
    template = jax_state.make_train_state(jax.random.key(0), jax_mcft(jcfg.train, jcfg.data),
                                          0.01)[0].params
    best = jax_ckpt.load_params_npz(template, str(tmp_path / "best_model.npz"))
    emb = np.load(tmp_path / "embedding_weights.npy")
    assert emb.shape == (201, 64)
    np.testing.assert_array_equal(np.asarray(best["backbone"]["embedding"]), emb)
    pretrain, points = logged[0], [d for d in logged[1:-1]]
    assert len(points) == 2 and logged[-1] == printed
    assert points[-1]["Val_HR@10"] > pretrain["Pretrain_Val_HR@10"]


# -- 6. guards --------------------------------------------------------------------


def _guard_cfg(tmp_path, **train_kw):
    return _cfg(port_config, tmp_path, epochs=1, **train_kw)


def _yaml(tmp_path):
    path = tmp_path / "experiment.yaml"
    path.write_text("data:\n  num_items: 9\n  train_path: missing.npz\n")
    return path


# The reference's preconditions of the lazy optimizers: where one fails, a
# qhead_optimizer from ``preset: fast`` falls back to dense Adam with a line
# ("fallback"), and an explicit setting raises ValueError.
GUARDS = {
    "lazy_adam": (dict(model="sqn", optimizer="lazy_adam", double_q_optimizers=1),
                  "lazy optimizers need double_q_optimizers=2"),
    "qhead_lazy_adam": (dict(model="sqn", qhead_optimizer="lazy_adam", double_q_optimizers=1),
                        "unsupported here: double_q_optimizers=1"),
    "preset_fast_sqn": (dict(model="sqn", preset="fast", head_idx=1, fused=True),
                        "fallback: head_idx != 0"),
    "preset_fast_sarm": (dict(model="sarm", preset="fast"),
                         "fallback: the fused train path resolved off"),
    "qhead_lazy_sarm": (dict(model="sarm", qhead_optimizer="lazy_adam"),
                        "unsupported here: the fused train path resolved off"),
}


@pytest.mark.parametrize("case", [
    "smorl_warns", "smorl_require_div_emb", *GUARDS, "parallel", "sharded_ce",
    "process_sharded", "div_embedding_files", "log_sinks_off", "profile_dir", "no_cuda",
])
def test_guards(tmp_path, monkeypatch, capsys, case):
    train_buf, val_buf = _buffers(port_synth)
    bufs = dict(train_buf=train_buf, val_buf=val_buf)
    if case in ("smorl_warns", "smorl_require_div_emb"):
        cfg = _guard_cfg(tmp_path, model="smorl")
        if case == "smorl_warns":
            with pytest.warns(RuntimeWarning, match="no diversity embedding"):
                out = port_trainer.train(cfg, unpopular={1, 2}, device="cpu", **bufs)
            assert out.logs[-1]["Val_Div_Reward"] == 0.0
        else:
            cfg.metrics.require_div_emb = True
            with pytest.raises(ValueError, match="no diversity embedding"):
                port_trainer.train(cfg, device="cpu", **bufs)
    elif case in GUARDS:
        kw, what = GUARDS[case]
        cfg = _guard_cfg(tmp_path, **kw)
        if what.startswith("fallback: "):
            out = port_trainer.train(cfg, device="cpu", **bufs)
            assert all(np.isfinite(v) for v in out.logs[-1].values())
            assert (f"[trainer] {what[len('fallback: '):]}"
                    in capsys.readouterr().out.split(": preset-fast qhead_optimizer falls back "
                                                     "to dense Adam")[0])
        else:
            with pytest.raises(ValueError, match=what):
                port_trainer.train(cfg, device="cpu", **bufs)
    elif case in ("parallel", "sharded_ce", "process_sharded"):
        # a mesh needs its ranks' process group (tests/test_torch_trainer_mesh*.py
        # train on one); sharded_ce and process_sharded need a mesh, as the
        # reference's checks say
        cfg = _guard_cfg(tmp_path)
        setattr(cfg.parallel, *{"parallel": ("data", 2), "sharded_ce": ("sharded_ce", True),
                                "process_sharded": ("process_sharded", True)}[case])
        if case == "parallel":
            with pytest.raises(RuntimeError, match=r"torchrun.*--backend"):
                port_trainer.train(cfg, device="cpu", **bufs)
        else:
            with pytest.raises(ValueError, match=f"{case} requires a multi-device mesh"):
                port_trainer.train(cfg, device="cpu", **bufs)
    elif case == "div_embedding_files":
        emb = np.random.RandomState(9).randn(A + 1, 4).astype(np.float32)
        np.save(tmp_path / "e.npy", emb)
        np.savez(tmp_path / "e.npz", embedding=emb)
        np.savez(tmp_path / "other.npz", weights=emb)
        torch.save(torch.from_numpy(emb), tmp_path / "e.pt")
        for name in ("e.npy", "e.npz", "other.npz", "e.pt"):
            got = port_trainer.load_div_embedding(str(tmp_path / name))
            want = jax_trainer.load_div_embedding(str(tmp_path / name))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, emb)
    elif case == "profile_dir":
        cfg = _guard_cfg(tmp_path, profile_dir=str(tmp_path / "trace"))
        port_trainer.train(cfg, device="cpu", **bufs)
        (trace,) = (tmp_path / "trace").iterdir()
        assert json.loads(trace.read_text())["traceEvents"]
    elif case == "log_sinks_off":
        log_fn, close_fn = logging_sinks.make_log_sinks(_guard_cfg(tmp_path))
        assert log_fn({"a": 1.0}, 0) is None and close_fn() is None
        assert not (tmp_path / "tensorboard").exists()
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_trainer.train(_guard_cfg(tmp_path), **bufs)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["-f", str(_yaml(tmp_path))])
