"""The port's IKEA rehearsal (``run/ikea_rehearsal.py``, numpy only) and its
columns path (``data/ikea_columns.py``) against ``scripts/ikea_rehearsal.py``
and the reference's ``data/ikea.py`` (pandas), at the size of
``tests/test_ikea_rehearsal.py`` (1500 sessions, 400 products, 80 images,
state_len 8, future_steps 3).

- ``synth``: the events' columns equal the script's DataFrame's, and
  ``synth_meta.json`` byte for byte;
- ``buffers``: every array of the three buffers bit for bit (dtypes too),
  the tokenizer files, ``meta.json`` and ``unpopular_items.json`` byte for
  byte; again with pandas unimportable;
- the columns path equal to ``preprocess_train_data`` for ``future_steps``
  1, 2, 3 and "all", padded at either end, on the synthetic events, on
  hand-made sessions (one without a click, one of a single event) and on
  interleaved sessions; pandas' compensated group sums; the input->output
  table;
- ``run``: gru4rec then smorl, one epoch each, on the CPU against the
  reference trainer on the script's buffers, both with
  ``fused_ce_min_actions=0`` so that the fused CE's twin runs at 80
  actions, the port from the JAX init with the JAX coins replayed (no
  dropout in either family): every loss within 1e-4, every other logged
  and test metric within 1e-3; smorl's test ``Div_Reward`` nonzero; smorl
  without an embedding refused on both sides.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pandas as pd
import pytest

from ikea_recommender_tpu.data import ikea as ref_ikea
from ikea_recommender_tpu.data.tokenizer import Tokenizer as RefTokenizer
from ikea_recommender_tpu_torch.data import ikea_columns
from ikea_recommender_tpu_torch.data.preprocessing import map_rewards
from ikea_recommender_tpu_torch.data.tokenizer import (
    Tokenizer,
    build_input_to_output_table,
    build_output_to_input_table,
)
from ikea_recommender_tpu_torch.run import ikea_rehearsal as port_ir

from _torch_parity import jax_trainer_init, replay_jax_coins

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "ikea_rehearsal_script", os.path.join(REPO, "scripts", "ikea_rehearsal.py"))
script_ir = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(script_ir)

SYNTH = ("--sessions", "1500", "--products", "400", "--insp", "80", "--seed", "0")
BUFFERS = ("--state-len", "8", "--future-steps", "3")
BUFFER_FILES = ("replay_buffer", "val_buffer", "test_buffer")
JSON_FILES = ("input_tokenizer.json", "output_tokenizer.json", "meta.json",
              "unpopular_items.json")
# the keys of the script's run_summary.json (scripts/ikea_rehearsal.py:270-285)
SUMMARY_KEYS = {"family", "epochs", "best_metric", "best_epoch", "test_metrics",
                "train_sessions_per_sec", "timing", "div_emb", "preset", "logs"}
REWARDS = {"click_inspiration": 1.0, "select_content": 1.0, "add_to_cart": 5.0,
           "view_item": 0.1}


def _script(argv):
    """``scripts/ikea_rehearsal.py``'s subcommand for ``argv``."""
    old = sys.argv
    sys.argv = ["ikea_rehearsal.py", *argv]
    try:
        script_ir.main()
    finally:
        sys.argv = old


def _protocol(run, root):
    data, bufs = os.path.join(root, "data"), os.path.join(root, "buffers")
    run(["synth", "--out", data, *SYNTH])
    run(["buffers", "--data", data, "--out", bufs, *BUFFERS])
    return data, bufs


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    root = tmp_path_factory.mktemp("ikea")
    return _protocol(_script, str(root / "script")), _protocol(port_ir.main, str(root / "port"))


def _assert_same_buffers(s_bufs, p_bufs):
    for name in BUFFER_FILES:
        with np.load(os.path.join(s_bufs, f"{name}.npz")) as a, \
                np.load(os.path.join(p_bufs, f"{name}.npz")) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                assert a[k].tobytes() == b[k].tobytes(), (name, k)
    for name in JSON_FILES:
        with open(os.path.join(s_bufs, name), "rb") as a, open(os.path.join(p_bufs, name), "rb") as b:
            assert a.read() == b.read(), name


def test_synth_matches_the_script(protocol):
    (s_data, _), (p_data, _) = protocol
    want = pd.read_pickle(os.path.join(s_data, "events.df"))
    got = port_ir.load_events(p_data)
    assert list(got) == list(want.columns)
    for col in want.columns:
        w, g = want[col].to_numpy(), got[col]
        if col in ("item_id", "action_type"):
            assert g.dtype.kind == "U" and g.tolist() == w.tolist(), col
        else:
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), col
    for name in ("synth_meta.json",):
        with open(os.path.join(s_data, name), "rb") as a, open(os.path.join(p_data, name), "rb") as b:
            assert a.read() == b.read()
    meta = json.load(open(os.path.join(p_data, "synth_meta.json")))
    assert meta["events"] == len(want) and meta["insp_clicks"] == 3993


def test_buffers_match_the_script(protocol):
    (s_data, s_bufs), (p_data, p_bufs) = protocol
    _assert_same_buffers(s_bufs, p_bufs)
    meta = json.load(open(os.path.join(p_bufs, "meta.json")))
    assert (meta["num_items"], meta["num_actions"], meta["padding_id"]) == (480, 80, 480)
    for cmd, s_dir, p_dir in (("synth", s_data, p_data), ("buffers", s_bufs, p_bufs)):
        want, got = (json.load(open(os.path.join(d, f"command_{cmd}.json")))
                     for d in (s_dir, p_dir))
        assert got["cmd"] == cmd and set(got) == set(want)


def test_buffers_without_pandas(protocol, tmp_path, monkeypatch):
    (_, s_bufs), _ = protocol
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    _, p_bufs = _protocol(port_ir.main, str(tmp_path))
    monkeypatch.undo()
    _assert_same_buffers(s_bufs, p_bufs)


# ---- the columns path against the frame path --------------------------------


def _session_events():
    """Hand-made sessions: clicks between views, a session without a click,
    one of a single event (a click), one of a single view."""
    return [
        ("A", "p1", "view_item"), ("A", "i1", "click_inspiration"), ("A", "p2", "view_item"),
        ("A", "p2", "add_to_cart"), ("A", "i2", "click_inspiration"),
        ("A", "i1", "select_content"), ("A", "p3", "view_item"),
        ("B", "p1", "view_item"), ("B", "p2", "view_item"),  # no click
        ("C", "i2", "click_inspiration"),  # one event
        ("D", "p3", "view_item"),  # one view
        ("E", "i1", "select_content"), ("E", "p1", "view_item"), ("E", "p2", "view_item"),
        ("E", "p3", "view_item"), ("E", "i2", "click_inspiration"),
    ]


def _random_events(seed, n_sessions=60, interleave=False):
    rs = np.random.RandomState(seed)
    kinds = ("view_item", "click_inspiration", "select_content", "add_to_cart", "remove")
    events, pos = [], []
    for s in range(n_sessions):
        for j in range(rs.randint(1, 14)):
            kind = kinds[rs.randint(len(kinds))]
            click = kind in ref_ikea.INSPIRATION_ACTIONS
            events.append((f"s{s:03d}", f"i{rs.randint(7)}" if click else f"p{rs.randint(9)}",
                           kind))
            pos.append(j)
    if interleave:  # the rows of all sessions mixed, each session's in order
        order = np.lexsort((rs.rand(len(events)), np.asarray(pos)))
        events = [events[i] for i in order]
    return events


def _synthetic_events():
    """The rehearsal's own event kinds and rewards (0.1 views, 1.0 clicks)."""
    rs = np.random.default_rng(4)
    events = []
    for s in range(80):
        for j in range(int(rs.integers(1, 13))):
            click = j > 0 and rs.random() < 0.35
            events.append((s, f"i{rs.integers(5)}" if click else f"p{rs.integers(11)}",
                           "click_inspiration" if click else "view_item"))
    return events


EVENT_SETS = {"sessions": _session_events, "random": lambda: _random_events(5),
              "interleaved": lambda: _random_events(6, interleave=True),
              "synthetic": _synthetic_events}


def _both_paths(events, future_steps, pad_pos, state_len=4):
    items = sorted({e[1] for e in events})
    vocab_out = [i for i in items if i.startswith("i")]
    frame = pd.DataFrame(events, columns=["sessionID", "item_id", "action_type"])
    frame["reward"] = frame["action_type"].map(REWARDS).fillna(0.0)
    frame["market"] = "de"
    want = ref_ikea.preprocess_train_data(
        frame, padding_id=len(items), state_len=state_len,
        tokenizer_market=RefTokenizer(["de"]), tokenizer_input=RefTokenizer(items),
        tokenizer_output=RefTokenizer(vocab_out), pad_pos=pad_pos,
        future_steps_next_state=future_steps)
    cols = {"sessionID": np.asarray([e[0] for e in events]),
            "item_id": np.asarray([e[1] for e in events]),
            "action_type": np.asarray([e[2] for e in events]),
            "market": np.asarray(["de"] * len(events))}
    cols["reward"] = map_rewards(cols["action_type"], REWARDS)
    got = ikea_columns.preprocess_train_columns(
        cols, padding_id=len(items), state_len=state_len, tokenizer_market=Tokenizer(["de"]),
        tokenizer_input=Tokenizer(items), tokenizer_output=Tokenizer(vocab_out),
        pad_pos=pad_pos, future_steps_next_state=future_steps)
    return got, want


def _assert_columns_are_the_frame(got, want):
    assert list(got) == list(want.columns)
    for col in want.columns:
        w = want[col].to_numpy()
        if len(w) and isinstance(w[0], np.ndarray):
            w = np.stack(w)
        assert got[col].dtype == w.dtype, col
        assert got[col].shape == w.shape and got[col].tobytes() == w.tobytes(), col


@pytest.mark.parametrize("future_steps", [1, 2, 3, "all"])
@pytest.mark.parametrize("pad_pos", ["end", "beg"])
@pytest.mark.parametrize("events", list(EVENT_SETS))
def test_columns_path_is_the_frame_path(events, pad_pos, future_steps):
    got, want = _both_paths(EVENT_SETS[events](), future_steps, pad_pos)
    assert len(want) > 0
    _assert_columns_are_the_frame(got, want)


def test_columns_path_on_the_rehearsal_events(protocol):
    """The script's own events at state_len 8, every future_steps case."""
    (s_data, _), _ = protocol
    frame = pd.read_pickle(os.path.join(s_data, "events.df"))
    cols = {c: frame[c].to_numpy() for c in frame.columns}
    cols["item_id"], cols["action_type"] = (cols[c].astype(str) for c in ("item_id", "action_type"))
    vocab_in = [f"prod_{i}" for i in range(400)] + [f"insp_{i}" for i in range(80)]
    vocab_out = [f"insp_{i}" for i in range(80)]
    for future_steps in (1, 2, 3, "all"):
        for pad_pos in ("end", "beg"):
            want = ref_ikea.preprocess_train_data(
                frame, padding_id=480, state_len=8, tokenizer_market=None,
                tokenizer_input=RefTokenizer(vocab_in), tokenizer_output=RefTokenizer(vocab_out),
                pad_pos=pad_pos, future_steps_next_state=future_steps)
            got = ikea_columns.preprocess_train_columns(
                cols, 480, 8, None, Tokenizer(vocab_in), Tokenizer(vocab_out), pad_pos=pad_pos,
                future_steps_next_state=future_steps)
            _assert_columns_are_the_frame(got, want)


def test_hand_made_values():
    """The no-click session has no row and no end; the one-event click is
    its session's end with a state of one pad (length 1) and a next state of
    itself; k = 2 sums the row's reward and the next one's."""
    got, _ = _both_paths(_session_events(), 2, "end")
    # rows: A's three clicks, C's click, E's two clicks
    np.testing.assert_array_equal(got["is_end"], [False, False, True, True, False, True])
    np.testing.assert_array_equal(got["true_state_len"], [1, 4, 4, 1, 1, 4])
    assert got["true_next_state_len"][3] == 1 and got["state"][3].tolist() == [5] * 4  # the pad id: 5 items
    np.testing.assert_array_equal(got["r_act"], [1.1, 2.0, 1.1, 1.0, 1.1, 1.0])


@pytest.mark.parametrize("events", ["sessions", "random", "interleaved"])
def test_mark_last_inspiration_click(events):
    ev = EVENT_SETS[events]()
    frame = pd.DataFrame(ev, columns=["sessionID", "item_id", "action_type"])
    got = ikea_columns.mark_last_inspiration_click(
        np.asarray([e[2] for e in ev]), np.asarray([e[0] for e in ev]))
    np.testing.assert_array_equal(got, ref_ikea.mark_last_inspiration_click(frame))


@pytest.mark.parametrize("seed", [0, 1])
def test_compensated_sums_are_pandas_group_sums(seed):
    rs = np.random.RandomState(seed)
    keys = np.sort(rs.randint(0, 50, 600))
    values = rs.choice([0.1, 0.2, 1.0, 1e16, -1e16, 3.3], 600) * rs.rand(600)
    values[rs.rand(600) < 0.3] = 0.1
    start = np.r_[True, keys[1:] != keys[:-1]]
    got = ikea_columns._compensated_run_sums(values, start)
    want = pd.Series(values).groupby(keys).transform("sum").to_numpy()
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() != np.repeat(np.add.reduceat(values, np.flatnonzero(start)),
                                      np.diff(np.r_[np.flatnonzero(start), 600])).tobytes()


def test_input_to_output_table():
    inp = Tokenizer([f"p{i}" for i in range(5)] + [f"i{i}" for i in range(3)])
    out = Tokenizer([f"i{i}" for i in (2, 0, 1)])
    table = build_input_to_output_table(inp, out)
    assert table.dtype == np.int64 and len(table) == len(inp)
    for i, tok in enumerate(inp.itos_):
        assert table[i] == (out.stoi(tok) if tok in out.stoi_ else -1)
    back = build_output_to_input_table(inp, out)
    np.testing.assert_array_equal(table[back], np.arange(len(out)))  # inverse on the outputs
    unk = Tokenizer(["i0"], unknown=True)
    assert build_input_to_output_table(inp, unk)[0] == unk.unk_idx
    with pytest.raises(KeyError):  # a click on an item the output vocabulary lacks
        ikea_columns.preprocess_train_columns(
            {"sessionID": np.zeros(2, int), "item_id": np.asarray(["p1", "i1"]),
             "action_type": np.asarray(["view_item", "click_inspiration"]),
             "reward": np.ones(2)}, 8, 3, None, inp, Tokenizer(["i0"]))


# ---- run: the trainer legs against the reference trainer --------------------


def _loss_key(key):
    return "Loss" in key or key in ("Q-Modification-Signal",)


def _assert_close(got, want, what):
    assert set(got) == set(want), what
    for key, w in want.items():
        if _loss_key(key):
            assert got[key] == pytest.approx(w, rel=1e-4, abs=1e-4), (what, key, got[key], w)
        else:
            assert abs(got[key] - w) <= 1e-3, (what, key, got[key], w)


def _legs(monkeypatch, bufs, root):
    """gru4rec then smorl through the script (the reference trainer) and
    through the port's ``run`` on the CPU; (script outcome, port outcome)
    per family."""
    import ikea_recommender_tpu.run.trainer as jax_trainer
    import ikea_recommender_tpu_torch.run.trainer as port_trainer

    outcomes, cfgs = {}, {}
    jax_train, port_train = jax_trainer.train, port_trainer.train

    def jax_side(cfg, **kw):
        cfg.train.fused_ce_min_actions = 0  # the kernels' path at 80 actions
        cfgs[cfg.train.model] = cfg
        outcomes[("jax", cfg.train.model)] = out = jax_train(cfg, **kw)
        return out

    def port_side(cfg, **kw):
        cfg.train.fused_ce_min_actions = 0
        init, rng = jax_trainer_init(cfgs[cfg.train.model])
        if rng is not None:
            replay_jax_coins(monkeypatch, rng)
        outcomes[("port", cfg.train.model)] = out = port_train(cfg, init_params=init, **kw)
        return out

    monkeypatch.setattr(jax_trainer, "train", jax_side)
    monkeypatch.setattr(port_trainer, "train", port_side)
    for family, lr in (("gru4rec", "0.0005"), ("smorl", "0.01")):
        argv = ["run", "--buffers", bufs, "--family", family, "--epochs", "1", "--lr", lr]
        _script([*argv, "--out", os.path.join(root, "script", f"{family}_run")])
        port_ir.main([*argv, "--out", os.path.join(root, "port", f"{family}_run"),
                      "--device", "cpu"])
    return outcomes


def test_run_legs_match_the_reference_trainer(protocol, tmp_path, monkeypatch):
    (_, s_bufs), _ = protocol
    outcomes = _legs(monkeypatch, s_bufs, str(tmp_path))
    for family in ("gru4rec", "smorl"):
        want, got = outcomes[("jax", family)], outcomes[("port", family)]
        assert len(got.logs) == len(want.logs) == 4
        for i, (g, w) in enumerate(zip(got.logs, want.logs)):
            _assert_close(g, w, f"{family} eval point {i}")
        assert got.best_epoch == want.best_epoch
        _assert_close(got.test_metrics, want.test_metrics, f"{family} test")
        out = tmp_path / "port" / f"{family}_run"
        summary = json.load(open(out / "run_summary.json"))
        assert set(summary) == SUMMARY_KEYS
        assert set(json.load(open(tmp_path / "script" / f"{family}_run" / "run_summary.json"))) \
            == SUMMARY_KEYS
        assert summary["test_metrics"] == got.test_metrics
        assert json.load(open(out / "command_run.json"))["device"] == "cpu"
    assert os.path.exists(tmp_path / "port" / "gru4rec_run" / "embedding_weights.npy")
    assert np.load(tmp_path / "port" / "gru4rec_run" / "embedding_weights.npy").shape == (481, 64)
    summary = json.load(open(tmp_path / "port" / "smorl_run" / "run_summary.json"))
    assert summary["div_emb"] == str(tmp_path / "port" / "gru4rec_run" / "embedding_weights.npy")
    div = [v for k, v in summary["test_metrics"].items() if "Div_Reward" in k]
    assert div and any(v != 0.0 for v in div)


def test_smorl_without_an_embedding_refuses(protocol, tmp_path):
    (_, s_bufs), _ = protocol
    argv = ["run", "--buffers", s_bufs, "--family", "smorl", "--epochs", "1",
            "--out", str(tmp_path / "isolated" / "smorl_run")]
    with pytest.raises(SystemExit, match="embedding_weights.npy"):
        port_ir.main([*argv, "--device", "cpu"])
    with pytest.raises(SystemExit, match="embedding_weights.npy"):
        _script(argv)
