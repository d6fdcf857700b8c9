"""The port's RetailRocket protocol (``run/retailrocket.py``, numpy only)
against ``scripts/retailrocket.py`` (pandas) at small invocations.

``synth``'s events.csv byte for byte; ``etl``'s ``sampled_*.npz`` column
for column (values and dtypes) against the script's pickled DataFrames and
``item_map.json`` byte for byte; ``buffers``' three buffers' arrays bit for
bit, ``unpopular_items.json`` and ``meta.json`` byte for byte; a case whose
filters need more than one pass to their fixpoint and one with
``--sample-sessions``; the three steps with pandas unimportable; ``run`` on
the CPU (the gru4rec leg exports its embedding, the smorl leg finds it) and
its refusal of smorl without one, as the script refuses.
"""

import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from ikea_recommender_tpu_torch.run import retailrocket as port_rr

from _torch_parity import deterministic  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "retailrocket_script", os.path.join(REPO, "scripts", "retailrocket.py"))
script_rr = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(script_rr)

SPLITS = ("train", "val", "test")
BUFFERS = ("replay_buffer", "val_buffer", "test_buffer")
# the keys of the script's run_summary.json (scripts/retailrocket.py:330-341)
SUMMARY_KEYS = {"family", "epochs", "best_metric", "best_epoch", "test_metrics",
                "train_sessions_per_sec", "timing", "div_emb", "preset", "logs"}


def _script(argv):
    """``scripts/retailrocket.py``'s subcommand for ``argv``."""
    old = sys.argv
    sys.argv = ["retailrocket.py", *argv]
    try:
        script_rr.main()
    finally:
        sys.argv = old


def _protocol(run, root, synth=(), etl=(), buffers=()):
    """synth -> etl -> buffers under ``root`` through ``run``(argv)."""
    events, data, bufs = (os.path.join(root, n) for n in ("events.csv", "data", "buffers"))
    run(["synth", "--out", events, *synth])
    run(["etl", "--events", events, "--out", data, *etl])
    run(["buffers", "--data", data, "--out", bufs, *buffers])
    return events, data, bufs


def _assert_same_protocol(script_dirs, port_dirs):
    (s_events, s_data, s_bufs), (p_events, p_data, p_bufs) = script_dirs, port_dirs
    with open(s_events, "rb") as a, open(p_events, "rb") as b:
        assert a.read() == b.read()
    for split in SPLITS:
        want = pd.read_pickle(os.path.join(s_data, f"sampled_{split}.df"))
        got = port_rr.load_split(os.path.join(p_data, f"sampled_{split}.npz"))
        assert list(want.columns) == list(got)
        for col in want.columns:
            assert got[col].dtype == want[col].to_numpy().dtype, (split, col)
            np.testing.assert_array_equal(got[col], want[col].to_numpy())
    for names, a_dir, b_dir in ((("item_map.json",), s_data, p_data),
                                (("unpopular_items.json", "meta.json"), s_bufs, p_bufs)):
        for name in names:
            with open(os.path.join(a_dir, name)) as a, open(os.path.join(b_dir, name)) as b:
                assert a.read() == b.read(), name
    for name in BUFFERS:
        with np.load(os.path.join(s_bufs, f"{name}.npz")) as a, \
                np.load(os.path.join(p_bufs, f"{name}.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    root = tmp_path_factory.mktemp("rr")
    args = dict(synth=("--num-sessions", "300", "--num-items", "200", "--seed", "0"))
    script_dirs = _protocol(_script, str(root / "script"), **args)
    port_dirs = _protocol(port_rr.main, str(root / "port"), **args)
    return root, script_dirs, port_dirs


def test_protocol_matches_the_script(protocol):
    _, script_dirs, port_dirs = protocol
    _assert_same_protocol(script_dirs, port_dirs)
    # each invocation is recorded with the script's keys
    for cmd, s_dir, p_dir in zip(("synth", "etl", "buffers"), script_dirs, port_dirs):
        if cmd == "synth":  # its --out is the events file
            s_dir, p_dir = os.path.dirname(s_dir), os.path.dirname(p_dir)
        want, got = (json.load(open(os.path.join(d, f"command_{cmd}.json")))
                     for d in (s_dir, p_dir))
        assert got["cmd"] == cmd and set(got) == set(want)


@pytest.mark.parametrize("argv", [
    ("--seed", "3", "--num-sessions", "250", "--num-items", "120"),
    (),  # the defaults: 400 sessions, 300 items
])
def test_synth_csv_byte_for_byte(tmp_path, argv):
    _script(["synth", "--out", str(tmp_path / "a.csv"), *argv])
    port_rr.main(["synth", "--out", str(tmp_path / "b.csv"), *argv])
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()


# numpy 2.0's default_rng(0).zipf(1.3, size=405000): the bytes' sha256 and
# the next random() (r5b's synth draws with numpy 2.0; later releases draw
# other values, so the port keeps 2.0's algorithm)
ZIPF_20 = ("463b2c5821b6a93a5e5ab11f4bd327b9362b5683ab0d3b59166f1e6bcef86382",
           0.8476108673398473)


def test_zipf_is_numpy20s():
    import hashlib

    rng = np.random.default_rng(0)
    got = port_rr.zipf_numpy20(rng, 1.3, 405000)
    assert got.dtype == np.int64 and len(got) == 405000
    assert (hashlib.sha256(got.tobytes()).hexdigest(), rng.random()) == ZIPF_20
    for seed, a, n in ((1, 1.3, 1000), (2, 2.5, 777)):
        ours, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
        want = theirs.zipf(a, size=n)
        if np.__version__.startswith("2.0."):  # numpy's own zipf is 2.0's
            np.testing.assert_array_equal(port_rr.zipf_numpy20(ours, a, n), want)
            assert ours.random() == theirs.random()


def _one_pass(events, min_item_count, min_session_len):
    """The etl's filters applied once to the kept events (numpy)."""
    ev = port_rr.read_events(events)
    keep = np.isin(ev["event"], ["view", "transaction", "addtocart"])
    item, vis = ev["itemid"][keep], ev["visitorid"][keep]
    ids, counts = np.unique(item, return_counts=True)
    ok = np.isin(item, ids[counts >= min_item_count])
    item, vis = item[ok], vis[ok]
    _, inv, sizes = np.unique(vis, return_inverse=True, return_counts=True)
    ok = sizes[inv] >= min_session_len
    return item[ok], vis[ok]


def test_fixpoint_needs_more_than_one_pass(tmp_path):
    """Filters whose first pass leaves items under the count (sessions cut
    short take their items' counts down): the fixpoint iterates, as the
    script's."""
    synth = ("--num-sessions", "200", "--num-items", "150", "--seed", "1")
    etl = ("--min-item-count", "6", "--min-session-len", "5")
    script_dirs = _protocol(_script, str(tmp_path / "script"), synth=synth, etl=etl)
    port_dirs = _protocol(port_rr.main, str(tmp_path / "port"), synth=synth, etl=etl)
    item, _ = _one_pass(port_dirs[0], 6, 5)
    _, counts = np.unique(item, return_counts=True)
    assert (counts < 6).any()  # one pass is not the fixpoint
    _assert_same_protocol(script_dirs, port_dirs)
    full = np.concatenate([port_rr.load_split(os.path.join(port_dirs[1], f"sampled_{s}.npz"))
                           ["item_id"] for s in SPLITS])
    assert np.unique(full, return_counts=True)[1].min() >= 6


def test_sample_sessions(tmp_path):
    synth = ("--num-sessions", "300", "--num-items", "200", "--seed", "2")
    etl = ("--sample-sessions", "90", "--seed", "4")
    script_dirs = _protocol(_script, str(tmp_path / "script"), synth=synth, etl=etl)
    port_dirs = _protocol(port_rr.main, str(tmp_path / "port"), synth=synth, etl=etl)
    _assert_same_protocol(script_dirs, port_dirs)
    sessions = np.concatenate([port_rr.load_split(os.path.join(
        port_dirs[1], f"sampled_{s}.npz"))["session_id"] for s in SPLITS])
    assert len(np.unique(sessions)) == 90


def test_protocol_without_pandas(protocol, tmp_path, monkeypatch):
    root, script_dirs, _ = protocol
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    port_dirs = _protocol(port_rr.main, str(tmp_path),
                          synth=("--num-sessions", "300", "--num-items", "200", "--seed", "0"))
    monkeypatch.undo()
    _assert_same_protocol(script_dirs, port_dirs)


def test_run_trains_the_chain_on_the_cpu(protocol, capsys):
    """gru4rec at the paper point for one epoch on the CPU exports its
    embedding; smorl finds it beside its --out and trains with a non-zero
    diversity reward. run_summary.json has the script's keys."""
    root, _, (_, _, bufs) = protocol
    runs = root / "runs"
    for family in ("gru4rec", "smorl"):
        out = str(runs / f"{family}_run")
        port_rr.main(["run", "--buffers", bufs, "--family", family, "--epochs", "1",
                      "--no-train-metrics", "--out", out, "--device", "cpu"])
        summary = json.load(open(os.path.join(out, "run_summary.json")))
        assert set(summary) == SUMMARY_KEYS
        assert summary["family"] == family and summary["epochs"] == 1
        metrics = json.load(open(os.path.join(out, "test_metrics.json")))
        assert metrics == summary["test_metrics"] and any("NDCG@10" in k for k in metrics)
        assert all(np.isfinite(v) for v in metrics.values())
        assert json.load(open(os.path.join(out, "command_run.json")))["device"] == "cpu"
    assert os.path.exists(runs / "gru4rec_run" / "embedding_weights.npy")
    assert summary["div_emb"] == str(runs / "gru4rec_run" / "embedding_weights.npy")
    assert "auto-discovered diversity embedding" in capsys.readouterr().out
    div = [v for k, v in summary["test_metrics"].items() if "Div_Reward" in k]
    assert div and any(v != 0.0 for v in div)


def test_smorl_without_pretrained_embeddings_refuses(protocol, tmp_path):
    _, _, (_, _, bufs) = protocol
    argv = ["run", "--buffers", bufs, "--family", "smorl", "--epochs", "1",
            "--out", str(tmp_path / "isolated" / "smorl_run")]
    with pytest.raises(SystemExit, match="diversity embedding"):
        port_rr.main([*argv, "--device", "cpu"])
    with pytest.raises(SystemExit, match="diversity embedding"):
        _script(argv)


# -- run's Config and resume; the accuracy legs' runner ----------------------------


class _Captured(Exception):
    """Raised by a stand-in ``train`` with the Config it was handed."""

    def __init__(self, cfg):
        super().__init__("captured")
        self.cfg = cfg


def _script_config(argv, monkeypatch):
    """The ``Config`` that ``scripts/retailrocket.py``'s ``run`` hands its
    ``train`` for ``argv`` (the script stops there)."""
    from ikea_recommender_tpu.run import trainer as jax_trainer

    def capture(cfg, **_):
        raise _Captured(cfg)

    monkeypatch.setattr(jax_trainer, "train", capture)
    with pytest.raises(_Captured) as got:
        _script(argv)
    return got.value.cfg


def _fields(cfg):
    """``{section: {field: value}}`` of a Config, its top-level scalars
    under ``""``."""
    import dataclasses

    out = {"": {}}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):
            out[f.name] = {g.name: getattr(value, g.name) for g in dataclasses.fields(value)}
        else:
            out[""][f.name] = value
    return out


@pytest.mark.parametrize("checkpoint", [False, True], ids=["no_ckpt", "ckpt"])
@pytest.mark.parametrize("preset", [None, "fast"], ids=["default", "fast"])
@pytest.mark.parametrize("family", ["gru4rec", "sqn", "smorl"])
def test_run_config_matches_the_script(protocol, tmp_path, monkeypatch, family, preset,
                                       checkpoint):
    """The port's ``run_config`` gives, field for field after the preset
    resolves, the Config that the script's ``run`` trains with; no field is
    in one package only."""
    _, _, (_, _, bufs) = protocol
    argv = ["run", "--buffers", bufs, "--family", family, "--epochs", "30",
            "--no-train-metrics", "--out", str(tmp_path / f"{family}_run")]
    if preset:
        argv += ["--preset", preset]
    if checkpoint:
        argv.append("--checkpoint")
    div = str(tmp_path / "gru4rec_run" / "embedding_weights.npy") if family == "smorl" else None
    if div:
        argv += ["--div-emb", div]
    want = _fields(_script_config(argv, monkeypatch))
    got = _fields(port_rr.run_config(port_rr.get_parser().parse_args(argv), div))
    assert set(got) == set(want)
    only = {(s, k) for s in want for k in set(got[s]) ^ set(want[s])}
    assert not only, f"fields in one package only: {sorted(only)}"
    for section in want:
        for name, value in want[section].items():
            assert got[section][name] == value, (section, name)
    train = got["train"]
    assert (train["preset"], train["resume"]) == (preset, checkpoint)
    assert (train["checkpoint_dir"] is not None) == checkpoint
    if preset == "fast":  # the preset resolved: "default" heads, bf16 moments
        assert train["head_precision"] == "default"
        assert train["optimizer_mv_dtype"] == "bfloat16"


@pytest.mark.parametrize("family", ["gru4rec", "sqn"])
def test_run_resumes_through_the_cli(protocol, tmp_path, deterministic, family):
    """``run --epochs 2 --checkpoint`` then ``run --epochs 3 --checkpoint``
    into the same ``--out`` ship what one uncut ``run --epochs 3`` ships:
    the best metric, its eval point and ``test_metrics.json``."""
    _, _, (_, _, bufs) = protocol

    def run(out, epochs, *flags):
        port_rr.main(["run", "--buffers", bufs, "--family", family, "--epochs", str(epochs),
                      "--no-train-metrics", "--out", str(out), "--device", "cpu", *flags])
        summary = json.loads((out / "run_summary.json").read_text())
        return summary, (out / "test_metrics.json").read_text()

    uncut, uncut_test = run(tmp_path / "uncut", 3)
    run(tmp_path / "cut", 2, "--checkpoint")
    assert sorted(os.listdir(tmp_path / "cut" / "ckpt")) == ["ckpt_1.pt", "ckpt_2.pt"]
    resumed, resumed_test = run(tmp_path / "cut", 3, "--checkpoint")
    assert len(resumed["logs"]) == 1  # the resumed run trained epoch 3 only
    assert resumed["logs"] == uncut["logs"][2:]
    assert (resumed["best_metric"], resumed["best_epoch"]) == (uncut["best_metric"],
                                                              uncut["best_epoch"])
    assert resumed_test == uncut_test


_legs_spec = importlib.util.spec_from_file_location(
    "torch_rr_legs", os.path.join(REPO, "scripts", "torch_rr_legs.py"))
legs = importlib.util.module_from_spec(_legs_spec)
_legs_spec.loader.exec_module(legs)
R5B_LEGS = ("gru4rec", "gru4rec_fast", "sqn", "sqn_fast", "smorl", "smorl_fast")


@pytest.mark.parametrize("leg,cut", [(leg, None) for leg in R5B_LEGS] + [
    (leg, 12) for leg in R5B_LEGS], ids=[*R5B_LEGS, *(f"{leg}-cut" for leg in R5B_LEGS)])
def test_legs_run_r5bs_argv(leg, cut):
    """The runner's argv for each r5b leg parses, in the port's ``run``, to
    the flags its ``command_run.json`` records; a cut changes the epochs
    alone. A smorl leg reads the default gru4rec leg's export beside its
    ``--out``, as r5b's ``div_emb`` names it; no other leg reads one."""
    rec = json.load(open(os.path.join(legs.R5B, f"{leg}_command_run.json")))
    out = os.path.join("root", "runs", leg)
    args = port_rr.get_parser().parse_args(legs.leg_argv(leg, "bufs", out, cut))
    for key in ("family", "epochs", "preset", "checkpoint", "seed", "no_train_metrics"):
        assert getattr(args, key) == (cut if key == "epochs" and cut else rec[key]), key
    assert (args.buffers, args.out) == ("bufs", out)
    want = os.path.join("root", "runs", "gru4rec", "embedding_weights.npy")
    assert args.div_emb == (want if leg.startswith("smorl") else None)
    assert (rec["div_emb"] or "").endswith("/runs/gru4rec/embedding_weights.npy") == (
        leg.startswith("smorl"))
    assert args.device == "cuda"  # the card, as the runner leaves it


def test_legs_compare_holds_the_seed_spread(tmp_path, capsys):
    """r5b's seed-1 gru4rec legs are within the bounds of its seed-0 legs
    (curve gaps 0.0042 and 0.0047); a leg moved by 0.013 is not."""
    for arm in ("gru4rec", "gru4rec_fast"):
        summary = json.load(open(os.path.join(legs.R5B, f"{arm}_s1_run_summary.json")))
        (tmp_path / f"{arm}_run_summary.json").write_text(json.dumps(summary))
    assert legs.main(["compare", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "largest Val_NDCG@10 gap 0.004216 at eval point 13 of 30" in out
    assert "gru4rec fast minus default, test NDCG@10: +0.023395 vs +0.021759" in out
    summary["test_metrics"]["Test_NDCG@10"] -= 0.013  # the fast arm's
    (tmp_path / "gru4rec_fast_run_summary.json").write_text(json.dumps(summary))
    assert legs.main(["compare", str(tmp_path)]) == 1
    assert capsys.readouterr().out.count("OUTSIDE") == 2  # the leg and the lead


@pytest.mark.parametrize("points,ok", [((12, 14), True), ((11, 14), False)],
                         ids=["past_best", "short_of_best"])
def test_legs_compare_a_cut_smorl_leg(tmp_path, capsys, points, ok):
    """r5b's smorl legs cut to their first eval points: held at the points
    they have, "cut at" printed; a leg that stops short of r5b's best eval
    point (11) is outside the bounds."""
    for leg, n in zip(("smorl", "smorl_fast"), points):
        summary = json.load(open(os.path.join(legs.R5B, f"{leg}_run_summary.json")))
        summary.update(epochs=n, logs=summary["logs"][:n])
        (tmp_path / f"{leg}_run_summary.json").write_text(json.dumps(summary))
    assert legs.main(["compare", str(tmp_path)]) == (0 if ok else 1)
    out = capsys.readouterr().out
    assert f"smorl: cut at {points[0]} of 30 (r5b's best point 11)" in out
    assert f"smorl_fast: cut at {points[1]} of 30 (r5b's best point 13)" in out
    assert f"at eval point 0 of {points[0]}; " in out
    assert "smorl fast minus default, test NDCG@10: +0.034694 vs +0.034694" in out
    assert out.count("OUTSIDE") == (0 if ok else 1)


def test_legs_run_records_a_cut(tmp_path, monkeypatch):
    """``run --epochs``: the line's ``cut_at`` beside r5b's epochs and the
    run's figures; the record takes a run only where ``compare`` can hold
    it (past r5b's best eval point, no shorter than the run held), and a
    cut export is held to the uncut line's."""
    root, record = tmp_path / "root", tmp_path / "record"
    record.mkdir()
    (record / "gru4rec_run_summary.json").write_text(json.dumps({"epochs": 30}))
    emb = np.arange(6, dtype=np.float32).reshape(3, 2)
    saved = io.BytesIO()
    np.save(saved, emb)
    (record / "legs.jsonl").write_text(json.dumps(
        {"leg": "gru4rec", "embedding_sha256": legs.hashlib.sha256(
            saved.getvalue()).hexdigest()}) + "\n")
    def fake_run(cmd, cwd, stdout, stderr):
        args = port_rr.get_parser().parse_args(cmd[3:])
        os.makedirs(args.out, exist_ok=True)
        summary = {"epochs": args.epochs, "best_epoch": 2, "best_metric": 0.42,
                   "div_emb": args.div_emb, "train_sessions_per_sec": 1.0, "timing": {},
                   "test_metrics": {"Test_HR@10": 0.7, "Test_NDCG@10": 0.42},
                   "logs": [{"Val_NDCG@10": 0.4}] * args.epochs}
        json.dump(summary, open(os.path.join(args.out, "run_summary.json"), "w"))
        json.dump({"argv": cmd}, open(os.path.join(args.out, "command_run.json"), "w"))
        if args.family == "gru4rec":
            np.save(os.path.join(args.out, "embedding_weights.npy"), emb)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(legs.subprocess, "run", fake_run)
    monkeypatch.setattr(legs, "card", lambda: "a card, 1 W")
    for cut in (3, 12):  # smorl: short of r5b's best eval point (11), then past it
        assert legs.main(["run", str(root), "--legs", "gru4rec", "smorl", "--epochs", str(cut),
                          "--record", str(record), "--keep", str(tmp_path / "keep")]) == 0
        smorl = record / "smorl_run_summary.json"
        assert smorl.exists() == (cut > 11)
    lines = [json.loads(line) for line in (record / "legs.jsonl").read_text().splitlines()]
    assert [(e["leg"], e["cut_at"], e["r5b_epochs"], e["recorded"]) for e in lines[1:]] == [
        ("gru4rec", 3, 30, False), ("smorl", 3, 30, False),
        ("gru4rec", 12, 30, False), ("smorl", 12, 30, True)]
    assert lines[2]["val_curve"] == [0.4] * 3
    assert lines[2]["test_metrics"] == {"Test_HR@10": 0.7, "Test_NDCG@10": 0.42}
    assert lines[1]["embedding_equals_uncut"] is True
    assert json.loads((record / "gru4rec_run_summary.json").read_text()) == {"epochs": 30}
    smorl = json.loads(smorl.read_text())
    assert (smorl["epochs"], smorl["div_emb"]) == (
        12, str(root / "runs" / "gru4rec" / "embedding_weights.npy"))
    assert (tmp_path / "keep" / "gru4rec_embedding_weights.npy").exists()
