"""The port's experiment workflow without pandas, against the scripts it
mirrors: ``run/prepare_synthetic.py``, ``run/build_replay_buffer.py``,
``run/build_unpopular_items.py`` and ``run/run_all_experiments_in_dir.py``
against ``scripts/{prepare_synthetic,build_replay_buffer,
build_unpopular_items,run_all_experiments_in_dir}.py`` (the reference
package, pandas), each run in this process.

Each port entry point runs with ``pandas`` unimportable
(``sys.modules["pandas"] = None``). What is held:
- prepare_synthetic: the same files; every ``.npz`` key, dtype and value
  (``savez`` stamps times into the zip, so not the bytes);
  ``unpopular.json`` byte for byte; ``experiment.yaml`` but for the output
  directory;
- build_replay_buffer: train and ``--eval`` buffers from CSV (int and float
  rewards, string session ids, a missing reward, interleaved sessions, both
  pad ends, custom column names) and JSON lines, and from the ``.npz`` of a
  frame's columns against the script's ``.df`` pickle of that frame: every
  array and the printed line; the port refuses the pickle;
- the columns reader (``data/session_columns.py``) against ``pandas``
  itself: dtypes and values of CSV and JSON-lines columns, pandas' float
  parsers to the last bit;
- build_unpopular_items: CSV and JSON lines at quantiles 0.9 and 0.5, the
  JSON file byte for byte;
- run_all_experiments_in_dir with ``train`` stubbed on both sides: the
  resolved configs (experiment directory, model, data paths), the files
  moved, the printed lines and the exit code, for three YAMLs (one without
  ``exp_class``/``exp_name``, one whose training raises) and for an empty
  directory; then the port's sweep training for real on the CPU, whose
  ``test_metrics.json`` must equal the port CLI's for the same YAML.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from ikea_recommender_tpu_torch.data import session_columns
from ikea_recommender_tpu_torch.run import build_replay_buffer as port_brb
from ikea_recommender_tpu_torch.run import build_unpopular_items as port_bui
from ikea_recommender_tpu_torch.run import cli
from ikea_recommender_tpu_torch.run import prepare_synthetic as port_ps
from ikea_recommender_tpu_torch.run import run_all_experiments_in_dir as port_sweep

from _torch_parity import deterministic  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_script",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


script_ps = _load_script("prepare_synthetic")
script_brb = _load_script("build_replay_buffer")
script_bui = _load_script("build_unpopular_items")
script_sweep = _load_script("run_all_experiments_in_dir")


def _run_script(mod, argv, monkeypatch, capsys):
    """A script's ``main()`` under ``argv``: (return value, stdout, stderr)."""
    capsys.readouterr()
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [mod.__file__, *argv])
        rc = mod.main()
    return (rc, *capsys.readouterr())


def _run_port(main, argv, monkeypatch, capsys):
    """A port entry point with pandas unimportable: (return value, stdout,
    stderr)."""
    capsys.readouterr()
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "pandas", None)
        rc = main(argv)
    return (rc, *capsys.readouterr())


def _assert_npz_equal(got_path, want_path):
    with np.load(got_path) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- prepare_synthetic ------------------------------------------------------------


def test_prepare_synthetic_matches_the_script(tmp_path, monkeypatch, capsys):
    ref, port = tmp_path / "ref", tmp_path / "port"
    capsys.readouterr()
    script_ps.main(str(ref))
    said_ref = capsys.readouterr().out
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "pandas", None)
        port_ps.main(str(port))
    said_port = capsys.readouterr().out
    assert said_port.replace(str(port), "OUT") == said_ref.replace(str(ref), "OUT")
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) == [
        "experiment.yaml", "test.npz", "train.npz", "unpopular.json", "val.npz"]
    for name in ("train.npz", "val.npz", "test.npz"):
        _assert_npz_equal(port / name, ref / name)
    assert (port / "unpopular.json").read_bytes() == (ref / "unpopular.json").read_bytes()
    assert ((port / "experiment.yaml").read_text().replace(str(port), "OUT")
            == (ref / "experiment.yaml").read_text().replace(str(ref), "OUT"))


# -- session files ----------------------------------------------------------------


def _frame(kind, seed=0, n_sessions=40):
    """A session frame whose rows interleave the sessions: item ids, session
    ids and rewards as ``kind`` asks."""
    rs = np.random.default_rng(seed)
    lens = rs.integers(1, 9, n_sessions)
    sid = np.repeat(np.arange(n_sessions), lens)
    order = rs.permutation(len(sid))
    sid = sid[order]
    items = rs.integers(0, 30, len(sid))
    reward = rs.integers(0, 2, len(sid))
    if kind in ("float", "nan_reward"):
        reward = rs.random(len(sid))  # written with 17 significant digits
    if kind == "nan_reward":
        reward[::7] = np.nan
    if kind == "buy_click":
        reward = np.where(reward == 1, 1.0, 0.2)
    if kind == "str_ids":  # IKEA-like string session ids
        sid = np.array([f"GA1.2.{100 + 37 * s}" for s in sid], dtype=object)
    return pd.DataFrame({"session_id": sid, "item_id": items, "reward": reward})


def _write(frame, path):
    if path.endswith(".csv"):
        frame.to_csv(path, index=False)
    elif path.endswith((".json", ".jsonl")):
        frame.to_json(path, orient="records", lines=True)
    elif path.endswith(".npz"):
        np.savez(path, **{c: (frame[c].to_numpy(dtype=str) if frame[c].dtype.kind in "OT"
                              else frame[c].to_numpy()) for c in frame.columns})
    else:
        frame.to_pickle(path)


# (frame kind, the port's file, the script's file, extra flags)
BUFFER_CASES = [
    ("int", "s.csv", "s.csv", []),
    ("int", "s.csv", "s.csv", ["--eval"]),
    ("float", "s.csv", "s.csv", ["--pad-pos", "beg"]),
    ("float", "s.csv", "s.csv", ["--eval", "--pad-pos", "beg"]),
    ("buy_click", "s.csv", "s.csv", ["--state-len", "3", "--padding-id", "30"]),
    ("nan_reward", "s.csv", "s.csv", []),
    ("str_ids", "s.csv", "s.csv", []),
    ("str_ids", "s.csv", "s.csv", ["--eval"]),
    ("custom", "s.csv", "s.csv", ["--session-col", "sessionID", "--item-col", "product",
                                  "--reward-col", "r"]),
    ("float", "s.jsonl", "s.jsonl", []),
    ("str_ids", "s.jsonl", "s.jsonl", ["--eval"]),
    ("buy_click", "s.json", "s.json", ["--pad-pos", "beg"]),
    ("str_ids", "s.npz", "s.df", []),
    ("float", "s.npz", "s.df", ["--eval"]),
]


@pytest.mark.parametrize("kind,port_file,ref_file,flags", BUFFER_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}{'-' + '-'.join(f.strip('-') for f in c[3]) if c[3] else ''}"
                              for c in BUFFER_CASES])
def test_build_replay_buffer_matches_the_script(tmp_path, monkeypatch, capsys, kind, port_file,
                                                ref_file, flags):
    frame = _frame(kind)
    if kind == "custom":
        frame = frame.rename(columns={"session_id": "sessionID", "item_id": "product",
                                      "reward": "r"})
    src_port, src_ref = str(tmp_path / f"port_{port_file}"), str(tmp_path / f"ref_{ref_file}")
    _write(frame, src_port)
    _write(frame, src_ref)
    out_ref, out_port = str(tmp_path / "ref"), str(tmp_path / "port")
    _, said_ref, _ = _run_script(script_brb, ["-f", src_ref, "-o", out_ref, *flags],
                              monkeypatch, capsys)
    _, said_port, _ = _run_port(port_brb.main, ["-f", src_port, "-o", out_port, *flags],
                             monkeypatch, capsys)
    name = "eval_buffer.npz" if "--eval" in flags else "replay_buffer.npz"
    assert said_port.replace(out_port, "OUT") == said_ref.replace(out_ref, "OUT")
    assert said_ref == f"wrote {len(frame)} rows -> {os.path.join(out_ref, name)}\n"
    assert os.listdir(out_port) == os.listdir(out_ref) == [name]
    _assert_npz_equal(os.path.join(out_port, name), os.path.join(out_ref, name))
    if ref_file.endswith(".df"):  # the port refuses the pickle, naming the .npz
        with pytest.raises(SystemExit, match=r"ref_s\.npz"):
            _run_port(port_brb.main, ["-f", src_ref, "-o", out_port, *flags], monkeypatch,
                      capsys)


def test_session_columns_match_pandas(tmp_path):
    """The reader's columns against pandas' own, dtype and value: the
    session frames of the buffer cases, then fields that probe each rule."""
    def same(got, want):
        assert list(got) == list(want)
        for c in want:
            w = want[c].to_numpy()
            assert got[c].dtype == w.dtype, (c, got[c].dtype, w.dtype)
            if w.dtype == object:
                assert [type(v) for v in got[c]] == [type(v) for v in w], c
                assert pd.Series(got[c]).equals(pd.Series(w)), c
            else:
                np.testing.assert_array_equal(got[c], w, err_msg=c)

    for kind in ("int", "float", "nan_reward", "str_ids", "buy_click"):
        frame = _frame(kind, seed=1)
        for ext, read in ((".csv", pd.read_csv),
                          (".jsonl", lambda p: pd.read_json(p, orient="records", lines=True))):
            path = str(tmp_path / f"{kind}{ext}")
            _write(frame, path)
            same(session_columns.read_session_columns(path), read(path))
    probes = ("a,b,c,d,e,f,g\n"
              "1,1.5,True,x,NA,007,18446744073709551615\n"
              "-2, .5 ,false,,nan,+3,1\n"
              "3,1e-320,TRUE,None,,4,2\n"
              "4,-Infinity,False,7,#N/A,5,3\n")
    (tmp_path / "probe.csv").write_text(probes)
    same(session_columns.read_csv_columns(str(tmp_path / "probe.csv")),
         pd.read_csv(tmp_path / "probe.csv"))
    rows = [{"a": 1, "b": 1.0, "c": "12", "d": True, "e": "x", "f": 0.951, "g": "1.5"},
            {"a": 2, "b": 2.0, "c": " 3", "d": None, "e": None, "f": 1e-300, "h": 2**63},
            {"a": 3, "b": -0.0, "c": "4", "d": False, "e": 2, "f": 0.1234567890123456789,
             "g": "inf", "h": 1}]
    (tmp_path / "probe.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    same(session_columns.read_jsonl_columns(str(tmp_path / "probe.jsonl")),
         pd.read_json(tmp_path / "probe.jsonl", orient="records", lines=True))
    # pandas' parsers, not Python's: these differ from float() in the last bit
    assert session_columns.xstrtod("0.04097352393619469") != 0.04097352393619469
    assert session_columns.json_float("0.951") != 0.951


# -- build_unpopular_items ------------------------------------------------------------


@pytest.mark.parametrize("ext", [".csv", ".jsonl"])
@pytest.mark.parametrize("quantile", ["0.9", "0.5"])
def test_build_unpopular_items_matches_the_script(tmp_path, monkeypatch, capsys, ext, quantile):
    frame = _frame("str_ids", seed=2, n_sessions=120)
    src = str(tmp_path / f"events{ext}")
    _write(frame, src)
    out_ref, out_port = str(tmp_path / "ref"), str(tmp_path / "port")
    argv = ["-f", src, "-q", quantile, "-i", "item_id"]
    _, said_ref, _ = _run_script(script_bui, argv + ["-t", out_ref], monkeypatch, capsys)
    _, said_port, _ = _run_port(port_bui.main, argv + ["-t", out_port], monkeypatch, capsys)
    assert said_port.replace(out_port, "OUT") == said_ref.replace(out_ref, "OUT")
    ref = Path(out_ref, "unpopular_items.json").read_bytes()
    assert Path(out_port, "unpopular_items.json").read_bytes() == ref
    assert 0 < len(json.loads(ref)) < 30


# -- run_all_experiments_in_dir -----------------------------------------------------------

SWEEP_YAMLS = {
    "b_first.yaml": 'exp_class: "cls"\nexp_name: "one"\ndata:\n  train_path: "data/train.npz"\n'
                    '  val_path: "data/val.npz"\n  test_path: "data/test.npz"\n'
                    '  num_items: 9\ntrain:\n  model: "gru4rec"\n',
    "a_second.yml": 'data:\n  train_path: "/abs/train.npz"\n  val_path: "/abs/val.npz"\n'
                    '  test_path: "/abs/test.npz"\n  num_items: 9\ntrain:\n  model: "sarm"\n',
    "c_third.yaml": 'exp_class: "cls"\nexp_name: "boom"\ndata:\n  num_items: 9\n'
                    'train:\n  model: "sqn"\n',
}


class _Recorder:
    """``train`` for either package: records what the sweep resolved, and
    raises for sqn."""

    def __init__(self, root):
        self.root, self.calls = root, []

    def __call__(self, cfg, log_fn=None, progress=False, **kw):
        d = cfg.data
        self.calls.append((os.path.relpath(cfg.exp_dir, self.root), cfg.train.model,
                           d.train_path, d.val_path, d.test_path, cfg.experiment.exp_class,
                           cfg.experiment.exp_name, progress, sorted(os.listdir(cfg.exp_dir))))
        if cfg.train.model == "sqn":
            raise RuntimeError("boom")
        return SimpleNamespace(best_metric=0.25 + len(self.calls) / 100)


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*"))


def test_sweep_matches_the_script(tmp_path, monkeypatch, capsys):
    sides = {}
    for side in ("ref", "port"):
        cfg_dir, root = tmp_path / side / "configs", tmp_path / side / "experiments"
        cfg_dir.mkdir(parents=True)
        for name, text in SWEEP_YAMLS.items():
            (cfg_dir / name).write_text(text)
        (cfg_dir / "notes.txt").write_text("not a config\n")
        rec = _Recorder(str(root))
        if side == "ref":
            monkeypatch.setattr(script_sweep, "train", rec)
            rc, out, err = _run_script(script_sweep, [str(cfg_dir), "--root", str(root)],
                                       monkeypatch, capsys)
        else:
            monkeypatch.setattr(port_sweep, "train", rec)
            rc, out, err = _run_port(port_sweep.main,
                                     [str(cfg_dir), "--root", str(root), "--device", "cpu"],
                                     monkeypatch, capsys)
        sides[side] = (rc, out, rec.calls, _tree(root), _tree(cfg_dir), err)
    ref, port = sides["ref"], sides["port"]
    assert port[:5] == ref[:5]
    assert ref[0] == 1
    assert ref[1].splitlines() == [
        "=== default/a_second ===", "    best Val_NDCG@10=0.26000",
        "=== cls/one ===", "    best Val_NDCG@10=0.27000",
        "=== cls/boom ===", "FAILED: ['boom']"]
    assert [c[:5] for c in ref[2]] == [
        ("default/a_second", "sarm", "/abs/train.npz", "/abs/val.npz", "/abs/test.npz"),
        ("cls/one", "gru4rec", "data/train.npz", "data/val.npz", "data/test.npz"),
        ("cls/boom", "sqn", "", "", "")]
    assert ref[3] == ["cls", "cls/boom", "cls/boom/c_third.yaml", "cls/one",
                      "cls/one/b_first.yaml", "default", "default/a_second",
                      "default/a_second/a_second.yml"]
    assert ref[4] == ["notes.txt"]
    for _, _, _, _, _, err in (ref, port):  # the traceback, and the sweep went on
        assert "RuntimeError: boom" in err


def test_sweep_of_an_empty_directory(tmp_path, monkeypatch, capsys):
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "x.txt").write_text("")
    argv = [str(tmp_path / "empty"), "--root", str(tmp_path / "root")]
    got = (_run_script(script_sweep, argv, monkeypatch, capsys),
           _run_port(port_sweep.main, argv + ["--device", "cpu"], monkeypatch, capsys))
    assert got[0] == got[1] == (1, f"no YAML configs in {tmp_path / 'empty'}\n", "")
    assert not (tmp_path / "root").exists()


def test_sweep_trains_as_the_cli_does(tmp_path, monkeypatch, capsys, deterministic):
    """The port's sweep trains prepare_synthetic's experiment, cut to
    gru4rec and 1 epoch, on the CPU into ROOT/synthetic/smorl-synth; its
    ``test_metrics.json`` equals the port CLI's for the same YAML."""
    data = tmp_path / "data"
    _run_port(port_ps.main, str(data), monkeypatch, capsys)
    text = ((data / "experiment.yaml").read_text().replace('model: "smorl"', 'model: "gru4rec"')
            .replace("epochs: 3", "epochs: 1"))
    sweep_dir, cli_dir = tmp_path / "sweep", tmp_path / "cli"
    for d in (sweep_dir, cli_dir):
        d.mkdir()
        (d / "experiment.yaml").write_text(text)
    rc, out, _ = _run_port(port_sweep.main, [str(sweep_dir), "--root", str(tmp_path / "runs"),
                                             "--device", "cpu"], monkeypatch, capsys)
    assert rc == 0, out
    exp = tmp_path / "runs" / "synthetic" / "smorl-synth"
    assert sorted(os.listdir(exp)) == ["best_model.json", "best_model.npz",
                                       "embedding_weights.npy", "experiment.yaml",
                                       "test_metrics.json"]
    assert os.listdir(sweep_dir) == []
    lines = out.splitlines()
    assert lines[0] == "=== synthetic/smorl-synth ===" and lines[-1].startswith(
        "    best Val_NDCG@10=")
    rc, _, _ = _run_port(cli.main, ["-f", str(cli_dir / "experiment.yaml"), "--device", "cpu"],
                      monkeypatch, capsys)
    assert rc == 0
    got = json.loads((exp / "test_metrics.json").read_text())
    assert got == json.loads((cli_dir / "test_metrics.json").read_text())
    assert got["Test_HR@10"] > 0
