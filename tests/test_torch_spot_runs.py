"""The port's spot runs without pandas, against the script they mirror:
``run/spot_run_experiments.py`` against ``scripts/spot_run_experiments.py``
(the reference package, pandas), both run in this process.

The port runs with ``pandas`` unimportable (``sys.modules["pandas"] =
None``). What is held:
- staging, one case per default config (16): each side's
  ``make_run_copy`` writes into its own root; the run-copy YAML texts are
  equal but for the root, and so is every staged file: each ``.npz`` key,
  dtype and value (``savez`` stamps times into the zip, so not the bytes),
  the ``.npy`` arrays, the JSON files (tokenizers, unpopular sets) byte for
  byte. The IKEA buffers are split by position, so equal buffers also show
  that the columns path keeps the frame path's row order;
- ``main``'s loop with ``subprocess.run`` stubbed on both sides by a
  recorder: the same commands but for the module and the port's
  ``--device``, the same ``cwd`` and printed lines, ``FAILED:`` and rc 1
  for a failing copy, and ``--platform=cpu`` as ``--device cpu``;
- the device check: without CUDA and without ``--platform=cpu`` the port's
  ``main`` raises before it writes anything;
- one real run on the CPU, the cheapest copy (IKEA gru4rec at batch 64),
  through the port's ``main`` with ``--platform=cpu``: rc 0 and a
  ``test_metrics.json`` of finite values.
"""

import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from ikea_recommender_tpu_torch.run import spot_run_experiments as port_spot

REPO = Path(__file__).resolve().parent.parent


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_script",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


script_spot = _load_script("spot_run_experiments")

RR_SRC = "experiments/paper/SMORL-RetailRocket/SMORL_GRU_front_train_pad/SMORL_GRU_front_train_pad.yaml"
IKEA_SRC = ("experiments/IKEA/first_runs/IKEA_GRU_right_tokenizer_smallerBS/"
            "IKEA_GRU_right_tokenizer_smallerBS.yaml")
BIDIR_SRC = ("experiments/IKEA/State-Length-Exp/BidirGRU-s20-d035-128-onelayer-twoGRUlay/"
             "BidirGRU-s20-d035-128-onelayer-twoGRUlay.yaml")


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def _assert_same_file(got, want):
    if got.suffix == ".npz":
        with np.load(got) as g, np.load(want) as w:
            assert sorted(g.files) == sorted(w.files), got
            for k in w.files:
                assert g[k].dtype == w[k].dtype, (got, k)
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{got}:{k}")
    elif got.suffix == ".npy":
        g, w = np.load(got), np.load(want)
        assert g.dtype == w.dtype, got
        np.testing.assert_array_equal(g, w, err_msg=str(got))
    else:
        assert got.read_bytes() == want.read_bytes(), got


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """Every default config's run copy, made by the script into one root
    and by the port, pandas unimportable, into another."""
    tmp = tmp_path_factory.mktemp("spot")
    roots = {"ref": tmp / "ref", "port": tmp / "port"}
    dsts = {}
    for src in script_spot.DEFAULTS:
        ref = script_spot.make_run_copy(str(REPO / src), str(roots["ref"]))
        with pytest.MonkeyPatch.context() as m:
            m.setitem(sys.modules, "pandas", None)
            port = port_spot.make_run_copy(str(REPO / src), str(roots["port"]))
        dsts[src] = (Path(ref), Path(port))
    return roots, dsts


def test_the_defaults_are_the_scripts():
    assert port_spot.DEFAULTS == script_spot.DEFAULTS
    assert len(set(port_spot.DEFAULTS)) == 16
    assert port_spot.RR_ITEMS == script_spot.RR_ITEMS
    assert port_spot.REPO == str(REPO)


@pytest.mark.parametrize("src", script_spot.DEFAULTS,
                         ids=[Path(s).stem for s in script_spot.DEFAULTS])
def test_staging_matches_the_script(staged, src):
    roots, dsts = staged
    ref, port = dsts[src]
    assert port.relative_to(roots["port"]) == ref.relative_to(roots["ref"])
    ref_text, port_text = ref.read_text(), port.read_text()
    assert port_text.replace(str(roots["port"]), "ROOT") == ref_text.replace(
        str(roots["ref"]), "ROOT")
    assert ref_text.startswith(f"# spot-run copy of {REPO / src} (synthetic data, epochs "
                               f"clamped to 1)\n")
    data = [v for k, v in yaml.safe_load(ref_text)["data"].items()
            if k.endswith("_path")]
    (staged_dir,) = {Path(p).parent for p in data}
    rel = staged_dir.relative_to(roots["ref"])
    assert _files(roots["port"] / rel) == _files(staged_dir)
    assert len(_files(staged_dir)) == (7 if rel.name.startswith("ikea") else 4)
    for name in _files(staged_dir):
        _assert_same_file(roots["port"] / rel / name, staged_dir / name)


def test_ikea_rows_keep_the_frames_order(staged):
    """The script splits the IKEA rows by position, so the columns path must
    keep the frame path's row order (held above against the script); here
    also against the events: the train and val actions are the output ids
    of the inspiration clicks in event order, the first 80% and the rest."""
    roots, _ = staged
    cols = port_spot.ikea_events()
    clicks = cols["item_id"][cols["action_type"] == "click_inspiration"]
    want = np.array([int(s.split("_")[1]) for s in clicks])  # insp_k is output id k
    n_tr = int(0.8 * len(want))
    for d in ("ikea_s10", "ikea_s20"):
        with np.load(roots["port"] / d / "replay_buffer_train.npz") as tr, \
                np.load(roots["port"] / d / "replay_buffer_val.npz") as va:
            np.testing.assert_array_equal(tr["action"], want[:n_tr])
            np.testing.assert_array_equal(va["action"], want[n_tr:])


def _sides(tmp_path):
    """Two repository roots whose ``experiments`` is this repository's."""
    roots = {}
    for side in ("ref", "port"):
        root = tmp_path / side
        root.mkdir()
        (root / "experiments").symlink_to(REPO / "experiments")
        roots[side] = root
    return roots


class _Runs:
    """``subprocess.run`` for either script: records each call, and fails
    the copy whose path holds ``fail``."""

    def __init__(self, fail=None):
        self.fail, self.calls = fail, []

    def __call__(self, cmd, cwd=None, env=None):
        self.calls.append((cmd, cwd, env))
        return SimpleNamespace(returncode=int(self.fail is not None and self.fail in cmd[4]))


def _main_both(roots, argv, monkeypatch, capsys, fail=None):
    got = {}
    for side, mod in (("ref", script_spot), ("port", port_spot)):
        runs = _Runs(fail)
        capsys.readouterr()
        with monkeypatch.context() as m:
            m.setattr(mod, "REPO", str(roots[side]))
            m.setattr(mod, "subprocess", SimpleNamespace(run=runs))
            if side == "port":
                m.setitem(sys.modules, "pandas", None)
            rc = mod.main(list(argv))
        got[side] = (rc, capsys.readouterr().out, runs.calls)
    return got


@pytest.mark.parametrize("platform", [None, "cpu"])
def test_main_loop_matches_the_script(tmp_path, monkeypatch, capsys, platform):
    roots = _sides(tmp_path)
    argv = [RR_SRC, IKEA_SRC, BIDIR_SRC]
    if platform:
        argv.insert(0, f"--platform={platform}")
    else:  # a machine with a card: the port's check passes
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # the bidir copy fails where there is a card
    got = _main_both(roots, argv, monkeypatch, capsys, fail=None if platform else "BidirGRU")
    (rc_ref, out_ref, calls_ref), (rc_port, out_port, calls_port) = got["ref"], got["port"]
    assert out_port == out_ref
    heads = "".join(f"=== spot-run {s}\n" for s in argv[-3:])
    if platform:
        assert rc_ref == rc_port == 0
        assert out_ref == heads + "all 3 spot-runs passed\n"
    else:
        assert rc_ref == rc_port == 1
        assert out_ref == heads + f"FAILED:\n  {BIDIR_SRC}\n"
    assert len(calls_ref) == len(calls_port) == 3
    device = "cpu" if platform else "cuda"
    for (cmd_r, cwd_r, env_r), (cmd_p, cwd_p, env_p) in zip(calls_ref, calls_port):
        assert cmd_r[:3] == [sys.executable, "-m", "ikea_recommender_tpu.run.cli"]
        assert cmd_p[:3] == [sys.executable, "-m", "ikea_recommender_tpu_torch.run.cli"]
        assert cmd_p[3] == cmd_r[3] == "-f" and cmd_p[5:] == ["--device", device]
        assert (Path(cmd_p[4]).relative_to(roots["port"])
                == Path(cmd_r[4]).relative_to(roots["ref"]))
        assert Path(cmd_p[4]).is_file()
        assert (cwd_r, cwd_p) == (str(roots["ref"]), str(roots["port"]))
        assert env_r.get("IKEA_PLATFORM") == platform and env_p is None
    assert _files(roots["port"]) == _files(roots["ref"])


def test_main_refuses_without_a_card(tmp_path, monkeypatch, capsys):
    """No CUDA and no ``--platform=cpu``: ``main`` raises before it stages
    a file or starts a run."""
    assert not torch.cuda.is_available()
    root = tmp_path / "repo"
    root.mkdir()
    (root / "experiments").symlink_to(REPO / "experiments")
    runs = _Runs()
    monkeypatch.setattr(port_spot, "REPO", str(root))
    monkeypatch.setattr(port_spot, "subprocess", SimpleNamespace(run=runs))
    for argv in ([], [IKEA_SRC]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_spot.main(argv)
    with pytest.raises(SystemExit, match="--platform=tpu"):  # only cpu names a device
        port_spot.main(["--platform=tpu", IKEA_SRC])
    assert runs.calls == [] and not (root / "data").exists()
    assert capsys.readouterr().out == ""


def test_main_trains_a_copy_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The cheapest copy through the port's ``main`` and a real CLI
    process on the CPU."""
    root = tmp_path / "repo"
    root.mkdir()
    (root / "experiments").symlink_to(REPO / "experiments")
    monkeypatch.setattr(port_spot, "REPO", str(root))
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "pandas", None)
        rc = port_spot.main(["--platform=cpu", IKEA_SRC])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out == f"=== spot-run {IKEA_SRC}\nall 1 spot-runs passed\n"
    exp = root / "data" / "spot" / "runs" / "IKEA_GRU_right_tokenizer_smallerBS"
    metrics = json.loads((exp / "test_metrics.json").read_text())
    assert metrics and all(math.isfinite(v) for v in metrics.values())
    assert {"best_model.npz", "IKEA_GRU_right_tokenizer_smallerBS.yaml"} <= set(os.listdir(exp))
