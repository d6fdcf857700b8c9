"""The port stands alone: no JAX, nothing of the reference package, and no
silent move to the CPU.

- every ``.py`` file of ``ikea_recommender_tpu_torch/`` and ``chip_smoke.py``
  is scanned for imports of jax, jaxlib, flax, optax or ikea_recommender_tpu,
  and the modules that replace pandas code (the analysis, the scaling bench,
  the RetailRocket protocol, the IKEA rehearsal and its columns path, the
  session-file columns and the experiment workflow) for pandas too;
- importing every port module in a fresh interpreter loads no ``jax`` and
  no ``pandas``; importing a subpackage imports none of its modules (no
  kernel builds), and each exports the reference's names but those without
  a counterpart;
- the entry points raise without CUDA unless the caller asks for the CPU;
- ``chip_smoke.py`` fails, and prints no result, without a card.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ikea_recommender_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ikea_recommender_tpu"}
# modules that run without pandas where the reference's need it
PANDAS_FREE = ("analysis/__init__.py", "analysis/embeddings.py", "analysis/trajectories.py",
               "analysis/visualize.py", "parallel/scaling_bench.py", "run/retailrocket.py",
               "run/ikea_rehearsal.py", "run/_rehearsal.py", "data/ikea_columns.py",
               "data/session_columns.py", "run/prepare_synthetic.py",
               "run/build_replay_buffer.py", "run/build_unpopular_items.py",
               "run/run_all_experiments_in_dir.py", "run/spot_run_experiments.py")
SUBPACKAGES = ("core", "data", "models", "ops", "train", "eval", "run", "utils", "analysis",
               "parallel")
# the reference's exports that have no counterpart in the port
NO_COUNTERPART = {"models": {"init_backbone", "init_model"},
                  "parallel": {"batch_sharding_tree"}}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


@pytest.mark.parametrize("path", PANDAS_FREE)
def test_pandas_free_modules(path):
    assert "pandas" not in _imported_roots(PORT / path), path


def test_git_ignores_no_port_source():
    """A checkout holds only what git tracks: no source of the port may
    match an ignore rule (the repository ignores every ``data/``)."""
    sources = [str(p.relative_to(REPO)) for p in sorted(PORT.rglob("*"))
               if p.suffix in (".py", ".cu")] + ["chip_smoke.py"]
    out = subprocess.run(["git", "check-ignore", *sources], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    if out.returncode == 128:
        pytest.skip(f"not a git checkout: {out.stderr.strip()}")
    assert out.stdout == "", f"ignored by git:\n{out.stdout}"


def test_importing_the_port_loads_no_jax():
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in sorted(PORT.rglob("*.py"))
    ]
    for new in ("ops.fused_ce", "ops.fused_argmax", "ops.rl", "ops.rewards", "train.state",
                "train.steps", "ops.ranking", "ops.coverage", "data.item_frequency",
                "data.preprocessing", "data.replay_buffer", "eval.protocol",
                "utils.logging_dicts", "core.mesh", "core.distributed", "parallel.topk",
                "parallel.fused_ce", "parallel.q_kernels", "parallel.sharding",
                "parallel.__init__", "parallel.scaling_bench", "analysis.__init__",
                "analysis.embeddings", "analysis.trajectories", "analysis.visualize",
                "run.retailrocket", "run.ikea_rehearsal", "run._rehearsal", "data.ikea_columns",
                "data.session_columns", "run.prepare_synthetic", "run.build_replay_buffer",
                "run.build_unpopular_items", "run.run_all_experiments_in_dir", "_exports"):
        assert f"ikea_recommender_tpu_torch.{new}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN | {'pandas'})!r})\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_subpackages_export_the_references_names():
    """Each subpackage's ``__all__`` is the reference's but for the names
    without a counterpart, and every name resolves. Importing the lazily
    exporting subpackages in a fresh interpreter imports none of their
    modules, so no kernel is built."""
    import importlib

    for sub in SUBPACKAGES:
        ref = importlib.import_module(f"ikea_recommender_tpu.{sub}").__all__
        port = importlib.import_module(f"ikea_recommender_tpu_torch.{sub}")
        assert port.__all__ == [n for n in ref if n not in NO_COUNTERPART.get(sub, ())], sub
        for name in port.__all__:
            assert getattr(port, name) is not None
    lazy = SUBPACKAGES[:8]
    code = (
        "import importlib, sys\n"
        f"for s in {list(lazy)!r}: importlib.import_module('ikea_recommender_tpu_torch.' + s)\n"
        "print(sorted(m for m in sys.modules if m.startswith('ikea_recommender_tpu_torch.')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    loaded = json.loads(out.stdout.replace("'", '"'))
    assert loaded == sorted(["ikea_recommender_tpu_torch._exports"]
                            + [f"ikea_recommender_tpu_torch.{s}" for s in lazy]), loaded


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch, tmp_path):
    from ikea_recommender_tpu_torch.convert import (
        double_q_from_numpy,
        numpy_init_double_q,
        numpy_init_params,
        opt_state_from_numpy,
        params_from_numpy,
    )
    from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
    from ikea_recommender_tpu_torch.models.families import model_config_from_train
    from ikea_recommender_tpu_torch.run import checkpoints, recommend
    from ikea_recommender_tpu_torch.run.serve import Recommender
    from ikea_recommender_tpu_torch.train.state import make_double_q_state, make_train_state
    from ikea_recommender_tpu_torch.train.steps import make_train_step

    mc = model_config_from_train(
        TrainConfig(embedding_size=4, hidden_state_size=4), DataConfig(num_items=9)
    )
    np_params = numpy_init_params(mc, 0)
    params = params_from_numpy(np_params, "cpu")
    checkpoints.save_params_npz(params, str(tmp_path / "best_model.npz"))
    (tmp_path / "experiment.yaml").write_text("data:\n  num_items: 9\n")
    (tmp_path / "in.jsonl").write_text('{"state": [1]}\n')

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(np_params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Recommender(params, mc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoints.load_params_npz(str(tmp_path / "best_model.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recommend.main(["-f", str(tmp_path / "experiment.yaml"),
                        "--input", str(tmp_path / "in.jsonl")])
    assert Recommender(params, mc, device="cpu").device.type == "cpu"

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_state(params, mc, 0.01)
    state, opt = make_train_state(params, mc, 0.01, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(mc, opt)
    adam = SimpleNamespace(count=np.int32(0), mu=np_params, nu=np_params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        opt_state_from_numpy(adam)
    assert opt_state_from_numpy(adam, "cpu").count.device.type == "cpu"
    batch = {"state": np.zeros((2, 3), np.int32), "action": np.zeros(2, np.int32),
             "true_len": np.ones(2, np.int32), "valid": np.ones(2, bool)}
    _, metrics = make_train_step(mc, opt, device="cpu")(state, batch)
    assert metrics["sup_loss"].device.type == "cpu"

    # the double-Q slice: sqn and smorl
    for family in ("sqn", "smorl"):
        mq = model_config_from_train(
            TrainConfig(model=family, embedding_size=4, hidden_state_size=4),
            DataConfig(num_items=9),
        )
        np_pair = numpy_init_double_q(mq)
        pair = [params_from_numpy(p, "cpu") for p in np_pair]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_double_q_state(pair, mq, 0.01)
        dq, opt = make_double_q_state(pair, mq, 0.01, device="cpu")
        aux = {"div_embedding": np.ones((10, 4), np.float32),
               "unpopular_mask": np.arange(9) % 2 == 0} if family == "smorl" else {}
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_train_step(mq, opt, **aux)
        adam = [SimpleNamespace(count=np.int32(0), mu=p, nu=p) for p in np_pair]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            double_q_from_numpy(np_pair, adam)
        assert double_q_from_numpy(np_pair, adam, "cpu")[0][0]["sup_head"]["bias"].device.type == "cpu"
        qbatch = dict(batch, reward=np.ones(2, np.float32), next_state=np.zeros((2, 3), np.int32),
                      true_next_len=np.ones(2, np.int32), is_end=np.zeros(2, bool))
        _, metrics = make_train_step(mq, opt, device="cpu", **aux)(dq, qbatch)
        assert metrics["q_loss"].device.type == "cpu"

    # A.9c: the analysis, the scaling bench, the RetailRocket run, the batch dict
    from ikea_recommender_tpu_torch.analysis import embeddings
    from ikea_recommender_tpu_torch.data.replay_buffer import Batch
    from ikea_recommender_tpu_torch.parallel.scaling_bench import run_scaling_bench
    from ikea_recommender_tpu_torch.run import retailrocket
    from ikea_recommender_tpu_torch.train.steps import batch_to_device_dict

    emb = np.eye(3, dtype=np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        embeddings.cosine_similarity_matrix(emb)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        embeddings.nearest_neighbors(emb, [0], k=1)
    assert embeddings.cosine_similarity_matrix(emb, device="cpu").device.type == "cpu"
    assert embeddings.nearest_neighbors(emb, [0], k=1, device="cpu")[0].shape == (1, 1)
    tiny = dict(model="gru4rec", per_device_batch=2, catalog=9, state_len=3, emb=4, hidden=4,
                warmup=0, iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scaling_bench(**tiny)
    assert len(run_scaling_bench(**tiny, device="cpu")) == 1
    argv = ["run", "--buffers", str(tmp_path / "none"), "--out", str(tmp_path / "rr")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        retailrocket.main(argv)
    with pytest.raises(FileNotFoundError):  # on the CPU it gets as far as the buffers
        retailrocket.main(argv + ["--device", "cpu"])
    from ikea_recommender_tpu_torch.run import ikea_rehearsal

    argv = ["run", "--buffers", str(tmp_path / "none"), "--out", str(tmp_path / "ikea")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ikea_rehearsal.main(argv)
    with pytest.raises(FileNotFoundError):
        ikea_rehearsal.main(argv + ["--device", "cpu"])
    # the directory sweep checks the device before it moves any YAML
    from ikea_recommender_tpu_torch.run import run_all_experiments_in_dir as sweep

    configs, root = tmp_path / "configs", tmp_path / "experiments"
    configs.mkdir()
    (configs / "exp.yaml").write_text('exp_name: "e"\ndata:\n  num_items: 9\n')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.main([str(configs), "--root", str(root)])
    assert os.listdir(configs) == ["exp.yaml"] and not root.exists()
    # on the CPU it moves the YAML and trains, here failing on the missing buffers
    assert sweep.main([str(configs), "--root", str(root), "--device", "cpu"]) == 1
    assert os.listdir(configs) == [] and (root / "default" / "e" / "exp.yaml").exists()
    rows = Batch(**qbatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_to_device_dict(rows)
    assert batch_to_device_dict(rows, device="cpu")["state"].device.type == "cpu"


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    # in the repository, and alone in a directory without the port
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode != 0
        lines = out.stdout.strip().splitlines()
        assert not lines or not json.loads(lines[-1] if lines[-1].startswith("{") else "{}").get("ok")
