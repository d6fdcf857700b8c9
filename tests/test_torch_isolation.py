"""The port stands alone: no JAX, nothing of the reference package, and no
silent move to the CPU.

- every ``.py`` file of ``ikea_recommender_tpu_torch/`` and ``chip_smoke.py``
  is scanned for imports of jax, jaxlib, flax, optax or ikea_recommender_tpu;
- importing every port module in a fresh interpreter loads no ``jax``;
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
    for new in ("ops.fused_ce", "train.state", "train.steps"):
        assert f"ikea_recommender_tpu_torch.{new}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch, tmp_path):
    from ikea_recommender_tpu_torch.convert import (
        numpy_init_params,
        opt_state_from_numpy,
        params_from_numpy,
    )
    from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
    from ikea_recommender_tpu_torch.models.families import model_config_from_train
    from ikea_recommender_tpu_torch.run import checkpoints, recommend
    from ikea_recommender_tpu_torch.run.serve import Recommender
    from ikea_recommender_tpu_torch.train.state import make_train_state
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
