"""Checkpointing: params as ``.npz``, the best-model tracker, and full
train-state checkpoints for resume.

Port of ``ikea_recommender_tpu/run/checkpoints.py``:

- ``save_params_npz`` / ``load_params_npz``: one array per leaf, keyed by
  its path joined with "/" (``backbone/embedding``,
  ``backbone/gru/0/fwd/wi``, ``sup_head/kernel``, ...). Files written by
  either package load in the other. No template tree is needed: the keys
  carry the structure.
- :class:`BestModelTracker` saves the winning network's params whenever the
  watched validation metric improves (reference
  ``utils/save_best_model.py``), with the reference's fixed comparator
  (explicit ``max``/``min`` mode, initial best ±inf), the same file names
  (``best_model.npz``, ``best_model.json``) and meta keys.
- :class:`CheckpointManager` keeps the newest ``max_to_keep`` full-state
  checkpoints, one ``torch.save`` file per epoch, where the reference has
  orbax. A payload is nested dicts, lists, tensors and numbers, so it
  loads with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from ikea_recommender_tpu_torch.convert import params_from_numpy


def flatten_params(params: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(params))
    else:
        return {prefix: params.detach().cpu().numpy()}
    flat = {}
    for k, v in items:
        flat.update(flatten_params(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def save_params_npz(params: Any, path: str) -> None:
    np.savez_compressed(path, **flatten_params(params))


def load_params_npz(path: str, device="cuda") -> Dict:
    with np.load(path) as data:
        return params_from_numpy({k: data[k] for k in data.files}, device)


class BestModelTracker:
    def __init__(self, out_dir: str, metric_name: str, mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.out_dir = out_dir
        self.metric_name = metric_name
        self.mode = mode
        self.best = -np.inf if mode == "max" else np.inf
        self.best_epoch: Optional[int] = None
        self.best_model_idx: Optional[int] = None
        os.makedirs(out_dir, exist_ok=True)

    @property
    def params_path(self) -> str:
        return os.path.join(self.out_dir, "best_model.npz")

    @property
    def meta_path(self) -> str:
        return os.path.join(self.out_dir, "best_model.json")

    def improved(self, value: float) -> bool:
        return value > self.best if self.mode == "max" else value < self.best

    def _write(self, value, epoch, params, model_idx, dims) -> None:
        save_params_npz(params, self.params_path)
        meta = {
            "epoch": int(epoch),
            "model_idx": int(model_idx),
            "metric_name": self.metric_name,
            "metric_value": float(value),
        }
        if dims:
            meta.update(dims)
        with open(self.meta_path, "w") as fh:
            json.dump(meta, fh, indent=2)

    def __call__(
        self, value: float, epoch: int, params: Any, model_idx: int = 1,
        dims: Optional[Dict] = None,
    ) -> bool:
        """Save ``params`` if ``value`` improves the watched metric."""
        if not self.improved(value):
            return False
        self.best = value
        self.best_epoch = epoch
        self.best_model_idx = model_idx
        self._write(value, epoch, params, model_idx, dims)
        return True

    def load_best(self, device="cuda") -> Dict:
        return load_params_npz(self.params_path, device)

    def restore(
        self, value: float, epoch: int, model_idx: int, params: Any = None,
        dims: Optional[Dict] = None,
    ) -> None:
        """Rehydrate the tracker from a resumed checkpoint, and write the
        best-model files when ``params`` is given and they are missing (a
        resume into a fresh ``exp_dir``). Without this a resumed run starts
        the comparator at ±inf and may ship a later, worse model."""
        self.best = float(value)
        self.best_epoch = int(epoch)
        self.best_model_idx = int(model_idx)
        if params is not None and not os.path.exists(self.params_path):
            self._write(value, epoch, params, model_idx, dims)


class CheckpointManager:
    """Full train-state save/restore, one ``ckpt_<step>.pt`` per saved step;
    the newest ``max_to_keep`` are kept."""

    _NAME = re.compile(r"^ckpt_(\d+)\.pt$")

    def __init__(self, ckpt_dir: str, max_to_keep: int = 2):
        self.dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step}.pt")

    def all_steps(self):
        return sorted(int(m.group(1)) for m in map(self._NAME.match, os.listdir(self.dir)) if m)

    def save(self, step: int, payload: Any) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))  # a killed save leaves the last good one
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, device="cpu") -> Optional[Any]:
        """The newest payload with its tensors on ``device``, or None."""
        step = self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location=device, weights_only=True)
