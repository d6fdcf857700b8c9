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
  loads with ``torch.load(weights_only=True)``. On a (data, model) mesh
  each rank writes its own file, ``ckpt_<step>.rank<r>-of-<world>.pt``,
  with its slice of the state (the reference's orbax writes each
  process's shards): a resume takes the newest step that every rank holds,
  a step's older ones are pruned only once every rank has written it, and
  checkpoints of another mesh shape are refused.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

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
    def __init__(self, out_dir: str, metric_name: str, mode: str = "max",
                 write_files: bool = True):
        """``write_files=False`` keeps the bookkeeping but writes no
        files: the ranks of a mesh but rank 0 track the (equal) metric
        without racing on the file system."""
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.out_dir = out_dir
        self.metric_name = metric_name
        self.mode = mode
        self.write_files = write_files
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
        if self.write_files:
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
        if self.write_files and params is not None and not os.path.exists(self.params_path):
            self._write(value, epoch, params, model_idx, dims)


class CheckpointManager:
    """Full train-state save/restore, one ``ckpt_<step>.pt`` per saved step;
    the newest ``max_to_keep`` are kept. With ``mesh`` (this rank's place on
    a (data, model) mesh, ``core/mesh.py``) every rank of the mesh makes
    one, and each saves and restores its own ``ckpt_<step>.rank<r>-of-
    <world>.pt``; every rank calls :meth:`save` and :meth:`restore`
    together."""

    _NAME = re.compile(r"^ckpt_(\d+)(?:\.rank(\d+)-of-(\d+))?\.pt$")

    def __init__(self, ckpt_dir: str, max_to_keep: int = 2, mesh=None):
        self.dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        self.shape = None if mesh is None else (mesh.spec.data, mesh.spec.model)
        self.world = 1 if mesh is None else mesh.spec.num_devices
        self.restored_step: Optional[int] = None
        os.makedirs(self.dir, exist_ok=True)

    def _suffix(self) -> str:
        return "" if self.mesh is None else f".rank{self.mesh.rank}-of-{self.world}"

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step}{self._suffix()}.pt")

    def _files(self):
        """[(step, rank or None, world or None, name)] of the directory."""
        out = []
        for name in os.listdir(self.dir):
            m = self._NAME.match(name)
            if m:
                rank, world = (None, None) if m.group(2) is None else map(int, m.group(2, 3))
                out.append((int(m.group(1)), rank, world, name))
        return out

    def all_steps(self):
        """The steps this rank (or the one process) has saved."""
        mine = None if self.mesh is None else self.mesh.rank
        world = None if self.mesh is None else self.world
        return sorted(s for s, r, w, _ in self._files() if (r, w) == (mine, world))

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()

    def save(self, step: int, payload: Any) -> None:
        """Writes this rank's payload atomically (a killed save leaves the
        last good one); the steps older than the newest ``max_to_keep`` go
        once every rank has written ``step``."""
        if self.mesh is not None:
            payload = {**payload, "mesh": list(self.shape)}
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        self._barrier()
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        """The newest step this rank holds; on a mesh, the newest that every
        rank holds (the least of the ranks' newest: a rank stopped during a
        save cannot make the ranks resume different epochs)."""
        steps = self.all_steps()
        mine = steps[-1] if steps else -1
        if self.mesh is not None:
            from ikea_recommender_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS

            t = torch.tensor([mine], dtype=torch.int64, device=self.mesh.device)
            for axis in (MODEL_AXIS, DATA_AXIS):
                t = self.mesh.all_reduce(t, "min", axis)
            mine = int(t.item())
        return None if mine < 0 else mine

    def _foreign(self) -> Optional[str]:
        """The mesh shape of checkpoints in the directory that another
        shape of mesh (or one process) wrote, or None."""
        for step, rank, world, name in sorted(self._files(), reverse=True):
            if (world or 1) == self.world and (rank is None) == (self.mesh is None):
                continue
            if rank is None:
                return "one process"
            meta = torch.load(os.path.join(self.dir, name), map_location="cpu",
                              weights_only=True).get("mesh")
            return f"a {tuple(meta)} mesh" if meta else f"{world} ranks"
        return None

    def restore(self, device="cpu") -> Optional[Any]:
        """The newest payload with its tensors on ``device``, or None.
        Raises where the directory holds another mesh shape's checkpoints
        and none of this one's."""
        step = self.latest_step()
        if step is None:
            other = self._foreign()
            if other is not None:
                raise ValueError(
                    f"checkpoint dir {self.dir} holds checkpoints of {other}; this run is "
                    f"{'one process' if self.mesh is None else f'a {self.shape} mesh'}")
            return None
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        self.restored_step = step
        got = payload.pop("mesh", None)
        if (None if got is None else tuple(got)) != self.shape:
            raise ValueError(f"checkpoint {self._path(step)} was written by "
                             f"{'one process' if got is None else f'a {tuple(got)} mesh'}; "
                             f"this run is "
                             f"{'one process' if self.shape is None else f'a {self.shape} mesh'}")
        return payload
