"""Multi-process plumbing.

Port of ``ikea_recommender_tpu/core/distributed.py`` (``initialize``,
``process_shard``, ``host_local_batch_to_global``). The reference starts
``jax.distributed`` from its own variables; the port starts
``torch.distributed`` from torch's standard environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``; ``LOCAL_RANK`` names a rank's
card), as ``torchrun`` sets it, or from explicit arguments. The backend is
always the caller's: nothing picks one.

Each rank loads and keeps its own rows: :func:`process_shard` is the
reference's contiguous block split of a dataset over the processes, and
:func:`local_rows` takes this rank's rows of a batch split over the mesh's
data axis. ``host_local_batch_to_global`` has no counterpart: it assembles
the processes' rows into one global array, and in the port each rank's
step takes its own rows as they are (``train/steps.py::TrainStep`` moves
them to the rank's device), so they never leave their rank.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ikea_recommender_tpu_torch.core.mesh import BACKENDS, DATA_AXIS, Mesh


def initialize(
    backend: str,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> Tuple[int, int]:
    """Start the process group with ``backend`` ("nccl" or "gloo") and
    return (rank, world size). ``init_method`` defaults to ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``), ``rank`` and ``world_size`` to
    ``RANK``/``WORLD_SIZE``. A group already running must have the same
    backend."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dist.is_initialized():
        if str(dist.get_backend()) != backend:
            raise ValueError(f"a {dist.get_backend()} process group is already running, "
                             f"not {backend}")
        return dist.get_rank(), dist.get_world_size()
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    return rank, world_size


def local_device(backend: str) -> torch.device:
    """This process's card under ``torchrun`` (``cuda:LOCAL_RANK``) for
    nccl; the CPU for gloo."""
    if backend == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cpu")


def process_shard(n: int) -> slice:
    """Row range of a length-n dataset owned by this process (contiguous
    blocks; the whole range without a process group)."""
    p, count = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    per = -(-n // count)
    return slice(p * per, min((p + 1) * per, n))


def data_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a length-n batch split over the data axis: the
    data index's contiguous block (n must divide by the axis)."""
    D = mesh.size(DATA_AXIS)
    if n % D:
        raise ValueError(f"batch of {n} rows not divisible by the data axis {D}")
    per = n // D
    d = mesh.index(DATA_AXIS)
    return slice(d * per, (d + 1) * per)


def local_rows(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of every array of a global batch."""
    rows = data_rows(len(next(iter(batch.values()))), mesh)
    return {k: v[rows] for k, v in batch.items()}
