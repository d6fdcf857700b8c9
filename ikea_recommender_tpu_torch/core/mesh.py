"""The (data, model) device mesh, and its collectives.

Port of ``ikea_recommender_tpu/core/mesh.py`` (``DATA_AXIS``, ``MODEL_AXIS``,
``MeshSpec``, ``make_mesh``, ``single_device_mesh``). The reference runs one
controller over many devices and lets ``shard_map`` place each shard; the
port is SPMD: one process per device, each holding its own shard and
running the same program. The grid is row-major, as the reference's
(``ikea_recommender_tpu/core/mesh.py:47``): rank r sits at
``(r // model, r % model)``; its ``model`` group is the ranks that share its
data index, its ``data`` group the ranks that share its model index. The
batch is split over ``data``, the embedding rows and the head columns over
``model``.

A :class:`Mesh` also carries the collective backend, named by the caller
and never switched by itself: ``"nccl"`` (one card per rank) or ``"gloo"``
(CPU tensors, or CUDA tensors of ranks that share one card). A collective
the backend cannot run on the tensors' device raises. Each JAX collective
is one torch call on the axis' group: ``pmax`` is ``all_reduce(MAX)``,
``pmin`` ``all_reduce(MIN)``, ``psum`` ``all_reduce(SUM)``, and
``all_gather`` ``all_gather`` (:meth:`Mesh.gather`; gloo runs all of them
on CUDA tensors, as ``chip_smoke.py``'s mesh phase probes on the H100). An
axis of size 1 takes no collective. The mesh counts each axis' calls and
payload bytes (:meth:`Mesh.counts`; a gather counts the (n, ...) tensor
it returns).

On a differentiable path a collective needs its transpose written down,
as JAX derives it: :func:`psum` sums in the forward and passes the
cotangent through (its consumers are replicated over the axis), and
:func:`pvary` passes a replicated value through and sums its cotangent
over the axis (the partial cotangents of the shards that read it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ikea_recommender_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)
BACKENDS = ("nccl", "gloo")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


@dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model


class Mesh:
    """This rank's place on a (data, model) grid: its coordinates, device,
    backend and the process group of each axis."""

    def __init__(self, spec: MeshSpec, backend: str, device: torch.device, rank: int,
                 groups: Dict[str, Optional[dist.ProcessGroup]]):
        self.spec = spec
        self.backend = backend
        self.device = device
        self.rank = rank
        self.groups = groups
        self.coords = {DATA_AXIS: rank // spec.model, MODEL_AXIS: rank % spec.model}
        self.reset_counts()

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.spec.data, MODEL_AXIS: self.spec.model}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def reset_counts(self) -> None:
        self.calls = {a: 0 for a in AXES}
        self.bytes = {a: 0 for a in AXES}

    def counts(self) -> Dict[str, Dict[str, int]]:
        """{axis: {"calls": n, "bytes": b}} since the last reset."""
        return {a: {"calls": self.calls[a], "bytes": self.bytes[a]} for a in AXES}

    def _check(self, x: torch.Tensor) -> None:
        if x.device.type != self.device.type:
            raise ValueError(f"a collective of the mesh on {self.device} got a tensor on {x.device}")
        if self.backend == "nccl" and x.device.type != "cuda":
            raise ValueError(f"the nccl backend runs collectives on CUDA tensors, got {x.device}")

    def all_reduce(self, x: torch.Tensor, op: str = "sum", axis: str = MODEL_AXIS) -> torch.Tensor:
        """The reduction of ``x`` over ``axis`` (``op`` "sum", "max" or
        "min"), a new tensor; not differentiable."""
        self._check(x)
        if self.size(axis) == 1:
            return x.detach().clone()
        out = x.detach().contiguous().clone()
        dist.all_reduce(out, _OPS[op], group=self.groups[axis])
        self.calls[axis] += 1
        self.bytes[axis] += out.numel() * out.element_size()
        return out

    def gather(self, x: torch.Tensor, axis: str = MODEL_AXIS) -> torch.Tensor:
        """(n, *x.shape): every rank of ``axis``' ``x`` in index order."""
        self._check(x)
        n = self.size(axis)
        if n == 1:
            return x.detach()[None].clone()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.detach().contiguous(), group=self.groups[axis])
        out = torch.stack(parts)
        self.calls[axis] += 1
        self.bytes[axis] += out.numel() * out.element_size()
        return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, "sum", axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, "sum", ctx.axis), None, None


def psum(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """``x`` summed over ``axis``; the cotangent passes through."""
    return _Psum.apply(x, mesh, axis)


def pvary(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """``x`` as it is; its cotangent is summed over ``axis``."""
    return _Pvary.apply(x, mesh, axis)


def make_mesh(spec: Optional[MeshSpec] = None, backend: Optional[str] = None,
              device="cuda", ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """This rank's mesh over the initialized process group
    (``core/distributed.py::initialize``); all ranks of the group call it
    in the same order. ``ranks`` (default: every rank of the group) are the
    group's ranks the mesh spans, in mesh order, and must number
    ``spec.num_devices``; a rank outside them gets None, and a rank inside
    takes its position in ``ranks`` as its mesh rank. With no spec, every
    rank goes on the data axis. ``backend`` (default: the process group's)
    names the collectives' backend; ``device`` is this rank's device
    (raises without CUDA unless ``device="cpu"``).

    The groups are made with ``dist.new_group`` per axis rather than
    ``init_device_mesh``, which maps rank r to the card ``r % count``
    itself: ranks that share one card over gloo need the device to be the
    caller's."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(core/distributed.py::initialize)")
    world, rank = dist.get_world_size(), dist.get_rank()
    members = list(range(world)) if ranks is None else [int(r) for r in ranks]
    spec = MeshSpec(data=len(members), model=1) if spec is None else spec
    if spec.num_devices != len(members):
        have = f"the process group has {world}" if ranks is None else f"got ranks {members}"
        raise ValueError(f"mesh {spec} needs {spec.num_devices} ranks, {have}")
    if len(set(members)) != len(members) or not all(0 <= r < world for r in members):
        raise ValueError(f"ranks {members} are not distinct ranks of a group of {world}")
    backend = backend or str(dist.get_backend())
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend runs on CUDA devices, got {dev}")
    D, M = spec.data, spec.model
    pos = members.index(rank) if rank in members else None
    groups: Dict[str, Optional[dist.ProcessGroup]] = {DATA_AXIS: None, MODEL_AXIS: None}
    # every rank creates every group, in one order (new_group is collective)
    for d in range(D):
        g = dist.new_group([members[d * M + m] for m in range(M)], backend=backend)
        if pos is not None and pos // M == d:
            groups[MODEL_AXIS] = g
    for m in range(M):
        g = dist.new_group([members[d * M + m] for d in range(D)], backend=backend)
        if pos is not None and pos % M == m:
            groups[DATA_AXIS] = g
    return None if pos is None else Mesh(spec, backend, dev, pos, groups)


def single_device_mesh(backend: str = "nccl", device="cuda") -> Mesh:
    """A (1, 1) mesh; starts a process group of one rank (an in-memory
    store) when none is running. That group lives on in the process until
    the caller that started it calls ``dist.destroy_process_group()``."""
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh(MeshSpec(1, 1), backend, device)
