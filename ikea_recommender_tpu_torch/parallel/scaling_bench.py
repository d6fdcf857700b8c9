"""Sessions/s of a train step over (data, model) meshes of growing size.

Port of ``ikea_recommender_tpu/parallel/scaling_bench.py`` (BASELINE.md
north star: >= 85% sessions/s scaling efficiency at 1 chip / 1 host / N
hosts). It times the family's step on a mesh
(``parallel/sharding.py::make_sharded_train_step`` on the state cut by
``shard_state``) for each ``MeshSpec`` and reports sessions/s and the
efficiency against linear scaling from the first point.

The reference builds every mesh inside one process over its devices. The
port is one process per rank, so every rank of an initialized process group
(``torchrun``, or ``core/distributed.py::initialize``) calls
:func:`run_scaling_bench` with the same arguments, and each point's mesh
spans the group's first ``spec.num_devices`` ranks (``core/mesh.py::
make_mesh(ranks=...)``); the other ranks wait for it. A spec larger than
the group is skipped, as the reference skips one larger than its device
count. Without a process group it starts one of one rank and ends it.

Each point reports the distinct cards its ranks used (``cards``) and
``shared_card`` where there are more ranks than cards: ranks that share one
card over gloo time-slice it and pass collectives through host copies, so
such a point's sessions/s and efficiency are not a scaling efficiency.

    torchrun --nproc-per-node 2 -m ikea_recommender_tpu_torch.parallel.scaling_bench \\
        --backend gloo      # ranks sharing one card; nccl: one card a rank

prints one JSON line a point (rank 0).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ikea_recommender_tpu_torch.convert import (
    numpy_init_double_q,
    numpy_init_params,
    params_from_numpy,
)
from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
from ikea_recommender_tpu_torch.core.device import resolve_device
from ikea_recommender_tpu_torch.core.distributed import initialize, local_device, local_rows
from ikea_recommender_tpu_torch.core.mesh import BACKENDS, Mesh, MeshSpec, make_mesh
from ikea_recommender_tpu_torch.models.families import model_config_from_train
from ikea_recommender_tpu_torch.parallel.sharding import make_sharded_train_step, shard_state
from ikea_recommender_tpu_torch.train.state import make_double_q_state, make_train_state
from ikea_recommender_tpu_torch.train.steps import RLStepConfig


@dataclass
class ScalePoint:
    mesh: Dict[str, int]
    global_batch: int
    steps_per_sec: float
    sessions_per_sec: float
    efficiency: float  # vs linear scaling from the first point
    # Host cores consumed during the timed loop: the ranks' process CPU
    # time over the wall time.
    cores_used: float = 0.0
    # Distinct cards the mesh's ranks used (0 on the CPU); shared_card where
    # there are more ranks than cards: then not a scaling efficiency.
    cards: int = 0
    shared_card: bool = False


def _make_batch(rs, B, T, A):
    return {
        "state": rs.randint(0, A, (B, T)).astype(np.int32),
        "action": rs.randint(0, A, (B,)).astype(np.int32),
        "reward": rs.rand(B).astype(np.float32),
        "next_state": rs.randint(0, A, (B, T)).astype(np.int32),
        "true_len": rs.randint(1, T + 1, (B,)).astype(np.int32),
        "true_next_len": rs.randint(1, T + 1, (B,)).astype(np.int32),
        "is_end": rs.rand(B) < 0.2,
        "valid": np.ones((B,), bool),
    }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_point(mesh: Mesh, model, per_device_batch, catalog, state_len, emb, hidden,
                warmup, iters):
    """(wall seconds, process CPU seconds) of ``iters`` steps on this
    rank's shard, after ``warmup``."""
    spec, dev = mesh.spec, mesh.device
    B = per_device_batch * spec.data
    train_cfg = TrainConfig(model=model, embedding_size=emb, hidden_state_size=hidden,
                            state_size=state_len)
    mc = model_config_from_train(train_cfg, DataConfig(num_items=catalog), align=spec.model)
    rs = np.random.RandomState(0)
    aux = {}
    if model == "smorl":
        aux = {"div_embedding": rs.randn(catalog + 1, emb).astype(np.float32),
               "unpopular_mask": np.arange(catalog) % 10 == 0}
    if model in ("sqn", "smorl"):
        pair = tuple(params_from_numpy(p, dev) for p in numpy_init_double_q(mc))
        state, opt = make_double_q_state(pair, mc, 0.01, device=dev)
    else:
        state, opt = make_train_state(params_from_numpy(numpy_init_params(mc, 0), dev), mc,
                                      0.01, device=dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in local_rows(_make_batch(rs, B, state_len, catalog), mesh).items()}
    step = make_sharded_train_step(mc, opt, mesh, RLStepConfig(), **aux)
    state = shard_state(state, mesh)
    for _ in range(warmup):
        state, _ = step(state, batch)
    _sync(dev)
    t0, c0 = time.perf_counter(), time.process_time()
    for _ in range(iters):
        state, _ = step(state, batch)
    _sync(dev)
    return time.perf_counter() - t0, time.process_time() - c0


def _reduce(values, op, dev: torch.device) -> List[float]:
    t = torch.tensor(values, dtype=torch.float64, device=dev)
    dist.all_reduce(t, op)
    return t.tolist()


def run_scaling_bench(
    model: str = "smorl",
    per_device_batch: int = 256,
    catalog: int = 70852,
    state_len: int = 10,
    emb: int = 64,
    hidden: int = 64,
    mesh_specs: Optional[List[MeshSpec]] = None,
    warmup: int = 3,
    iters: int = 20,
    backend: Optional[str] = None,
    device="cuda",
) -> List[ScalePoint]:
    """Every rank of the process group calls this with the same arguments
    and gets the same points. ``device`` is this rank's (raises without
    CUDA unless ``device="cpu"``); ``backend`` the meshes' collectives'
    (default: the process group's). Default specs: data 1, 2, 4, ... up to
    the group's size, then (size / 2, 2), as the reference's over its
    devices. A point's time is its slowest rank's."""
    dev = resolve_device(device)
    started = not dist.is_initialized()
    if started:
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                store=dist.HashStore(), rank=0, world_size=1)
    try:
        world = dist.get_world_size()
        if mesh_specs is None:
            mesh_specs = []
            d = 1
            while d <= world:
                mesh_specs.append(MeshSpec(data=d, model=1))
                d *= 2
            if world >= 2:
                mesh_specs.append(MeshSpec(data=world // 2, model=2))
        n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        results: List[ScalePoint] = []
        base_rate = None
        for spec in mesh_specs:
            if spec.num_devices > world:
                continue
            mesh = make_mesh(spec, backend, dev, ranks=range(spec.num_devices))
            dt, cpu, card = 0.0, 0.0, [0.0] * n_cards
            if mesh is not None:
                dt, cpu = _time_point(mesh, model, per_device_batch, catalog, state_len, emb,
                                      hidden, warmup, iters)
                if dev.type == "cuda":
                    card[dev.index if dev.index is not None else torch.cuda.current_device()] = 1
            dt, *card = _reduce([dt, *card], dist.ReduceOp.MAX, dev)
            (cpu,) = _reduce([cpu], dist.ReduceOp.SUM, dev)
            cards = int(sum(card))
            B = per_device_batch * spec.data
            steps_per_sec = iters / dt
            sessions = steps_per_sec * B
            if base_rate is None:
                base_rate = sessions / spec.num_devices
            results.append(ScalePoint(
                mesh={"data": spec.data, "model": spec.model},
                global_batch=B,
                steps_per_sec=steps_per_sec,
                sessions_per_sec=sessions,
                efficiency=sessions / (base_rate * spec.num_devices),
                cores_used=cpu / dt,
                cards=cards,
                shared_card=0 < cards < spec.num_devices,
            ))
        return results
    finally:
        if started:
            dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="smorl")
    p.add_argument("--backend", choices=BACKENDS, default=None,
                   help="the collectives' backend under torchrun (WORLD_SIZE > 1): nccl, "
                        "one card a rank; gloo, every rank on --device")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    device, rank, started = args.device, 0, False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if args.backend is None:
            raise SystemExit(f"WORLD_SIZE={os.environ['WORLD_SIZE']}: name the collectives' "
                             f"backend with --backend {{{','.join(BACKENDS)}}}")
        started = not dist.is_initialized()
        rank, _ = initialize(args.backend)
        if args.backend == "nccl":
            device = local_device("nccl")
    try:
        pts = run_scaling_bench(model=args.model, backend=args.backend, device=device)
    finally:
        if started:
            dist.destroy_process_group()
    if rank == 0:
        for pt in pts:
            print(json.dumps({
                "mesh": pt.mesh,
                "global_batch": pt.global_batch,
                "sessions_per_sec": round(pt.sessions_per_sec, 1),
                "efficiency": round(pt.efficiency, 3),
                "cards": pt.cards,
                "shared_card": pt.shared_card,
            }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
