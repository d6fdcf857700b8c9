"""CLI driver: ``python -m ikea_recommender_tpu_torch.run.cli -f experiment.yaml``.

The port's counterpart of ``ikea_recommender_tpu/run/cli.py``: one driver,
the model family comes from the config, and the config file's directory
becomes the experiment output dir. It prints the test metrics as JSON and a
``best <metric>=... @ eval point N; S sessions/s`` line. ``--device``
(default ``cuda``) takes the place of the reference's ``IKEA_PLATFORM``
override; ``--device cpu`` runs the kernels' plain twins. Dense products
run with TF32 off.

On a (data, model) mesh (the YAML's ``parallel:`` section) each rank is one
process of this CLI, started by ``torchrun`` (which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``):
``torchrun --nproc-per-node N -m ikea_recommender_tpu_torch.run.cli -f
exp.yaml --backend nccl``. With ``WORLD_SIZE > 1`` the CLI starts the
process group with ``--backend``, which it needs and never picks itself:
under nccl each rank trains on its own card (``cuda:LOCAL_RANK``), under
gloo on ``--device`` (ranks may share one card, or run on the CPU). Only
rank 0 prints the test metrics and the ``best ...`` line, and writes the
log sinks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.distributed as dist

from ikea_recommender_tpu_torch.core import distributed
from ikea_recommender_tpu_torch.core.config import load_experiment_config
from ikea_recommender_tpu_torch.core.mesh import BACKENDS
from ikea_recommender_tpu_torch.run.logging_sinks import make_log_sinks
from ikea_recommender_tpu_torch.run.trainer import train


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "-f", "--file", dest="filename", metavar="FILE", required=True,
        help="experiment definition YAML",
    )
    parser.add_argument(
        "--progress", action="store_true", help="print per-eval-point progress"
    )
    parser.add_argument(
        "--device", default="cuda", help="torch device to train on (default: cuda)"
    )
    parser.add_argument(
        "--backend", choices=BACKENDS, default=None,
        help="the collectives' backend when WORLD_SIZE > 1 (torchrun): nccl, one card a "
             "rank; gloo, every rank on --device",
    )
    return parser


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products (compute_dtype) reduce split-K partials in fp32, not bf16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device, rank, started = args.device, 0, False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if args.backend is None:
            raise SystemExit(f"WORLD_SIZE={os.environ['WORLD_SIZE']}: name the collectives' "
                             f"backend with --backend {{{','.join(BACKENDS)}}}")
        started = not dist.is_initialized()
        rank, _ = distributed.initialize(args.backend)
        if args.backend == "nccl":
            device = distributed.local_device("nccl")
    cfg = load_experiment_config(args.filename)
    log_fn, close_fn = make_log_sinks(cfg) if rank == 0 else (None, lambda: None)
    try:
        outcome = train(cfg, log_fn=log_fn, progress=args.progress, device=device)
    finally:
        close_fn()
        if started:
            dist.destroy_process_group()
    if rank != 0:
        return 0
    print(json.dumps(outcome.test_metrics, indent=2))
    print(
        f"best {cfg.train.best_model_metric}={outcome.best_metric:.5f} "
        f"@ eval point {outcome.best_epoch}; "
        f"{outcome.throughput_sessions_per_sec:.0f} sessions/s"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
