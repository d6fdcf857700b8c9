"""The ``run`` subcommand shared by the numpy-only protocol modules
(``run/retailrocket.py``, ``run/ikea_rehearsal.py``): the card, the fp32
products, smorl's diversity-embedding discovery, the trainer, and the
scripts' ``run_summary.json``. Each module supplies only its ``Config``
builder and its refusal text."""

from __future__ import annotations

import glob
import json
import os
from typing import Callable, Optional


def find_div_embedding(out: str) -> Optional[str]:
    """A gru4rec leg's ``embedding_weights.npy`` beside ``out`` (the
    scripts' discovery): a sibling run's whose path names gru4rec first,
    else any sibling's, else one in ``out``'s parent itself."""
    parent = os.path.dirname(os.path.abspath(out))
    candidates = sorted(glob.glob(os.path.join(parent, "*", "embedding_weights.npy"))) + sorted(
        glob.glob(os.path.join(parent, "embedding_weights.npy")))
    pretrained = [c for c in candidates if "gru4rec" in c.lower()] or candidates
    return pretrained[0] if pretrained else None


def train_and_summarize(args, run_config: Callable, refusal: str):
    """Train ``args.family`` with ``run_config(args, div_emb_path)`` on
    ``args.device`` (default the card; raises without CUDA unless ``--device
    cpu``) and write run_summary.json; returns the trainer's
    ``TrainOutcome``. The smorl leg reads ``--div-emb`` or a sibling gru4rec
    leg's export, and exits with ``refusal`` without one."""
    import torch

    from ikea_recommender_tpu_torch.core.device import resolve_device
    from ikea_recommender_tpu_torch.run.trainer import train

    device = resolve_device(getattr(args, "device", "cuda"))
    # fp32 products, as the CLI runs them (run/cli.py)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    os.makedirs(args.out, exist_ok=True)
    # The frozen diversity-embedding chain: the gru4rec leg exports
    # embedding_weights.npy to its --out; the smorl leg reads it.
    div_emb_path = getattr(args, "div_emb", None)
    if args.family == "smorl" and not div_emb_path:
        div_emb_path = find_div_embedding(args.out)
        if div_emb_path is None:
            raise SystemExit(refusal)
        print(f"[run] smorl: auto-discovered diversity embedding {div_emb_path}")
    cfg = run_config(args, div_emb_path)
    out = train(cfg, progress=True, device=device)
    keys = [k for k in out.test_metrics if "HR" in k or "NDCG" in k]
    print("[run] headline:", {k: round(out.test_metrics[k], 4) for k in sorted(keys)})
    print(f"[run] best {cfg.train.best_model_metric}={out.best_metric:.4f} "
          f"@ eval point {out.best_epoch}")
    print(f"[run] in-loop throughput: {out.throughput_sessions_per_sec:,.0f} sessions/s "
          f"(train spans only, host clock to the device)")
    with open(os.path.join(args.out, "run_summary.json"), "w") as fh:
        json.dump({
            "family": args.family,
            "epochs": args.epochs,
            "best_metric": out.best_metric,
            "best_epoch": out.best_epoch,
            "test_metrics": out.test_metrics,
            "train_sessions_per_sec": out.throughput_sessions_per_sec,
            "timing": out.timing,  # idx_build/dispatch/sync/eval breakdown
            "div_emb": div_emb_path,
            "preset": getattr(args, "preset", None),
            "logs": out.logs,  # per-eval-point metric curves
        }, fh, indent=2)
    return out
