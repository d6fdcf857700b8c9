"""Directory-sweep experiment runner.

Port of ``scripts/run_all_experiments_in_dir.py`` (the reference's bash
YAML parser and nohup loop, ``scripts/general/run_all_experiments_in_dir.sh:
4-60``): for every YAML in the given directory, in sorted order, create
``ROOT/<exp_class>/<exp_name>/`` (``default`` and the file's stem when
the YAML names none), move the config there, and train it with the port's
trainer. A failing experiment is logged with its traceback and the sweep
goes on; any failure makes the exit code 1.

``--device`` (default ``cuda``) is the device every experiment trains on,
as in ``run/cli.py``. It is checked before the first YAML moves: without
CUDA the sweep raises unless given ``--device cpu``.

    python -m ikea_recommender_tpu_torch.run.run_all_experiments_in_dir CONFIG_DIR \\
        [--root experiments] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import traceback

import yaml

from ikea_recommender_tpu_torch.core.config import config_from_dict
from ikea_recommender_tpu_torch.core.device import resolve_device
from ikea_recommender_tpu_torch.run.logging_sinks import make_log_sinks
from ikea_recommender_tpu_torch.run.trainer import train


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("config_dir")
    p.add_argument("--root", default="experiments")
    p.add_argument("--device", default="cuda", help="torch device to train on (default: cuda)")
    args = p.parse_args(argv)
    resolve_device(args.device)

    yamls = sorted(
        f for f in os.listdir(args.config_dir) if f.endswith((".yaml", ".yml"))
    )
    if not yamls:
        print(f"no YAML configs in {args.config_dir}")
        return 1

    failures = []
    for name in yamls:
        src = os.path.join(args.config_dir, name)
        with open(src) as fh:
            raw = yaml.safe_load(fh) or {}
        exp_class = raw.get("exp_class", "default")
        exp_name = raw.get("exp_name", os.path.splitext(name)[0])
        exp_dir = os.path.join(args.root, exp_class, exp_name)
        os.makedirs(exp_dir, exist_ok=True)
        dst = os.path.join(exp_dir, name)
        if os.path.abspath(src) != os.path.abspath(dst):
            shutil.move(src, dst)
        cfg = config_from_dict(raw, exp_dir=exp_dir)
        print(f"=== {exp_class}/{exp_name} ===")
        log_fn, close_fn = make_log_sinks(cfg)
        try:
            outcome = train(cfg, log_fn=log_fn, progress=True, device=args.device)
            print(
                f"    best {cfg.train.best_model_metric}="
                f"{outcome.best_metric:.5f}"
            )
        except Exception:
            traceback.print_exc()
            failures.append(exp_name)
        finally:
            close_fn()
    if failures:
        print(f"FAILED: {failures}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
