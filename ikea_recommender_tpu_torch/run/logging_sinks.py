"""Logging sinks: optional wandb, optional TensorBoard.

The port's own copy of ``ikea_recommender_tpu/run/logging_sinks.py``.
TensorBoard uses the reference's ``CorrectedSummaryWriter`` behavior
(``utils/summary_writer.py:6-24``): ``add_hparams`` writes into the run's
own log dir instead of a fresh subdirectory. Both sinks are import-gated:
the package never hard-depends on them, and with neither set the returned
functions do nothing.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

from ikea_recommender_tpu_torch.core.config import Config


def make_log_sinks(cfg: Config) -> Tuple[Callable[[Dict, int], None], Callable[[], None]]:
    """(log_fn(dict, step), close_fn()) over the sinks ``cfg.experiment``
    asks for."""
    sinks = []
    closers = []

    if cfg.experiment.use_wandb:
        try:
            import wandb

            wandb.init(
                project=cfg.experiment.exp_class,
                name=cfg.experiment.exp_name,
                config={"exp_dir": cfg.exp_dir},
            )
            sinks.append(lambda d, step: wandb.log(d, step=step))
            closers.append(wandb.finish)
        except ImportError:
            print("[logging] wandb requested but not installed; skipping")

    if cfg.experiment.use_tensorboard:
        try:
            from torch.utils.tensorboard import SummaryWriter

            class CorrectedSummaryWriter(SummaryWriter):
                """add_hparams into self.log_dir (no extra subdir)."""

                def add_hparams(self, hparam_dict, metric_dict):
                    from torch.utils.tensorboard.summary import hparams

                    exp, ssi, sei = hparams(hparam_dict, metric_dict)
                    self.file_writer.add_summary(exp)
                    self.file_writer.add_summary(ssi)
                    self.file_writer.add_summary(sei)
                    for k, v in metric_dict.items():
                        self.add_scalar(k, v)

            tb_dir = os.path.join(
                cfg.exp_dir, cfg.experiment.tensorboard_root, cfg.experiment.exp_name
            )
            writer = CorrectedSummaryWriter(log_dir=tb_dir)

            def tb_log(d, step):
                for k, v in d.items():
                    writer.add_scalar(k, v, step)

            sinks.append(tb_log)
            closers.append(writer.close)
        except ImportError:
            print("[logging] tensorboard requested but not installed; skipping")

    def log_fn(d: Dict, step: int) -> None:
        for s in sinks:
            s(d, step)

    def close_fn() -> None:
        for c in closers:
            c()

    return log_fn, close_fn


def export_wandb_history(run_path: str, out_csv: str) -> None:
    """Export a wandb run's metric history to CSV (reference
    ``ikea/data_utils/utils.py:106-118`` download_wandb_history)."""
    import wandb  # optional, import-gated like the sinks

    api = wandb.Api()
    run = api.run(run_path)
    run.history().to_csv(out_csv)
