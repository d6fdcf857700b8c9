"""Orchestration: the trainer, checkpoints and best-model tracking.

Port of ``ikea_recommender_tpu/run/__init__.py``, the same names."""

from ikea_recommender_tpu_torch._exports import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "checkpoints": ("BestModelTracker", "CheckpointManager"),
    "trainer": ("train", "TrainOutcome"),
})
