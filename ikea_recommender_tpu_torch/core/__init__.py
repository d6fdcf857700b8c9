"""Experiment config schema, device mesh and device choice.

Port of ``ikea_recommender_tpu/core/__init__.py``, the same names."""

from ikea_recommender_tpu_torch._exports import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "config": (
        "DataConfig",
        "ExperimentConfig",
        "MetricsConfig",
        "TrainConfig",
        "load_experiment_config",
    ),
    "mesh": ("MeshSpec", "make_mesh"),
})
