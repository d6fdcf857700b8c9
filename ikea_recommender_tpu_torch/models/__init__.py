"""Embedding + GRU backbone + heads, all five families.

Port of ``ikea_recommender_tpu/models/__init__.py``."""

from ikea_recommender_tpu_torch._exports import lazy_exports

# not exported: init_backbone, init_model (no counterpart: convert.numpy_init_params draws)
__all__, __getattr__ = lazy_exports(__name__, {
    "backbone": ("BackboneConfig", "apply_backbone"),
    "families": ("ModelConfig", "apply_model", "model_config_from_train"),
})
