"""Metric-name logging dicts.

Port of ``ikea_recommender_tpu/utils/__init__.py``, the same names."""

from ikea_recommender_tpu_torch._exports import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "logging_dicts": ("get_logging_dict_train", "get_logging_dict_test"),
})
