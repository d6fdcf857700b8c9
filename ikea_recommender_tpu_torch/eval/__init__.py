"""The evaluation protocol.

Port of ``ikea_recommender_tpu/eval/__init__.py``, the same names."""

from ikea_recommender_tpu_torch._exports import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "protocol": ("EvalProtocol", "EvalAccum", "EvalResult"),
})
