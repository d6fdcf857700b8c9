"""Train states, Adam and the train steps.

Port of ``ikea_recommender_tpu/train/__init__.py``, the same names."""

from ikea_recommender_tpu_torch._exports import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "state": ("TrainState", "DoubleQState", "make_train_state", "make_double_q_state"),
    "steps": ("RLStepConfig", "make_train_step"),
})
