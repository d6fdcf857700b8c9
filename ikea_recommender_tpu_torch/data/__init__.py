"""Host-side data: tokenizer, session windowing, replay buffers and their
fixed-shape batches.

Port of ``ikea_recommender_tpu/data/__init__.py``, the same names."""

from ikea_recommender_tpu_torch._exports import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "tokenizer": ("Tokenizer",),
    "replay_buffer": ("ReplayBuffer", "EvalBuffer", "train_batches", "eval_batches"),
    "preprocessing": ("window_sessions", "preprocess_train_data", "preprocess_val_data"),
})
