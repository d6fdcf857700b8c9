"""RL tensor ops and ranking. The CUDA kernels' wrappers are modules of
their own (``fused_ce``, ``fused_argmax``, ``gru_cuda``) and build at
first use.

Port of ``ikea_recommender_tpu/ops/__init__.py``, the same names."""

from ikea_recommender_tpu_torch._exports import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "rl": ("gather_from_3d", "weighted_q_loss", "get_weighted_q_target", "get_max_action"),
    "ranking": ("topk_indices", "hit_ranks", "hr_ndcg_at_k"),
})
