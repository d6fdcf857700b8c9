"""Embedding, trajectory and prediction analysis of a trained model.

Port of ``ikea_recommender_tpu/analysis/__init__.py``, the same names."""

from ikea_recommender_tpu_torch.analysis.embeddings import (
    cosine_similarity_matrix,
    nearest_neighbors,
)
from ikea_recommender_tpu_torch.analysis.trajectories import (
    find_action_rows,
    predict_and_describe,
    sample_trajectories,
)
from ikea_recommender_tpu_torch.analysis.visualize import (
    find_hits,
    plot_stream_and_predictions,
    render_predictions_html,
)

__all__ = [
    "cosine_similarity_matrix",
    "nearest_neighbors",
    "find_action_rows",
    "predict_and_describe",
    "sample_trajectories",
    "find_hits",
    "plot_stream_and_predictions",
    "render_predictions_html",
]
