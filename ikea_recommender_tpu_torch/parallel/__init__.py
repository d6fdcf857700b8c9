"""The (data, model) mesh's sharded ops and rules (ROADMAP A.9a).

Port of ``ikea_recommender_tpu/parallel/__init__.py``; its
``batch_sharding_tree`` has no counterpart, since each rank holds its own
rows (``core/distributed.py::local_rows``).
"""

from ikea_recommender_tpu_torch.parallel.sharding import (
    make_sharded_train_step,
    shard_state,
    state_shardings,
)
from ikea_recommender_tpu_torch.parallel.topk import sharded_softmax_ce, sharded_top_k

__all__ = [
    "state_shardings",
    "shard_state",
    "make_sharded_train_step",
    "sharded_top_k",
    "sharded_softmax_ce",
]
