"""The subpackages' public names, each imported from its module at first
use.

A subpackage's ``__init__`` names what it exports (the reference package's
``__init__`` files list the same names) without importing its modules: the
port's modules import one another across subpackages (``ops.fused_topk``
reads ``train.lazy_adam``, ``train.steps`` reads ``ops.fused_topk``), so
eager re-exports would import in a cycle. Importing a subpackage therefore
costs nothing and builds no kernel; ``from ikea_recommender_tpu_torch.train
import make_train_step`` imports ``train.steps`` then.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Sequence, Tuple


def lazy_exports(package: str, modules: Dict[str, Sequence[str]]
                 ) -> Tuple[List[str], Callable[[str], object]]:
    """``(__all__, __getattr__)`` for ``package`` from {module name under
    the package: its exported names}."""
    where = {name: mod for mod, names in modules.items() for name in names}

    def __getattr__(name: str):
        if name not in where:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        return getattr(importlib.import_module(f"{package}.{where[name]}"), name)

    return list(where), __getattr__
