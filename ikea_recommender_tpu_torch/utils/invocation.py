"""Record a driver's exact invocation next to its output.

The port's own copy of ``ikea_recommender_tpu/utils/invocation.py``: a
driver subcommand drops a ``command_<name>.json`` (its parsed arguments and
the raw argv) into its output directory, so that a generated dataset can be
regenerated from what was run. The caller passes the output directory: each
subcommand knows whether its ``--out`` is a file or a directory, so nothing
is guessed from the path's shape.
"""

from __future__ import annotations

import json
import os
import sys


def record_invocation(args, out_dir: str) -> None:
    """Write ``command_<args.cmd>.json`` into ``out_dir``.

    ``args`` is an argparse Namespace; its entries that cannot be written
    as JSON (the ``fn`` dispatch target, any callable) are dropped.
    """
    os.makedirs(out_dir or ".", exist_ok=True)
    rec = {k: v for k, v in vars(args).items() if k != "fn" and not callable(v)}
    rec["argv"] = sys.argv
    path = os.path.join(out_dir, f"command_{args.cmd}.json")
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=2)
