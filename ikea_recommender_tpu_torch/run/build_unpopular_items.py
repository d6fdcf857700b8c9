"""Write the unpopular-item set to JSON (reference
``data_utils/item_frequency.py`` CLI).

Port of ``scripts/build_unpopular_items.py``, the same flags and file,
without pandas: the events are read as columns by
``data/session_columns.py`` (``.csv``, JSON lines, or an ``.npz`` of the
columns in place of a pickle).

    python -m ikea_recommender_tpu_torch.run.build_unpopular_items -f events.csv -t out/ \\
        -q 0.9 -i item_id
"""

from __future__ import annotations

import argparse
import os

from ikea_recommender_tpu_torch.data.item_frequency import save_unpopular_items
from ikea_recommender_tpu_torch.data.session_columns import read_session_columns


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("-f", "--filename", required=True)
    p.add_argument("-t", "--targetdir", required=True)
    p.add_argument("-q", "--quantile", type=float, default=0.9)
    p.add_argument("-i", "--item-col-name", default="item_id")
    args = p.parse_args(argv)

    items = read_session_columns(args.filename)[args.item_col_name]
    os.makedirs(args.targetdir, exist_ok=True)
    out = os.path.join(args.targetdir, "unpopular_items.json")
    save_unpopular_items(items, out, quantile=args.quantile)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
