"""Prediction visualization: the reference's click-stream/top-k plots
(``ikea/results/result_analysis.py:175-441``: ``plot_stream_and_predictions``,
``predict_and_plot_state``, ``find_working_example``) without the
hardwired BigQuery/requests/PIL stack.

Port of ``ikea_recommender_tpu/analysis/visualize.py``. Item metadata
(image URLs, names) comes from the same pluggable ``lookup_fn`` as
``trajectories.predict_and_describe``; the renderer writes a standalone
HTML report (the browser fetches the images: the port needs no network)
and, where matplotlib is importable, a figure from image arrays the caller
supplies. matplotlib is imported only inside
:func:`plot_stream_and_predictions`.
"""

from __future__ import annotations

import html
import json
from typing import Dict, List, Optional

import numpy as np



def find_hits(
    recommender,
    buf,
    k: int,
    max_rows: Optional[int] = None,
    min_state_len: int = 1,
    batch_size: int = 1024,
) -> np.ndarray:
    """Rows whose TRUE action appears in the model's top-k: the reference's
    ``find_working_example``/``find_working_multiple_clicks``
    (``result_analysis.py:323-379``) scanned rows one by one in Python;
    here one batched pass a block of ``batch_size`` rows, its ids read back
    once."""
    n = len(buf) if max_rows is None else min(max_rows, len(buf))
    hits = []
    for start in range(0, n, batch_size):
        rows = np.arange(start, min(start + batch_size, n))
        states = buf.state[rows]
        lens = buf.true_len[rows]
        idx = recommender.recommend(states, lens, k=k)[1].cpu().numpy()
        actions = buf.action[rows][:, None]
        hit = (idx == actions).any(axis=1)
        ok = hit & (lens >= min_state_len)
        hits.append(rows[ok])
    return np.concatenate(hits) if hits else np.zeros((0,), np.int64)


def _item_cell(item: int, meta: Optional[Dict], highlight: bool) -> str:
    label = html.escape(str((meta or {}).get("name", item)))
    url = (meta or {}).get("image_url")
    style = "border:3px solid #2a7" if highlight else "border:1px solid #ccc"
    img = (
        f'<img src="{html.escape(url)}" width="96" loading="lazy"><br>'
        if url
        else ""
    )
    return (
        f'<td style="{style};padding:4px;text-align:center">{img}'
        f"{label}</td>"
    )


def render_predictions_html(
    records: List[Dict],
    out_path: str,
    title: str = "Predictions",
) -> str:
    """Render ``predict_and_describe`` records (optionally with ``meta``
    dicts carrying ``image_url``/``name``) to a standalone HTML report:
    one row per record — the state click-stream, then the top-k predictions
    with the true next action highlighted (reference
    ``plot_stream_and_predictions``, ``result_analysis.py:175-284``)."""
    parts = [
        "<!doctype html><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title>",
        f"<h1>{html.escape(title)}</h1>",
    ]
    for rec in records:
        meta_by_pred = {
            int(p["item"]): p.get("meta") for p in rec["predictions"]
        }
        true_action = int(rec["true_action"])
        parts.append(f"<h3>row {rec['row']}</h3>")
        state_meta = rec.get("state_meta") or {}
        parts.append("<table><tr><th>state&nbsp;→</th>")
        for item in rec["state"]:
            parts.append(_item_cell(int(item), state_meta.get(int(item)), False))
        parts.append("</tr><tr><th>top-k</th>")
        for p in rec["predictions"]:
            parts.append(
                _item_cell(
                    int(p["item"]), p.get("meta"), int(p["item"]) == true_action
                )
            )
        parts.append("</tr></table>")
        if true_action not in meta_by_pred:
            parts.append(
                f"<p>true next action: <b>{true_action}</b> (not in top-k)</p>"
            )
    doc = "\n".join(parts)
    with open(out_path, "w") as fh:
        fh.write(doc)
    return out_path


def plot_stream_and_predictions(
    record: Dict,
    images: Optional[Dict[int, np.ndarray]] = None,
    save_to: Optional[str] = None,
):
    """Matplotlib flavor of the report for notebook use: state stream on the
    top row, predictions on the bottom, true action outlined. ``images``
    maps item id -> HxWx3 array (the caller fetches/decodes — the reference
    inlined requests+PIL here, ``result_analysis.py:85-103``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    state = [int(i) for i in record["state"]]
    preds = [int(p["item"]) for p in record["predictions"]]
    true_action = int(record["true_action"])
    ncols = max(len(state), len(preds))
    fig, axes = plt.subplots(2, ncols, figsize=(1.6 * ncols, 4))
    axes = np.atleast_2d(axes)
    for r, items in enumerate((state, preds)):
        for c in range(ncols):
            ax = axes[r][c]
            ax.set_xticks([])
            ax.set_yticks([])
            if c >= len(items):
                ax.axis("off")
                continue
            item = items[c]
            if images and item in images:
                ax.imshow(images[item])
            ax.set_title(str(item), fontsize=8)
            if r == 1 and item == true_action:
                for spine in ax.spines.values():
                    spine.set_edgecolor("green")
                    spine.set_linewidth(3)
    axes[0][0].set_ylabel("state", fontsize=9)
    axes[1][0].set_ylabel("top-k", fontsize=9)
    if save_to:
        fig.savefig(save_to, bbox_inches="tight")
        plt.close(fig)
        return save_to
    return fig


def save_records_json(records: List[Dict], out_path: str) -> str:
    with open(out_path, "w") as fh:
        json.dump(records, fh, indent=2, default=int)
    return out_path
