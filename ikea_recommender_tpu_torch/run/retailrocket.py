"""The RetailRocket accuracy-parity protocol without pandas: raw
events.csv -> sampled session files -> replay buffers -> paper-operating-
point training runs on the card.

Port of ``scripts/retailrocket.py`` (whose docstring sets out the protocol:
Xin et al., SIGIR 2020, on the Kaggle "retailrocket/ecommerce-dataset"
events), numpy only, so that it runs where pandas is not installed:

  synth    schema-identical SYNTHETIC events.csv: the script's draws from
           ``np.random.default_rng(seed)`` in its order (``zipf`` as numpy
           2.0 draws it, :func:`zipf_numpy20`), written as pandas'
           ``to_csv`` writes them (the same seed gives the same bytes)
  etl      events.csv -> sampled_{train,val,test}.npz + item_map.json: the
           script's filters and split, with pandas' semantics reproduced
           (a stable sort by visitor then time, item counts and session
           lengths filtered to a joint fixpoint, session ids in order of
           appearance shuffled by the seeded generator, the 80/10/10 cut)
  buffers  sampled_*.npz -> the train replay buffer, the val/test eval
           buffers, unpopular_items.json, meta.json (the script's files and
           arrays)
  run      train one family at the paper operating point on the card and
           write run_summary.json

The splits are ``.npz`` files holding the script's pickled DataFrames'
columns (``session_id``, ``item_id``, ``is_buy``, ``reward``), in the same
row order and dtypes: without pandas there is no ``.df`` pickle. Each
subcommand writes ``command_<cmd>.json`` (``utils/invocation.py``).

    python -m ikea_recommender_tpu_torch.run.retailrocket synth --out rr/events.csv \\
        --num-sessions 260000 --num-items 135000 --seed 0
    python -m ikea_recommender_tpu_torch.run.retailrocket etl --events rr/events.csv --out rr/data
    python -m ikea_recommender_tpu_torch.run.retailrocket buffers --data rr/data --out rr/buffers
    python -m ikea_recommender_tpu_torch.run.retailrocket run --buffers rr/buffers \\
        --family gru4rec --out rr/gru4rec_run [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict, Optional

import numpy as np

REWARD_BUY = 1.0
REWARD_CLICK = 0.2
PAPER_CATALOG = 70852
STATE_LEN = 10
EVENT_COLUMNS = ("timestamp", "visitorid", "event", "itemid", "transactionid")
SPLIT_COLUMNS = ("session_id", "item_id", "is_buy", "reward")


# ---------------------------------------------------------------------------
# synth
# ---------------------------------------------------------------------------


def zipf_numpy20(rng: np.random.Generator, a: float, size: int) -> np.ndarray:
    """``rng.zipf(a, size)`` as numpy 2.0's ``Generator.zipf`` draws it,
    whatever numpy runs this. A later release changed the algorithm (its
    uniform draw is no longer ``1 - u``; numpy 2.3 draws so), so there the
    same seed gives other values and shifts every later draw.

    numpy 2.0's rejection loop takes two doubles an attempt, ``U = 1 - u``
    and ``V``; ``X = floor(U ** (-1 / (a - 1)))``; it rejects X past int64
    or below 1 and accepts where ``V X (T - 1) / (b - 1) <= T / b``, with
    ``T = (1 + 1/X) ** (a - 1)`` and ``b = 2 ** (a - 1)``. The doubles are
    drawn in bulk, never more than the samples still missing need, and the
    arithmetic is the C library's (``math.pow``), as numpy's."""
    am1 = a - 1.0
    b = 2.0 ** am1
    big = float(np.iinfo(np.int64).max)
    out = []
    while len(out) < size:
        uv = rng.random(2 * (size - len(out))).tolist()
        for u, v in zip(uv[0::2], uv[1::2]):
            x = float(math.floor(math.pow(1.0 - u, -1.0 / am1)))
            if x > big or x < 1.0:
                continue
            t = math.pow(1.0 + 1.0 / x, am1)
            if v * x * (t - 1.0) / (b - 1.0) <= t / b:
                out.append(int(x))
    return np.asarray(out, dtype=np.int64)


def synth(args) -> None:
    """Markov-process sessions written in the exact events.csv schema, so
    the WHOLE protocol (etl -> buffers -> run) runs without the real
    dataset; byte for byte the script's file for the same arguments."""
    rng = np.random.default_rng(args.seed)
    n_items = args.num_items
    # popularity-skewed successor process, emitted as raw events
    pop = zipf_numpy20(rng, 1.3, n_items * 3) % n_items
    succ = rng.integers(0, n_items, size=(n_items, 4))
    lines = [",".join(EVENT_COLUMNS)]
    t = 1_400_000_000_000
    for s in range(args.num_sessions):
        length = int(rng.integers(3, 15))
        item = int(pop[rng.integers(len(pop))])
        visitor = 10_000 + s
        for _ in range(length):
            event = "transaction" if rng.random() < 0.05 else (
                "addtocart" if rng.random() < 0.05 else "view")
            # pandas writes the float column's NaN as "" and s as "s.0"
            tx = repr(float(s)) if event == "transaction" else ""
            lines.append(f"{t},{visitor},{event},{100_000 + item},{tx}")
            t += int(rng.integers(1_000, 600_000))
            item = (int(succ[item, rng.integers(4)])
                    if rng.random() < 0.7 else int(pop[rng.integers(len(pop))]))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    # every session has at least 3 events, so each visitor id appears
    print(f"[synth] wrote {args.out}: {len(lines) - 1} events, {args.num_sessions} sessions")


# ---------------------------------------------------------------------------
# etl
# ---------------------------------------------------------------------------


def read_events(path: str) -> Dict[str, np.ndarray]:
    """events.csv -> {timestamp, visitorid, itemid: int64; event: str}, the
    columns etl reads, in file order. Plain comma-separated fields with a
    header row, as the dataset and ``synth`` write them (no quoting)."""
    with open(path, "r", newline="") as fh:
        header = fh.readline().rstrip("\r\n").split(",")
        body = fh.read()
    missing = {"timestamp", "visitorid", "event", "itemid"} - set(header)
    if missing:
        raise SystemExit(f"events file lacks columns {sorted(missing)}")
    fields = body.replace("\r\n", "\n").rstrip("\n")
    fields = fields.replace("\n", ",").split(",") if fields else []
    width = len(header)
    if len(fields) % width:
        raise SystemExit(f"{path}: a row does not have the header's {width} fields")
    out = {}
    for name in ("timestamp", "visitorid", "event", "itemid"):
        col = fields[header.index(name)::width]
        out[name] = np.asarray(col) if name == "event" else np.asarray(col, dtype=np.int64)
    return out


def unique_in_order(x: np.ndarray) -> np.ndarray:
    """The distinct values of ``x`` in order of first appearance, as
    pandas' ``Series.unique`` returns them."""
    _, first = np.unique(x, return_index=True)
    return x[np.sort(first)]


def _take(cols: Dict[str, np.ndarray], keep: np.ndarray) -> Dict[str, np.ndarray]:
    return {k: v[keep] for k, v in cols.items()}


def etl(args) -> None:
    ev = read_events(args.events)
    keep = np.isin(ev["event"], sorted(set(args.click_events) | set(args.buy_events)))
    ev = _take(ev, keep)
    ev["is_buy"] = np.isin(ev["event"], sorted(set(args.buy_events))).astype(np.int64)
    # the script's stable sort_values(["visitorid", "timestamp"])
    ev = _take(ev, np.lexsort((ev["timestamp"], ev["visitorid"])))

    # iterate item-count / session-length filters to a joint fixpoint
    while True:
        n0 = len(ev["itemid"])
        ids, counts = np.unique(ev["itemid"], return_counts=True)
        ev = _take(ev, np.isin(ev["itemid"], ids[counts >= args.min_item_count]))
        _, inv, sizes = np.unique(ev["visitorid"], return_inverse=True, return_counts=True)
        ev = _take(ev, sizes[inv.reshape(-1)] >= args.min_session_len)
        if len(ev["itemid"]) == n0:
            break

    items = np.unique(ev["itemid"])
    n_items = len(items)
    print(f"[etl] {len(ev['itemid'])} events, {len(np.unique(ev['visitorid']))} sessions, "
          f"{n_items} items ({int(ev['is_buy'].sum())} buys)")
    if n_items != PAPER_CATALOG:
        print(f"[etl] WARNING: catalog {n_items} != paper's {PAPER_CATALOG}; "
              f"use --padding-id {n_items} downstream")
    item_map = {int(o): i for i, o in enumerate(items)}
    cols = {
        "session_id": ev["visitorid"],
        "item_id": np.searchsorted(items, ev["itemid"]).astype(np.int64),
        "is_buy": ev["is_buy"],
        "reward": np.where(ev["is_buy"] == 1, REWARD_BUY, REWARD_CLICK),
    }

    rng = np.random.default_rng(args.seed)
    sessions = unique_in_order(cols["session_id"])
    rng.shuffle(sessions)
    if args.sample_sessions and args.sample_sessions < len(sessions):
        sessions = sessions[: args.sample_sessions]
        cols = _take(cols, np.isin(cols["session_id"], sessions))
    n = len(sessions)
    cut1, cut2 = int(n * 0.8), int(n * 0.9)
    parts = {"train": sessions[:cut1], "val": sessions[cut1:cut2], "test": sessions[cut2:]}
    os.makedirs(args.out, exist_ok=True)
    for name, ids in parts.items():
        part = _take(cols, np.isin(cols["session_id"], ids))
        path = os.path.join(args.out, f"sampled_{name}.npz")
        np.savez(path, **part)
        print(f"[etl] {path}: {len(part['session_id'])} events, {len(ids)} sessions")
    with open(os.path.join(args.out, "item_map.json"), "w") as fh:
        json.dump({"num_items": n_items,
                   "padding_id": n_items,
                   "item_map": {str(k): v for k, v in item_map.items()}}, fh)


def load_split(path: str) -> Dict[str, np.ndarray]:
    """A ``sampled_<split>.npz`` written by :func:`etl` -> its columns."""
    with np.load(path) as data:
        return {c: data[c] for c in SPLIT_COLUMNS}


# ---------------------------------------------------------------------------
# buffers
# ---------------------------------------------------------------------------


def buffers(args) -> None:
    from ikea_recommender_tpu_torch.data.item_frequency import get_low_frequency_items
    from ikea_recommender_tpu_torch.data.preprocessing import window_sessions
    from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer, ReplayBuffer

    with open(os.path.join(args.data, "item_map.json")) as fh:
        meta = json.load(fh)
    pad = meta["padding_id"]
    os.makedirs(args.out, exist_ok=True)

    def windows(split):
        cols = load_split(os.path.join(args.data, f"sampled_{split}.npz"))
        return cols, window_sessions(cols["item_id"], cols["session_id"], args.state_len, pad,
                                     args.pad_pos)

    train, win = windows("train")
    ReplayBuffer(
        state=win.state, action=win.action, reward=train["reward"], next_state=win.next_state,
        true_len=win.true_state_len, true_next_len=win.true_next_state_len, is_end=win.is_end,
    ).save_npz(os.path.join(args.out, "replay_buffer.npz"))
    for split in ("val", "test"):
        _, win = windows(split)
        EvalBuffer(state=win.state, action=win.action, true_len=win.true_state_len).save_npz(
            os.path.join(args.out, f"{split}_buffer.npz"))
    # unpopular set over the TRAIN interactions (novelty/coverage metrics)
    unpop = get_low_frequency_items(train["item_id"], quantile=args.unpopular_quantile)
    with open(os.path.join(args.out, "unpopular_items.json"), "w") as fh:
        json.dump(sorted(int(i) for i in unpop), fh)
    with open(os.path.join(args.out, "meta.json"), "w") as fh:
        json.dump({"num_items": meta["num_items"],
                   "padding_id": pad,
                   "state_len": args.state_len}, fh)
    print(f"[buffers] wrote buffers for catalog {meta['num_items']} -> {args.out}")


# ---------------------------------------------------------------------------
# run: the paper operating point
# ---------------------------------------------------------------------------


def run_config(args, div_emb_path: Optional[str]):
    """The script's ``Config`` for ``args`` (``scripts/retailrocket.py:287-328``):
    batch 256, val batch 2000, lr 0.01, E = H = 64, gamma 0.5."""
    from ikea_recommender_tpu_torch.core.config import (
        Config,
        DataConfig,
        ExperimentConfig,
        MetricsConfig,
        TrainConfig,
    )

    preset = getattr(args, "preset", None)
    checkpoint = getattr(args, "checkpoint", False)
    with open(os.path.join(args.buffers, "meta.json")) as fh:
        meta = json.load(fh)
    return Config(
        experiment=ExperimentConfig(
            exp_class="RetailRocket-Comparison", exp_name=f"{args.family}_paper",
            seed=args.seed,
            # gru4rec is the embedding-pretraining leg of the chain
            save_pretrained_embeddings=(args.family == "gru4rec"),
        ),
        data=DataConfig(
            num_items=meta["num_items"],
            train_path=os.path.join(args.buffers, "replay_buffer.npz"),
            val_path=os.path.join(args.buffers, "val_buffer.npz"),
            test_path=os.path.join(args.buffers, "test_buffer.npz"),
        ),
        train=TrainConfig(
            model=args.family,
            batch_size=256,
            val_batch_size=2000,
            epochs=args.epochs,
            learning_rate=0.01,
            embedding_size=64,
            hidden_state_size=64,
            state_size=meta["state_len"],
            gamma=0.5,
            alpha=1.0,
            q_weights=[1.0, 1.0, 1.0],
            best_model_metric="Val_NDCG@10",
            eval_at=[1.0],
            preset=preset,
            checkpoint_dir=os.path.join(args.out, "ckpt") if checkpoint else None,
            resume=checkpoint,
        ),
        metrics=MetricsConfig(
            topk_hr_ndcg=[10, 20],
            topk_cov=[1, 5, 10, 20],
            topk_div=1,
            div_emb_dir=div_emb_path,
            require_div_emb=(args.family == "smorl"),
            train_metrics=not getattr(args, "no_train_metrics", False),
            unpopular_actions_path=os.path.join(args.buffers, "unpopular_items.json"),
        ),
        exp_dir=args.out,
    )


def run(args):
    """Train ``args.family`` on ``args.device`` (default the card; raises
    without CUDA unless ``--device cpu``) and write run_summary.json;
    returns the trainer's ``TrainOutcome``."""
    from ikea_recommender_tpu_torch.run._rehearsal import train_and_summarize

    return train_and_summarize(
        args, run_config,
        "[run] smorl needs a frozen diversity embedding: run the gru4rec leg "
        "first (it exports embedding_weights.npy to its --out) or pass --div-emb "
        "explicitly. Without it the diversity reward is identically 0 (dead "
        "third objective).")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("etl")
    e.add_argument("--events", required=True)
    e.add_argument("--out", required=True)
    e.add_argument("--click-events", nargs="+", default=["view"])
    e.add_argument("--buy-events", nargs="+", default=["transaction", "addtocart"])
    e.add_argument("--min-item-count", type=int, default=3)
    e.add_argument("--min-session-len", type=int, default=3)
    e.add_argument("--sample-sessions", type=int, default=0,
                   help="keep only N randomly chosen sessions (0 = all)")
    e.add_argument("--seed", type=int, default=0)
    e.set_defaults(fn=etl)

    s = sub.add_parser("synth")
    s.add_argument("--out", required=True, help="synthetic events.csv path")
    s.add_argument("--num-sessions", type=int, default=400)
    s.add_argument("--num-items", type=int, default=300)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=synth)

    b = sub.add_parser("buffers")
    b.add_argument("--data", required=True, help="etl output dir")
    b.add_argument("--out", required=True)
    b.add_argument("--state-len", type=int, default=STATE_LEN)
    b.add_argument("--pad-pos", default="end", choices=["end", "beg"])
    b.add_argument("--unpopular-quantile", type=float, default=0.4)
    b.set_defaults(fn=buffers)

    r = sub.add_parser("run")
    r.add_argument("--buffers", required=True)
    r.add_argument("--family", default="gru4rec",
                   choices=["gru4rec", "bidir_gru4rec", "sqn", "smorl", "sarm"])
    r.add_argument("--epochs", type=int, default=30)
    r.add_argument("--preset", default=None, choices=["fast", "reference"],
                   help="numerics preset; None = default arm")
    r.add_argument("--checkpoint", action="store_true",
                   help="epoch checkpoints + resume under <out>/ckpt")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--no-train-metrics", action="store_true",
                   help="skip per-batch train-metric accumulation "
                        "(metrics.train_metrics=false; Train_* keys log 0)")
    r.add_argument("--div-emb", default=None,
                   help="frozen diversity-embedding export for smorl "
                        "(embedding_weights.npy from a gru4rec leg); "
                        "auto-discovered next to --out when omitted")
    r.add_argument("--out", required=True)
    r.add_argument("--device", default="cuda", help="torch device to train on (default: cuda)")
    r.set_defaults(fn=run)
    return p


def main(argv=None):
    """Run the subcommand of ``argv``; returns ``run``'s ``TrainOutcome``
    (None for the others)."""
    from ikea_recommender_tpu_torch.utils.invocation import record_invocation

    args = get_parser().parse_args(argv)
    # synth's --out is a FILE (events.csv); every other subcommand's a directory
    record_invocation(args, os.path.dirname(os.path.abspath(args.out)) if args.cmd == "synth"
                      else args.out)
    return args.fn(args)


if __name__ == "__main__":
    main()
