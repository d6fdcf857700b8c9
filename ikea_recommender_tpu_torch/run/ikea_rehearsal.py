"""The IKEA-flavor rehearsal without pandas: GA-schema synthetic sessions
-> dual tokenizers -> k-step IKEA buffers -> the trainer on the card
(gru4rec's embedding leg, then smorl).

Port of ``scripts/ikea_rehearsal.py`` (whose docstring sets out the
flavor: an INPUT vocabulary of products and inspiration images, an OUTPUT
head of the images only, states that end at the session's last inspiration
click, k-step cumulated returns, metrics read through the output->input
table), numpy only, so that it runs where pandas is not installed:

  synth    the script's draws from ``np.random.default_rng(seed)``, in its
           order: product views interleaved with inspiration clicks that
           follow the last viewed product, Zipf-like product popularity
  buffers  the script's 96/2/2 session split, tokenizers and buffers, by
           ``data/ikea_columns.py::preprocess_train_columns`` (the values of
           the frame path's ``preprocess_train_data``); the bottom quantile
           of the output items by train frequency as unpopular_items.json
  run      one family at the IKEA-final operating point on the card, writing
           the script's run_summary.json

The events are an ``.npz`` of the script's DataFrame columns (``sessionID``,
``item_id``, ``action_type``, ``reward``; the same values, strings as numpy
unicode), not a pickle: without pandas there is no ``.df``. Every other
file equals the script's. Each subcommand writes ``command_<cmd>.json``
(``utils/invocation.py``).

    python -m ikea_recommender_tpu_torch.run.ikea_rehearsal synth --out ikea --sessions 300000
    python -m ikea_recommender_tpu_torch.run.ikea_rehearsal buffers --data ikea --out ikea/buffers
    python -m ikea_recommender_tpu_torch.run.ikea_rehearsal run --buffers ikea/buffers \\
        --family gru4rec --epochs 8 --out ikea/runs/gru4rec
    python -m ikea_recommender_tpu_torch.run.ikea_rehearsal run --buffers ikea/buffers \\
        --family smorl --epochs 8 --lr 0.01 --out ikea/runs/smorl [--device cpu]

The smorl leg needs ``--lr 0.01``: at the default 0.0005 the 3-objective
Q-gradient keeps the supervised head at chance for the whole run.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import numpy as np

STATE_LEN = 10
REWARD_VIEW = 0.1
REWARD_CLICK = 1.0
EVENTS_FILE = "events.npz"


def synth(args) -> None:
    """Vectorized GA-like event log (the script's ``synth``, value for
    value): product views interleaved with inspiration clicks whose identity
    follows the last viewed product, skewed product popularity."""
    rs = np.random.default_rng(args.seed)
    S, P, I = args.sessions, args.products, args.insp
    lengths = rs.integers(5, 13, S)
    sess = np.repeat(np.arange(S, dtype=np.int64), lengths)
    E = len(sess)
    starts = np.zeros(E, bool)
    starts[np.concatenate([[0], np.cumsum(lengths)[:-1]])] = True
    is_insp = (rs.random(E) < 0.35) & ~starts  # sessions open with a view

    # product views: skewed popularity (u^3 concentrates near 0)
    prod = np.minimum((rs.random(E) ** 3 * P).astype(np.int64), P - 1)
    # the index of the last product view so far: every session starts with
    # one, so a running maximum over the whole log stays in its session
    pidx = np.where(~is_insp, np.arange(E), -1)
    prev_prod = prod[np.maximum.accumulate(pidx)]
    insp = np.where(rs.random(E) < 0.7, prev_prod % I, rs.integers(0, I, E))

    item = np.where(is_insp, np.char.add("insp_", insp.astype(str)),
                    np.char.add("prod_", prod.astype(str)))
    cols = {
        "sessionID": sess,
        "item_id": item.astype(f"U{max(int(np.char.str_len(item).max(initial=0)), 1)}"),
        "action_type": np.where(is_insp, "click_inspiration", "view_product"),
        "reward": np.where(is_insp, REWARD_CLICK, REWARD_VIEW),
    }
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, EVENTS_FILE), **cols)
    meta = {
        "sessions": int(S),
        "events": int(E),
        "products": int(P),
        "insp": int(I),
        "insp_clicks": int(is_insp.sum()),
    }
    with open(os.path.join(args.out, "synth_meta.json"), "w") as fh:
        json.dump(meta, fh, indent=2)
    print(f"[synth] {meta}")


def load_events(data_dir: str) -> Dict[str, np.ndarray]:
    """``synth``'s event columns from ``data_dir``."""
    with np.load(os.path.join(data_dir, EVENTS_FILE)) as data:
        return {k: data[k] for k in data.files}


def unpopular_items(actions: np.ndarray, num_actions: int, quantile: float) -> list:
    """The ``quantile`` least frequent output items of the train rows, in
    the script's order of ties (``np.argsort``'s default kind), sorted."""
    freq = np.bincount(actions, minlength=num_actions)
    order = np.argsort(freq)
    cut = int(len(order) * quantile)
    return sorted(int(a) for a in order[:cut])


def buffers(args) -> None:
    from ikea_recommender_tpu_torch.data.ikea_columns import preprocess_train_columns
    from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer, ReplayBuffer
    from ikea_recommender_tpu_torch.data.tokenizer import Tokenizer

    t0 = time.perf_counter()
    events = load_events(args.data)
    with open(os.path.join(args.data, "synth_meta.json")) as fh:
        meta = json.load(fh)
    P, I = meta["products"], meta["insp"]

    input_tok = Tokenizer([f"prod_{i}" for i in range(P)] + [f"insp_{i}" for i in range(I)])
    output_tok = Tokenizer([f"insp_{i}" for i in range(I)])

    # session split: 96/2/2 train/val/test
    m = events["sessionID"] % 50
    splits = {"train": m >= 2, "val": m == 0, "test": m == 1}
    os.makedirs(args.out, exist_ok=True)
    counts = {}
    for name, rows in splits.items():
        cols = preprocess_train_columns(
            {k: v[rows] for k, v in events.items()},
            padding_id=input_tok.pad_idx,
            state_len=args.state_len,
            tokenizer_market=None,
            tokenizer_input=input_tok,
            tokenizer_output=output_tok,
            future_steps_next_state=args.future_steps,
        )
        counts[name] = len(cols["action"])
        if name == "train":
            ReplayBuffer(
                state=cols["state"], action=cols["action"], reward=cols["r_act"],
                next_state=cols["next_state"], true_len=cols["true_state_len"],
                true_next_len=cols["true_next_state_len"], is_end=cols["is_end"],
            ).save_npz(os.path.join(args.out, "replay_buffer.npz"))
            unpop = unpopular_items(cols["action"], len(output_tok) - 1, args.unpopular_quantile)
            with open(os.path.join(args.out, "unpopular_items.json"), "w") as fh:
                json.dump(unpop, fh)
        else:
            EvalBuffer(state=cols["state"], action=cols["action"], true_len=cols["true_state_len"]
                       ).save_npz(os.path.join(args.out, f"{name}_buffer.npz"))
    input_tok.save_to_file(os.path.join(args.out, "input_tokenizer.json"))
    output_tok.save_to_file(os.path.join(args.out, "output_tokenizer.json"))
    with open(os.path.join(args.out, "meta.json"), "w") as fh:
        json.dump(
            {
                "num_items": len(input_tok) - 1,
                "num_actions": len(output_tok) - 1,
                "padding_id": input_tok.pad_idx,
                "state_len": args.state_len,
                "future_steps": args.future_steps,
                "windows": counts,
            },
            fh,
            indent=2,
        )
    print(f"[buffers] windows={counts} input_vocab={len(input_tok)-1} "
          f"output_vocab={len(output_tok)-1} ({time.perf_counter()-t0:.1f}s)")


def run_config(args, div_emb_path: Optional[str]):
    """The script's ``Config`` for ``args`` (``scripts/ikea_rehearsal.py:205-
    261``), the IKEA-final operating point: batch 256, val batch 5000,
    E = H = 64, gamma 0.5, eval at 4 points an epoch, HR/NDCG at {1, 6, 12},
    ``Val_NDCG@12``; the tokenizers, and for smorl ``require_div_emb``."""
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
            exp_class="IKEA-Rehearsal",
            exp_name=f"{args.family}_rehearsal",
            seed=args.seed,
            save_pretrained_embeddings=(args.family == "gru4rec"),
        ),
        data=DataConfig(
            num_items=meta["num_items"],
            num_actions=meta["num_actions"],
            train_path=os.path.join(args.buffers, "replay_buffer.npz"),
            val_path=os.path.join(args.buffers, "val_buffer.npz"),
            test_path=os.path.join(args.buffers, "test_buffer.npz"),
            input_tokenizer=os.path.join(args.buffers, "input_tokenizer.json"),
            output_tokenizer=os.path.join(args.buffers, "output_tokenizer.json"),
        ),
        train=TrainConfig(
            model=args.family,
            batch_size=256,
            val_batch_size=5000,
            epochs=args.epochs,
            learning_rate=getattr(args, "lr", 0.0005),
            embedding_size=64,
            hidden_state_size=64,
            state_size=meta["state_len"],
            gamma=0.5,
            alpha=getattr(args, "alpha", 1.0),
            q_weights=[1.0, 1.0, 1.0],
            best_model_metric="Val_NDCG@12",
            eval_at=[0.25, 0.5, 0.75, 1.0],
            padding_id=meta["padding_id"],
            preset=preset,
            checkpoint_dir=os.path.join(args.out, "ckpt") if checkpoint else None,
            resume=bool(checkpoint),
        ),
        metrics=MetricsConfig(
            topk_hr_ndcg=[1, 6, 12],
            topk_cov=[1, 5, 10, 20],
            topk_div=1,
            div_emb_dir=div_emb_path,
            require_div_emb=(args.family == "smorl"),
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
        "[run] smorl needs the gru4rec leg's embedding_weights.npy "
        "(run --family gru4rec first) or --div-emb")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("synth")
    s.add_argument("--out", required=True)
    s.add_argument("--sessions", type=int, default=300_000)
    s.add_argument("--products", type=int, default=100_000)
    s.add_argument("--insp", type=int, default=10_000)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=synth)

    b = sub.add_parser("buffers")
    b.add_argument("--data", required=True)
    b.add_argument("--out", required=True)
    b.add_argument("--state-len", type=int, default=STATE_LEN)
    b.add_argument("--future-steps", default=3,
                   type=lambda v: v if v == "all" else int(v),
                   help="k-step cumulated returns ('all' or int >= 2; 1 = plain next-step)")
    b.add_argument("--unpopular-quantile", type=float, default=0.4)
    b.set_defaults(fn=buffers)

    r = sub.add_parser("run")
    r.add_argument("--buffers", required=True)
    r.add_argument("--family", default="gru4rec", choices=["gru4rec", "sqn", "smorl", "sarm"])
    r.add_argument("--epochs", type=int, default=8)
    r.add_argument("--lr", type=float, default=0.0005,
                   help="IKEA-final default; for smorl use 0.01 (at 0.0005 the "
                        "3-objective Q-gradient keeps the supervised head at chance)")
    r.add_argument("--alpha", type=float, default=1.0,
                   help="Q-loss weight; 0 = pure supervised bisect arm")
    r.add_argument("--preset", default=None, choices=["fast", "reference"])
    r.add_argument("--checkpoint", action="store_true")
    r.add_argument("--div-emb", default=None)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--out", required=True)
    r.add_argument("--device", default="cuda", help="torch device to train on (default: cuda)")
    r.set_defaults(fn=run)
    return p


def main(argv=None):
    """Run the subcommand of ``argv``; returns ``run``'s ``TrainOutcome``
    (None for the others)."""
    from ikea_recommender_tpu_torch.utils.invocation import record_invocation

    args = get_parser().parse_args(argv)
    record_invocation(args, args.out)  # every subcommand's --out is a directory
    return args.fn(args)


if __name__ == "__main__":
    main()
