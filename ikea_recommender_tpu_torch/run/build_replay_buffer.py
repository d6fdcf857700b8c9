"""Build replay buffers from a raw session file (RetailRocket-style).

Port of ``scripts/build_replay_buffer.py`` (the reference's
``scripts/general/replay_buffer_SMORL_from_file.py``: pad id 70852,
state_len 10), the same flags and files, without pandas: the session file
is read as columns by ``data/session_columns.py`` (``.csv``, JSON lines,
or an ``.npz`` of the columns in place of a pickled ``.df``).

    python -m ikea_recommender_tpu_torch.run.build_replay_buffer -f sessions.csv -o out/ \\
        --padding-id 70852 --state-len 10 [--eval]
"""

from __future__ import annotations

import argparse
import os

from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer, ReplayBuffer
from ikea_recommender_tpu_torch.data.session_columns import (
    preprocess_train_columns,
    preprocess_val_columns,
)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("-f", "--file", required=True,
                   help="raw session file (csv/jsonl, or npz for a pickle)")
    p.add_argument("-o", "--out", required=True, help="output directory")
    p.add_argument("--padding-id", type=int, default=70852)
    p.add_argument("--state-len", type=int, default=10)
    p.add_argument("--pad-pos", default="end", choices=["end", "beg"])
    p.add_argument("--session-col", default="session_id")
    p.add_argument("--item-col", default="item_id")
    p.add_argument("--reward-col", default="reward")
    p.add_argument("--eval", action="store_true", help="build an eval buffer instead")
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.eval:
        cols = preprocess_val_columns(
            args.file,
            padding_id=args.padding_id,
            state_len=args.state_len,
            pad_pos=args.pad_pos,
            session_id_name=args.session_col,
            action_name=args.item_col,
        )
        out = os.path.join(args.out, "eval_buffer.npz")
        EvalBuffer(state=cols["state"], action=cols["action"],
                   true_len=cols["true_state_len"]).save_npz(out)
    else:
        cols = preprocess_train_columns(
            args.file,
            padding_id=args.padding_id,
            state_len=args.state_len,
            pad_pos=args.pad_pos,
            session_id_name=args.session_col,
            action_name=args.item_col,
            reward_name=args.reward_col,
        )
        out = os.path.join(args.out, "replay_buffer.npz")
        ReplayBuffer(
            state=cols["state"], action=cols["action"], reward=cols["r_act"],
            next_state=cols["next_state"], true_len=cols["true_state_len"],
            true_next_len=cols["true_next_state_len"], is_end=cols["is_end"],
        ).save_npz(out)
    print(f"wrote {len(cols['action'])} rows -> {out}")


if __name__ == "__main__":
    main()
