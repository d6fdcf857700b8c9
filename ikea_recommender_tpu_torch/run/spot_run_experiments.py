"""Spot-run mirrored experiment configs through the port's CLI on synthetic
data.

Port of ``scripts/spot_run_experiments.py``, numpy and PyYAML only: picks
one config from each mirrored experiment class, stages synthetic data in
its schema (RetailRocket flavor with click/buy action types; IKEA flavor
with dual tokenizers), rewrites ONLY the data paths, vocabulary sizes,
padding id, epoch count and eval batch into a run copy, and trains each
copy with ``python -m ikea_recommender_tpu_torch.run.cli``. The staged
files and the run copies are the script's: the IKEA events are numpy
columns windowed by ``data/ikea_columns.py::preprocess_train_columns``,
the values and row order of the frame path's ``preprocess_train_data``.

    python -m ikea_recommender_tpu_torch.run.spot_run_experiments [--platform=cpu] [config.yaml ...]

Default picks ONE config from every mirrored class directory (16 classes),
spanning the axes: beg/end padding, packed sequences, single/double-Q
Adam, action-type metrics, SMORL alpha/q_weights overrides, IKEA
dual-tokenizer data, 2-layer 128-wide bidirectional GRU, and the SARM
template. Data and copies go under ``REPO/data/spot``, where a staged
directory is reused. ``--platform=cpu`` trains with ``--device cpu`` (the
kernels' plain twins: slow); without it each copy trains on the card, and
without CUDA ``main`` raises before it stages anything.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import yaml

from ikea_recommender_tpu_torch.core.device import resolve_device
from ikea_recommender_tpu_torch.data.ikea_columns import preprocess_train_columns
from ikea_recommender_tpu_torch.data.item_frequency import save_unpopular_items
from ikea_recommender_tpu_torch.data.preprocessing import window_sessions
from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer, ReplayBuffer
from ikea_recommender_tpu_torch.data.split import train_test_split_ids
from ikea_recommender_tpu_torch.data.synthetic import synthetic_sessions
from ikea_recommender_tpu_torch.data.tokenizer import Tokenizer

# the directory above the package: configs are read and data staged below it
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULTS = [  # one per mirrored class directory
    "experiments/Ablations/SQN-action-types/SQN-action-types.yaml",
    "experiments/IKEA/Hyperparameter-Tuning/SMORL-lr-001-sd2-alpha5-133-divnovfirst/SMORL-lr-001-sd2-alpha5-133-divnovfirst.yaml",
    "experiments/IKEA/State-Length-Exp/BidirGRU-s20-d035-128-onelayer-twoGRUlay/BidirGRU-s20-d035-128-onelayer-twoGRUlay.yaml",
    "experiments/IKEA/Test-Runs/SQN-Test1-lr001-sd1/SQN-Test1-lr001-sd1.yaml",
    "experiments/IKEA/final_experiments/SMORL-paper/SMORL-paper.yaml",
    "experiments/IKEA/first_runs/IKEA_GRU_right_tokenizer_smallerBS/IKEA_GRU_right_tokenizer_smallerBS.yaml",
    "experiments/IKEA/templates/exp_adam_QSLATE-tester-64/exp_adam_QSLATE-tester-64.yaml",
    "experiments/RetailRocket-Comparison/GRU4Rec_paper/GRU4Rec_paper.yaml",
    "experiments/paper/GRU4Rec/GRU_opt3_packed/GRU_opt3_packed.yaml",
    "experiments/paper/RetailRocket-Comparison-Val/paper_SMORL/paper_SMORL.yaml",
    "experiments/paper/SMORL-RetailRocket/SMORL_GRU_front_train_pad/SMORL_GRU_front_train_pad.yaml",
    "experiments/paper/SMORL-SQN-Exps/SQN-SMORL-Rew1/SQN-SMORL-Rew1.yaml",
    "experiments/paper/SQN_RetailRocket_NoCV/SQN_GRU_paper_opt3_packed/SQN_GRU_paper_opt3_packed.yaml",
    "experiments/paper/SQN_RetailRocket_NoCV_2/SQN_GRU_paper_replica_trainable/SQN_GRU_paper_replica_trainable.yaml",
    "experiments/paper/SQN_RetailRocket_NoCV_final/SQN_GRU_paper_opt2_front/SQN_GRU_paper_opt2_front.yaml",
    "experiments/paper/playing/play_around/play_around.yaml",
]

RR_ITEMS = 500


def stage_retailrocket(out: str, pad_pos: str, state_len: int) -> None:
    os.makedirs(out, exist_ok=True)
    items, sids = synthetic_sessions(
        num_sessions=800, num_items=RR_ITEMS, mean_len=8, seed=11
    )
    tr, va, _te = train_test_split_ids(sids, seed=118)

    def build(mask):
        win = window_sessions(
            items[mask], sids[mask], state_len, pad_id=RR_ITEMS, pad_pos=pad_pos
        )
        rs = np.random.RandomState(3)
        # click/buy action types with the reference's 0.2/1.0 reward map
        types = (rs.rand(len(win)) < 0.25).astype(np.int32)
        return ReplayBuffer(
            state=win.state,
            action=win.action,
            reward=np.where(types == 1, 1.0, 0.2).astype(np.float32),
            next_state=win.next_state,
            true_len=win.true_state_len,
            true_next_len=win.true_next_state_len,
            is_end=win.is_end,
            action_type=types,
        )

    build(tr).save_npz(os.path.join(out, "replay_buffer.npz"))
    EvalBuffer.from_replay_buffer(build(va)).save_npz(
        os.path.join(out, "eval_buffer.npz")
    )
    save_unpopular_items(items, os.path.join(out, "unpopular_items.json"), 0.9)
    rs = np.random.RandomState(0)
    np.save(
        os.path.join(out, "OG_embeddings.npy"),
        rs.randn(RR_ITEMS + 1, 64).astype(np.float32),
    )


def ikea_events(n_prod: int = 120, n_insp: int = 60):
    """The script's 400 sessions of events, drawn from ``RandomState(5)`` in
    its order, as the columns of its frame: ``sessionID`` ``"s{s}"``,
    ``item_id``, ``action_type``, ``reward`` (float64)."""
    rs = np.random.RandomState(5)
    sessions, items, types, rewards = [], [], [], []
    for s in range(400):
        for _ in range(rs.randint(4, 10)):
            sessions.append(f"s{s}")
            if rs.rand() < 0.5:
                items.append(f"prod_{rs.randint(n_prod)}")
                types.append("view_product")
                rewards.append(0.0)
            else:
                items.append(f"insp_{rs.randint(n_insp)}")
                types.append("click_inspiration")
                rewards.append(1.0)
    return {
        "sessionID": np.array(sessions, dtype=object),
        "item_id": np.array(items, dtype=object),
        "action_type": np.array(types, dtype=object),
        "reward": np.array(rewards, dtype=np.float64),
    }


def stage_ikea(out: str, state_len: int) -> None:
    os.makedirs(out, exist_ok=True)
    n_prod, n_insp = 120, 60
    cols = ikea_events(n_prod, n_insp)
    input_tok = Tokenizer(
        [f"prod_{i}" for i in range(n_prod)]
        + [f"insp_{i}" for i in range(n_insp)]
    )
    output_tok = Tokenizer([f"insp_{i}" for i in range(n_insp)])
    input_tok.save_to_file(os.path.join(out, "input_tokenizer.json"))
    output_tok.save_to_file(os.path.join(out, "output_tokenizer.json"))
    Tokenizer(["se", "de"]).save_to_file(
        os.path.join(out, "market_tokenizer.json")
    )
    frame = preprocess_train_columns(
        cols,
        padding_id=input_tok.pad_idx,
        state_len=state_len,
        tokenizer_market=None,
        tokenizer_input=input_tok,
        tokenizer_output=output_tok,
    )
    # the script's split is positional: the first 80% of the rows train
    n = len(frame["action"])
    tr, va = slice(0, int(0.8 * n)), slice(int(0.8 * n), n)
    ReplayBuffer(
        state=frame["state"][tr],
        action=frame["action"][tr],
        reward=frame["r_act"][tr],
        next_state=frame["next_state"][tr],
        true_len=frame["true_state_len"][tr],
        true_next_len=frame["true_next_state_len"][tr],
        is_end=frame["is_end"][tr],
    ).save_npz(os.path.join(out, "replay_buffer_train.npz"))
    EvalBuffer(
        state=frame["state"][va],
        action=frame["action"][va],
        true_len=frame["true_state_len"][va],
    ).save_npz(os.path.join(out, "replay_buffer_val.npz"))
    save_unpopular_items(
        frame["action"], os.path.join(out, "unpopular_images.json"), 0.9
    )
    num_items = len(input_tok) - 1
    np.save(
        os.path.join(out, "embedding_weights.npy"),
        np.random.RandomState(1).randn(num_items + 1, 64).astype(np.float32),
    )


def make_run_copy(src: str, spot_root: str) -> str:
    with open(src) as fh:
        cfg = yaml.safe_load(fh)
    name = cfg["exp_name"]
    train = cfg["train"]
    data = cfg["data"]
    metrics = cfg["metrics"]
    ikea_flavor = bool(data.get("input_tokenizer"))
    state_len = int(train.get("state_size", 10))
    if ikea_flavor:
        d = os.path.join(spot_root, f"ikea_s{state_len}")
        if not os.path.exists(os.path.join(d, "replay_buffer_train.npz")):
            stage_ikea(d, state_len)
        data.update(
            train_path=f"{d}/replay_buffer_train.npz",
            val_path=f"{d}/replay_buffer_val.npz",
            test_path=f"{d}/replay_buffer_val.npz",
            input_tokenizer=f"{d}/input_tokenizer.json",
            output_tokenizer=f"{d}/output_tokenizer.json",
            market_tokenizer=f"{d}/market_tokenizer.json",
            num_items=0,
            num_actions=0,
        )
        metrics["unpopular_actions_path"] = f"{d}/unpopular_images.json"
        metrics["div_emb_dir"] = f"{d}/embedding_weights.npy"
    else:
        pad = train.get("padding_position", "end")
        d = os.path.join(spot_root, f"rr_{pad}_s{state_len}")
        if not os.path.exists(os.path.join(d, "replay_buffer.npz")):
            stage_retailrocket(d, pad, state_len)
        data.update(
            train_path=f"{d}/replay_buffer.npz",
            val_path=f"{d}/eval_buffer.npz",
            test_path=f"{d}/eval_buffer.npz",
            num_items=RR_ITEMS,
        )
        train["padding_id"] = RR_ITEMS
        metrics["unpopular_actions_path"] = f"{d}/unpopular_items.json"
        metrics["div_emb_dir"] = f"{d}/OG_embeddings.npy"
    train["epochs"] = 1
    train["val_batch_size"] = min(512, int(train.get("val_batch_size", 512)))
    run_dir = os.path.join(spot_root, "runs", name)
    os.makedirs(run_dir, exist_ok=True)
    dst = os.path.join(run_dir, f"{name}.yaml")
    with open(dst, "w") as fh:
        fh.write(
            f"# spot-run copy of {src} (synthetic data, epochs clamped to 1)\n"
            + yaml.safe_dump(cfg, sort_keys=False)
        )
    return dst


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    platform = None
    if argv and argv[0].startswith("--platform="):
        platform = argv[0].split("=", 1)[1]
        argv = argv[1:]
    if platform not in (None, "cpu"):
        raise SystemExit(f"--platform={platform}: the port trains on the card, or with "
                         f"--platform=cpu on the CPU")
    device = "cuda" if platform is None else "cpu"
    resolve_device(device)  # before anything is staged
    configs = argv or DEFAULTS
    spot_root = os.path.join(REPO, "data", "spot")
    failures = []
    for src in configs:
        dst = make_run_copy(os.path.join(REPO, src), spot_root)
        print(f"=== spot-run {src}", flush=True)
        res = subprocess.run(
            [sys.executable, "-m", "ikea_recommender_tpu_torch.run.cli", "-f", dst,
             "--device", device],
            cwd=REPO,
        )
        if res.returncode != 0:
            failures.append(src)
    if failures:
        print("FAILED:", *failures, sep="\n  ")
        return 1
    print(f"all {len(configs)} spot-runs passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
