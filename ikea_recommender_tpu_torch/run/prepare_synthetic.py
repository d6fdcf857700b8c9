"""Write a deterministic synthetic experiment: buffers and a tokenizer-free
config, ready for the CLI.

Port of ``scripts/prepare_synthetic.py``, through the port's own
``data/{synthetic,split,preprocessing,replay_buffer,item_frequency}.py``:
the same 2000 sessions over 200 items (seed 7), the same split (seed 118),
and the same ``train.npz``, ``val.npz``, ``test.npz``, ``unpopular.json``
and ``experiment.yaml`` (smorl, 3 epochs). numpy and PyYAML only.

    python -m ikea_recommender_tpu_torch.run.prepare_synthetic OUTDIR
    python -m ikea_recommender_tpu_torch.run.cli -f OUTDIR/experiment.yaml [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ikea_recommender_tpu_torch.data.item_frequency import save_unpopular_items
from ikea_recommender_tpu_torch.data.preprocessing import window_sessions
from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer, ReplayBuffer
from ikea_recommender_tpu_torch.data.split import train_test_split_ids
from ikea_recommender_tpu_torch.data.synthetic import synthetic_sessions

NUM_ITEMS = 200
STATE_LEN = 10


def main(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    items, sids = synthetic_sessions(
        num_sessions=2000, num_items=NUM_ITEMS, mean_len=8, seed=7
    )
    tr_mask, va_mask, te_mask = train_test_split_ids(sids, seed=118)

    def build(mask):
        win = window_sessions(
            items[mask], sids[mask], STATE_LEN, pad_id=NUM_ITEMS, pad_pos="end"
        )
        return ReplayBuffer(
            state=win.state,
            action=win.action,
            reward=np.ones(len(win), np.float32),
            next_state=win.next_state,
            true_len=win.true_state_len,
            true_next_len=win.true_next_state_len,
            is_end=win.is_end,
        )

    build(tr_mask).save_npz(os.path.join(out_dir, "train.npz"))
    for name, mask in (("val", va_mask), ("test", te_mask)):
        EvalBuffer.from_replay_buffer(build(mask)).save_npz(
            os.path.join(out_dir, f"{name}.npz")
        )
    save_unpopular_items(items, os.path.join(out_dir, "unpopular.json"), 0.9)

    cfg = f"""exp_class: "synthetic"
exp_name: "smorl-synth"

experiment:
  desc: "SMORL on the synthetic successor process"
  seed: 118
  save_pretrained_embeddings: True

data:
  train_path: "{out_dir}/train.npz"
  val_path: "{out_dir}/val.npz"
  test_path: "{out_dir}/test.npz"
  num_items: {NUM_ITEMS}

train:
  model: "smorl"
  batch_size: 256
  val_batch_size: 2000
  epochs: 3
  learning_rate: 0.005
  embedding_size: 64
  hidden_state_size: 64
  gamma: 0.5
  alpha: 1
  q_weights: [1, 1, 1]
  state_size: {STATE_LEN}
  best_model_metric: "Val_NDCG@10"

metrics:
  unpopular_actions_path: "{out_dir}/unpopular.json"
  topk_cov: [1, 5, 10, 20]
  topk_div: 1
  topk_hr_ndcg: [10, 20]
  topk_nov: 1
  nov_rew_sig: 1
  eval_at: [0.5, 1]
"""
    with open(os.path.join(out_dir, "experiment.yaml"), "w") as fh:
        fh.write(cfg)
    print(f"wrote buffers + experiment.yaml to {out_dir}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/tmp/synth")
