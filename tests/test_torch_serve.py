"""The port's serving path against the reference package.

``Recommender.recommend`` on ``device="cpu"`` against the reference's
``Recommender`` (JAX on the CPU) from the same numpy params, and the
batch-inference CLI end to end against ``scripts/recommend.py`` on the same
checkpoint and JSON lines. Ids must match wherever adjacent top-k values
differ by more than 1e-5; scores within atol 1e-5 (fp32, summation order).
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
from _torch_parity import as_jax_tree, assert_topk_match

from ikea_recommender_tpu.core import config as jax_config
from ikea_recommender_tpu.models import families as jax_families
from ikea_recommender_tpu.run import checkpoints as jax_checkpoints
from ikea_recommender_tpu.run.serve import Recommender as JaxRecommender
from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
from ikea_recommender_tpu_torch.core import config
from ikea_recommender_tpu_torch.data import synthetic, tokenizer
from ikea_recommender_tpu_torch.models import families
from ikea_recommender_tpu_torch.run import checkpoints, recommend, trainer
from ikea_recommender_tpu_torch.run.serve import Recommender

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(model, A, E, T, seed):
    kw = dict(model=model, embedding_size=E, hidden_state_size=E, state_size=T)
    mc = families.model_config_from_train(
        config.TrainConfig(**kw), config.DataConfig(num_items=A)
    )
    jmc = jax_families.model_config_from_train(
        jax_config.TrainConfig(**kw), jax_config.DataConfig(num_items=A)
    )
    return mc, jmc, numpy_init_params(mc, seed)


def _sessions(B, A, T, seed):
    rs = np.random.RandomState(seed)
    lens = rs.randint(1, T + 1, (B,)).astype(np.int32)
    states = np.full((B, T), A, dtype=np.int32)
    for i, L in enumerate(lens):
        states[i, :L] = rs.randint(0, A, L)
    return states, lens


@pytest.mark.parametrize(
    "model,A,E,T,B,head_idx,fused",
    [
        ("gru4rec", 70852, 64, 10, 32, 0, None),  # the RetailRocket width: fused
        ("gru4rec", 50, 8, 5, 16, 0, None),  # small catalog: dense logits
        ("gru4rec", 50, 8, 5, 16, 0, True),
        ("sqn", 50, 8, 5, 16, 1, None),
        ("sqn", 50, 8, 5, 16, 1, True),
        ("sarm", 50, 8, 5, 16, 0, None),  # head 0, the CE head
        ("sarm", 50, 8, 5, 16, 0, True),
        ("sarm", 50, 8, 5, 16, 3, None),
        ("sarm", 50, 8, 5, 16, 3, True),
    ],
)
def test_recommend_matches_reference(model, A, E, T, B, head_idx, fused):
    mc, jmc, np_params = _setup(model, A, E, T, seed=A)
    states, lens = _sessions(B, A, T, seed=B)
    k = 10
    want = JaxRecommender(as_jax_tree(np_params), jmc, head_idx, fused=fused)
    rec = Recommender(params_from_numpy(np_params, "cpu"), mc, head_idx, fused, device="cpu")
    assert rec.fused == want.fused == (A >= families.FUSED_CE_MIN_ACTIONS or bool(fused))
    wv, wi = want.recommend(states, lens, k=k + 1)
    gv, gi = rec.recommend(states, lens, k=k + 1)
    assert gi.shape == (B, k + 1)
    assert_topk_match(gv.numpy(), gi.numpy(), wv, wi, k)
    # top-1 is the argmax of the full score vector
    np.testing.assert_array_equal(gi[:, 0].numpy(), rec.scores(states, lens).argmax(1).numpy())


def _load_reference_cli():
    spec = importlib.util.spec_from_file_location(
        "reference_recommend_cli", os.path.join(REPO, "scripts", "recommend.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "padding_position,tokenized",
    [("end", False), ("beg", False), ("end", True)],
    ids=["end", "beg", "end-tokenized"],
)
def test_cli_matches_reference(tmp_path, padding_position, tokenized):
    A, E, T, k = 50, 8, 5, 5
    mc, jmc, np_params = _setup("gru4rec", A, E, T, seed=7)
    exp = tmp_path / "exp"
    exp.mkdir()
    yaml = (
        f"data:\n  num_items: {A}\n"
        f"train:\n  model: gru4rec\n  embedding_size: {E}\n  hidden_state_size: {E}\n"
        f"  state_size: {T}\n  padding_position: {padding_position}\n"
    )
    vocab = [f"item{i}" for i in range(A)]
    if tokenized:  # string items in, string predictions out
        tok = exp / "tokenizer.json"
        tokenizer.Tokenizer(vocab).save_to_file(str(tok))
        yaml = yaml.replace("data:\n", f"data:\n  input_tokenizer: {tok}\n"
                                       f"  output_tokenizer: {tok}\n")
    (exp / "experiment.yaml").write_text(yaml)
    jax_checkpoints.save_params_npz(as_jax_tree(np_params), str(exp / "best_model.npz"))

    rs = np.random.RandomState(1)
    rows = []
    for i in range(40):
        items = rs.randint(0, A, rs.randint(0, 2 * T)).tolist()
        row = {"state": [vocab[j] for j in items] if tokenized else items}
        if i % 3:
            row["id"] = f"s{i}"
        rows.append(row)
    inp = tmp_path / "sessions.jsonl"
    inp.write_text("".join(json.dumps(r) + "\n" for r in rows))

    args = ["-f", str(exp / "experiment.yaml"), "--input", str(inp), "--k", str(k + 1),
            "--batch-size", "16"]
    _load_reference_cli().main(args + ["--output", str(tmp_path / "want.jsonl")])
    recommend.main(args + ["--output", str(tmp_path / "got.jsonl"), "--device", "cpu"])

    def read(name):
        return [json.loads(line) for line in (tmp_path / name).read_text().splitlines()]

    def ids(records):
        if not tokenized:
            return [r["predictions"] for r in records]
        index = {s: i for i, s in enumerate(vocab)}
        return [[index[s] for s in r["predictions"]] for r in records]

    want, got = read("want.jsonl"), read("got.jsonl")
    assert len(got) == len(want) == len(rows)
    assert [r.get("id") for r in got] == [r.get("id") for r in want]
    assert_topk_match(
        [r["scores"] for r in got], ids(got), [r["scores"] for r in want], ids(want), k
    )


def test_trained_sarm_model_serves(tmp_path):
    """A sarm model trained by the port's trainer (one epoch, scored by head
    3) ships a ``best_model.npz`` that the port's and the reference's batch
    CLIs both load from the same YAML and answer alike, and whose top-1 is
    the argmax of head 3's full scores."""
    A, E, T, k = 50, 8, 5, 5
    yaml = (f"data:\n  num_items: {A}\n"
            f"train:\n  model: sarm\n  embedding_size: {E}\n  hidden_state_size: {E}\n"
            f"  state_size: {T}\n  head_idx: 3\n  batch_size: 32\n  epochs: 1\n"
            f"  learning_rate: 0.01\n  eval_at: [1.0]\n")
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "experiment.yaml").write_text(yaml)
    cfg = config.load_experiment_config(str(exp / "experiment.yaml"))
    assert cfg.exp_dir == str(exp)
    train_buf, val_buf = synthetic.synthetic_buffers(num_sessions=60, num_items=A, state_len=T,
                                                     seed=1)
    out = trainer.train(cfg, train_buf=train_buf, val_buf=val_buf, device="cpu")
    assert out.best_epoch == 0 and (exp / "best_model.npz").exists()

    rs = np.random.RandomState(2)
    rows = [{"state": rs.randint(0, A, rs.randint(0, 2 * T)).tolist()} for _ in range(20)]
    inp = tmp_path / "sessions.jsonl"
    inp.write_text("".join(json.dumps(r) + "\n" for r in rows))
    args = ["-f", str(exp / "experiment.yaml"), "--input", str(inp), "--k", str(k + 1)]
    _load_reference_cli().main(args + ["--output", str(tmp_path / "want.jsonl")])
    recommend.main(args + ["--output", str(tmp_path / "got.jsonl"), "--device", "cpu"])
    got, want = ([json.loads(line) for line in (tmp_path / name).read_text().splitlines()]
                 for name in ("got.jsonl", "want.jsonl"))
    assert len(got) == len(want) == len(rows)
    assert_topk_match([r["scores"] for r in got], [r["predictions"] for r in got],
                      [r["scores"] for r in want], [r["predictions"] for r in want], k)

    mc = families.model_config_from_train(cfg.train, cfg.data)
    rec = Recommender(checkpoints.load_params_npz(str(exp / "best_model.npz"), device="cpu"),
                      mc, head_idx=3, device="cpu")
    states, lens = recommend.pad_batch(rows, T, A, cfg.train.padding_position)
    np.testing.assert_array_equal([r["predictions"][0] for r in got],
                                  rec.scores(states, lens).argmax(1).numpy())


def test_npz_roundtrip_with_reference(tmp_path):
    mc, jmc, np_params = _setup("smorl", 30, 8, 5, seed=3)
    params = params_from_numpy(np_params, "cpu")
    checkpoints.save_params_npz(params, str(tmp_path / "p.npz"))
    template = jax_families.init_model(jax.random.key(0), jmc)
    theirs = jax_checkpoints.load_params_npz(template, str(tmp_path / "p.npz"))
    jax.tree.map(np.testing.assert_array_equal, theirs, np_params)

    jax_checkpoints.save_params_npz(as_jax_tree(np_params), str(tmp_path / "j.npz"))
    ours = checkpoints.load_params_npz(str(tmp_path / "j.npz"), device="cpu")
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(a.numpy(), b), ours, np_params
    )


def test_pad_batch_keeps_reference_padding():
    rows = [{"state": []}, {"state": [1, 2]}, {"state": [1, 2, 3, 4, 5, 6]}]
    states, lens = recommend.pad_batch(rows, 4, 9, "beg")
    np.testing.assert_array_equal(states, [[9, 9, 9, 9], [9, 9, 1, 2], [3, 4, 5, 6]])
    np.testing.assert_array_equal(lens, [1, 2, 4])
    states, lens = recommend.pad_batch(rows, 4, 9, "end")
    np.testing.assert_array_equal(states, [[9, 9, 9, 9], [1, 2, 9, 9], [3, 4, 5, 6]])
    with pytest.raises(SystemExit):
        recommend.pad_batch([{"items": []}], 4, 9)
