"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

The same numpy inputs go through the reference package (JAX on the CPU)
and the port. Dense torch products run with TF32 off, so both sides are
IEEE fp32 and differ only in summation order.
"""

import numpy as np
import pytest
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# fp32 values of order 1 that differ only in summation order and in
# exp/tanh implementations.
ATOL = 1e-5


@pytest.fixture
def one_rank_mesh():
    """A (1, 1) gloo mesh on the CPU in the pytest process
    (``core/mesh.py::single_device_mesh``). The one-rank process group it
    starts is destroyed after the test, so a later test in this process
    (an xdist worker runs several files) finds no group."""
    import torch.distributed as dist

    from ikea_recommender_tpu_torch.core.mesh import single_device_mesh

    started = not dist.is_initialized()
    try:
        yield single_device_mesh("gloo", "cpu")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture
def deterministic():
    """On the CPU, ``index_put_(accumulate=True)`` (the backward of the
    embedding and head-column gathers) sums duplicate indices across threads
    in no fixed order unless torch is asked for deterministic algorithms;
    on the card it sorts the indices first."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


def gru_inputs(B, T, H, seed, masked=True):
    """Numpy (xw, wh, bh, mask) for the recurrence; lengths cover 1 and T."""
    rs = np.random.RandomState(seed)
    b = 1.0 / np.sqrt(H)
    xw = rs.randn(B, T, 3 * H).astype(np.float32)
    wh = rs.uniform(-b, b, (H, 3 * H)).astype(np.float32)
    bh = rs.uniform(-b, b, (3 * H,)).astype(np.float32)
    lens = rs.randint(1, T + 1, size=(B,))
    lens[: min(B, 2)] = (1, T)[: min(B, 2)]
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    return xw, wh, bh, (mask if masked else None)


def fold_sensitive_heads(B, F, A, seed):
    """Numpy (h, w (3, F, A), b (3, A), q (3,)) for B6 whose weighted head
    sum rounds differently in head order than after folding q into W.

    Heads 0 and 2 are the same integer head X with weights Q and -Q, head 1
    an integer head Y with weight 1, so every product and every fold is
    exact: sum_k q_k W_k = Y, and the folded values are h Y + b_1 exactly.
    In head order, Q (h X) is at least 2^24, so adding head 1's logit to it
    rounds that logit to a multiple of 2 or more before -Q (h X) takes the
    large part away again."""
    rs = np.random.RandomState(seed)
    h = rs.randint(1, 3, (B, F)).astype(np.float32)
    x = rs.randint(1, 3, (F, A)).astype(np.float32)  # h X in [F, 4 F]
    y = rs.randint(-2, 3, (F, A)).astype(np.float32)
    w = np.stack([x, y, x])
    b = np.zeros((3, A), np.float32)
    b[1] = rs.randint(-2, 3, A)
    big = 2.0 ** (24 - int(np.floor(np.log2(F))))
    return h, w, b, np.asarray([big, 1.0, -big], np.float32)


def folded_head_values(h, w, b, q):
    """The values B6 would take with q folded into W and b first (numpy,
    fp32): h (sum_k q_k W_k) + sum_k q_k b_k, each sum in head order."""
    wf, bf = np.zeros_like(w[0]), np.zeros_like(b[0])
    for k in range(len(q)):
        wf, bf = wf + q[k] * w[k], bf + q[k] * b[k]
    return h @ wf + bf


def to_torch(*arrays, device="cpu"):
    return [None if a is None else torch.tensor(a, device=device) for a in arrays]


def as_jax_tree(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, tree)


def assert_topk_match(got_v, got_i, want_v, want_i, k, gap=1e-5, atol=ATOL):
    """Top-k parity from (B, k+1) results of both sides: values within
    ``atol`` over the first k columns, and ids equal at every position whose
    reference value is more than ``gap`` from both neighbours (the k+1-th
    column gives the last position its right-hand neighbour)."""
    got_v, got_i = np.asarray(got_v), np.asarray(got_i)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    np.testing.assert_allclose(got_v[:, :k], want_v[:, :k], atol=atol, rtol=0)
    d = np.abs(np.diff(want_v, axis=1))  # (B, k): |v[p+1] - v[p]|
    left = np.concatenate([np.full((d.shape[0], 1), np.inf), d[:, : k - 1]], axis=1)
    clear = (left > gap) & (d[:, :k] > gap)
    np.testing.assert_array_equal(np.where(clear, got_i[:, :k], -1), np.where(clear, want_i[:, :k], -1))
    assert clear.mean() > 0.5, "too few separated positions to compare ids"


def model_configs(A, align=1, **train_kw):
    """(port ModelConfig, reference ModelConfig) from the same TrainConfig
    fields; ``fused_ce_min_actions=0`` lets a toy catalog take the fused CE
    when ``fused_ce`` asks for it, and the reference runs its Pallas GRU."""
    from ikea_recommender_tpu.core import config as jax_config
    from ikea_recommender_tpu.models import families as jax_families
    from ikea_recommender_tpu_torch.core import config
    from ikea_recommender_tpu_torch.models import families

    kw = dict(fused_ce_min_actions=0, scan_impl="pallas", **train_kw)
    mc = families.model_config_from_train(
        config.TrainConfig(**kw), config.DataConfig(num_items=A), align
    )
    jmc = jax_families.model_config_from_train(
        jax_config.TrainConfig(**kw), jax_config.DataConfig(num_items=A), align
    )
    return mc, jmc


def jax_leaves(tree):
    """The leaves of a reference tree as fp32 numpy arrays."""
    import jax

    return [np.asarray(x, dtype=np.float32) for x in jax.tree.leaves(tree)]


def torch_leaves(tree):
    """The leaves of a port tree as fp32 numpy arrays, in the same order."""
    from ikea_recommender_tpu_torch.convert import tree_leaves

    return [x.detach().float().cpu().numpy() for x in tree_leaves(tree)]


def jax_trainer_init(cfg):
    """The reference trainer's init for ``cfg`` (its ``_build_state``), as
    numpy, and for double-Q the state's coin key (else None)."""
    import jax

    from ikea_recommender_tpu.models.families import model_config_from_train
    from ikea_recommender_tpu.train import state as jax_state
    from ikea_recommender_tpu_torch.run.trainer import DOUBLE_Q_FAMILIES

    jmc = model_config_from_train(cfg.train, cfg.data)
    key = jax.random.key(cfg.seed)
    lr = cfg.train.learning_rate
    if cfg.train.model in DOUBLE_Q_FAMILIES:
        st = jax_state.make_double_q_state(
            key, jmc, lr, single_optimizer=(cfg.train.double_q_optimizers == 1))[0]
        return tuple(jax.tree.map(np.asarray, p) for p in st.params), st.rng
    return jax.tree.map(np.asarray, jax_state.make_train_state(key, jmc, lr)[0].params), None


def replay_jax_coins(monkeypatch, rng):
    """The port's trainer's double-Q step takes the reference's coin for its
    step, ``bernoulli(fold_in(rng, step))``, through ``coin=``."""
    import jax

    from ikea_recommender_tpu_torch.run import trainer as port_trainer

    make = port_trainer.make_train_step

    def wrapped(*args, **kw):
        step = make(*args, **kw)

        def call(state, batch):
            coin = int(jax.random.bernoulli(jax.random.fold_in(rng, state.step)))
            return step(state, batch, coin=coin)

        return call

    monkeypatch.setattr(port_trainer, "make_train_step", wrapped)
