"""bfloat16 compute (``compute_dtype="bfloat16"``): the port against the
reference package on the CPU.

The same numpy inputs go through the reference (JAX on the CPU, its Pallas
GRU kernels in interpret mode: ``scan_impl="pallas"``) and the port on
``device="cpu"``, where the bf16 twins of B3 and B4 run. bf16's unit
roundoff is u = 2^-8, and one bf16 step (one unit in the last place) is
at most 2u = 2^-7 of a value. Tolerances:
- the recurrence (``gru_scan`` against ``gru_scan_pallas``): both sides
  compute in fp32 and round only their outputs, so y, h_fin and dxw are
  held to one bf16 step of each value and dW_h, db_h to one step of the
  leaf's largest entry, each plus 1e-5 of the largest entry for the fp32
  sums' order (values that cancel). The backward takes the same y on both
  sides;
- whole models and train steps (``apply_model``, the first step's
  gradients, the lazy sqn step's moments): every layer rounds its inputs,
  outputs and the input projection to bf16, so one step's difference in
  an early value moves later ones, and a gradient summed over many rows
  that cancel (b_i's, the embedding's) carries its terms' steps: each
  output and gradient leaf is held to MODEL_STEPS bf16 steps of its
  largest entry (measured: the outputs equal, the gradients at most 3.3
  steps, b_i of the two-layer bidir's first layer), the losses to
  MODEL_STEPS steps of their value;
- the reference's default arm, ``scan_impl="auto"``, which at these widths
  (T H < 12800) runs XLA's scan: it carries h in bf16 between steps where
  the port (and the Pallas kernel) carries it in fp32. The head inputs'
  gap is measured here (3.9e-3 at a largest entry of 0.32: 1.56 bf16
  steps of it, where the Pallas arm's is 0) and held to XLA_STEPS steps
  (ROADMAP C.5);
- the trainer, one epoch: losses within one bf16 step of their value
  (measured 5e-6 of it); HR, NDCG, R@k and the rewards within
  TRAINER_METRIC_ATOL (measured at most 1.1e-3, NDCG@10), since a score
  that moves by a bf16 step may reorder the rows near a tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import as_jax_tree, gru_inputs, jax_leaves, model_configs, torch_leaves

from ikea_recommender_tpu.core import config as jax_config
from ikea_recommender_tpu.data import synthetic as jax_synth
from ikea_recommender_tpu.models import families as jax_families
from ikea_recommender_tpu.ops.gru_pallas import _backward as pallas_backward
from ikea_recommender_tpu.ops.gru_pallas import gru_scan_pallas
from ikea_recommender_tpu.run import trainer as jax_trainer
from ikea_recommender_tpu.train import state as jax_state
from ikea_recommender_tpu.train import steps as jax_steps
from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
from ikea_recommender_tpu_torch.core import config as port_config
from ikea_recommender_tpu_torch.data import synthetic as port_synth
from ikea_recommender_tpu_torch.models import families
from ikea_recommender_tpu_torch.ops import gru_cuda
from ikea_recommender_tpu_torch.ops.gru_cuda import gru_scan
from ikea_recommender_tpu_torch.run import trainer as port_trainer
from ikea_recommender_tpu_torch.train.steps import loss_and_grads

BF16_STEP = 2.0**-7  # one bf16 step at most, relative to the value (2 u)
MODEL_STEPS = 6
XLA_STEPS = 4
TRAINER_METRIC_ATOL = 0.01
A, E, T, B = 60, 16, 10, 24
LR = 0.01


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_steps(got, want, name, steps=1, leaf=False):
    """|got - want| within ``steps`` bf16 steps of each value (``leaf``:
    of the largest entry), plus 1e-5 of the largest entry."""
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    top = np.abs(want).max()
    bound = steps * BF16_STEP * (top if leaf else np.abs(want)) + 1e-5 * top
    excess = (np.abs(got - want) - bound).max()
    assert excess <= 0, f"{name}: {excess:.3g} past {steps} bf16 step(s)"


# -- 1. the recurrence: B3 and B4's bf16 twins against the Pallas kernels ----

CASES = {"masked": (True, False), "unmasked": (False, False), "reverse": (True, True)}


def _scan_inputs(masked, seed, Bc=6, Tc=7, H=16):
    xw, wh, bh, mask = gru_inputs(Bc, Tc, H, seed=seed, masked=masked)
    return [_bf16(a) for a in (xw, wh, bh)], mask


@pytest.mark.parametrize("case", list(CASES))
def test_gru_scan_bf16_forward_matches_pallas(case):
    masked, reverse = CASES[case]
    (xw, wh, bh), mask = _scan_inputs(masked, seed=1)
    y_j, h_j = gru_scan_pallas(xw, wh, bh, None if mask is None else jnp.asarray(mask),
                               reverse=reverse)
    args = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16() for a in (xw, wh, bh)]
    y, h = gru_scan(*args, None if mask is None else torch.from_numpy(mask), reverse=reverse)
    assert y.dtype == h.dtype == torch.bfloat16 and y_j.dtype == jnp.bfloat16
    _assert_steps(y, y_j, "y")
    _assert_steps(h, h_j, "h_fin")


@pytest.mark.parametrize("case", list(CASES))
def test_gru_scan_bf16_backward_matches_pallas(case):
    """Both adjoints from the same bf16 y (the port's forward), gy, g_hfin."""
    masked, reverse = CASES[case]
    (xw, wh, bh), mask = _scan_inputs(masked, seed=2)
    Bc, Tc, H3 = xw.shape
    H = H3 // 3
    rs = np.random.RandomState(3)
    gy, ghf = _bf16(rs.randn(Bc, Tc, H)), _bf16(rs.randn(Bc, H))
    def to_t(a):
        return torch.from_numpy(_np32(a)).bfloat16()

    m_t = torch.ones(Bc, Tc) if mask is None else torch.from_numpy(mask)
    y, _ = gru_scan(to_t(xw), to_t(wh), to_t(bh), None if mask is None else m_t, reverse=reverse)
    got = gru_cuda.gru_scan_bwd_plain(to_t(xw), to_t(wh), to_t(bh),
                                      None if mask is None else m_t, y, to_t(gy), to_t(ghf),
                                      reverse)

    # the reference's adjoint kernel on the same y, laid out as gru_scan_pallas
    # lays it out (time-major, flipped for reverse)
    flip = (lambda a: jnp.flip(a, axis=1)) if reverse else (lambda a: a)  # noqa: E731
    tm = lambda a: jnp.swapaxes(flip(a), 0, 1)  # noqa: E731
    y_j = _bf16(y.float().numpy())
    m_j = jnp.asarray(m_t.numpy())
    dxw_tm, dwh, dbh = pallas_backward(tm(xw), wh, bh, tm(m_j)[:, :, None], tm(y_j), tm(gy),
                                       ghf)
    dxw = flip(jnp.swapaxes(dxw_tm, 0, 1))
    assert got[0].dtype == torch.bfloat16 and dxw.dtype == jnp.bfloat16
    assert dwh.dtype == jnp.bfloat16 and got[1].dtype == torch.bfloat16
    _assert_steps(got[0], dxw, "dxw")
    _assert_steps(got[1], dwh, "dwh", leaf=True)
    _assert_steps(got[2], dbh, "dbh", leaf=True)


def test_gru_scan_bf16_autograd_matches_jax_vjp():
    """The whole custom VJP, forward and backward, against jax.vjp of
    gru_scan_pallas: each side's backward on its own y."""
    (xw, wh, bh), mask = _scan_inputs(True, seed=4)
    rs = np.random.RandomState(5)
    Bc, Tc, H = xw.shape[0], xw.shape[1], xw.shape[2] // 3
    gy, ghf = _bf16(rs.randn(Bc, Tc, H)), _bf16(rs.randn(Bc, H))
    m_j = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: gru_scan_pallas(a, b, c, m_j), xw, wh, bh)
    want = vjp((gy, ghf))
    leaves = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16().requires_grad_()
              for a in (xw, wh, bh)]
    y, h = gru_scan(*leaves, torch.from_numpy(mask))
    torch.autograd.backward((y, h), (torch.from_numpy(_np32(gy)).bfloat16(),
                                     torch.from_numpy(_np32(ghf)).bfloat16()))
    for leaf, w, name in zip(leaves, want, ("xw", "wh", "bh")):
        assert leaf.grad.dtype == torch.bfloat16
        _assert_steps(leaf.grad, w, name, steps=2, leaf=name != "xw")


# -- 2. whole models and one train step -----------------------------------------

FAMILIES = {  # name: (family, extra train config)
    "gru4rec": ("gru4rec", {}),
    "bidir2": ("bidir_gru4rec", dict(gru_layers=2)),
    "sqn": ("sqn", {}),
}


def _batch(seed):
    rs = np.random.RandomState(seed)
    return {
        "state": rs.randint(0, A + 1, (B, T)).astype(np.int32),
        "action": rs.randint(0, A, (B,)).astype(np.int32),
        "true_len": rs.randint(1, T + 1, (B,)).astype(np.int32),
        "valid": rs.rand(B) < 0.9,
    }


def _model_cfgs(family, scan_impl, kw):
    from ikea_recommender_tpu_torch.core import config

    jcfg = jax_config.TrainConfig(model=family, embedding_size=E, hidden_state_size=E,
                                  state_size=T, compute_dtype="bfloat16", scan_impl=scan_impl,
                                  **kw)
    pcfg = config.TrainConfig(model=family, embedding_size=E, hidden_state_size=E,
                              state_size=T, compute_dtype="bfloat16", **kw)
    return (families.model_config_from_train(pcfg, config.DataConfig(num_items=A)),
            jax_families.model_config_from_train(jcfg, jax_config.DataConfig(num_items=A)))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_apply_model_bf16_matches_pallas(name):
    family, kw = FAMILIES[name]
    mc, jmc = _model_cfgs(family, "pallas", kw)
    assert mc.backbone.compute_dtype == "bfloat16"
    np_params = numpy_init_params(mc, 0)
    b = _batch(0)
    want = jax_families.apply_model(as_jax_tree(np_params), jmc, jnp.asarray(b["state"]),
                                    jnp.asarray(b["true_len"]))
    params = params_from_numpy(np_params, "cpu")
    got = families.apply_model(params, mc, torch.as_tensor(b["state"]),
                               torch.as_tensor(b["true_len"]))
    assert all(p.dtype == torch.float32 for p in torch_leaves_raw(params))  # params stay fp32
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        _assert_steps(g, w, f"output {k}", steps=MODEL_STEPS, leaf=True)


def torch_leaves_raw(tree):
    from ikea_recommender_tpu_torch.convert import tree_leaves

    return tree_leaves(tree)


@pytest.mark.parametrize("name", ["gru4rec", "bidir2"])
def test_first_step_gradients_bf16_match_pallas(name):
    """The first step's loss and gradients (the reference's read back from
    its first moment, g = mu / (1 - b1))."""
    family, kw = FAMILIES[name]
    mc, jmc = _model_cfgs(family, "pallas", kw)
    np_params = numpy_init_params(mc, 1)
    b = _batch(1)
    opt = jax_state.make_optimizer(LR)
    step = jax_steps.make_train_step(jmc, opt, jax_steps.RLStepConfig(), donate=False)
    jp = as_jax_tree(np_params)
    js = jax_state.TrainState(params=jp, opt_state=opt.init(jp), step=jnp.zeros((), jnp.int32),
                              rng=jax.random.key(0))
    js, m = step(js, {k: jnp.asarray(v) for k, v in b.items()})
    want_g = [mu / 0.1 for mu in jax_leaves(js.opt_state[0].mu)]
    loss, grads = loss_and_grads(params_from_numpy(np_params, "cpu"),
                                 {k: torch.as_tensor(v) for k, v in b.items()}, mc)
    assert float(loss) == pytest.approx(float(m["sup_loss"]), rel=MODEL_STEPS * BF16_STEP)
    got_g = torch_leaves(grads)
    assert len(got_g) == len(want_g)
    for k, (g, w) in enumerate(zip(got_g, want_g)):
        _assert_steps(g, w, f"gradient leaf {k}", steps=MODEL_STEPS, leaf=True)


def test_lazy_sqn_step_bf16_matches_pallas():
    """sqn with the lazy embedding Adam, whose rows enter the backbone as
    ``inputs_embeds`` and are cast there: one step with the reference's
    coin, its losses, and every first moment (the gradient, times 1 - b1)."""
    import test_torch_lazy as lazy

    mc, jmc = model_configs(lazy.A, embedding_size=lazy.E, hidden_state_size=lazy.E,
                            state_size=lazy.T, model="sqn", compute_dtype="bfloat16")
    init = [numpy_init_params(mc, s) for s in (0, 1)]
    batches = lazy._batches(1, seed=6)
    jstates, coins, j_losses = lazy._jax_run(jmc, "sqn", init, batches, True, True, None, {})
    pb = [{k: torch.as_tensor(v) for k, v in b.items()} for b in batches]
    state, p_losses = lazy._port_run(mc, "sqn", init, pb, True, True, None, {}, coins)
    np.testing.assert_allclose(p_losses, j_losses, rtol=MODEL_STEPS * BF16_STEP, atol=1e-6)
    net = coins[0]
    key = "q_head"
    got_m = lazy._moments_by_param(state.opt_state[net], True, 1, key, "sqn")[0]
    want_m = lazy._moments_by_param(jstates[-1].opt_state[net], False, 1, key, "sqn")[0]
    assert set(got_m) == set(want_m)
    for name in want_m:
        _assert_steps(got_m[name], want_m[name], name, steps=MODEL_STEPS, leaf=True)


def test_gap_to_the_xla_scan_is_measured():
    """The reference's default arm (XLA's scan, h carried in bf16) against
    the port (h carried in fp32): the head inputs differ by more than the
    Pallas arm's rounding but within XLA_STEPS steps (ROADMAP C.5)."""
    mc, jmc_pallas = _model_cfgs("gru4rec", "pallas", {})
    assert T * E < 12800  # where "auto" takes XLA's scan
    _, jmc_xla = _model_cfgs("gru4rec", "auto", {})
    np_params = numpy_init_params(mc, 2)
    b = _batch(2)
    args = (jnp.asarray(b["state"]), jnp.asarray(b["true_len"]))
    feats = {}
    for tag, jmc in (("pallas", jmc_pallas), ("xla", jmc_xla)):
        feats[tag] = _np32(jax_families.apply_features(as_jax_tree(np_params), jmc, *args))
    got = families.apply_features(params_from_numpy(np_params, "cpu"), mc,
                                  torch.as_tensor(b["state"]), torch.as_tensor(b["true_len"]))
    top = np.abs(feats["xla"]).max()
    gap_xla = np.abs(_np32(got) - feats["xla"]).max() / top
    gap_pallas = np.abs(_np32(got) - feats["pallas"]).max() / top
    assert gap_pallas <= BF16_STEP + 1e-5
    assert gap_pallas < gap_xla <= XLA_STEPS * BF16_STEP, f"gap to the XLA arm {gap_xla:.3g}"


# -- 3. the trainer, one epoch ----------------------------------------------------


def _trainer_cfg(C, exp_dir):
    return C.Config(
        experiment=C.ExperimentConfig(seed=0),
        data=C.DataConfig(num_items=50),
        train=C.TrainConfig(model="gru4rec", batch_size=32, val_batch_size=64, epochs=1,
                            learning_rate=0.01, embedding_size=E, hidden_state_size=E,
                            state_size=6, eval_at=[0.5, 1.0], fused_ce=False,
                            compute_dtype="bfloat16", scan_impl="pallas",
                            best_model_metric="Val_NDCG@10"),
        metrics=C.MetricsConfig(topk_cov=[1, 5], topk_hr_ndcg=[5, 10], topk_div=1, topk_nov=1),
        exp_dir=str(exp_dir),
    )


def test_trainer_one_epoch_bf16_matches_reference(tmp_path):
    jcfg = _trainer_cfg(jax_config, tmp_path / "jax")
    pcfg = _trainer_cfg(port_config, tmp_path / "port")
    bufs = {}
    for tag, synth in (("jax", jax_synth), ("port", port_synth)):
        train, _ = synth.synthetic_buffers(num_sessions=150, num_items=50, state_len=6, seed=1)
        _, val = synth.synthetic_buffers(num_sessions=40, num_items=50, state_len=6, seed=2)
        bufs[tag] = (train, val)
    want = jax_trainer.train(jcfg, train_buf=bufs["jax"][0], val_buf=bufs["jax"][1])
    jmc = jax_families.model_config_from_train(jcfg.train, jcfg.data)
    init = jax.tree.map(np.asarray,
                        jax_state.make_train_state(jax.random.key(0), jmc, 0.01)[0].params)
    got = port_trainer.train(pcfg, train_buf=bufs["port"][0], val_buf=bufs["port"][1],
                             init_params=init, device="cpu")
    assert len(got.logs) == len(want.logs) == 2
    pairs = [(got.pretrain_metrics, want.pretrain_metrics), (got.test_metrics, want.test_metrics)]
    pairs += list(zip(got.logs, want.logs))
    for g, w in pairs:
        assert set(g) == set(w)
        for key, wv in w.items():
            gv = g[key]
            assert np.isfinite(gv), key
            if "Loss" in key:
                assert gv == pytest.approx(wv, rel=BF16_STEP), key
            else:
                assert abs(gv - wv) <= TRAINER_METRIC_ATOL, (key, gv, wv)
