#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels to
their plain twins.

    python3 chip_smoke.py             # from the repository root, one card
    python3 chip_smoke.py --profile   # adds where a serving batch's, each
                                      # train step's, an eval batch's and
                                      # a trainer span's time goes

Phases; any failure ends the run with a non-zero exit and no result line:
1. device: card name and power limit, torch and CUDA versions, TF32 off;
2. build: every CUDA kernel of the serving and train paths, one ``nvcc``
   per source in ``ikea_recommender_tpu_torch/csrc``, all started together;
   each kernel's registers, and any stack frame or spill the compiler
   reports;
3. kernels: each kernel against its plain twin on the card at the shapes
   the paths give it and at longer, wider and padded ones, with the
   kernel's time, the twin's, its bound and one PyTorch call's as a
   yardstick: B3 gru_fwd and B4 gru_bwd (the GRU recurrence and its
   adjoint, also at the bidir point H = 128 in both directions, and at the
   spot runs' points: (256, 20, 128) in both directions, B3 at its eval
   batch (512, 20, 128), (64, 10, 64), B4 at (2000, 10, 64)), B1 fused_ce_fwd and B2 fused_ce_bwd (the softmax CE over the
   catalog and its gradients, in "high", "default", "highest" and with a
   NaN-padded catalog, at the gru4rec head width F = 64 and the bidir one
   F = 256, and at F = 200; B2's yardstick is autograd's backward replayed
   from a CUDA graph, its eager time beside it), B5 fused_argmax and B6
   fused_wargmax (the argmax over the catalog of one Q head, and of K = 3
   heads' weighted sum: max within 1e-5 of the twin's largest, ids equal
   wherever the twin's two best differ by more; also "default",
   "highest", NaN in a padded catalog, one row, and exact ties on both
   sides of a tile edge and at the last valid column, which the lowest id
   must win; and the same cases, F = 90 too, on the lazy optimizers'
   action-major W, launched and counted as the action-major form); B3 and
   B4 on bf16 tensors (compute_dtype: bfloat16) against their bf16 twins,
   the backward on the kernel forward's own y, at the train, serving,
   eval and bidir2 points, unmasked, H % 8 != 0 and 3H odd (BF16_GRU_CASES;
   y, h_fin, dxw within one bf16 step of each value, dW_h, db_h of the
   leaf's largest, see BF16_STEP), the library yardstick torch.nn.GRU in
   bf16; every kernel launched twice on each input must agree bit for bit;
4. serving: gru4rec at the RetailRocket width (catalog 70852, E=H=64,
   T=10, one layer; random weights from a seed) answers 4 batches of 512
   seeded sessions through ``run.recommend.recommend_rows``. The launch
   counters, reset just before, show the kernels ran; top-1 must be the
   argmax of the full scores, and the timed batches' records must match a
   run through the plain recurrence: scores within 1e-5 (plus the
   records' 6-digit rounding), ids wherever adjacent top-k values differ
   by > 1e-5;
5. train gru4rec: the train step at the same width (batch 256, lr 0.01,
   fused CE in "high" precision, fp32 Adam; params from a seed, batches as
   bench.py draws them plus one with a padded tail) through
   ``train.steps.make_train_step``: 3 steps held to the same 3 steps on
   CPU copies (where the twins run), then 1 warm-up and 20 timed steps,
   whose launch counters, reset just before, must show B1, B2, B3 and B4
   once per step;
6. train sqn and smorl: the double-Q steps at the same width and settings
   (``RLStepConfig()``: gamma 0.5, K = 3 heads weighted (1, 1, 1) for
   smorl; two nets from seeds 0 and 1; smorl's diversity embedding and
   unpopular mask as bench.py:94-100 draws them): 3 steps with the coins
   fixed to (0, 1, 1) held to CPU copies (losses, first-step gradients,
   params over the moved entries, target ids wherever the twin's two best
   next actions differ by more than 1e-5, and the net a step does not
   train unchanged bit for bit), then 1 warm-up and 20 timed steps with
   the coins drawn on the host, whose counters must show per step B1, B2,
   B5 once and B3 three times (sqn), or B2, B6 once and B3 three times and
   no B1 (smorl), and B4 once;
7. train sarm: the sarm step at the same width and settings
   (``RLStepConfig()``: sarm_gamma 0.99; five Q heads, head 0 also the CE
   head; params from seed 0; bench.py batches, some rows at an episode
   end, one with a padded tail): 3 steps held to CPU copies (losses,
   first-step gradients, head 0's unlabelled columns at their own scale,
   params over the moved entries); the five-head target max
   (``ops/fused_topk.py::blockwise_multihead_max``, plain torch products)
   held to its dense fp32 form within the "high" split's rounding and
   timed ("[train] sarm target max": CUDA graph, eager, launches, bound,
   the dense form's time); then 1 warm-up and 20 timed steps whose
   counters must show per step B1, B2 and B4 once, B3 twice, no B5 or B6;
7b. train sqn, smorl and sarm fast: the steps as ``preset: fast``
   resolves them (``TrainConfig(preset="fast")``: "default", bf16 Adam
   moments, lazy action-major Q-head Adam; ``train/lazy_adam.py``) at the
   same width: 3 steps (coins (0, 1, 1)) held to CPU copies as phases 6
   and 7 hold theirs, the moments in their bf16 storage to one bf16 step
   per update of the net (or 1e-4 of the leaf's largest), the params over
   the entries whose stored moments agreed to lr / 1000, then 20
   timed steps whose counters must show per step B1, B2, B4 and the
   action-major B5 once and B3 three times (sqn), B2, B4 and the
   action-major B6 once and B3 three times (smorl), or B1, B2, B4 once and
   B3 twice (sarm), and no canonical B5 or B6;
8. train bidir_gru4rec: the CE step at the width of
   ``experiments/Ablations/BidirGRU-128/BidirGRU-128.yaml`` (E 64, H 128, so
   the head input is F = 256; lr 0.0005, dropout 0.35 on the head input),
   as phase 5, with the card and the CPU copies given the same dropout
   masks for the checked steps and params held to lr / 1000; per timed
   step B1 and B2 once, B3 and B4 twice (both directions);
8b. bf16 compute (compute_dtype: bfloat16; B3 and B4 on bf16 tensors,
   counted apart, and no fp32 B3 or B4 launch): serving as phase 4, the
   head inputs held to the bf16 plain recurrence's within one bf16 step
   and the scores within what those differences can move (score_slack);
   the gru4rec step as phase 5 and "bidir2" (the width of
   ``experiments/IKEA/State-Length-Exp/BidirGRU-s20-d035-128-onelayer-
   twoGRUlay``: E = H = 128, state 20, two bidirectional GRU layers,
   dropout 0.35, lr 0.0005, at catalog 70852; per step B1, B2 once and B3,
   B4 four times), their first-step gradients held to BF16_MODEL_STEPS
   bf16 steps of each leaf's largest, losses to one step, params where the
   two sides' gradients agree to a bf16 step; and sqn as ``preset: fast``
   resolves it (the lazy embedding rows cast in the backbone), its
   targets held to the card's own plain head;
9. eval: ``eval.protocol.EvalProtocol.evaluate`` at the eval batch
   ``val_batch_size`` = 2000 over 20011 rows (11 batches, the last with 11
   valid rows), windowed by ``data.preprocessing.window_sessions`` from
   seeded sessions of 1-20 items: gru4rec at the RetailRocket width, then
   bidir_gru4rec at hidden 128. About half the labels are set to one of the
   row's top-20 ids under the plain recurrence, so that HR, NDCG and every
   rank are exercised at random weights. Per batch the top-21 values and
   CE are held to the same protocol with the recurrence run by B3's plain
   twin (values and CE within 1e-5, ids wherever adjacent values differ by
   more; only rows with a near tie may change a label's rank or a top-k
   set, and they are counted); whole passes within 1e-5 (loss, rewards)
   and, for HR, NDCG, repetitions and coverage, within what those counted
   rows can move; the dense arm to the fused one (gru4rec) the same way; two fused
   passes bit-identical; the counters of a pass show B3 once per batch and
   direction and no other kernel. "[eval]" gives ms per pass, ms per batch
   and sessions/s;
10. trainer: ``run/trainer.py::train`` at the RetailRocket width on an
   experiment built by the port's ``data/synthetic.py`` and
   ``data/split.py`` (16391 train rows, 65 steps of 256 an epoch; 4139 val
   and 4046 test rows at the eval batch 2000): gru4rec for 2 epochs (eval
   at 0.5 and 1, checkpoints, the embedding exported) through the CLI,
   ``run.cli.main(["-f", yaml, "--progress"])``, which must exit 0, print
   the test metrics it writes, write the best model, the checkpoint and
   a (70853, 64) embedding, log only finite values, and lower epoch 2's
   first-window train loss below epoch 1's; sqn and smorl for 1 epoch
   through ``train(cfg, train_buf=...)``, with both nets' ``Sec_`` keys
   (every run through ``train`` evaluates once an epoch, ``eval_at``
   [1]: no check reads a point within an epoch, and each point that
   improves writes a compressed best model);
   sarm for 1 epoch the same way from its own YAML, one net and no
   ``Sec_`` keys, whose ``best_model.npz`` then answers 512 val sessions in
   one batch through ``run.recommend.main`` (B3 once, no other kernel),
   top-1 the argmax of the config's head's and head 3's full masked scores.
   Each run's launch counters, reset just before, must equal ``PER_STEP``
   per step plus B3 once per eval batch (each train-metrics batch, the
   val passes of each net, the test pass). sqn then runs 2 epochs, whose
   first epoch must equal the 1-epoch run's logs bit for bit, and a run
   resumed from that run's checkpoint must give its second epoch, best
   point and test metrics bit for bit. gru4rec runs 1 epoch with train
   metrics off. sqn, smorl and sarm then run 1 epoch each from YAMLs that
   set ``preset: fast`` (their ``best_model.npz`` in the lazy layout,
   launches ``PER_STEP``'s fast rows per step plus B3 per eval batch);
   fast sqn twice and resumed, bit for bit, and its best model serves 512
   val sessions through ``run.recommend.main``, top-1 its head's argmax.
   "[trainer]" lines give sessions/s of the train loop and
   the four ``timing`` shares; with ``--profile`` one more gru4rec epoch
   is traced over its first span (``profile_dir``), and "[profile]
   trainer" gives its busy time, idle share and largest kernels. Then the
   experiment's buffers are written as JSON lines with the json module,
   read back through the port's native parser (``data/native.py``; its
   counter must show each file, the arrays equal those written), and
   gru4rec trains 1 epoch in bf16 compute from a YAML naming those files
   (the native counter again shows all three; launches ``PER_STEP``'s
   "gru4rec bf16" row per step plus bf16 B3 per eval batch; params saved
   as fp32) and its best model serves 512 val sessions. Between the eval
   and the trainer phases, one gru4rec eval pass in bf16 is held to the
   bf16 plain recurrence as the bf16 serving phase holds its batches.
   Afterwards neither jax nor the reference package may be loaded;
11. mesh (ROADMAP A.9a): the (data, model) mesh on the one card. First, in
   this process, the shard contract: B1, B2, B5 and B6 launched on each
   column shard of 2 and of 4 (widths 35426 and 17713) as rank r of n
   launches them (``local_valid``, labels shifted by the shard's offset,
   so negative past their owner and at least the width before it), and
   once with a last shard of padding only; merged by
   ``parallel/fused_ce.py::ce_from_shards`` and
   ``parallel/q_kernels.py::argmax_from_shards`` and held to the kernel on
   the whole head (lse and label logit within 1e-5, dh and each shard's dW
   and db within 1e-5 of the leaf's largest, ids where the two best differ
   by more than 1e-5, the maxima), and ties over a shard edge to the lower
   global id. Then ranks in processes of their own on the card, over gloo
   with CUDA tensors: (1, 2) trains gru4rec, bidir_gru4rec (H 128), sqn,
   smorl and sarm at the RetailRocket width (the model aligned to 2: 70854
   embedding rows), (2, 2) gru4rec and smorl, each 3 steps held to the
   same steps in this process (losses 1e-4, first-step gradients and
   first moments 1e-4 of each leaf's largest, params lr / 1000 where the
   gradients are clear), then 10 timed steps whose launches on every rank
   must be ``PER_STEP``'s (B1, B2 per shard a step; B5, B6) and whose
   collective calls and bytes per step are printed ("[mesh]": ms per step
   on a card the ranks share, not a multi-GPU speed); which collectives
   gloo runs on CUDA tensors; ``Recommender(mesh=)`` serves 512 sessions
   and ``EvalProtocol(mesh=)`` scores 20011 rows at 2000, held to one
   process as phases 4 and 9 hold theirs; and one rank over nccl (a (1, 1)
   mesh: one ``all_reduce``, the gru4rec steps). No rank may load jax.
12. mesh trainer (ROADMAP A.9b): ``run/trainer.py::train`` on meshes of
   ranks that share the card over gloo (phase 11's machinery), on phase
   10's experiment: (a) gru4rec on (1, 2), 2 epochs, per-rank checkpoints,
   the model aligned to 2 from one seeded init, held to one process from
   the same params (losses rtol 1e-4, rank metrics exact but for the rows
   within ``MESH_TRAINER_GAP`` of a tie, the best eval point equal); (b) a
   resume from a's per-rank epoch-1 checkpoints, a's second epoch bit for
   bit (logs, ``best_model.npz``, ``test_metrics.json``, each rank's final
   slice); (c) ``sharded_ce: true`` for 1 epoch, a's first bit for bit
   (``fused_ce`` resolved on: the same step); (d) ``preset: fast`` sqn on
   (2, 1), 1 epoch, the action-major B5 once a step on each rank's 128
   rows, held to one process within the reference's mesh bound
   (``MESH_TRAINER_FAST``), the replicated params bit-equal on both ranks;
   (e) gru4rec on (2, 1) with ``process_sharded: true``: each rank holds
   only its 8196 rows, each batch the rows ``_sharded_index_matrices``
   names, the replicas bit-equal. Every rank's launches are ``PER_STEP``
   per step plus B3 per eval batch; "[mesh-trainer]" lines give ms per
   step per rank, sessions/s, collectives per step per axis and the
   phase's seconds, none of them a multi-GPU speed.
13. RetailRocket (ROADMAP A.9c, A.10, A.10b): the protocol without
   pandas (``run/retailrocket.py``) at r5b's invocation
   (``experiments/RetailRocket-Comparison/rehearsal_r5b/command_{synth,
   etl,buffers}.json``: 260000 sessions, 135000 items, seed 0, state_len
   10): synth, etl and buffers, each step's host seconds, the splits'
   rows, sessions and buys; the catalog must be 72293 (``RESULTS.md:152``).
   Then ``run --family gru4rec --epochs 1 --no-train-metrics`` and the
   same for sqn (ROADMAP A.10: B5 once a step) and for smorl (A.10b: B6
   once a step, ``--div-emb`` the gru4rec run's export), sqn and smorl on
   the first 1024 batches of the train rows (``RR_PREFIX_STEPS``), on the card at the
   paper point (batch 256, lr 0.01, E = H = 64; ~1.72M train rows), each
   run's launches ``PER_STEP`` per step plus B3 per eval batch (both nets'
   val passes for sqn and smorl), its logs finite, sessions/s and the test
   HR@10 and NDCG@10 printed, smorl's test Div_Reward nonzero; on the
   gru4rec model the analysis (``analysis/``): ``find_hits`` over the test buffer (its hit share must be the test
   HR@10), ``predict_and_describe`` on 3 hits (each true action in its
   top-10), ``render_predictions_html``, ``sample_trajectories``,
   ``nearest_neighbors`` on the exported embedding held to the same
   function on the CPU, a served top-1 the head's argmax, B3 once per
   ``recommend`` call and no other kernel;
   then ``parallel/scaling_bench.py::run_scaling_bench`` for smorl at the
   bench width (catalog 70852, E = H = 64, 256 rows a rank) on (1, 1),
   (2, 1) and (1, 2), two ranks spawned on the card over gloo (phase 11's
   machinery): equal points on both ranks, ``PER_STEP`` per step on each,
   ``shared_card`` on every point of more than one rank.
14. IKEA (ROADMAP A.12): the IKEA flavor without pandas
   (``run/ikea_rehearsal.py``) at the script's defaults (300000 sessions,
   100000 products, 10000 inspiration images, seed 0; state_len 10,
   3-step returns, unpopular quantile 0.4): synth and buffers on the host,
   which must give 2550083 events, 786870 clicks, 755402 / 15709 / 15759
   windows, an input vocabulary of 110000 and an output one of 10000, the
   tokenizer and meta files and each buffer's arrays with the digests the
   script's output has (``IKEA_FILE_DIGESTS``, ``IKEA_BUFFER_DIGESTS``),
   and 4000 unpopular ids none more frequent than an id left out; then
   ``run --family gru4rec --epochs 1`` (lr 0.0005, 2951 steps, train
   metrics on) and ``run --family smorl --epochs 1 --lr 0.01`` on the
   gru4rec leg's (110001, 64) embedding, at the IKEA-final point (batch
   256, val batch 5000, E = H = 64, 10000 output columns: the fused CE on),
   each run's launches ``PER_STEP`` per step plus B3 per eval batch, its
   logs finite, its head (64, 10000) and embedding (110001, 64), its
   run_summary.json the script's keys, its test HR@12 above
   ``IKEA_HR_FLOOR``, smorl's test Div_Reward nonzero; "[ikea]" lines give
   the host seconds, sessions/s and the test HR/NDCG@{1, 6, 12}, Div and
   Nov rewards.
15. workflow (ROADMAP A.13a): the experiment workflow through the user's
   entry points, without pandas: ``run.prepare_synthetic.main`` writes the
   synthetic experiment (200 items, smorl, 3 epochs); phase 10's sessions
   (``trainer_experiment``'s 3050 at catalog 70852, seeds 7 and 118) are
   written with the csv and json modules as session files (train as CSV,
   val and test as JSON lines, a reward column) and staged by
   ``run.build_replay_buffer`` (``--eval`` for val and test) into buffers
   that must equal ``trainer_experiment``'s array for array, and by
   ``run.build_unpopular_items`` into the train split's unpopular set;
   then ``run.run_all_experiments_in_dir.main`` sweeps a directory of two
   YAMLs: the synthetic smorl experiment as written but for
   ``fused_ce_min_actions: 0`` (below 8192 actions the head takes the dense
   arm, as in the reference; the line puts B2 and B6 on its path, held in
   phase 3 at 200 columns), and gru4rec at the RetailRocket width on the
   staged buffers (1 epoch, 65 steps of 256). The sweep must return 0,
   move each YAML into its experiment directory beside
   ``best_model.npz`` and ``test_metrics.json``, and launch exactly what
   ``trainer_launches`` owes for the two runs (gru4rec: B1, B2, B3, B4;
   smorl: B2, B3, B4, B6). "[workflow]" lines give the seconds, each run's
   sessions/s and its launches.
16. spot runs (ROADMAP A.13b): ``run/spot_run_experiments.py``, one config
   of each of the 16 mirrored experiment classes on the script's
   synthetic data (RetailRocket flavor: 800 sessions, 500 items, click/buy
   types, both pad ends; IKEA flavor: 400 sessions, 180 input and 60
   output tokens, state 10 and 20): (a) ``make_run_copy`` stages the 16
   run copies into a temporary root; (b) each copy trains 1 epoch in this
   process through ``run.cli.main(["-f", copy, "--device", "cuda"])`` at
   its own widths (E = H = 64 or 128, 1 or 2 layers, batch 64, 256 or
   2000, eval batch clamped to 512): rc 0, a finite ``test_metrics.json``
   beside the copy, the eval points its ``eval_at`` gives, per-action-type
   keys where the config names the types, and exactly what
   ``trainer_launches`` owes: at catalogs 500 and 60 the head takes the
   dense arm, so B3 and B4 only (per step ``PER_STEP``'s times the GRU
   layers, B3 per eval batch, layer and direction); (c) ``python -m
   ikea_recommender_tpu_torch.run.spot_run_experiments`` over
   ``SPOT_MAIN`` (one copy of each flavor) in a subprocess, staged under
   the checkout's ``data/spot``: rc 0 and "all 2 spot-runs passed".
   "[spot]" lines give each copy's seconds, sessions/s of the train loop,
   best metric and eval point, and launches. At the end neither jax, the
   reference package nor pandas may be loaded.

The card's name and power limit, as nvidia-smi prints them, come on a line
of their own; the line before the last is a JSON object listing each
kernel with its launches on the paths' timed runs (their sum and each
path's), its error against the twin, its time, the twin's time, its bound
and the yardstick's time; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peak rates (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

SOURCES = ("gru_fwd", "gru_bwd", "fused_ce", "fused_argmax")
# Kernel against twin, for each output: max |kernel - twin| <= KERNEL_TOL *
# max |twin| (fp32, sums in other orders; B3 also elementwise, as before).
# B2's dW and db are also held on the columns that no row labels, where
# only the softmax term lands (~1e-6 there against ~1e-2 at a label).
KERNEL_TOL = 1e-5
# In "default" B2 rounds dl itself to bf16 before the dW and dh products, a
# step function: where the kernel's fp32 dl and the twin's (logits summed in
# another order) fall on two sides of a bf16 rounding boundary, that entry
# moves by one bf16 step. The off-label dW columns, sums of a few large terms,
# show it at up to ~1e-3 of their largest entry between two correct orders
# (tests/test_torch_fused_ce.py::test_default_off_label_dw_is_ill_conditioned),
# so there they are held to one bf16 step, 2^-8, which a wrong softmax term
# (off by O(1)) still fails.
DEFAULT_OFF_LABEL_TOL = 2.0**-8
SHAPE_KEYS = ("B", "T", "H", "F", "A", "K", "valid", "masked", "reverse", "precision")
# bf16 compute (compute_dtype: bfloat16). bf16's unit roundoff is u = 2^-8,
# and one bf16 step (a unit in the last place) is at most 2 u = 2^-7 of a
# value. B3 and B4 in bf16 and their bf16 twins compute in fp32 and round
# only their outputs, so an output differs by at most one step where the two
# fp32 values straddle a rounding: y, h_fin and dxw within one step of each
# value, dW_h and db_h within one step of the leaf's largest entry, each plus
# KERNEL_TOL of the largest entry for the fp32 sums' order. Whole bf16 train steps
# round every layer's inputs and outputs, so one step's difference in an
# early value moves later ones by a few: their first-step gradients are held
# to BF16_MODEL_STEPS steps of each leaf's largest entry (the CPU tests
# measured up to 3.3 between the port and the reference), their losses to
# one step of the loss.
BF16_STEP = 2.0**-7
BF16_MODEL_STEPS = 6

GAP = 1e-5  # ids are compared where adjacent top-k values differ by more


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def graph_ms(fn, n, stream=None):
    """Device time per call: ``n`` calls captured in one CUDA graph (on
    ``stream`` if given), replayed 5 times after a warm-up; median replay /
    n."""
    with torch.cuda.stream(stream or torch.cuda.current_stream()):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def eager_ms(fn, n):
    """Time per call of ``n`` back-to-back eager calls (host overhead
    included where the host is slower than the card)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(n_bytes, flops, peak):
    """(ms, "bytes" | "operations"): the larger of bytes over the memory
    rate and operations over ``peak``."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gru_bound(B, T, H, mask, esz=4):
    """Least time for the recurrence, over the (b, t) steps the mask lets
    through: their xw rows read once (a masked-off step only carries h),
    W_h, b_h and the mask read once, all of y and h_fin written once; and
    those steps' h W_h FMAs (gate arithmetic, ~5% more, not counted), fp32
    in either dtype. ``esz``: bytes a value of xw, W_h, b_h, y, h_fin (2 in
    bf16; the mask is fp32)."""
    active = B * T if mask is None else float(mask.sum())
    n_bytes = esz * (3 * H * active + H * 3 * H + 3 * H + B * T * H + B * H)
    n_bytes += 0 if mask is None else 4 * B * T
    return bound(n_bytes, 2.0 * 3 * H * H * active, FP32_FLOPS)


def gru_bwd_bound(B, T, H, mask, esz=4):
    """Least time for the adjoint recurrence: over the (b, t) steps the mask
    lets through, their xw rows and h_prev read, and three H x 3H products
    (recompute h W_h, dhw W_h^T, h^T dhw); gy, the mask, g_hfin, W_h and b_h
    read once; dxw, dW_h and db_h written once (a masked-off step only
    carries dh, and its dxw row is written as zeros). ``esz``: bytes a value
    of every tensor but the mask (2 in bf16)."""
    active = B * T if mask is None else float(mask.sum())
    n_bytes = esz * (4 * H * active + B * T * H + B * H + H * 3 * H + 3 * H)
    n_bytes += esz * (B * T * 3 * H + H * 3 * H + 3 * H)
    n_bytes += 0 if mask is None else 4 * B * T
    return bound(n_bytes, 3 * 2.0 * 3 * H * H * active, FP32_FLOPS)


def ce_bound(B, F, A, valid, precision, backward):
    """Least time for B1 (forward) or B2 (backward) over the ``valid``
    columns: h, W's valid columns, b, the labels (and lse, ct) read once;
    lse and the label logit (or dh, all of dW and db) written once; one
    (B, F, valid) product (three in the backward), three bf16 passes each in
    "high" on the tensor cores, one in "default", fp32 FMA in "highest"."""
    passes = {"highest": 1, "high": 3, "default": 1}[precision]
    peak = FP32_FLOPS if precision == "highest" else BF16_FLOPS
    flops = 2.0 * B * F * valid * passes * (3 if backward else 1)
    n_bytes = 4 * (B * F + F * valid + valid) + 8 * B
    n_bytes += 4 * (2 * B + B * F + F * A + A) if backward else 4 * 2 * B
    return bound(n_bytes, flops, peak)


def argmax_bound(B, F, A, valid, K, precision):
    """Least time for B5 (K = 1) or B6 over the ``valid`` columns: h, the K
    heads' valid columns of W and b, and the weights read once; the ids
    (int64) and maxima written once; K (B, F, valid) products, three bf16
    passes each in "high" on the tensor cores, one in "default", fp32 FMA in
    "highest" (the weighted sum and the comparisons, ~K B valid operations,
    not counted)."""
    passes = {"highest": 1, "high": 3, "default": 1}[precision]
    peak = FP32_FLOPS if precision == "highest" else BF16_FLOPS
    n_bytes = 4 * (B * F + K * F * valid + K * valid + K) + 12 * B
    return bound(n_bytes, 2.0 * B * F * valid * K * passes, peak)


def max_err(got, want):
    return max((a - w).abs().max().item() for a, w in zip(got, want))


def rel_err(got, want):
    """max |got - want| over max |want| (inf where want is 0 and got not)."""
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))


def bf16_close(got, want, what, leaf=False):
    """``got`` (bf16) within one bf16 step of each value of ``want`` (of its
    largest entry with ``leaf``), plus KERNEL_TOL of the largest entry;
    returns max |got - want| over max |want|."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        fail(f"{what}: {got.dtype} and {want.dtype}, not bfloat16")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{what} is not finite")
    top = w.abs().max()
    bound = BF16_STEP * (top if leaf else w.abs()) + KERNEL_TOL * top
    excess = ((g - w).abs() - bound).max().item()
    if excess > 0:
        fail(f"{what} differs by {excess:.3g} more than one bf16 step")
    return rel_err(g, w)


def check_close(got, want, names, what, tol=KERNEL_TOL):
    """Each output finite and within ``tol`` of ``want`` relative to its own
    largest entry; returns {name: relative error}."""
    errs = {}
    for a, w, name in zip(got, want, names):
        if not torch.isfinite(a).all():
            fail(f"{what}: {name} is not finite")
        errs[name] = rel_err(a, w)
        if errs[name] > tol:
            fail(f"{what}: {name} differs by {errs[name]:.3g} of its largest entry > {tol:.3g}")
    return errs


def counters():
    """The launch counters of every kernel wrapper, by kernel."""
    from ikea_recommender_tpu_torch.ops import fused_argmax, fused_ce, gru_cuda

    return {"B1 fused_ce_fwd": fused_ce.LAUNCHES, "B2 fused_ce_bwd": fused_ce.BWD_LAUNCHES,
            "B3 gru_fwd": gru_cuda.LAUNCHES, "B4 gru_bwd": gru_cuda.BWD_LAUNCHES,
            "B3 gru_fwd bf16": gru_cuda.LAUNCHES_BF16,
            "B4 gru_bwd bf16": gru_cuda.BWD_LAUNCHES_BF16,
            "B5 fused_argmax": fused_argmax.LAUNCHES,
            "B6 fused_wargmax": fused_argmax.WEIGHTED_LAUNCHES,
            "B5 fused_argmax am": fused_argmax.AM_LAUNCHES,
            "B6 fused_wargmax am": fused_argmax.WEIGHTED_AM_LAUNCHES}


def reset_counters():
    from ikea_recommender_tpu_torch.ops import fused_argmax, fused_ce, gru_cuda

    fused_ce.LAUNCHES = fused_ce.BWD_LAUNCHES = 0
    gru_cuda.LAUNCHES = gru_cuda.BWD_LAUNCHES = 0
    gru_cuda.LAUNCHES_BF16 = gru_cuda.BWD_LAUNCHES_BF16 = 0
    fused_argmax.LAUNCHES = fused_argmax.WEIGHTED_LAUNCHES = 0
    fused_argmax.AM_LAUNCHES = fused_argmax.WEIGHTED_AM_LAUNCHES = 0


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products (compute_dtype) reduce split-K partials in fp32, not bf16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from ikea_recommender_tpu_torch.ops import build

    t0 = time.perf_counter()
    reports = build.build_all(SOURCES)
    print(f"[build] {', '.join(SOURCES)}: "
          f"{sum(r is not None for r in reports.values())} built in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, report in reports.items():
        for line in (report or "").strip().splitlines():
            spilled = "bytes stack frame" in line and not line.strip().startswith(
                "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
            if "Used" in line or spilled or "error" in line.lower():
                print(f"[build] {name}: {line.strip()}")


def gru_case(B, T, H, masked):
    """Seeded inputs of the recurrence on the card: (xw, wh, bh, mask)."""
    g = torch.Generator(device="cuda").manual_seed(B + T + H)
    b = 1.0 / H**0.5
    xw = torch.randn(B, T, 3 * H, device="cuda", generator=g)
    wh = (torch.rand(H, 3 * H, device="cuda", generator=g) * 2 - 1) * b
    bh = (torch.rand(3 * H, device="cuda", generator=g) * 2 - 1) * b
    mask = None
    if masked:
        lens = torch.randint(1, T + 1, (B,), device="cuda", generator=g)
        lens[:2] = torch.tensor([1, T])
        mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None]).float()
    return xw, wh, bh, mask


def kernels_gru_fwd():
    """B3 gru_fwd against gru_scan_plain; rows keyed by (B, T, H), the first
    of each."""
    from ikea_recommender_tpu_torch.ops.gru_cuda import gru_scan, gru_scan_plain

    rows = {}
    for B, T, H, masked, reverse in [
        (256, 10, 64, True, False),  # the train point
        (512, 10, 64, True, False),  # the serving point
        (256, 10, 128, True, False),  # the bidir point, both directions
        (256, 10, 128, True, True),
        (256, 200, 64, True, True),  # long sequences, reverse direction
        (256, 50, 256, False, False),  # wide: W_h from L2, unmasked
        (2000, 10, 64, True, False),  # the eval point: 500 blocks, ~3.8 waves
        (2000, 10, 128, True, True),  # bidir's eval point, both directions
        (5000, 10, 64, True, False),  # the IKEA eval point: 1250 blocks of 4 rows
        (256, 20, 128, True, False),  # bidir2: two bidirectional layers at state 20
        (256, 20, 128, True, True),
        (512, 20, 128, True, False),  # bidir2's spot-run eval batch (512), both directions
        (512, 20, 128, True, True),
        (64, 10, 64, True, False),  # the IKEA gru4rec spot run's batch of 64
    ]:
        xw, wh, bh, mask = gru_case(B, T, H, masked)
        y, h = gru_scan(xw, wh, bh, mask, reverse=reverse)
        again = gru_scan(xw, wh, bh, mask, reverse=reverse)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((y, h), again)):
            fail(f"gru_fwd at {(B, T, H)}: two launches on the same inputs differ")
        y_p, h_p = gru_scan_plain(xw, wh, bh, mask, reverse=reverse)
        torch.cuda.synchronize()
        err = max_err((y, h), (y_p, h_p))
        for got, want in ((y, y_p), (h, h_p)):
            if not torch.allclose(got, want, atol=1e-5, rtol=1e-5):
                fail(f"gru_fwd != twin at {(B, T, H)}: max abs err {err:.3g}")
        rel = check_close((y, h), (y_p, h_p), ("y", "h_fin"), f"gru_fwd at {(B, T, H)}")

        ms = graph_ms(lambda: gru_scan(xw, wh, bh, mask, reverse=reverse), 20)
        call_ms = eager_ms(lambda: gru_scan(xw, wh, bh, mask, reverse=reverse), 20)
        plain_ms = graph_ms(lambda: gru_scan_plain(xw, wh, bh, mask, reverse=reverse), 3)
        cudnn = torch.nn.GRU(H, H, batch_first=True).cuda()
        x = torch.randn(B, T, H, device="cuda")
        with torch.inference_mode():
            library_ms = eager_ms(lambda: cudnn(x), 20)
        bound_ms, bound_by = gru_bound(B, T, H, mask)
        row = dict(B=B, T=T, H=H, masked=masked, reverse=reverse, max_abs_err=err,
                   rel_err=rel, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        print(f"[kernels] B3 gru_fwd {json.dumps(row)}")
        rows.setdefault((B, T, H), row)
    return rows


def kernels_gru_bwd():
    """B4 gru_bwd against gru_scan_bwd_plain; rows keyed by (B, T, H), the
    first of each."""
    from ikea_recommender_tpu_torch.ops import gru_cuda
    from ikea_recommender_tpu_torch.ops.gru_cuda import gru_scan_bwd_plain, gru_scan_plain

    rows = {}
    for B, T, H, masked, reverse in [
        (256, 10, 64, True, False),  # the train point
        (256, 10, 128, True, False),  # the bidir point, both directions
        (256, 10, 128, True, True),
        (256, 200, 64, True, True),  # long sequences, reverse direction
        (256, 50, 256, False, False),  # wide: W_h from L2, unmasked
        (256, 20, 128, True, False),  # bidir2: two bidirectional layers at state 20
        (256, 20, 128, True, True),
        (64, 10, 64, True, False),  # the IKEA gru4rec spot run's batch of 64
        (2000, 10, 64, True, False),  # play_around's train batch of 2000
    ]:
        xw, wh, bh, mask = gru_case(B, T, H, masked)
        g = torch.Generator(device="cuda").manual_seed(T)
        gy = torch.randn(B, T, H, device="cuda", generator=g)
        ghf = torch.randn(B, H, device="cuda", generator=g)
        with torch.no_grad():
            y, _ = gru_scan_plain(xw, wh, bh, mask, reverse=reverse)

        def kernel():
            return gru_cuda._launch_bwd(xw, wh, bh, mask, y, gy, ghf, reverse)

        def plain():
            return gru_scan_bwd_plain(xw, wh, bh, mask, y, gy, ghf, reverse)

        got = kernel()
        again = kernel()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"gru_bwd at {(B, T, H)}: two launches on the same inputs differ")
        want = plain()
        rel = check_close(got, want, ("dxw", "dwh", "dbh"), f"gru_bwd at {(B, T, H)}")
        err = max_err(got, want)
        ms, call_ms, plain_ms = graph_ms(kernel, 20), eager_ms(kernel, 20), graph_ms(plain, 3)

        cudnn = torch.nn.GRU(H, H, batch_first=True).cuda()
        x = torch.randn(B, T, H, device="cuda", requires_grad=True)
        out, hn = cudnn(x)
        leaves = [x, *cudnn.parameters()]
        library_ms = eager_ms(lambda: torch.autograd.grad(
            (out, hn), leaves, (gy, ghf[None]), retain_graph=True), 20)
        bound_ms, bound_by = gru_bwd_bound(B, T, H, mask)
        row = dict(B=B, T=T, H=H, masked=masked, reverse=reverse, max_abs_err=err,
                   rel_err=rel, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        print(f"[kernels] B4 gru_bwd {json.dumps(row)}")
        rows.setdefault((B, T, H), row)
    return rows


def cudnn_gru_ms(B, T, H, dtype, gy=None, ghf=None):
    """One torch.nn.GRU call (cuDNN) in ``dtype`` at (B, T, H): the forward
    (inference), or with cotangents its backward; None where this torch
    runs no such GRU (the reason printed)."""
    try:
        cudnn = torch.nn.GRU(H, H, batch_first=True).cuda().to(dtype)
        if gy is None:
            x = torch.randn(B, T, H, device="cuda", dtype=dtype)
            with torch.inference_mode():
                return eager_ms(lambda: cudnn(x), 20)
        x = torch.randn(B, T, H, device="cuda", dtype=dtype, requires_grad=True)
        out, hn = cudnn(x)
        leaves = [x, *cudnn.parameters()]
        return eager_ms(lambda: torch.autograd.grad(
            (out, hn), leaves, (gy, ghf[None]), retain_graph=True), 20)
    except RuntimeError as exc:
        print(f"[kernels] torch.nn.GRU in {dtype} at {(B, T, H)} did not run: {exc}")
        return None


# B3 and B4 on bf16 tensors: the train, serving and eval points, the bidir2
# point (H = 128, T = 20) in both directions, unmasked, H % 8 != 0 (no
# 16-byte copy in bf16, H % 4 == 0) and 3H odd (rows end mid-word).
BF16_GRU_CASES = [
    (256, 10, 64, True, False),  # the train point
    (512, 10, 64, True, False),  # the serving point
    (2000, 10, 64, True, False),  # the eval point
    (256, 20, 128, True, True),  # the bidir2 point, both directions
    (256, 20, 128, True, False),
    (256, 10, 64, False, False),  # unmasked
    (37, 7, 60, True, True),  # H % 8 != 0
    (7, 3, 37, True, False),  # 3H odd
]


def kernels_gru_bf16():
    """B3 and B4 on bf16 tensors against their bf16 twins, the backward on
    the kernel forward's own y, every launch twice bit for bit; rows keyed
    by (B, T, H, reverse), the forward's under "fwd" and the backward's
    under "bwd"."""
    from ikea_recommender_tpu_torch.ops import gru_cuda
    from ikea_recommender_tpu_torch.ops.gru_cuda import gru_scan, gru_scan_bwd_plain, gru_scan_plain

    rows = {}
    for B, T, H, masked, reverse in BF16_GRU_CASES:
        xw, wh, bh, mask = gru_case(B, T, H, masked)
        xw, wh, bh = xw.bfloat16(), wh.bfloat16(), bh.bfloat16()
        shape = (B, T, H)
        y, h = gru_scan(xw, wh, bh, mask, reverse=reverse)
        again = gru_scan(xw, wh, bh, mask, reverse=reverse)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((y, h), again)):
            fail(f"gru_fwd bf16 at {shape}: two launches on the same inputs differ")
        y_p, h_p = gru_scan_plain(xw, wh, bh, mask, reverse=reverse)
        rel = {"y": bf16_close(y, y_p, f"gru_fwd bf16 at {shape}: y"),
               "h_fin": bf16_close(h, h_p, f"gru_fwd bf16 at {shape}: h_fin")}
        err = max_err((y.float(), h.float()), (y_p.float(), h_p.float()))
        ms = graph_ms(lambda: gru_scan(xw, wh, bh, mask, reverse=reverse), 20)
        plain_ms = graph_ms(lambda: gru_scan_plain(xw, wh, bh, mask, reverse=reverse), 3)
        bound_ms, bound_by = gru_bound(B, T, H, mask, esz=2)
        rows[("fwd", B, T, H, reverse)] = row = dict(
            B=B, T=T, H=H, masked=masked, reverse=reverse, max_abs_err=err, rel_err=rel, ms=ms,
            call_ms=eager_ms(lambda: gru_scan(xw, wh, bh, mask, reverse=reverse), 20),
            plain_ms=plain_ms, library_ms=cudnn_gru_ms(B, T, H, torch.bfloat16),
            bound_ms=bound_ms, bound_by=bound_by)
        print(f"[kernels] B3 gru_fwd bf16 {json.dumps(row)}")

        g = torch.Generator(device="cuda").manual_seed(T)
        gy = torch.randn(B, T, H, device="cuda", generator=g).bfloat16()
        ghf = torch.randn(B, H, device="cuda", generator=g).bfloat16()

        def kernel():
            return gru_cuda._launch_bwd(xw, wh, bh, mask, y, gy, ghf, reverse)

        got, twice = kernel(), kernel()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, twice)):
            fail(f"gru_bwd bf16 at {shape}: two launches on the same inputs differ")
        want = gru_scan_bwd_plain(xw, wh, bh, mask, y, gy, ghf, reverse)
        rel = {name: bf16_close(a, w, f"gru_bwd bf16 at {shape}: {name}", leaf=name != "dxw")
               for a, w, name in zip(got, want, ("dxw", "dwh", "dbh"))}
        err = max_err([a.float() for a in got], [w.float() for w in want])
        bound_ms, bound_by = gru_bwd_bound(B, T, H, mask, esz=2)
        rows[("bwd", B, T, H, reverse)] = row = dict(
            B=B, T=T, H=H, masked=masked, reverse=reverse, max_abs_err=err, rel_err=rel,
            ms=graph_ms(kernel, 20), call_ms=eager_ms(kernel, 20),
            plain_ms=graph_ms(lambda: gru_scan_bwd_plain(xw, wh, bh, mask, y, gy, ghf, reverse),
                              3),
            library_ms=cudnn_gru_ms(B, T, H, torch.bfloat16, gy, ghf),
            bound_ms=bound_ms, bound_by=bound_by)
        print(f"[kernels] B4 gru_bwd bf16 {json.dumps(row)}")
    return rows


def kernels_fused_ce():
    """B1 fused_ce_fwd and B2 fused_ce_bwd against their twins; the rows of
    the gru4rec train point (F = 64) and, under "<name> bidir", of the
    bidir_gru4rec one (F = 2 H = 256), both "high" without padding."""
    import torch.nn.functional as F

    from ikea_recommender_tpu_torch.ops.fused_ce import (
        fused_ce_bwd,
        fused_ce_bwd_plain,
        fused_ce_fwd,
        fused_ce_fwd_plain,
    )

    rows = {}
    for B, Fd, A, valid, precision in [
        (256, 64, 70852, 70852, "high"),  # the train point
        (256, 64, 70852, 70852, "default"),
        (256, 64, 70852, 70852, "highest"),
        (256, 64, 70912, 70852, "high"),  # padded to 554 x 128, NaN in the pad
        (256, 256, 70852, 70852, "high"),  # the bidir point: B1 and B2 sliced over F
        (256, 256, 70852, 70852, "default"),
        (256, 256, 70852, 70852, "highest"),
        (256, 256, 70912, 70852, "high"),
        (256, 200, 70852, 70852, "high"),  # F not a multiple of 128: slices of 128 and 72
        (256, 64, 10000, 10000, "high"),  # the IKEA point: 10000 output columns
        (256, 64, 200, 200, "high"),  # prepare_synthetic's 200 items (the workflow's smorl)
    ]:
        g = torch.Generator(device="cuda").manual_seed(A)
        h = torch.randn(B, Fd, device="cuda", generator=g)
        w = torch.randn(Fd, A, device="cuda", generator=g) / Fd**0.5
        b = torch.randn(A, device="cuda", generator=g) * 0.1
        labels = torch.randint(0, valid, (B,), device="cuda", generator=g)
        ct = torch.rand(B, device="cuda", generator=g) / B
        w[:, valid:] = float("nan")
        shape = dict(B=B, F=Fd, A=A, valid=valid, precision=precision)

        def fwd():
            return fused_ce_fwd(h, w, b, labels, valid, precision)

        def fwd_plain():
            return fused_ce_fwd_plain(h, w, b, labels, valid, precision)

        got = fwd()
        again = fwd()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"fused_ce_fwd at {shape}: two launches differ")
        want = fwd_plain()
        rel = check_close(got, want, ("lse", "label logit"), f"fused_ce_fwd at {shape}")
        lse = want[0]

        def bwd():
            return fused_ce_bwd(h, w, b, labels, lse, ct, valid, precision)

        def bwd_plain():
            return fused_ce_bwd_plain(h, w, b, labels, lse, ct, valid, precision)

        got_b = bwd()
        again = bwd()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got_b, again)):
            fail(f"fused_ce_bwd at {shape}: two launches differ")
        want_b = bwd_plain()
        rel_b = check_close(got_b, want_b, ("dh", "dw", "db"), f"fused_ce_bwd at {shape}")
        off = torch.arange(A, device="cuda") < valid  # valid columns no row labels
        off[labels] = False
        rel_b.update(check_close((got_b[2][off],), (want_b[2][off],), ("db off-label",),
                                 f"fused_ce_bwd at {shape}"))
        rel_b.update(check_close(
            (got_b[1][:, off],), (want_b[1][:, off],), ("dw off-label",),
            f"fused_ce_bwd at {shape}",
            DEFAULT_OFF_LABEL_TOL if precision == "default" else KERNEL_TOL))
        if not ((got_b[1][:, valid:] == 0).all() and (got_b[2][valid:] == 0).all()):
            fail(f"fused_ce_bwd at {shape}: padded columns got a gradient")

        # yardsticks: one dense fp32 head product and torch's CE, and its
        # backward: autograd's, replayed from a CUDA graph captured on the
        # stream its forward ran on, where its backward runs (and eager)
        wv, bv = w[:, :valid].contiguous(), b[:valid].contiguous()
        lib_fwd = graph_ms(lambda: F.cross_entropy(
            torch.addmm(bv, h, wv), labels, reduction="none"), 20)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            leaves = [t.clone().requires_grad_() for t in (h, wv, bv)]
            loss = F.cross_entropy(torch.addmm(leaves[2], leaves[0], leaves[1]), labels,
                                   reduction="none")

        def lib_grad():
            return torch.autograd.grad(loss, leaves, ct, retain_graph=True)

        lib_bwd = graph_ms(lib_grad, 20, stream=side)
        with torch.cuda.stream(side):
            lib_bwd_call = eager_ms(lib_grad, 20)

        for name, fn, plain, ref, errs, lib, lib_call, backward in (
            ("B1 fused_ce_fwd", fwd, fwd_plain, (got, want), rel, lib_fwd, None, False),
            ("B2 fused_ce_bwd", bwd, bwd_plain, (got_b, want_b), rel_b, lib_bwd, lib_bwd_call,
             True),
        ):
            bound_ms, bound_by = ce_bound(B, Fd, A, valid, precision, backward)
            row = dict(shape, max_abs_err=max_err(*ref), rel_err=errs, ms=graph_ms(fn, 20),
                       call_ms=eager_ms(fn, 20), plain_ms=graph_ms(plain, 3),
                       library_ms=lib, bound_ms=bound_ms, bound_by=bound_by)
            if lib_call is not None:
                row["library_call_ms"] = lib_call
            print(f"[kernels] {name} {json.dumps(row)}")
            if A in (IKEA_ACTIONS, SYNTH_ITEMS):
                rows[f"{name} {'ikea' if A == IKEA_ACTIONS else 'synth'}"] = row
                continue
            rows.setdefault({64: name, 256: f"{name} bidir"}.get(Fd, f"{name} F={Fd}"), row)
            if Fd == 64 and A == valid and precision != "high":
                rows.setdefault(f"{name} {precision}", row)
    return rows


def argmax_case(B, F, A, valid, K, integer, seed):
    """Seeded (h, w, b, q_weights or None) on the card, NaN in the columns
    >= valid; with ``integer`` small integers (weights 0.5, 0.25, ...), so
    every sum is exact and rows tie, and columns 127, 128 (the two sides of
    a kernel tile edge) and valid - 1 are copies, made each row's largest."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    heads = 1 if K is None else K
    if integer:
        h = torch.randint(-2, 3, (B, F), device="cuda", generator=g).float()
        w = torch.randint(-2, 3, (heads, F, A), device="cuda", generator=g).float()
        b = torch.randint(-4, 5, (heads, A), device="cuda", generator=g).float()
        q = 0.5 ** torch.arange(1, heads + 1, device="cuda", dtype=torch.float32)
    else:
        h = torch.randn(B, F, device="cuda", generator=g)
        w = torch.randn(heads, F, A, device="cuda", generator=g) / F**0.5
        b = torch.randn(heads, A, device="cuda", generator=g) * 0.1
        q = torch.tensor([1.0, 1.0, 1.0][:heads] + [0.5] * (heads - 3), device="cuda")
    w[..., valid:] = float("nan")
    b[..., valid:] = float("nan")
    if integer:
        for col in (128, valid - 1):
            w[..., col], b[..., col] = w[..., 127], b[..., 127]
        b[..., [127, 128, valid - 1]] = 1000.0
    return (h, w[0], b[0], None) if K is None else (h, w, b, q)


# The cases of B5 and B6: (B, F, A, valid, K (None: B5), precision, ties).
# The canonical forms' train points are "high" (the dense arm's); the
# action-major forms' are "default" (the fast preset's); F = 90 makes the
# action-major staging take 4-byte copies.
ARGMAX_CASES = [
    (256, 64, 70852, 70852, None, "high", False),  # the sqn point
    (256, 64, 70852, 70852, 3, "high", False),  # the smorl point
    (256, 64, 70852, 70852, None, "default", False),
    (256, 64, 70852, 70852, 3, "default", False),
    (256, 64, 70852, 70852, None, "highest", False),
    (256, 64, 70852, 70852, 3, "highest", False),
    (256, 64, 70912, 70852, None, "high", False),  # NaN in the pad
    (256, 64, 70912, 70852, 3, "high", False),
    (256, 64, 70912, 70852, None, "high", True),  # forced ties
    (256, 64, 70912, 70852, 3, "high", True),
    (1, 64, 70852, 70852, None, "high", False),  # one row
    (1, 64, 70852, 70852, 3, "high", False),
    (256, 64, 10000, 10000, 3, "high", False),  # the IKEA smorl point
    (256, 64, 10000, 10000, 3, "high", True),
    (256, 64, 200, 200, 3, "high", False),  # the workflow's smorl, 200 items
    (256, 64, 200, 200, 3, "high", True),
]
ARGMAX_AM_CASES = [
    (256, 64, 70852, 70852, None, "default", False),  # the sqn fast point
    (256, 64, 70852, 70852, 3, "default", False),  # the smorl fast point
    (256, 64, 70852, 70852, None, "high", False),
    (256, 64, 70852, 70852, 3, "high", False),
    (256, 64, 70852, 70852, None, "highest", False),
    (256, 64, 70852, 70852, 3, "highest", False),
    (256, 64, 70912, 70852, None, "default", False),  # NaN in the pad
    (256, 64, 70912, 70852, 3, "default", False),
    (256, 64, 70912, 70852, None, "default", True),  # forced ties
    (256, 64, 70912, 70852, 3, "default", True),
    (256, 64, 70912, 70852, 3, "highest", True),
    (256, 90, 70852, 70852, None, "default", False),  # 4-byte copies
    (256, 90, 70852, 70852, 3, "high", False),
    (1, 64, 70852, 70852, 3, "default", False),  # one row
]


def kernels_fused_argmax():
    """B5 fused_argmax and B6 fused_wargmax against their twins, on the
    canonical W and (``action_major``) on the lazy optimizers' (A, K F) W:
    the max within KERNEL_TOL of the twin's largest |max|, ids equal
    wherever the twin's top two values differ by more (the rest counted);
    on the integer cases the ids equal everywhere, ties to the lowest id.
    Returns the train points' rows (sqn's B5, smorl's B6 at K = 3: "high",
    "highest", and the action-major forms as "<name> am" in "default"; B6
    at the IKEA point as "<name> ikea", at the synthetic experiment's 200
    items as "<name> synth")."""
    rows = {}
    for am, cases in ((False, ARGMAX_CASES), (True, ARGMAX_AM_CASES)):
        for case in cases:
            name, row = argmax_row(*case, am)
            key = f"{name} am" if am else name
            if case[2] in (IKEA_ACTIONS, SYNTH_ITEMS):
                rows.setdefault(f"{key} {'ikea' if case[2] == IKEA_ACTIONS else 'synth'}", row)
                continue
            rows.setdefault(key, row)
            if case[:4] == (256, 64, 70852, 70852) and case[5] == "highest":
                rows.setdefault(f"{key} highest", row)
    return rows


def argmax_row(B, Fd, A, valid, K, precision, integer, am):
    """One case of B5 or B6 against its twin: (name, row)."""
    from ikea_recommender_tpu_torch.ops import fused_argmax
    from ikea_recommender_tpu_torch.ops.fused_argmax import (
        fused_linear_argmax,
        fused_weighted_multihead_argmax,
        head_values_plain,
    )

    name = "B5 fused_argmax" if K is None else "B6 fused_wargmax"
    h, w, b, q = argmax_case(B, Fd, A, valid, K, integer, seed=B + A + (K or 1))
    if am:  # the same values, action-major: (A, F) or (A, K F)
        w = w.reshape(-1, A).T.contiguous()
    shape = dict(B=B, F=Fd, A=A, valid=valid, K=K or 1, precision=precision,
                 ties=integer, action_major=am)

    def kernel():
        if q is None:
            return fused_linear_argmax(h, w, b, valid, precision, with_max=True,
                                       action_major=am)
        return fused_weighted_multihead_argmax(h, w, b, q, valid, precision, with_max=True,
                                               action_major=am)

    def plain():
        v = head_values_plain(h, w, b, valid, precision, q, am)
        return v.argmax(dim=1), v.amax(dim=1)

    counter = ("WEIGHTED_" if K else "") + ("AM_LAUNCHES" if am else "LAUNCHES")
    before = getattr(fused_argmax, counter)
    idx, mx = kernel()
    if getattr(fused_argmax, counter) != before + 1:
        fail(f"{name} at {shape}: the launch was not counted under {counter}")
    again = kernel()
    torch.cuda.synchronize()
    if not (torch.equal(idx, again[0]) and torch.equal(mx, again[1])):
        fail(f"{name} at {shape}: two launches differ")
    v = head_values_plain(h, w, b, valid, precision, q, am)
    idx_p, mx_p = v.argmax(dim=1), v.amax(dim=1)
    top2 = v.topk(2, dim=1).values
    scale = mx_p.abs().max().item()
    clear = (top2[:, 0] - top2[:, 1]) > KERNEL_TOL * scale
    err = (mx - mx_p).abs().max().item()
    if not (torch.isfinite(mx).all() and (idx < valid).all()):
        fail(f"{name} at {shape}: non-finite max or an id past valid_dim")
    if err > KERNEL_TOL * scale:
        fail(f"{name} at {shape}: max differs from the twin by {err:.3g}")
    if integer and not (torch.equal(idx, idx_p) and (idx == 127).all()):
        fail(f"{name} at {shape}: exact ties not broken to the lowest id 127")
    if (idx != idx_p)[clear].any():
        fail(f"{name} at {shape}: ids differ from the twin at separated rows")
    excluded = int((~clear).sum())
    if not integer and excluded > max(2, B // 50):
        fail(f"{name} at {shape}: {excluded} rows with near-tied maxima")

    bv = b[..., :valid].contiguous()
    heads = K or 1
    if am:  # one fp32 cuBLAS product on the (valid K, F) rows, as they lie
        wv = w[:valid].contiguous().view(valid * heads, Fd)
        if q is None:
            library_ms = graph_ms(lambda: torch.argmax(torch.addmm(bv, h, wv.T), 1), 20)
        else:
            bk = bv.T.reshape(-1)  # (valid K,) in the rows' (action, head) order
            library_ms = graph_ms(lambda: torch.argmax(
                (torch.addmm(bk, h, wv.T).view(B, valid, heads) * q).sum(2), 1), 20)
    else:
        wv = w[..., :valid].contiguous()
        if q is None:
            library_ms = graph_ms(lambda: torch.argmax(torch.addmm(bv, h, wv), 1), 20)
        else:
            library_ms = graph_ms(lambda: torch.argmax(torch.einsum(
                "kba,k->ba", torch.matmul(h, wv) + bv[:, None, :], q), 1), 20)
    bound_ms, bound_by = argmax_bound(B, Fd, A, valid, heads, precision)
    row = dict(shape, max_abs_err=err, rel_err=err / scale, excluded_rows=excluded,
               ms=graph_ms(kernel, 20), call_ms=eager_ms(kernel, 20),
               plain_ms=graph_ms(plain, 3), library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    print(f"[kernels] {name}{' am' if am else ''} {json.dumps(row)}")
    return name, row


def phase_kernels():
    """Every kernel against its twin. Returns the rows of the main paths'
    shapes: B3 at the train, serving and eval points, B4, B1 and B2 at the
    train point, B5 and B6 at the sqn and smorl train points, and B1-B4 at
    the bidir point under "<name> bidir"."""
    b3, b4, bf = kernels_gru_fwd(), kernels_gru_bwd(), kernels_gru_bf16()
    rows = {"B3 gru_fwd": b3[(256, 10, 64)], "B3 serving": b3[(512, 10, 64)],
            "B3 eval": b3[(2000, 10, 64)], "B3 eval bidir": b3[(2000, 10, 128)],
            "B3 gru_fwd ikea eval": b3[(5000, 10, 64)],
            "B3 gru_fwd bidir": b3[(256, 10, 128)], "B4 gru_bwd": b4[(256, 10, 64)],
            "B4 gru_bwd bidir": b4[(256, 10, 128)],
            # the spot runs' fp32 points: bidir2, its eval batch, batch 64, batch 2000
            "B3 gru_fwd bidir2": b3[(256, 20, 128)], "B4 gru_bwd bidir2": b4[(256, 20, 128)],
            "B3 gru_fwd bidir2 eval": b3[(512, 20, 128)], "B3 gru_fwd b64": b3[(64, 10, 64)],
            "B4 gru_bwd b64": b4[(64, 10, 64)], "B4 gru_bwd b2000": b4[(2000, 10, 64)],
            "B3 gru_fwd bf16": bf[("fwd", 256, 10, 64, False)],
            "B3 bf16 serving": bf[("fwd", 512, 10, 64, False)],
            "B3 bf16 eval": bf[("fwd", 2000, 10, 64, False)],
            "B3 gru_fwd bf16 bidir2": bf[("fwd", 256, 20, 128, True)],
            "B4 gru_bwd bf16": bf[("bwd", 256, 10, 64, False)],
            "B4 gru_bwd bf16 bidir2": bf[("bwd", 256, 20, 128, True)]}
    rows.update(kernels_fused_ce())
    rows.update(kernels_fused_argmax())
    return rows


def plain_topk(params, mc, states, lens, k):
    """The serving path with the recurrence run by the plain twin, in the
    model's compute dtype. Returns (values, ids, the head input)."""
    from ikea_recommender_tpu_torch.models.backbone import compute_dtype
    from ikea_recommender_tpu_torch.models.gru import length_mask
    from ikea_recommender_tpu_torch.ops.fused_topk import blockwise_head_topk_ce
    from ikea_recommender_tpu_torch.ops.gru_cuda import gru_scan_plain

    dtype = compute_dtype(mc.backbone)
    layer = {n: p.to(dtype) for n, p in params["backbone"]["gru"][0]["fwd"].items()}
    x = params["backbone"]["embedding"][states.long()].to(dtype)
    xw = torch.matmul(x, layer["wi"]) + layer["bi"]
    _, h = gru_scan_plain(xw, layer["wh"], layer["bh"], length_mask(lens, states.shape[1]))
    h = h.float()
    head = params["sup_head"]
    v, i, _ = blockwise_head_topk_ce(h, head["kernel"], head["bias"], k, mc.action_dim)
    return v, i, h


def score_slack(h, h_ref, kernel):
    """(B,): the most any score h W + b can move between two head inputs,
    max_j sum_i |h - h_ref|_i |W_ij| (0 on rows whose inputs are equal)."""
    return ((h - h_ref).abs() @ kernel.abs()).max(dim=1).values


def check_topk(v, i, v_ref, i_ref, k, atol=1e-5, ref="the plain recurrence", slack=None):
    """Values (B, >= k) within ``atol`` of the reference's (B, k+1) over k
    columns; ids equal where the reference's adjacent values differ by more
    than GAP. ``slack`` (B,): how far each row's scores may move besides
    (bf16 features that differ, score_slack), added to ``atol`` and twice
    to GAP. Returns that (B, k) mask of separated positions."""
    if not (torch.isfinite(v).all() and v.shape[0] == v_ref.shape[0] and v.shape[1] >= k):
        fail("non-finite or misshapen top-k values")
    s = torch.zeros_like(v_ref[:, :1]) if slack is None else slack[:, None]
    err = ((v[:, :k] - v_ref[:, :k]).abs() - s).max().item()
    if err > atol:
        fail(f"top-k values differ from {ref} by {err:.3g} past their slack")
    d = (v_ref[:, 1:] - v_ref[:, :-1]).abs()
    left = torch.cat([torch.full_like(d[:, :1], float("inf")), d[:, : k - 1]], dim=1)
    clear = (left > GAP + 2 * s) & (d[:, :k] > GAP + 2 * s)
    if (clear & (i[:, :k] != i_ref[:, :k])).any():
        fail(f"top-k ids differ from {ref} at separated positions")
    return clear


def phase_serving(profile=False, dtype="float32"):
    """4 batches of 512 through recommend_rows in ``dtype`` compute, held to
    the plain recurrence in the same dtype (bf16: the head inputs within
    one bf16 step, the scores within what their differences can move, the
    ids where the scores are further apart than that). Returns B3's
    launches."""
    from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
    from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
    from ikea_recommender_tpu_torch.models.families import apply_features, model_config_from_train
    from ikea_recommender_tpu_torch.run.recommend import pad_batch, recommend_rows
    from ikea_recommender_tpu_torch.run.serve import Recommender

    A, E, T, B, K, N_BATCHES = 70852, 64, 10, 512, 10, 4
    bf16 = dtype == "bfloat16"
    b3 = "B3 gru_fwd bf16" if bf16 else "B3 gru_fwd"
    mc = model_config_from_train(
        TrainConfig(model="gru4rec", embedding_size=E, hidden_state_size=E, state_size=T,
                    compute_dtype=dtype),
        DataConfig(num_items=A),
    )
    params = params_from_numpy(numpy_init_params(mc, seed=0), device="cuda")
    rec = Recommender(params, mc, device="cuda")
    if not rec.fused:
        fail("the RetailRocket width must take the blockwise head")

    rs = np.random.RandomState(1)
    batches = []
    for _ in range(N_BATCHES + 1):  # the first one warms up
        lens = rs.randint(0, 2 * T, B)
        lens[rs.rand(B) < 0.05] = 0  # a few empty states
        batches.append([{"state": rs.randint(0, A, n).tolist(), "id": i}
                        for i, n in enumerate(lens)])
    pad_id = mc.backbone.padding_idx
    recommend_rows(rec, batches[0], T, pad_id, "end", K)

    reset_counters()
    batch_ms, outputs = [], []
    for rows in batches[1:]:
        t0 = time.perf_counter()
        outputs.append(recommend_rows(rec, rows, T, pad_id, "end", K))
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    launched = counters()
    launches = launched.pop(b3)
    if launches != N_BATCHES or any(launched.values()):
        fail(f"serving {N_BATCHES} batches launched {b3} {launches} times and {launched}")

    cleared, slacks = [], []
    for rows, out in zip(batches[1:], outputs):
        if len(out) != B or any(len(r["predictions"]) != K for r in out):
            fail("serving returned the wrong number of rows or predictions")
        states, lens = (torch.as_tensor(a, device="cuda") for a in pad_batch(rows, T, pad_id))
        v, i = rec.recommend(states, lens, k=K + 1)
        scores = rec.scores(states, lens)
        # top-1 is the argmax, up to products summed in another order
        best = scores.max(dim=1).values
        at_top1 = scores.gather(1, i[:, :1])[:, 0]
        if not (torch.isfinite(scores).all() and (best - at_top1).max() <= GAP):
            fail("top-1 is not the argmax of the full scores")
        v_ref, i_ref, h_ref = plain_topk(rec.params, mc, states, lens, K + 1)
        slack = None
        if bf16:  # the head inputs, then what their differences can move
            h = apply_features(rec.params, mc, states, lens)
            bf16_close(h.bfloat16(), h_ref.bfloat16(), "bf16 serving: the head input")
            slack = score_slack(h, h_ref, rec.params["sup_head"]["kernel"])
            slacks.append(slack.max().item())
        cleared.append(check_topk(v, i, v_ref, i_ref, K, slack=slack).float().mean().item())
        # the timed batch's own records; scores are rounded to 6 digits there
        v_out = torch.tensor([r["scores"] for r in out], device="cuda")
        i_out = torch.tensor([r["predictions"] for r in out], device="cuda")
        check_topk(v_out, i_out, v_ref, i_ref, K, atol=1e-5 + 5e-7, slack=slack)
    ms = float(np.median(batch_ms))
    print(f"[serving] gru4rec{' bf16' if bf16 else ''} A={A} E=H={E} T={T}: {N_BATCHES}x{B} "
          f"sessions, batch ms {[round(t, 3) for t in batch_ms]}, median {ms:.3f} ms = "
          f"{B / ms * 1e3:.0f} sessions/s; {b3} launches {launches}; ids compared "
          f"at {np.mean(cleared):.4f} of positions"
          + (f"; score slack from bf16 head inputs, max per batch {slacks}" if bf16 else ""))
    if profile:
        profile_serving(rec, batches[1], T, pad_id, K)
    return launches


def profile_serving(rec, rows, T, pad_id, K):
    """Where one serving batch's time goes: host clock around the three
    steps of ``recommend_rows``, then torch.profiler's device time by
    kernel and the device's busy share during ``recommend``."""
    from ikea_recommender_tpu_torch.run.recommend import format_records, pad_batch

    split = []
    for _ in range(5):
        t0 = time.perf_counter()
        states, lens = pad_batch(rows, T, pad_id)
        t1 = time.perf_counter()
        v, i = rec.recommend(states, lens, k=K)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        format_records(rows, v, i)
        t3 = time.perf_counter()
        split.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
    pad, dev, fmt = np.median(np.array(split), axis=0)
    print(f"[profile] batch of {len(rows)} (median of 5): pad_batch {pad:.3f} ms, "
          f"recommend to sync {dev:.3f} ms, format_records {fmt:.3f} ms")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec.recommend(states, lens, k=K)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [  # device kernels only: operator rows repeat their kernels' time
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"[profile] recommend: wall {wall_us:.1f} us, device busy {busy_us:.1f} us "
          f"({busy_us / wall_us:.4f}), idle share {1 - busy_us / wall_us:.4f}")
    for e in events[:10]:
        print(f"[profile]   {e.self_device_time_total:10.1f} us  x{e.count:<4d} {e.key[:90]}")


def bench_batch(rs, B, A, T):
    """A train batch drawn as bench.py:125-138 draws it."""
    batch = {
        "state": rs.randint(0, A, (B, T)).astype(np.int32),
        "action": rs.randint(0, A, (B,)).astype(np.int32),
        "reward": rs.rand(B).astype(np.float32),
        "next_state": rs.randint(0, A, (B, T)).astype(np.int32),
        "true_len": rs.randint(1, T + 1, (B,)).astype(np.int32),
        "true_next_len": rs.randint(1, T + 1, (B,)).astype(np.int32),
        "is_end": rs.rand(B) < 0.2,
        "valid": np.ones((B,), bool),
    }
    return batch


def named_leaves(tree, path=""):
    """{"a/b/0/c": leaf} of a params-like tree, as fp32 copies on the host
    (copies: Adam moves the CPU state's tensors in place)."""
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items() for p, t in named_leaves(v, f"{path}{k}/").items()}
    if isinstance(tree, list):
        return {p: t for i, v in enumerate(tree)
                for p, t in named_leaves(v, f"{path}{i}/").items()}
    return {path.rstrip("/"): tree.detach().float().cpu().clone()}


# The CE train steps' operating points: gru4rec at the RetailRocket width
# (bench.py:57-139), bidir_gru4rec at that of
# experiments/Ablations/BidirGRU-128/BidirGRU-128.yaml (head input F = 2 H);
# in bf16 compute, gru4rec at the same width and "bidir2" at that of
# experiments/IKEA/State-Length-Exp/BidirGRU-s20-d035-128-onelayer-twoGRUlay
# (E = H = 128, state 20, two bidirectional GRU layers, dropout 0.35, lr
# 0.0005) at the RetailRocket catalog.
CE_POINTS = {
    "gru4rec": dict(family="gru4rec", E=64, H=64, T=10, layers=1, lr=0.01, dropout=0.0),
    "bidir_gru4rec": dict(family="bidir_gru4rec", E=64, H=128, T=10, layers=1, lr=0.0005,
                          dropout=0.35),
    "gru4rec bf16": dict(family="gru4rec", E=64, H=64, T=10, layers=1, lr=0.01, dropout=0.0,
                         dtype="bfloat16"),
    "bidir2 bf16": dict(family="bidir_gru4rec", E=128, H=128, T=20, layers=2, lr=0.0005,
                        dropout=0.35, dtype="bfloat16"),
}
# Of the entries some checked step moved, the fractions whose gradients are
# clear at every step (all entries, the head kernel's), as this script's
# seeded data gives them, read off the CPU side: gru4rec 0.339 and 0.299,
# bidir_gru4rec 0.1908 and 0.1763 (most of its head's entries take a
# nonzero gradient below 1e-6 at some step), sarm 0.3283 and 0.2870 (its
# five heads' kernel).
# In bf16 compute the entries compared are further those whose card and
# CPU gradients agree within one bf16 step of the value at every step (fp32
# gradients of bf16 products differ past that where they cancel); an H100
# gave gru4rec bf16 0.3386 and 0.2987, bidir2 bf16 0.3005 and 0.2708.
COMPARED_FLOORS = {"gru4rec": (0.3, 0.25), "bidir_gru4rec": (0.17, 0.15), "sarm": (0.3, 0.25),
                   "gru4rec bf16": (0.3, 0.25), "bidir2 bf16": (0.25, 0.22)}


@contextlib.contextmanager
def shared_keep_masks(seed):
    """Inside, the k-th dropout keep mask drawn from each train state's
    generator is the k-th mask of one seeded CPU generator, moved to the
    state's device: the card and its CPU copy drop the same entries.
    Outside, the step draws as it always does."""
    from ikea_recommender_tpu_torch.models import backbone

    drawn, masks, gen = {}, [], torch.Generator().manual_seed(seed)
    draw = backbone.draw_keep_mask

    def same_mask(shape, keep, generator, device):
        k = drawn.get(id(generator), 0)
        drawn[id(generator)] = k + 1
        if k == len(masks):
            masks.append(torch.rand(shape, generator=gen) < keep)
        return masks[k].to(device)

    backbone.draw_keep_mask = same_mask
    try:
        yield
    finally:
        backbone.draw_keep_mask = draw


def phase_train(name="gru4rec", profile=False):
    """A CE train step (a CE_POINTS entry: gru4rec or bidir_gru4rec, fp32 or
    bf16 compute) at full width: 3 steps against CPU copies, with the same
    dropout masks on both sides, then 1 warm-up and 20 timed steps. Returns
    the timed run's launches."""
    from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
    from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
    from ikea_recommender_tpu_torch.models.families import model_config_from_train
    from ikea_recommender_tpu_torch.train.state import make_train_state
    from ikea_recommender_tpu_torch.train.steps import loss_and_grads, make_train_step

    pt = CE_POINTS[name]
    family, bf16 = pt["family"], pt.get("dtype") == "bfloat16"
    A, B, N_CHECK, N_TIMED = 70852, 256, 3, 20
    E, H, T, LR = pt["E"], pt["H"], pt["T"], pt["lr"]
    tc = TrainConfig(model=family, batch_size=B, embedding_size=E, hidden_state_size=H,
                     state_size=T, learning_rate=LR, dropout=pt["dropout"], fused_ce=True,
                     head_precision="high", gru_layers=pt["layers"],
                     compute_dtype=pt.get("dtype", "float32"))
    mc = model_config_from_train(tc, DataConfig(num_items=A))
    if not (mc.fused_ce and mc.head_precision == "high"):
        fail(f"{name} at catalog {A} must train through the fused CE in 'high'")
    if mc.backbone.compute_dtype != tc.compute_dtype or mc.backbone.gru_layers != pt["layers"]:
        fail(f"{name}: the model config lost compute_dtype or gru_layers")
    np_params = numpy_init_params(mc, seed=0)
    rs = np.random.RandomState(0)
    batches = [{k: v for k, v in bench_batch(rs, B, A, T).items()
                if k in ("state", "action", "true_len", "valid")}  # what the step reads
               for _ in range(N_CHECK + 1 + N_TIMED)]
    batches[N_CHECK - 1]["valid"][200:] = False  # a tail batch of 200 sessions

    # -- the same 3 steps on the card and on CPU copies, where the twins run
    states, steps = {}, {}
    for dev in ("cuda", "cpu"):
        states[dev], opt = make_train_state(params_from_numpy(np_params, dev), mc, LR, device=dev)
        steps[dev] = make_train_step(mc, opt, device=dev)
    losses = {"cuda": [], "cpu": []}
    with shared_keep_masks(seed=1):
        grads = {dev: loss_and_grads(
            states[dev].params, {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()},
            mc, states[dev].generator)[1] for dev in states}
        mus = {dev: [named_leaves(states[dev].opt_state.mu)] for dev in states}
        for b in batches[:N_CHECK]:
            for dev in states:
                states[dev], m = steps[dev](states[dev], b)
                losses[dev].append(m["sup_loss"].item())
                mus[dev].append(named_leaves(states[dev].opt_state.mu))
    # first-step gradients, per leaf: max |card - cpu| <= 1e-4 max |cpu|
    # (fp32 sums of up to B*T*A terms in other orders; a wrong kernel is off
    # by O(1)). The head's columns that no row labels take only B2's softmax
    # term (~1e-6, against ~1e-2 at a label), so they are held at their own
    # scale too.
    got_g, want_g = (named_leaves(grads[dev]) for dev in ("cuda", "cpu"))
    off = torch.ones(A, dtype=torch.bool)
    off[torch.as_tensor(batches[0]["action"]).long()] = False
    for d in (got_g, want_g):
        d["sup_head/kernel off-label"] = d["sup_head/kernel"][:, off]
        d["sup_head/bias off-label"] = d["sup_head/bias"][off]
    grad_err = check_close([got_g[k] for k in want_g], list(want_g.values()), list(want_g),
                           f"{name} step: first-step gradient against the CPU twins",
                           BF16_MODEL_STEPS * BF16_STEP if bf16 else 1e-4)
    loss_err = max(abs(a - c) for a, c in zip(losses["cuda"], losses["cpu"]))
    # losses near log(A) = 11.2; fp32 sums over A in other orders (bf16: one
    # bf16 step of the loss)
    if loss_err > (BF16_STEP * max(losses["cpu"]) if bf16 else 1e-4):
        fail(f"{name} step: losses {losses['cuda']} differ from the CPU twins' {losses['cpu']}")
    # params after 3 steps, atol lr / 1000 (1e-5 for gru4rec, 5e-7 for
    # bidir), over the entries that some step moved on the CPU side (a
    # nonzero gradient; rows no batch touches cannot differ), where each
    # step's CPU gradient, read back from the first moment, is 0 or above
    # 1e-6 in size: Adam moves an entry near zero by about +-lr whatever its
    # size, so a summation-order difference there says nothing about the
    # kernels. The head kernel, trained through B2, must be among them.
    # In bf16 compute the entries are further those whose card and CPU
    # gradients agree within one bf16 step of the value at every step; an
    # Adam update, lr m^/(sqrt(v^) + eps) with |m^ / sqrt(v^)| <= ~2 over 3
    # steps, then moves by at most 2 steps' worth (4 2^-8 relative) of that:
    # 4 BF16_STEP lr a step.
    p_tol = N_CHECK * 4 * BF16_STEP * LR if bf16 else LR / 1000
    got_p, want_p = (named_leaves(states[dev].params) for dev in ("cuda", "cpu"))
    compared, param_err, worst = {}, 0.0, None

    def step_grads(dev, leaf):
        mu = mus[dev]
        return torch.stack([(mu[k + 1][leaf] - 0.9 * mu[k][leaf]) / 0.1 for k in range(N_CHECK)])

    for leaf, want in want_p.items():
        g = step_grads("cpu", leaf)
        moved = (g != 0).any(dim=0)
        sure = moved & ((g == 0) | (g.abs() > 1e-6)).all(dim=0)
        if bf16:
            sure &= ((step_grads("cuda", leaf) - g).abs() <= BF16_STEP * g.abs()).all(dim=0)
        err = (got_p[leaf] - want)[sure].abs().max().item() if sure.any() else 0.0
        if err > param_err:
            param_err, worst = err, leaf
        compared[leaf] = (int(sure.sum()), int(moved.sum()))
    n_sure, n_moved = (sum(c[i] for c in compared.values()) for i in (0, 1))
    head_sure, head_moved = compared["sup_head/kernel"]
    print(f"[train] {name}: {N_CHECK} steps on the card vs the CPU twins: losses "
          f"{losses['cuda']}, max loss diff {loss_err:.3g}; first-step grads rel diff "
          f"{json.dumps(grad_err)}; params max diff {param_err:.3g} ({worst}) over {n_sure} of "
          f"{n_moved} moved entries ({n_sure / n_moved:.4f}; head kernel {head_sure} of "
          f"{head_moved}, {head_sure / head_moved:.4f})")
    if param_err > p_tol:
        fail(f"{name} step: {worst} after {N_CHECK} steps differs by {param_err:.3g} > {p_tol:g}")
    floor_all, floor_head = COMPARED_FLOORS[name]
    if n_sure < floor_all * n_moved or head_sure < floor_head * head_moved:
        fail(f"{name} step: too few params compared: {compared} (compared, moved)")

    # -- timed: the card's state goes on; 1 warm-up step, then 20 steps
    state, step = states["cuda"], steps["cuda"]
    del states["cpu"]
    state, _ = step(state, batches[N_CHECK])
    torch.cuda.synchronize()
    reset_counters()
    step_ms, metrics = [], []
    for b in batches[N_CHECK + 1:]:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m["sup_loss"])
    launches = counters()
    check_launches(name, launches, N_TIMED)
    if not torch.isfinite(torch.stack(metrics)).all():
        fail(f"non-finite {name} train loss")
    step_ms_line(name, A, E, H, T, B, step_ms, launches, f"{metrics[-1].item():.5f}",
                 precision="high" + (f", bf16 compute, {pt['layers']} layers" if bf16 else ""))
    if profile:
        profile_train(step, state, batches[-1])
    return launches


# Launches per train step of each kernel, by family (B3 runs on the state,
# in sqn and smorl also on the next state with each net, in sarm with its
# one net).
PER_STEP = {
    "gru4rec": {"B1 fused_ce_fwd": 1, "B2 fused_ce_bwd": 1, "B3 gru_fwd": 1, "B4 gru_bwd": 1},
    "bidir_gru4rec": {"B1 fused_ce_fwd": 1, "B2 fused_ce_bwd": 1, "B3 gru_fwd": 2,
                      "B4 gru_bwd": 2},
    "sqn": {"B1 fused_ce_fwd": 1, "B2 fused_ce_bwd": 1, "B3 gru_fwd": 3, "B4 gru_bwd": 1,
            "B5 fused_argmax": 1},
    "smorl": {"B2 fused_ce_bwd": 1, "B3 gru_fwd": 3, "B4 gru_bwd": 1, "B6 fused_wargmax": 1},
    "sarm": {"B1 fused_ce_fwd": 1, "B2 fused_ce_bwd": 1, "B3 gru_fwd": 2, "B4 gru_bwd": 1},
    # preset: fast, whose lazy Q heads are action-major
    "sqn fast": {"B1 fused_ce_fwd": 1, "B2 fused_ce_bwd": 1, "B3 gru_fwd": 3, "B4 gru_bwd": 1,
                 "B5 fused_argmax am": 1},
    "smorl fast": {"B2 fused_ce_bwd": 1, "B3 gru_fwd": 3, "B4 gru_bwd": 1,
                   "B6 fused_wargmax am": 1},
    "sarm fast": {"B1 fused_ce_fwd": 1, "B2 fused_ce_bwd": 1, "B3 gru_fwd": 2, "B4 gru_bwd": 1},
    # compute_dtype: bfloat16, whose recurrence runs B3 and B4 on bf16 tensors
    "gru4rec bf16": {"B1 fused_ce_fwd": 1, "B2 fused_ce_bwd": 1, "B3 gru_fwd bf16": 1,
                     "B4 gru_bwd bf16": 1},
    "bidir2 bf16": {"B1 fused_ce_fwd": 1, "B2 fused_ce_bwd": 1, "B3 gru_fwd bf16": 4,
                    "B4 gru_bwd bf16": 4},
    "sqn fast bf16": {"B1 fused_ce_fwd": 1, "B2 fused_ce_bwd": 1, "B3 gru_fwd bf16": 3,
                      "B4 gru_bwd bf16": 1, "B5 fused_argmax am": 1},
}


def check_launches(family, launches, n_steps):
    want = {name: PER_STEP[family].get(name, 0) * n_steps for name in launches}
    if launches != want:
        fail(f"{n_steps} {family} train steps launched {launches}, expected {want}")


def step_ms_line(family, A, E, H, T, B, step_ms, launches, last_loss, precision="high"):
    ms = float(np.median(step_ms))
    print(f"[train] {family} A={A} E={E} H={H} T={T} B={B} {precision}: {len(step_ms)} steps, "
          f"ms per step median {ms:.3f} (min {min(step_ms):.3f}, max {max(step_ms):.3f}, "
          f"p90 {float(np.percentile(step_ms, 90)):.3f}) = {B / ms * 1e3:.0f} sessions/s; "
          f"launches {launches}; last loss {last_loss}")


def phase_double_q(family, profile=False):
    """The sqn or smorl train step at full width: 3 steps with fixed coins
    against CPU copies, then 1 warm-up and 20 timed steps with the coins
    drawn on the host. Returns the timed run's launches."""
    from ikea_recommender_tpu_torch.convert import (
        numpy_init_double_q,
        params_from_numpy,
        tree_leaves,
    )
    from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
    from ikea_recommender_tpu_torch.models.families import apply_features, model_config_from_train
    from ikea_recommender_tpu_torch.ops.fused_argmax import head_values_plain
    from ikea_recommender_tpu_torch.train.state import make_double_q_state
    from ikea_recommender_tpu_torch.train.steps import (
        RLStepConfig,
        double_q_loss_and_grads,
        make_train_step,
    )

    A, E, T, B, LR, N_TIMED = 70852, 64, 10, 256, 0.01, 20
    COINS = (0, 1, 1)  # both nets train, one of them twice in a row
    tc = TrainConfig(model=family, batch_size=B, embedding_size=E, hidden_state_size=E,
                     state_size=T, learning_rate=LR, fused_ce=True, head_precision="high")
    mc = model_config_from_train(tc, DataConfig(num_items=A))
    if not (mc.fused_ce and mc.head_precision == "high"):
        fail(f"the RetailRocket width must train {family} through the fused path in 'high'")
    rl = RLStepConfig()
    np_pair = numpy_init_double_q(mc, (0, 1))
    rs = np.random.RandomState(0)
    aux = {}
    if family == "smorl":  # as bench.py:94-100 draws them, before the batches
        aux = {"div_embedding": rs.randn(A + 1, E).astype(np.float32),
               "unpopular_mask": np.arange(A) % 10 == 0}
    batches = [bench_batch(rs, B, A, T) for _ in range(len(COINS) + 1 + N_TIMED)]
    batches[len(COINS) - 1]["valid"][200:] = False  # a tail batch of 200 sessions
    head = "q_head" if family == "sqn" else "q_heads"

    # -- the same 3 steps on the card and on CPU copies, where the twins run
    states, steps = {}, {}
    for dev in ("cuda", "cpu"):
        pair = [params_from_numpy(p, dev) for p in np_pair]
        states[dev], opt = make_double_q_state(pair, mc, LR, device=dev)
        steps[dev] = make_train_step(mc, opt, rl, device=dev, **aux)

    def on(dev, batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    grads = {dev: double_q_loss_and_grads(states[dev].params, on(dev, batches[0]), mc, rl,
                                          COINS[0], steps[dev].aux)[1] for dev in states}
    # first-step gradients of the main net, per leaf, as the gru4rec phase
    # holds them; the supervised head's unlabelled columns at their own scale
    got_g, want_g = (named_leaves(grads[dev]) for dev in ("cuda", "cpu"))
    off = torch.ones(A, dtype=torch.bool)
    off[torch.as_tensor(batches[0]["action"]).long()] = False
    for d in (got_g, want_g):
        d["sup_head/kernel off-label"] = d["sup_head/kernel"][:, off]
        d["sup_head/bias off-label"] = d["sup_head/bias"][off]
    grad_err = check_close([got_g[k] for k in want_g], list(want_g.values()), list(want_g),
                           f"{family} step: first-step gradient against the CPU twins", 1e-4)

    losses = {"cuda": [], "cpu": []}
    mus = [[named_leaves(states["cpu"].opt_state[n].mu) for n in (0, 1)]]
    id_diffs, near = 0, []
    for b, coin in zip(batches, COINS):
        # the twin's gap between the main net's two best next actions, read
        # on the CPU side before the step moves its params
        cpu_main = states["cpu"].params[coin]
        with torch.no_grad():
            bc = on("cpu", b)
            h_next = apply_features(cpu_main, mc, bc["next_state"], bc["true_next_len"])
            qh = cpu_main[head]
            v = head_values_plain(h_next, qh["kernel"], qh["bias"], mc.action_dim,
                                  mc.head_precision, steps["cpu"].aux.get("q_weights"))
            top2 = v.topk(2, dim=1).values
            gap = top2[:, 0] - top2[:, 1]
            scale = top2[:, 0].abs().max().item()
        kept = states["cuda"]
        before = [t.clone() for t in tree_leaves((kept.params[1 - coin],
                                                  kept.opt_state[1 - coin].mu,
                                                  kept.opt_state[1 - coin].nu))]
        targets = {}
        for dev in states:
            states[dev], m = steps[dev](states[dev], b, coin=coin)
            losses[dev].append((m["sup_loss"].item(), m["q_loss"].item()))
            targets[dev] = m["target_action"].cpu()
        after = tree_leaves((kept.params[1 - coin], kept.opt_state[1 - coin].mu,
                             kept.opt_state[1 - coin].nu))
        if not all(torch.equal(x, y) for x, y in zip(before, after)):
            fail(f"{family} step: the net the step did not train moved")
        differ = targets["cuda"] != targets["cpu"]
        id_diffs += int(differ.sum())
        near.append(int((gap <= KERNEL_TOL * scale).sum()))
        if (differ & (gap > KERNEL_TOL * scale)).any():
            fail(f"{family} step: target actions differ from the CPU twins' at rows whose "
                 f"two best values are more than {KERNEL_TOL:g} of the largest apart")
        mus.append([named_leaves(states["cpu"].opt_state[n].mu) for n in (0, 1)])
    loss_err = max(abs(a - c) for x, y in zip(losses["cuda"], losses["cpu"]) for a, c in zip(x, y))
    if loss_err > 1e-4:
        fail(f"{family} step: losses {losses['cuda']} differ from the CPU twins' {losses['cpu']}")
    # params of both nets after 3 steps over the entries some step moved, as
    # the gru4rec phase; each net's gradients read off its first moment at
    # the steps that trained it
    compared, param_err = {}, 0.0
    for n in (0, 1):
        got_p, want_p = (named_leaves(states[dev].params[n]) for dev in ("cuda", "cpu"))
        for name, want in want_p.items():
            g = torch.stack([(mus[k + 1][n][name] - 0.9 * mus[k][n][name]) / 0.1
                             if COINS[k] == n else torch.zeros_like(want)
                             for k in range(len(COINS))])
            moved = (g != 0).any(dim=0)
            sure = moved & ((g == 0) | (g.abs() > 1e-6)).all(dim=0)
            err = (got_p[name] - want)[sure].abs().max().item() if sure.any() else 0.0
            param_err = max(param_err, err)
            if err > 1e-5:
                fail(f"{family} step: net {n} {name} after {len(COINS)} steps differs by {err:.3g}")
            compared[f"{n}/{name}"] = (int(sure.sum()), int(moved.sum()))
    n_sure, n_moved = (sum(c[i] for c in compared.values()) for i in (0, 1))
    head_sure = sum(compared[f"{n}/sup_head/kernel"][0] for n in (0, 1))
    head_moved = sum(compared[f"{n}/sup_head/kernel"][1] for n in (0, 1))
    if n_sure < 0.2 * n_moved or head_sure < 0.15 * head_moved:
        fail(f"{family} step: too few params compared: {compared} (compared, moved)")
    print(f"[train] {family}: {len(COINS)} steps (coins {COINS}) on the card vs the CPU twins: "
          f"losses (sup, q) {losses['cuda']}, max loss diff {loss_err:.3g}; first-step grads "
          f"rel diff {json.dumps(grad_err)}; target ids differing {id_diffs} (rows within "
          f"{KERNEL_TOL:g} of a tie: {near}); params max diff {param_err:.3g} over {n_sure} of "
          f"{n_moved} moved entries ({n_sure / n_moved:.4f}; sup head kernel {head_sure} of "
          f"{head_moved})")

    # -- timed: the card's state goes on; 1 warm-up step, then 20 steps
    state, step = states["cuda"], steps["cuda"]
    del states["cpu"]
    state, _ = step(state, batches[len(COINS)])
    torch.cuda.synchronize()
    reset_counters()
    step_ms, metrics = [], []
    for b in batches[len(COINS) + 1:]:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m["sup_loss"] + m["q_loss"])
    launches = counters()
    check_launches(family, launches, N_TIMED)
    if not torch.isfinite(torch.stack(metrics)).all():
        fail(f"non-finite {family} train loss")
    step_ms_line(family, A, E, E, T, B, step_ms, launches, f"{metrics[-1].item():.5f}")
    if profile:
        profile_train(step, state, batches[-1])
    return launches


def multihead_max_bound(B, F, valid, K, precision):
    """Least time for sarm's target max over the ``valid`` columns: h, the
    K heads' valid columns of W and b read once, the (B, K) maxima written
    once; K (B, F, valid) products, three bf16 passes each in "high" on the
    tensor cores, one in "default", fp32 FMA in "highest" (the maxima's
    comparisons, ~K B valid operations, not counted)."""
    passes = {"highest": 1, "high": 3, "default": 1}[precision]
    peak = FP32_FLOPS if precision == "highest" else BF16_FLOPS
    n_bytes = 4 * (B * F + K * F * valid + K * valid + B * K)
    return bound(n_bytes, 2.0 * B * F * valid * K * passes, peak)


def cuda_items(fn):
    """The CUDA kernels one call of ``fn`` runs, under torch.profiler:
    (busy us, launches, [(us, count, name)] largest first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e[0])
    return sum(e[0] for e in events), sum(e[1] for e in events), events


def phase_sarm(profile=False):
    """The sarm train step at full width (five Q heads of (64, 70852), head
    0 also the CE head; ``RLStepConfig()``: sarm_gamma 0.99): 3 steps
    against CPU copies, then 1 warm-up and 20 timed steps; and the
    five-head target max (``blockwise_multihead_max``, plain torch) timed
    at the step's shapes against its dense fp32 form. Returns the timed
    run's launches."""
    from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
    from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
    from ikea_recommender_tpu_torch.models.families import apply_features, model_config_from_train
    from ikea_recommender_tpu_torch.ops.fused_topk import blockwise_multihead_max
    from ikea_recommender_tpu_torch.train.state import make_train_state
    from ikea_recommender_tpu_torch.train.steps import (
        RLStepConfig,
        make_train_step,
        sarm_loss_and_grads,
    )

    A, E, T, B, LR, N_CHECK, N_TIMED = 70852, 64, 10, 256, 0.01, 3, 20
    tc = TrainConfig(model="sarm", batch_size=B, embedding_size=E, hidden_state_size=E,
                     state_size=T, learning_rate=LR, fused_ce=True, head_precision="high")
    mc = model_config_from_train(tc, DataConfig(num_items=A))
    rl = RLStepConfig()
    if not (mc.fused_ce and mc.head_precision == "high" and mc.num_q_heads == 5
            and rl.sarm_gamma == 0.99):
        fail("sarm at the RetailRocket width must train 5 heads through the fused path in "
             "'high' at sarm_gamma 0.99")
    K = mc.num_q_heads
    np_params = numpy_init_params(mc, seed=0)
    rs = np.random.RandomState(0)
    batches = [bench_batch(rs, B, A, T) for _ in range(N_CHECK + 1 + N_TIMED)]
    batches[N_CHECK - 1]["valid"][200:] = False  # a tail batch of 200 sessions
    ends = [int(b["is_end"].sum()) for b in batches[:N_CHECK]]

    def on(dev, batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    # -- the same 3 steps on the card and on CPU copies, where the twins run
    states, steps = {}, {}
    for dev in ("cuda", "cpu"):
        states[dev], opt = make_train_state(params_from_numpy(np_params, dev), mc, LR, device=dev)
        steps[dev] = make_train_step(mc, opt, rl, device=dev)
    grads = {dev: sarm_loss_and_grads(states[dev].params, on(dev, batches[0]), mc, rl)[1]
             for dev in states}
    # first-step gradients, per leaf, as the gru4rec phase holds them; head
    # 0's unlabelled columns (the CE's softmax term only) at their own scale
    got_g, want_g = (named_leaves(grads[dev]) for dev in ("cuda", "cpu"))
    off = torch.ones(A, dtype=torch.bool)
    off[torch.as_tensor(batches[0]["action"]).long()] = False
    for d in (got_g, want_g):
        d["q_heads/kernel 0 off-label"] = d["q_heads/kernel"][0][:, off]
        d["q_heads/bias 0 off-label"] = d["q_heads/bias"][0][off]
    grad_err = check_close([got_g[k] for k in want_g], list(want_g.values()), list(want_g),
                           "sarm step: first-step gradient against the CPU twins", 1e-4)
    losses = {"cuda": [], "cpu": []}
    mus = [named_leaves(states["cpu"].opt_state.mu)]
    for b in batches[:N_CHECK]:
        for dev in states:
            states[dev], m = steps[dev](states[dev], b)
            losses[dev].append((m["sup_loss"].item(), m["q_loss"].item()))
        mus.append(named_leaves(states["cpu"].opt_state.mu))
    loss_err = max(abs(a - c) for x, y in zip(losses["cuda"], losses["cpu"]) for a, c in zip(x, y))
    if loss_err > 1e-4:
        fail(f"sarm step: losses {losses['cuda']} differ from the CPU twins' {losses['cpu']}")
    # params after 3 steps over the entries some step moved, as the gru4rec
    # phase holds them (atol lr / 1000)
    got_p, want_p = (named_leaves(states[dev].params) for dev in ("cuda", "cpu"))
    compared, param_err, worst = {}, 0.0, None
    for name, want in want_p.items():
        g = torch.stack([(mus[k + 1][name] - 0.9 * mus[k][name]) / 0.1 for k in range(N_CHECK)])
        moved = (g != 0).any(dim=0)
        sure = moved & ((g == 0) | (g.abs() > 1e-6)).all(dim=0)
        err = (got_p[name] - want)[sure].abs().max().item() if sure.any() else 0.0
        if err > param_err:
            param_err, worst = err, name
        compared[name] = (int(sure.sum()), int(moved.sum()))
    n_sure, n_moved = (sum(c[i] for c in compared.values()) for i in (0, 1))
    head_sure, head_moved = compared["q_heads/kernel"]
    print(f"[train] sarm: {N_CHECK} steps on the card vs the CPU twins (rows at an episode end "
          f"{ends}): losses (sup, q) {losses['cuda']}, max loss diff {loss_err:.3g}; first-step "
          f"grads rel diff {json.dumps(grad_err)}; params max diff {param_err:.3g} ({worst}) over "
          f"{n_sure} of {n_moved} moved entries ({n_sure / n_moved:.4f}; head kernel {head_sure} "
          f"of {head_moved}, {head_sure / head_moved:.4f})")
    if param_err > LR / 1000:
        fail(f"sarm step: {worst} after {N_CHECK} steps differs by {param_err:.3g}")
    floor_all, floor_head = COMPARED_FLOORS["sarm"]
    if n_sure < floor_all * n_moved or head_sure < floor_head * head_moved:
        fail(f"sarm step: too few params compared: {compared} (compared, moved)")

    # -- the five-head target max at the step's shapes: against its dense
    # fp32 form (one batched cuBLAS product and a max over (K, B, A)), whose
    # products it splits into three bf16 passes in "high"
    state, step = states["cuda"], steps["cuda"]
    del states["cpu"]
    qh = state.params["q_heads"]
    bn = on("cuda", batches[N_CHECK])
    with torch.no_grad():
        h_next = apply_features(state.params, mc, bn["next_state"], bn["true_next_len"])

    def target_max():
        return blockwise_multihead_max(h_next, qh["kernel"], qh["bias"], A, precision="high")

    def dense_max():
        return torch.baddbmm(qh["bias"][:, None, :], h_next.expand(K, -1, -1),
                             qh["kernel"]).amax(dim=2).T

    got, want = target_max(), dense_max()
    scale = torch.einsum("bf,kfa->bka", h_next.abs(), qh["kernel"].abs()).amax(dim=2)
    max_err_ = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or ((got - want).abs() > 3 * 2.0**-16 * scale + 1e-5).any():
        fail(f"sarm target max differs from its dense fp32 form by {max_err_:.3g}")
    busy_us, n_launch, items = cuda_items(target_max)
    mh = {"ms": graph_ms(target_max, 20), "eager_ms": eager_ms(target_max, 20),
          "dense_ms": graph_ms(dense_max, 20), "launches": n_launch,
          "bound": multihead_max_bound(B, E, A, K, "high")}
    print(f"[train] sarm target max (B={B}, K={K}, F={E}, A={A}, blocks of 4096, high): "
          f"{mh['ms']:.6f} ms in a CUDA graph, {mh['eager_ms']:.6f} eager, {n_launch} launches "
          f"({busy_us:.1f} us busy under the profiler); bound {mh['bound'][0]:.6f} ms "
          f"({mh['bound'][1]}); dense fp32 (baddbmm + amax) {mh['dense_ms']:.6f} ms; max diff "
          f"{max_err_:.3g}")
    for us, count, name in items[:6]:
        print(f"[train]   target max: {us:10.1f} us  x{count:<4d} {name[:90]}")

    # -- timed: the card's state goes on; 1 warm-up step, then 20 steps
    state, _ = step(state, batches[N_CHECK])
    torch.cuda.synchronize()
    reset_counters()
    step_ms, metrics = [], []
    for b in batches[N_CHECK + 1:]:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m["sup_loss"] + m["q_loss"])
    launches = counters()
    check_launches("sarm", launches, N_TIMED)
    if not torch.isfinite(torch.stack(metrics)).all():
        fail("non-finite sarm train loss")
    step_ms_line("sarm", A, E, E, T, B, step_ms, launches, f"{metrics[-1].item():.5f}")
    if profile:
        profile_train(step, state, batches[-1])
    return launches


def bf16_steps(got, want):
    """|got - want| in bf16 steps of the larger of the two, for moments
    stored in bf16 (0 where both are 0)."""
    g, w = got.float().cpu(), want.float().cpu()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    return (g - w).abs() / torch.ldexp(torch.ones_like(g), e - 8)


def lazy_moments(opt_state, family, K):
    """{param name: (m, v)} of one net's lazy optimizer state, as fp32 on
    the host: dense Adam's leaves (``rest/...`` under their param names,
    sarm's ``h0`` as ``q_heads/kernel0``, ``bias0``) and the action-major
    heads' packed rows, unpacked into ``kernel_am`` and the bias."""
    out = {}
    for kind in ("mu", "nu"):
        for name, t in named_leaves(getattr(opt_state.rest, kind)).items():
            name = name[5:] if name.startswith("rest/") else "q_heads/" + name[3:] + "0"
            out.setdefault(name, []).append(t)
    key, bname = ("q_head", "bias") if family == "sqn" else (
        "q_heads", "bias_rest" if family == "sarm" else "bias")
    mv = opt_state.qh.mv.float().cpu()
    A = mv.shape[0]
    for half in mv.chunk(2, dim=1):
        p = half.reshape(A, K, -1)
        bias = p[:, :, -1].T
        out.setdefault(f"{key}/kernel_am", []).append(p[:, :, :-1].reshape(A, -1))
        out.setdefault(f"{key}/{bname}", []).append(bias[0] if family == "sqn" else bias)
    return out


def lazy_param_grads(grads, pieces, params, family, K):
    """One net's lazy step gradients in the params' layout (host fp32): the
    dense part's leaves, and the sorted rows' scattered to their actions
    (for the host's comparison masks only)."""
    out = {}
    for name, t in named_leaves(grads["dense"]).items():
        out[name[5:] if name.startswith("rest/") else "q_heads/" + name[3:] + "0"] = t
    key, bname = ("q_head", "bias") if family == "sqn" else (
        "q_heads", "bias_rest" if family == "sarm" else "bias")
    sids = pieces["sids"].cpu()
    kam = params[key]["kernel_am"]
    g_w = grads["w_rows"].float().cpu().reshape(sids.shape[0], -1)
    out[f"{key}/kernel_am"] = torch.zeros(kam.shape).index_add_(0, sids, g_w)
    g_b = torch.zeros(K, kam.shape[0]).index_add_(1, sids, grads["b_cols"].float().cpu())
    out[f"{key}/{bname}"] = g_b[0] if family == "sqn" else g_b
    return out


def phase_fast(family, profile=False, dtype="float32"):
    """sqn, smorl or sarm as ``preset: fast`` resolves them at full width:
    the fused path in "default", bf16 Adam moments and lazy action-major Q
    heads (B5 or B6 in their action-major form; sarm's heads 1-4 as rows,
    its target max ``blockwise_multihead_max_am``), with ``dtype`` compute
    (bf16: the lazy embedding rows cast where they enter the backbone). 3
    steps (coins (0, 1, 1)) against CPU copies, then 1 warm-up and 20 timed
    steps. Returns the timed run's launches.

    In bf16 compute the gradients and moments are held as the bf16 train
    phases hold them (BF16_MODEL_STEPS steps of each leaf's largest entry),
    the losses to one bf16 step of the loss, the target actions to the
    plain head on the card's own features and params, and the params where
    the stored moments agreed at every step: the fp32 moments each update
    used were then within one bf16 step of each other, so the update is
    within two (4 BF16_STEP relative) of one of at most ~2 lr, 4 BF16_STEP
    lr a step. Where the stored moments fell apart the gradients differed
    past a bf16 rounding, and the params are reported, not held."""
    from ikea_recommender_tpu_torch.convert import (
        numpy_init_double_q,
        numpy_init_params,
        params_from_numpy,
        tree_leaves,
    )
    from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
    from ikea_recommender_tpu_torch.models.families import apply_features, model_config_from_train
    from ikea_recommender_tpu_torch.ops.fused_argmax import head_values_plain
    from ikea_recommender_tpu_torch.train.state import (
        QH_KEY,
        make_lazy_double_q_state,
        make_lazy_sarm_state,
    )
    from ikea_recommender_tpu_torch.train.steps import (
        LazyCfg,
        RLStepConfig,
        lazy_apply_updates,
        lazy_loss_and_grads,
        make_train_step,
    )

    A, E, T, B, LR, N_TIMED = 70852, 64, 10, 256, 0.01, 20
    double_q = family != "sarm"
    bf16 = dtype == "bfloat16"
    label = f"{family} fast" + (" bf16" if bf16 else "")
    tie = BF16_MODEL_STEPS * BF16_STEP if bf16 else KERNEL_TOL  # relative to the leaf's largest
    COINS = (0, 1, 1) if double_q else (0, 0, 0)
    tc = TrainConfig(model=family, batch_size=B, embedding_size=E, hidden_state_size=E,
                     state_size=T, learning_rate=LR, fused_ce=True, preset="fast",
                     compute_dtype=dtype)
    mc = model_config_from_train(tc, DataConfig(num_items=A))
    if not (mc.fused_ce and mc.head_precision == "default" and tc.qhead_optimizer == "lazy_adam"
            and tc.optimizer_mv_dtype == "bfloat16"):
        fail(f"preset fast must train {family} through the fused path in 'default' with bf16 "
             "moments and lazy Q heads")
    rl, lazy = RLStepConfig(), LazyCfg(qh_lr=LR)
    K = {"sqn": 1, "smorl": mc.num_q_heads, "sarm": mc.num_q_heads - 1}[family]
    key = QH_KEY[family]
    rs = np.random.RandomState(0)
    aux = {}
    if family == "smorl":  # as bench.py:94-100 draws them, before the batches
        aux = {"div_embedding": rs.randn(A + 1, E).astype(np.float32),
               "unpopular_mask": np.arange(A) % 10 == 0}
    batches = [bench_batch(rs, B, A, T) for _ in range(len(COINS) + 1 + N_TIMED)]
    batches[len(COINS) - 1]["valid"][200:] = False  # a tail batch of 200 sessions

    states, steps, opts = {}, {}, {}
    for dev in ("cuda", "cpu"):
        if double_q:
            pair = [params_from_numpy(p, dev) for p in numpy_init_double_q(mc, (0, 1))]
            states[dev], opts[dev] = make_lazy_double_q_state(
                pair, mc, LR, tc.optimizer_mv_dtype, lazy_qh=True, device=dev)
        else:
            states[dev], opts[dev] = make_lazy_sarm_state(
                params_from_numpy(numpy_init_params(mc, 0), dev), mc, LR, tc.optimizer_mv_dtype,
                lazy_qh=True, device=dev)
        steps[dev] = make_train_step(mc, opts[dev], rl, lazy_qhead_lr=LR, device=dev, **aux)

    def on(dev, batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def net(dev, n):
        st = states[dev]
        return (st.params[n], st.opt_state[n]) if double_q else (st.params, st.opt_state)

    def grads_of(dev, b, coin):
        p = net(dev, coin)[0]
        boot = dict(boot=states[dev].params[1 - coin], aux=steps[dev].aux) if double_q else {}
        return lazy_loss_and_grads(p, on(dev, b), mc, lazy, rl, **boot)

    # first-step gradients of the main net, per leaf (the sorted rows' too),
    # as the dense phases hold them; the supervised head's unlabelled
    # columns at their own scale, to one bf16 step of dl in "default"
    cpu_first = grads_of("cpu", batches[0], COINS[0])
    got_g = named_leaves(grads_of("cuda", batches[0], COINS[0])[1])
    want_g = named_leaves(cpu_first[1])
    off = torch.ones(A, dtype=torch.bool)
    off[torch.as_tensor(batches[0]["action"]).long()] = False
    head0 = "dense/rest/sup_head" if family != "sarm" else "dense/h0"
    offl = {side: {"kernel off-label": d[f"{head0}/kernel"][:, off],
                   "bias off-label": d[f"{head0}/bias"][off]}
            for side, d in (("got", got_g), ("want", want_g))}
    grad_err = check_close([got_g[k] for k in want_g], list(want_g.values()), list(want_g),
                           f"{label} step: first-step gradient against the CPU twins",
                           tie if bf16 else 1e-4)
    grad_err.update(check_close(list(offl["got"].values()), list(offl["want"].values()),
                                list(offl["want"]), f"{label} step: first-step gradient",
                                max(tie, DEFAULT_OFF_LABEL_TOL)))

    losses = {"cuda": [], "cpu": []}
    id_diffs, near, flips = 0, [], {}
    hist = []  # per step: the main net and its CPU gradients in the params' layout
    # the CPU copy steps as the step function does, from the gradients it
    # keeps for the comparison masks: lazy_loss_and_grads, lazy_apply_updates
    for i, (b, coin) in enumerate(zip(batches, COINS)):
        cpu_p, cpu_o = net("cpu", coin)
        m_cpu, g, pieces = cpu_first if i == 0 else grads_of("cpu", b, coin)
        hist.append((coin, lazy_param_grads(g, pieces, cpu_p, family, K)))
        if double_q:
            # the gap between the main net's two best next actions, by the
            # plain head on the CPU copy's next-state features; in bf16
            # compute, on the card's own features and params (the two
            # sides' bf16 features differ by bf16 steps, so the target is
            # held to the card's own values there)
            side = "cuda" if bf16 else "cpu"
            with torch.no_grad():
                bc, tp = on(side, b), net(side, coin)[0]
                h_next = apply_features(tp, mc, bc["next_state"], bc["true_next_len"])
                v = head_values_plain(h_next, tp[key]["kernel_am"], tp[key]["bias"],
                                      mc.action_dim, mc.head_precision,
                                      steps[side].aux.get("q_weights"), action_major=True)
                top2, want_t = v.topk(2, dim=1).values.cpu(), v.argmax(dim=1).cpu()
                gap, scale = top2[:, 0] - top2[:, 1], top2[:, 0].abs().max().item()
            kept_p, kept_o = net("cuda", 1 - coin)
            before = [t.clone() for t in tree_leaves((kept_p, kept_o.rest.mu, kept_o.rest.nu))]
            before += [kept_o.qh.mv.clone(), kept_o.count.clone()]
        states["cuda"], m = steps["cuda"](states["cuda"], b, **(dict(coin=coin) if double_q else {}))
        lazy_apply_updates(cpu_p, g, pieces, cpu_o, opts["cpu"], family, mc, lazy)
        states["cpu"].step += 1
        targets = {}
        for dev, met in (("cuda", m), ("cpu", m_cpu)):
            losses[dev].append((met["sup_loss"].item(), met["q_loss"].item()))
            targets[dev] = met.get("target_action")
        if double_q:
            after = tree_leaves((kept_p, kept_o.rest.mu, kept_o.rest.nu))
            after += [kept_o.qh.mv, kept_o.count]
            if not all(torch.equal(x, y) for x, y in zip(before, after)):
                fail(f"{family} fast step: the net the step did not train moved")
            id_diffs += int((targets["cuda"].cpu() != targets["cpu"]).sum())
            differ = targets["cuda"].cpu() != (want_t if bf16 else targets["cpu"])
            near.append(int((gap <= KERNEL_TOL * scale).sum()))
            if (differ & (gap > KERNEL_TOL * scale)).any():
                fail(f"{label} step: target actions differ from the plain head's at rows "
                     f"whose two best values are more than {KERNEL_TOL:g} of the largest apart")
        # moments in their bf16 storage: where the two sides' fp32 moments
        # fall on two sides of a rounding they are one bf16 step apart, and
        # a later update carries that step on (times b1 or b2) beside its
        # own: at most one step per update of the net so far; or within the
        # first-step gradients' 1e-4 of the leaf's largest entry (a moment
        # far below it carries its gradient's summation order)
        got_m = lazy_moments(net("cuda", coin)[1], family, K)
        want_m = lazy_moments(net("cpu", coin)[1], family, K)
        updates = int(net("cpu", coin)[1].count)
        for name, pair in want_m.items():
            for which, (x, y) in enumerate(zip(got_m[name], pair)):
                st = bf16_steps(x, y)
                small = (x.float().cpu() - y).abs() <= (tie if bf16 else 1e-4) * y.abs().max()
                if ((st > updates) & ~small).any():
                    fail(f"{family} fast step: {'mv'[which]} of {name} differs by "
                         f"{st[~small].max().item():.3g} bf16 steps from the CPU twins'")
                f = flips.setdefault((coin, name), torch.zeros(x.shape, dtype=torch.bool))
                f |= st > 0
        if int(net("cuda", coin)[1].count) != int(net("cpu", coin)[1].count):
            fail(f"{family} fast step: the lazy count differs from the CPU twins'")
    loss_err = max(abs(a - c) for x, y in zip(losses["cuda"], losses["cpu"]) for a, c in zip(x, y))
    top_loss = max(abs(a) for x in losses["cpu"] for a in x)
    if loss_err > (BF16_STEP * top_loss if bf16 else 1e-4):
        fail(f"{label} step: losses {losses['cuda']} differ from the CPU twins' "
             f"{losses['cpu']}")
    # params after 3 steps, as the dense phases hold them (lr / 1000 over the
    # entries some step moved with gradients 0 or above 1e-6), on the
    # entries whose stored moments agreed at every step; of those whose
    # stored moments fell apart, a later update moves by up to its moments'
    # bf16 steps apart (at most 2 after 2 updates, 2^-7 of the update each)
    # of an update of at most ~2 lr: 3 lr 2^-6 over the 3 steps
    nets = (0, 1) if double_q else (0,)
    compared, n_flipped, param_err, flip_err = 0, 0, 0.0, 0.0
    n_moved = 0
    for n in nets:
        got_p, want_p = (named_leaves(net(dev, n)[0]) for dev in ("cuda", "cpu"))
        for name, want in want_p.items():
            g = torch.stack([gr[name] if c == n else torch.zeros_like(want) for c, gr in hist])
            moved = (g != 0).any(dim=0)
            sure = moved & ((g == 0) | (g.abs() > 1e-6)).all(dim=0)
            flip = flips.get((n, name), torch.zeros_like(moved))
            diff = (got_p[name] - want).abs()
            if (sure & ~flip).any():
                param_err = max(param_err, diff[sure & ~flip].max().item())
            if (sure & flip).any():
                flip_err = max(flip_err, diff[sure & flip].max().item())
            compared += int((sure & ~flip).sum())
            n_flipped += int((sure & flip).sum())
            n_moved += int(moved.sum())
    p_tol = len(COINS) * 4 * BF16_STEP * LR if bf16 else LR / 1000
    if param_err > p_tol or (not bf16 and flip_err > 3 * LR * 2.0**-6):
        fail(f"{label} step: params after {len(COINS)} steps differ by {param_err:.3g} "
             f"(moments equal) / {flip_err:.3g} (a bf16 rounding apart)")
    if compared < (0.05 if bf16 else 0.2) * n_moved:
        fail(f"{label} step: too few params compared ({compared} of {n_moved})")
    print(f"[train] {label}: {len(COINS)} steps (coins {COINS if double_q else '-'}) on "
          f"the card vs the CPU twins: losses (sup, q) {losses['cuda']}, max loss diff "
          f"{loss_err:.3g}; first-step grads rel diff {json.dumps(grad_err)}; target ids "
          f"differing from the CPU twins' {id_diffs} (rows within {KERNEL_TOL:g} of a tie: "
          f"{near}); params max diff "
          f"{param_err:.3g} over {compared} of {n_moved} moved entries, {flip_err:.3g} over the "
          f"{n_flipped} more whose bf16 moments fell apart")

    # -- timed: the card's state goes on; 1 warm-up step, then 20 steps
    state, step = states["cuda"], steps["cuda"]
    del states["cpu"]
    state, _ = step(state, batches[len(COINS)])
    torch.cuda.synchronize()
    reset_counters()
    step_ms, metrics = [], []
    for b in batches[len(COINS) + 1:]:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m["sup_loss"] + m["q_loss"])
    launches = counters()
    check_launches(label, launches, N_TIMED)
    if not torch.isfinite(torch.stack(metrics)).all():
        fail(f"non-finite {label} train loss")
    step_ms_line(label, A, E, E, T, B, step_ms, launches, f"{metrics[-1].item():.5f}",
                 precision="default, bf16 moments, lazy Q heads"
                 + (", bf16 compute" if bf16 else ""))
    if profile:
        profile_train(step, state, batches[-1])
    return launches


def profile_train(step, state, batch):
    """One train step's device time by kernel and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"[profile] train step: wall {wall_us:.1f} us, device busy {busy_us:.1f} us "
          f"({busy_us / wall_us:.4f}), idle share {1 - busy_us / wall_us:.4f}, "
          f"{sum(e.count for e in events)} kernel launches")
    for e in events[:15]:
        print(f"[profile]   {e.self_device_time_total:10.1f} us  x{e.count:<4d} {e.key[:90]}")


# The eval protocol's operating point: the eval batch val_batch_size = 2000
# (core/config.py) over 20011 rows, 11 batches, the last holding 11 valid
# rows and 1989 padded ones (scripts/bench_eval.py uses 20000 at this width;
# the 11 more exercise the tail). gru4rec at the RetailRocket width and
# bidir_gru4rec at that of BidirGRU-128.yaml, as in the train phases.
EVAL_ROWS, EVAL_BATCH = 20011, 2000
EVAL_POINTS = {"gru4rec": dict(E=64, H=64), "bidir_gru4rec": dict(E=64, H=128)}


@contextlib.contextmanager
def plain_recurrence():
    """Inside, the backbone's recurrence runs B3's plain twin, on the card
    too; outside, ``gru_scan`` as always."""
    from ikea_recommender_tpu_torch.models import gru
    from ikea_recommender_tpu_torch.ops.gru_cuda import gru_scan_plain

    scan = gru.gru_scan
    gru.gru_scan = gru_scan_plain
    try:
        yield
    finally:
        gru.gru_scan = scan


def eval_buffer(A, T, n_rows, rs):
    """``n_rows`` eval windows (the port's ``window_sessions``, pad id A) of
    seeded sessions of 1-20 items."""
    from ikea_recommender_tpu_torch.data.preprocessing import window_sessions
    from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer

    lens = rs.randint(1, 21, n_rows)
    lens = lens[: np.searchsorted(np.cumsum(lens), n_rows) + 1]
    lens[-1] -= lens.sum() - n_rows
    win = window_sessions(rs.randint(0, A, n_rows), np.repeat(np.arange(len(lens)), lens), T, A)
    return EvalBuffer(state=win.state, action=win.action, true_len=win.true_state_len)


def eval_scores(proto, params, buf, k):
    """Per eval batch: (top-k values, ids, per-sample CE, labels, valid) of
    the protocol's scorer, the path ``update`` takes."""
    from ikea_recommender_tpu_torch.data.replay_buffer import eval_batches

    out = []
    for b in eval_batches(buf, EVAL_BATCH):
        v, i, ce = proto.topk_ce(params, b.state, b.true_len, b.action, k=k)
        out.append((v, i, ce, *(torch.as_tensor(x, device="cuda") for x in (b.action, b.valid))))
    return out


def hold_eval_batches(got, want, proto, ref, slacks=None):
    """Each batch's top max-k to ``want``'s by check_topk's rule, and its CE
    within 1e-5, on the valid rows (``slacks``: each batch's score_slack,
    added to both, twice to the CE). Returns the counts of valid rows with a
    near tie in the top max k + 1 ("near"), and of those whose label's rank
    ("rank") or whose top-k set, for each k a metric reads (k), differs
    from the reference: only near rows may, and only these can move a
    metric."""
    from ikea_recommender_tpu_torch.ops.ranking import hit_ranks

    ks = sorted({*proto.topk_hr_ndcg, *proto.topk_cov, proto.topk_div, proto.topk_nov})
    max_k = ks[-1]
    moved = dict.fromkeys(["near", "rank", *ks], 0)
    for n, ((v, i, ce, label, valid), (v_ref, i_ref, ce_ref, _, _)) in enumerate(zip(got, want)):
        slack = None if slacks is None else slacks[n]
        clear = check_topk(v, i, v_ref, i_ref, max_k, ref=ref, slack=slack)
        extra = 0.0 if slack is None else 2 * slack[valid]
        err = ((ce - ce_ref)[valid].abs() - extra).max().item()
        if not (torch.isfinite(ce).all() and err <= 1e-5):
            fail(f"eval: per-sample CE differs from {ref} by {err:.3g} past its slack")
        near = valid & ~clear.all(dim=1)
        rows = {"near": near,
                "rank": valid & (hit_ranks(i[:, :max_k], label)[1]
                                 != hit_ranks(i_ref[:, :max_k], label)[1])}
        for k in ks:
            rows[k] = valid & (i[:, :k].sort(dim=1).values
                               != i_ref[:, :k].sort(dim=1).values).any(dim=1)
        for key, r in rows.items():
            if (r & ~near).any():
                fail(f"eval: rows without a near tie moved ({key}) against {ref}")
            moved[key] += int(r.sum())
    return moved


def hold_eval_result(got, want, moved, proto, T, ref, loss_tol=1e-5):
    """Whole passes: the loss within ``loss_tol``; the rewards within 1e-5
    plus what the rows whose top-k set moved can move; HR, NDCG (+1e-6, sums
    in other orders), repetitions and coverage within what the rows whose
    rank or top-k set moved can move: exact where none did."""
    n = EVAL_ROWS
    n_unpop = max(int(proto.unpopular_mask.sum()), 1)
    bad = []
    if not all(np.isfinite(x).all() for x in (got.loss, got.hr, got.ndcg, got.reps)):
        bad.append("not finite")
    if abs(got.loss - want.loss) > loss_tol:
        bad.append(f"loss {got.loss} vs {want.loss}")
    if abs(got.div_rew - want.div_rew) > 1e-5 + 2 * moved[proto.topk_div] / n:
        bad.append(f"div_rew {got.div_rew} vs {want.div_rew}")
    if abs(got.nov_rew - want.nov_rew) > 1e-5 + proto.nov_rew_sig * moved[proto.topk_nov] / n:
        bad.append(f"nov_rew {got.nov_rew} vs {want.nov_rew}")
    for j, k in enumerate(proto.topk_hr_ndcg):
        if abs(got.hr[j] - want.hr[j]) > moved["rank"] / n:
            bad.append(f"HR@{k} {got.hr[j]} vs {want.hr[j]}")
        if abs(got.ndcg[j] - want.ndcg[j]) > 1e-6 + moved["rank"] / n:
            bad.append(f"NDCG@{k} {got.ndcg[j]} vs {want.ndcg[j]}")
        if abs(got.reps[j] - want.reps[j]) > moved[k] * k * T / n:
            bad.append(f"R@{k} {got.reps[j]} vs {want.reps[j]}")
    for k in proto.topk_cov:
        (gu, ga), (wu, wa) = got.coverage[k], want.coverage[k]
        if abs(gu - wu) > moved[k] * k / n_unpop or abs(ga - wa) > moved[k] * k / proto.num_actions:
            bad.append(f"coverage@{k} {got.coverage[k]} vs {want.coverage[k]}")
    if bad:
        fail(f"eval pass against {ref} (rows moved: {moved}): {'; '.join(bad)}")


def same_result(a, b):
    """Two EvalResults equal bit for bit."""
    return (a.loss == b.loss and a.div_rew == b.div_rew and a.nov_rew == b.nov_rew
            and all(np.array_equal(x, y) for x, y in ((a.hr, b.hr), (a.ndcg, b.ndcg),
                                                      (a.reps, b.reps)))
            and a.coverage == b.coverage)


def eval_slacks(mc, params, buf):
    """Per eval batch, the score_slack between the head inputs of the card's
    recurrence and of the plain one, after holding those (bf16) inputs to
    one bf16 step; and the valid rows whose inputs differ at all."""
    from ikea_recommender_tpu_torch.data.replay_buffer import eval_batches
    from ikea_recommender_tpu_torch.models.families import apply_features

    slacks, differ = [], 0
    for b in eval_batches(buf, EVAL_BATCH):
        state, true_len = (torch.as_tensor(x, device="cuda") for x in (b.state, b.true_len))
        h = apply_features(params, mc, state, true_len)
        with plain_recurrence():
            h_ref = apply_features(params, mc, state, true_len)
        bf16_close(h.bfloat16(), h_ref.bfloat16(), "bf16 eval: the head input")
        slacks.append(score_slack(h, h_ref, params["sup_head"]["kernel"]))
        differ += int(((h != h_ref).any(dim=1).cpu() & torch.as_tensor(b.valid)).sum())
    return slacks, differ


def phase_eval(family, smi, profile=False, dtype="float32"):
    """One family's eval at the eval batch: per batch and per pass against
    the plain recurrence, the dense arm against the fused one (gru4rec), two
    passes bit for bit, then timed passes. In bf16 compute the head inputs
    are held to the plain recurrence's within one bf16 step, and the scores
    and CE within what those differences can move (score_slack). Returns a
    timed pass's launches."""
    from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
    from ikea_recommender_tpu_torch.core.config import DataConfig, MetricsConfig, TrainConfig
    from ikea_recommender_tpu_torch.data.replay_buffer import eval_batches, num_batches
    from ikea_recommender_tpu_torch.eval.protocol import EvalProtocol
    from ikea_recommender_tpu_torch.models.families import model_config_from_train

    A, T = 70852, 10
    E, H = EVAL_POINTS[family]["E"], EVAL_POINTS[family]["H"]
    bf16 = dtype == "bfloat16"
    b3_key = "B3 gru_fwd bf16" if bf16 else "B3 gru_fwd"
    tc = TrainConfig(model=family, embedding_size=E, hidden_state_size=H, state_size=T,
                     compute_dtype=dtype)
    if tc.val_batch_size != EVAL_BATCH:
        fail(f"val_batch_size is {tc.val_batch_size}, not {EVAL_BATCH}")
    mc = model_config_from_train(tc, DataConfig(num_items=A))
    params = params_from_numpy(numpy_init_params(mc, seed=0), device="cuda")
    rs = np.random.RandomState(2)
    buf = eval_buffer(A, T, EVAL_ROWS, rs)
    m = MetricsConfig()  # topk_hr_ndcg (10, 20), topk_cov (1, 5, 10, 20), div and nov 1
    kw = dict(topk_hr_ndcg=m.topk_hr_ndcg, topk_cov=m.topk_cov, topk_div=m.topk_div,
              topk_nov=m.topk_nov, nov_rew_sig=m.nov_rew_sig,
              # as scripts/bench_eval.py:43-50 draws them
              div_embedding=rs.randn(A + 1, E).astype(np.float32),
              unpopular_mask=np.arange(A) % 10 == 0)
    fused = EvalProtocol(mc, device="cuda", **kw)
    if not fused.fused:
        fail("the RetailRocket width must take the fused eval arm")
    max_k = max(*m.topk_hr_ndcg, *m.topk_cov, m.topk_div, m.topk_nov)

    # about half the labels at one of the row's top-20 ids under the plain
    # recurrence: at random weights a label almost never hits otherwise
    with plain_recurrence():
        top = torch.cat([i[valid] for _, i, _, _, valid in eval_scores(fused, params, buf, max_k)])
    top = top.cpu().numpy()
    relabel = rs.rand(EVAL_ROWS) < 0.5
    buf.action[relabel] = top[relabel, rs.randint(0, max_k, EVAL_ROWS)[relabel]]

    # -- per batch: the card against the plain recurrence, then dense vs fused
    with plain_recurrence():
        want = eval_scores(fused, params, buf, max_k + 1)
    got = eval_scores(fused, params, buf, max_k + 1)
    slacks, differ, loss_tol = None, 0, 1e-5
    if bf16:
        slacks, differ = eval_slacks(mc, params, buf)
        # the mean CE moves by at most 2 slack on each row whose inputs differ
        loss_tol += 2 * max(x.max().item() for x in slacks) * differ / EVAL_ROWS
    moved = hold_eval_batches(got, want, fused, "the plain recurrence", slacks)
    dense, moved_d = None, None
    if family == "gru4rec":
        dense = EvalProtocol(mc, fused=False, device="cuda", **kw)
        moved_d = hold_eval_batches(eval_scores(dense, params, buf, max_k + 1), got, dense,
                                    "the fused arm")
    del got, want

    # -- whole passes: the reference, then three timed fused passes
    with plain_recurrence():
        res_ref = fused.evaluate(params, buf, EVAL_BATCH)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    res = fused.evaluate(params, buf, EVAL_BATCH)
    pass_ms = [(time.perf_counter() - t0) * 1e3]
    launches = counters()
    n_b = num_batches(EVAL_ROWS, EVAL_BATCH)
    n_dir = 2 if mc.backbone.bidirectional else 1
    b3 = launches.pop(b3_key)
    if b3 != n_b * n_dir or any(launches.values()):
        fail(f"an eval pass of {n_b} batches launched {b3_key} {b3} times and {launches}")
    launches[b3_key] = b3
    hold_eval_result(res, res_ref, moved, fused, T, "the plain recurrence", loss_tol)
    for _ in range(2):
        t0 = time.perf_counter()
        again = fused.evaluate(params, buf, EVAL_BATCH)
        pass_ms.append((time.perf_counter() - t0) * 1e3)
        if not same_result(res, again):
            fail(f"two fused eval passes differ: {res} and {again}")
    if dense is not None:
        hold_eval_result(dense.evaluate(params, buf, EVAL_BATCH), res, moved_d, dense, T,
                         "the fused arm")
    if not res.hr[-1] > 0.3:
        fail(f"HR@{m.topk_hr_ndcg[-1]} {res.hr[-1]} with half the labels in the top 20")

    # -- one batch at a time, each to a synchronize
    accum, batch_ms = fused.init_accum(), []
    for b in eval_batches(buf, EVAL_BATCH):
        t0 = time.perf_counter()
        accum = fused.update(params, accum, b.state, b.action, b.true_len, b.valid)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(pass_ms))
    if bf16:
        family = f"{family} bf16"
        print(f"[eval] {family}: valid rows whose bf16 head input differs from the plain "
              f"recurrence's {differ}; score slack max per batch "
              f"{[round(x.max().item(), 7) for x in slacks]}; loss held to {loss_tol:.3g}")
    print(f"[eval] {family} A={A} E={E} H={H} T={T}: {EVAL_ROWS} rows in {n_b} batches of "
          f"{EVAL_BATCH}; loss {res.loss:.6f} HR {res.hr.tolist()} NDCG {res.ndcg.tolist()} "
          f"R {res.reps.tolist()} coverage {res.coverage} div {res.div_rew:.6f} nov "
          f"{res.nov_rew:.6f} (about half the labels drawn from the top 20, so HR is not "
          f"a model's); valid rows near a tie, and whose label rank or top-k set moved, "
          f"against the plain recurrence {moved}"
          + ("" if moved_d is None else f", dense against fused {moved_d}")
          + f"; launches {launches}")
    print(f"[eval] {family}: ms per pass {[round(t, 3) for t in pass_ms]}, median {ms:.3f} = "
          f"{EVAL_ROWS / ms * 1e3:.0f} sessions/s; ms per batch to a synchronize median "
          f"{float(np.median(batch_ms)):.3f} (min {min(batch_ms):.3f}, max "
          f"{max(batch_ms):.3f}); {smi}")
    if profile:
        profile_eval(fused, params, next(eval_batches(buf, EVAL_BATCH)))
    return launches


def profile_eval(proto, params, batch):
    """One eval batch's device time by kernel, its idle share and the
    radix ``topk`` kernels' share of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def update():
        proto.update(params, proto.init_accum(), batch.state, batch.action, batch.true_len,
                     batch.valid)
        torch.cuda.synchronize()

    update()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        update()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in events)
    topk_us = sum(e.self_device_time_total for e in events
                  if "topk" in e.key.lower() or "radix" in e.key.lower())
    print(f"[profile] eval batch of {len(batch.valid)}: wall {wall_us:.1f} us, device busy "
          f"{busy_us:.1f} us ({busy_us / wall_us:.4f}), idle share {1 - busy_us / wall_us:.4f}, "
          f"{sum(e.count for e in events)} kernel launches; radix topk {topk_us:.1f} us "
          f"({topk_us / busy_us:.4f} of busy)")
    for e in events[:12]:
        print(f"[profile]   {e.self_device_time_total:10.1f} us  x{e.count:<4d} {e.key[:90]}")


# The trainer phase's experiment: the RetailRocket width (catalog 70852,
# E = H = 64, state_len 10, batch 256, val_batch_size 2000, fused CE in
# "high"), with about 64 train batches of 256 an epoch and about 4000 val
# and 4000 test rows, windowed from synthetic sessions (data/synthetic.py,
# mean length 8) split by session (data/split.py).
TRAINER_A, TRAINER_T, TRAINER_B = 70852, 10, 256
TRAINER_SESSIONS, TRAINER_SPLIT = 3050, (0.67, 0.165, 0.165)


def trainer_experiment(out_dir):
    """Writes train/val/test ``.npz`` buffers, an unpopular-items JSON and
    an ``experiment.yaml`` (gru4rec, 2 epochs, eval at 0.5 and 1, a
    checkpoint dir, the embedding exported) under ``out_dir``; returns the
    YAML's path."""
    import os

    from ikea_recommender_tpu_torch.data.item_frequency import save_unpopular_items
    from ikea_recommender_tpu_torch.data.preprocessing import window_sessions
    from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer, ReplayBuffer
    from ikea_recommender_tpu_torch.data.split import train_test_split_ids
    from ikea_recommender_tpu_torch.data.synthetic import synthetic_sessions

    A, T = TRAINER_A, TRAINER_T
    items, sids = synthetic_sessions(TRAINER_SESSIONS, A, mean_len=8, seed=7)
    masks = train_test_split_ids(sids, ratio=TRAINER_SPLIT, seed=118)
    for name, mask in zip(("train", "val", "test"), masks):
        win = window_sessions(items[mask], sids[mask], T, pad_id=A, pad_pos="end")
        buf = ReplayBuffer(state=win.state, action=win.action,
                           reward=np.ones(len(win), np.float32), next_state=win.next_state,
                           true_len=win.true_state_len, true_next_len=win.true_next_state_len,
                           is_end=win.is_end)
        out = buf if name == "train" else EvalBuffer.from_replay_buffer(buf)
        out.save_npz(os.path.join(out_dir, f"{name}.npz"))
    save_unpopular_items(items, os.path.join(out_dir, "unpopular.json"), 0.9)
    path = os.path.join(out_dir, "experiment.yaml")
    with open(path, "w") as fh:
        fh.write(f"""exp_name: "trainer-smoke"
experiment:
  seed: 118
  save_pretrained_embeddings: true
data:
  train_path: "{out_dir}/train.npz"
  val_path: "{out_dir}/val.npz"
  test_path: "{out_dir}/test.npz"
  num_items: {A}
train:
  model: "gru4rec"
  batch_size: {TRAINER_B}
  val_batch_size: {EVAL_BATCH}
  epochs: 2
  learning_rate: 0.01
  embedding_size: 64
  hidden_state_size: 64
  state_size: {T}
  fused_ce: true
  head_precision: "high"
  best_model_metric: "Val_NDCG@10"
  eval_at: [0.5, 1]
  checkpoint_dir: "{out_dir}/ckpt"
metrics:
  unpopular_actions_path: "{out_dir}/unpopular.json"
  topk_cov: [1, 5, 10, 20]
  topk_hr_ndcg: [10, 20]
""")
    return path


def trainer_launches(family, outcome, n_steps, n_val, n_test, train_metrics=True, dense=False,
                     layers=1):
    """The counters a run must show: PER_STEP per train step, and B3 once
    per eval batch, layer and direction: each train-metrics batch, the val
    passes (the warm-up and every eval point, each net) and the test pass.
    PER_STEP's B3 and B4 are one layer's: ``layers`` GRU layers run them
    ``layers`` times. ``dense``: the head's dense arm (a catalog under
    ``FUSED_CE_MIN_ACTIONS``), which launches no B1, B2, B5 or B6."""
    nets = 2 if family.split()[0] in ("sqn", "smorl") else 1
    dirs = 2 if family.split()[0] == "bidir_gru4rec" else 1
    eval_batches = (n_steps if train_metrics else 0) + n_test
    eval_batches += (1 + nets * len(outcome.logs)) * n_val
    want = {}
    for name in counters():
        per = PER_STEP[family].get(name, 0)
        if name.startswith(("B3", "B4")):
            per *= layers
        elif dense:
            per = 0
        want[name] = per * n_steps
    want["B3 gru_fwd bf16" if family.endswith("bf16") else "B3 gru_fwd"] += (
        eval_batches * layers * dirs)
    return want


def trainer_line(what, outcome, smi, launches):
    t = outcome.timing
    total = sum(t.values())
    print(f"[trainer] {what}: {outcome.throughput_sessions_per_sec:.0f} sessions/s of the train "
          f"loop; timing s {json.dumps({k: round(v, 4) for k, v in t.items()})}, shares "
          f"{json.dumps({k: round(v / total, 4) for k, v in t.items()})}; best "
          f"{outcome.best_metric:.6f} @ eval point {outcome.best_epoch}; launches "
          f"{json.dumps(launches)}; {smi}")


def check_logs(what, outcome):
    for d in [outcome.pretrain_metrics, *outcome.logs, outcome.test_metrics]:
        bad = {k: v for k, v in d.items() if not np.isfinite(v)}
        if bad:
            fail(f"trainer {what}: non-finite logged values {bad}")


def profile_trainer(trace_dir):
    """The device's busy time and idle share over the trainer's first span,
    from the chrome trace its ``profile_dir`` wrote."""
    import glob

    (path,) = glob.glob(f"{trace_dir}/*.json")
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        fail(f"the trainer's trace {path} holds no kernel")
    t0 = min(e["ts"] for e in events)
    wall = max(e["ts"] + e["dur"] for e in events) - t0
    busy = sum(e["dur"] for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    print(f"[profile] trainer, gru4rec's first span (train metrics on): wall {wall:.1f} us, "
          f"device busy {busy:.1f} us ({busy / wall:.4f}), idle share {1 - busy / wall:.4f}, "
          f"{len(kernels)} kernel launches")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile]   {us:10.1f} us  {name[:90]}")


def serve_trained(yaml_path, val_buf, what, heads=(), n_rows=512, k=10, b3="B3 gru_fwd"):
    """A trainer's ``best_model.npz`` (its YAML's directory) answers
    ``n_rows`` val sessions in one batch through ``run.recommend.main``,
    scored by the config's head; top-1 must be the argmax of that head's
    full masked scores, and of each of ``heads`` through ``Recommender``
    as well. Returns the CLI's launches, which must be ``b3`` once."""
    import os

    from ikea_recommender_tpu_torch.core.config import load_experiment_config
    from ikea_recommender_tpu_torch.models.families import model_config_from_train
    from ikea_recommender_tpu_torch.run import recommend
    from ikea_recommender_tpu_torch.run.checkpoints import load_params_npz
    from ikea_recommender_tpu_torch.run.serve import Recommender

    cfg = load_experiment_config(yaml_path)
    exp = cfg.exp_dir
    rows = [{"state": val_buf.state[i, : val_buf.true_len[i]].tolist(), "id": i}
            for i in range(n_rows)]
    with open(os.path.join(exp, "sessions.jsonl"), "w") as fh:
        fh.writelines(json.dumps(r) + "\n" for r in rows)
    torch.cuda.synchronize()
    reset_counters()
    recommend.main(["-f", yaml_path, "--input", os.path.join(exp, "sessions.jsonl"),
                    "--output", os.path.join(exp, "recs.jsonl"), "--k", str(k)])
    launches = counters()
    if launches != {name: int(name == b3) for name in launches}:
        fail(f"one served batch of {n_rows} launched {launches}")
    with open(os.path.join(exp, "recs.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    if len(records) != n_rows or any(len(r["predictions"]) != k for r in records):
        fail(f"the {what} model's recommendations have the wrong number of rows or ids")
    mc = model_config_from_train(cfg.train, cfg.data)
    params = load_params_npz(os.path.join(exp, "best_model.npz"), device="cuda")
    states, lens = (torch.as_tensor(a, device="cuda") for a in recommend.pad_batch(
        rows, cfg.train.state_size, cfg.padding_id, cfg.train.padding_position))
    top1 = {cfg.train.head_idx: torch.tensor([r["predictions"][0] for r in records],
                                             device="cuda")}
    for head in heads:
        rec = Recommender(params, mc, head_idx=head, device="cuda")
        top1[head] = rec.recommend(states, lens, k=1)[1][:, 0]
    for head, ids in top1.items():
        # top-1 is the argmax, up to products summed in another order
        scores = Recommender(params, mc, head_idx=head, device="cuda").scores(states, lens)
        gap = (scores.max(dim=1).values - scores.gather(1, ids[:, None])[:, 0]).max().item()
        if not (torch.isfinite(scores).all() and gap <= GAP):
            fail(f"the {what} model's top-1 is not the argmax of head {head}'s scores ({gap:.3g})")
    print(f"[trainer] {what} serving: best_model.npz ({len(params)} top-level keys: "
          f"{sorted(params)}) answered {n_rows} val sessions in one batch through "
          f"run/recommend.py (head {cfg.train.head_idx}; launches {json.dumps(launches)}); top-1 "
          f"is the argmax of heads {sorted(top1)}' full masked scores")
    return launches


def phase_trainer(smi, profile=False):
    """The trainer (run/trainer.py) at the RetailRocket width: gru4rec for 2
    epochs through the CLI, sqn, smorl and sarm for 1 epoch through
    ``train`` (sarm's best model then served), sqn again for determinism
    and resume, gru4rec with train metrics off
    (and with ``profile``, one epoch traced over its first span). Returns
    each checked run's launches."""
    import contextlib
    import io
    import os
    import tempfile

    from ikea_recommender_tpu_torch.core.config import load_experiment_config
    from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer, ReplayBuffer, num_batches
    from ikea_recommender_tpu_torch.run import cli, trainer

    paths = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
        t0 = time.perf_counter()
        yaml_path = trainer_experiment(tmp)
        bufs = dict(train_buf=ReplayBuffer(os.path.join(tmp, "train.npz")),
                    val_buf=EvalBuffer(os.path.join(tmp, "val.npz")),
                    test_buf=EvalBuffer(os.path.join(tmp, "test.npz")))
        n_b = num_batches(len(bufs["train_buf"]), TRAINER_B)
        n_val = num_batches(len(bufs["val_buf"]), EVAL_BATCH)
        n_test = num_batches(len(bufs["test_buf"]), EVAL_BATCH)
        print(f"[trainer] experiment: {len(bufs['train_buf'])} train rows ({n_b} batches of "
              f"{TRAINER_B}), {len(bufs['val_buf'])} val, {len(bufs['test_buf'])} test rows, "
              f"catalog {TRAINER_A}; built in {time.perf_counter() - t0:.2f} s")

        # -- gru4rec through the CLI, as a user runs it
        outcomes, logged = [], []
        train = cli.train
        cli.train = lambda *a, **k: outcomes.append(train(*a, **k)) or outcomes[-1]
        sinks = cli.make_log_sinks
        cli.make_log_sinks = lambda cfg: (lambda d, step: logged.append(d), lambda: None)
        out = io.StringIO()
        try:
            torch.cuda.synchronize()
            reset_counters()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["-f", yaml_path, "--progress"])
            launches = counters()
        finally:
            cli.train, cli.make_log_sinks = train, sinks
        for line in out.getvalue().splitlines():
            print(f"[trainer] cli: {line}")
        if rc != 0:
            fail(f"the trainer CLI exited {rc}")
        gru = outcomes[0]
        printed = out.getvalue()
        if json.loads(printed[printed.index("{"): printed.rindex("\nbest ")]) != json.loads(
                open(os.path.join(tmp, "test_metrics.json")).read()):
            fail("the CLI's printed test metrics differ from test_metrics.json")
        for name in ("best_model.npz", "best_model.json", "embedding_weights.npy",
                     "ckpt/ckpt_2.pt"):
            if not os.path.exists(os.path.join(tmp, name)):
                fail(f"the trainer CLI wrote no {name}")
        emb = np.load(os.path.join(tmp, "embedding_weights.npy"))
        if emb.shape != (TRAINER_A + 1, 64) or not np.isfinite(emb).all():
            fail(f"embedding_weights.npy has shape {emb.shape} or non-finite entries")
        check_logs("gru4rec", gru)
        if len(logged) != 2 + len(gru.logs) or len(gru.logs) != 4:
            fail(f"the CLI logged {len(logged)} dicts for {len(gru.logs)} eval points")
        first = [d["Supervised Train Loss"] for d in gru.logs[::2]]
        if not first[1] < first[0]:
            fail(f"epoch 2's first-window train loss {first[1]} is not below epoch 1's {first[0]}")
        want = trainer_launches("gru4rec", gru, 2 * n_b, n_val, n_test)
        if launches != want:
            fail(f"the gru4rec trainer launched {launches}, expected {want}")
        paths["trainer_gru4rec"] = launches
        trainer_line(f"gru4rec 2 epochs via the CLI, first-window train loss {first}", gru, smi,
                     launches)

        # -- sqn and smorl through train(cfg, buffers), 1 epoch. These runs
        # take one eval point an epoch: no check reads a point within an
        # epoch, and each point that improves writes a compressed best
        # model (~3.4 s at this catalog)
        def run(family, epochs, sub, yaml=yaml_path, **train_kw):
            cfg = load_experiment_config(yaml)
            cfg.exp_dir = os.path.join(tmp, sub)
            cfg.train.model, cfg.train.epochs, cfg.train.checkpoint_dir = family, epochs, None
            cfg.train.eval_at = [1.0]
            cfg.experiment.save_pretrained_embeddings = False
            for k, v in train_kw.items():
                setattr(cfg.train if k != "train_metrics" else cfg.metrics, k, v)
            extra = {}
            if family == "smorl":
                rs = np.random.RandomState(3)
                extra["div_embedding"] = rs.randn(TRAINER_A + 1, 64).astype(np.float32)
            return trainer.train(cfg, **bufs, **extra)

        for family in ("sqn", "smorl"):
            torch.cuda.synchronize()
            reset_counters()
            kw = dict(checkpoint_dir=os.path.join(tmp, "ckpt_sqn")) if family == "sqn" else {}
            res = run(family, 1, family, **kw)
            launches = counters()
            check_logs(family, res)
            if not all({"Sec_Val_NDCG@10", "Sec_Val_HR@10"} <= set(d) for d in res.logs):
                fail(f"{family}: the second net's Sec_ metrics are missing")
            want = trainer_launches(family, res, n_b, n_val, n_test)
            if launches != want:
                fail(f"the {family} trainer launched {launches}, expected {want}")
            paths[f"trainer_{family}"] = launches
            trainer_line(f"{family} 1 epoch via train()", res, smi, launches)
            if family == "sqn":
                sqn_leg1 = res

        # -- sarm through train(cfg, buffers), 1 epoch, from its own YAML;
        # its best model then answers a batch of 512 through run/recommend.py
        os.makedirs(os.path.join(tmp, "sarm"))
        sarm_yaml = os.path.join(tmp, "sarm", "experiment.yaml")
        with open(yaml_path) as src, open(sarm_yaml, "w") as dst:
            dst.write(src.read().replace('model: "gru4rec"', 'model: "sarm"'))
        torch.cuda.synchronize()
        reset_counters()
        res = run("sarm", 1, "sarm")
        launches = counters()
        check_logs("sarm", res)
        if any(k.startswith("Sec_") for d in res.logs for k in d):
            fail("sarm trains one net, but its logs hold Sec_ metrics")
        want = trainer_launches("sarm", res, n_b, n_val, n_test)
        if launches != want:
            fail(f"the sarm trainer launched {launches}, expected {want}")
        for name in ("best_model.npz", "best_model.json", "test_metrics.json"):
            if not os.path.exists(os.path.join(tmp, "sarm", name)):
                fail(f"the sarm trainer wrote no {name}")
        paths["trainer_sarm"] = launches
        trainer_line("sarm 1 epoch via train()", res, smi, launches)
        paths["trainer_sarm_serving"] = serve_trained(sarm_yaml, bufs["val_buf"], "sarm",
                                                      heads=(3,))

        # -- determinism and resume (sqn): a 2-epoch run's first epoch is
        # the 1-epoch run's bit for bit; its second, the resumed run's
        full = run("sqn", 2, "sqn_full")
        first = len(sqn_leg1.logs)  # epoch 1's eval points
        if full.logs[:first] != sqn_leg1.logs:
            moved = {k: (a[k], b[k]) for a, b in zip(sqn_leg1.logs, full.logs) for k in a
                     if a[k] != b.get(k)}
            fail(f"two identical sqn runs differ: {moved}")
        resumed = run("sqn", 2, "sqn_resumed", checkpoint_dir=os.path.join(tmp, "ckpt_sqn"),
                      resume=True)
        same = (resumed.logs == full.logs[first:] and resumed.test_metrics == full.test_metrics
                and (resumed.best_metric, resumed.best_epoch) == (full.best_metric,
                                                                  full.best_epoch))
        if not same:
            moved = {k: (a[k], b[k]) for a, b in zip(resumed.logs + [resumed.test_metrics],
                                                    full.logs[first:] + [full.test_metrics])
                     for k in b if a.get(k) != b[k]}
            fail(f"a resumed sqn run differs from the uninterrupted one: {moved}; best "
                 f"{resumed.best_metric} @ {resumed.best_epoch} against {full.best_metric} @ "
                 f"{full.best_epoch}")
        print(f"[trainer] sqn: a second run's epoch 1 and a resumed run's epoch 2 are "
              f"bit-identical to the uninterrupted run's (best {full.best_metric:.6f} @ "
              f"{full.best_epoch}, test {json.dumps(full.test_metrics)})")

        # -- the same gru4rec epoch with train metrics off
        off = run("gru4rec", 1, "gru4rec_off", train_metrics=False)
        check_logs("gru4rec, train metrics off", off)
        trainer_line("gru4rec 1 epoch, train_metrics off", off, smi, {})
        print(f"[trainer] train metrics cost: gru4rec {gru.throughput_sessions_per_sec:.0f} "
              f"sessions/s on (2 epochs) against {off.throughput_sessions_per_sec:.0f} off "
              f"(1 epoch); {smi}")
        paths.update(trainer_fast(tmp, yaml_path, run, bufs, n_b, n_val, n_test, smi))
        paths.update(trainer_jsonl(tmp, yaml_path, bufs, n_b, n_val, n_test, smi))
        if profile:
            run("gru4rec", 1, "gru4rec_profiled", profile_dir=os.path.join(tmp, "trace"))
            profile_trainer(os.path.join(tmp, "trace"))
    print(f"[trainer] phase: {time.perf_counter() - t_phase:.1f} s")
    return paths


def trainer_fast(tmp, yaml_path, run, bufs, n_b, n_val, n_test, smi):
    """sqn, smorl and sarm for 1 epoch each from YAMLs that set ``preset:
    fast`` (bf16 moments, lazy action-major Q heads, "default"): finite
    logs, ``PER_STEP`` launches of the fast paths, ``best_model.npz`` in the
    lazy layout; sqn twice and resumed bit for bit, and its best model
    served through run/recommend.py. Returns each checked run's
    launches."""
    import os

    from ikea_recommender_tpu_torch.core.config import load_experiment_config

    paths, yamls = {}, {}
    for family in ("sqn", "smorl", "sarm"):
        sub = f"{family}_fast"
        os.makedirs(os.path.join(tmp, sub))
        yamls[family] = os.path.join(tmp, sub, "experiment.yaml")
        with open(yaml_path) as src, open(yamls[family], "w") as dst:
            dst.write(src.read().replace('model: "gru4rec"', f'model: "{family}"').replace(
                "  fused_ce: true\n", '  fused_ce: true\n  preset: "fast"\n'))
        t_cfg = load_experiment_config(yamls[family]).train
        if (t_cfg.head_precision, t_cfg.optimizer_mv_dtype, t_cfg.qhead_optimizer) != (
                "default", "bfloat16", "lazy_adam"):
            fail(f"the fast YAML resolves to {t_cfg.head_precision}, {t_cfg.optimizer_mv_dtype}, "
                 f"{t_cfg.qhead_optimizer}")
        torch.cuda.synchronize()
        reset_counters()
        kw = dict(checkpoint_dir=os.path.join(tmp, "ckpt_sqn_fast")) if family == "sqn" else {}
        res = run(family, 1, sub, yaml=yamls[family], **kw)
        launches = counters()
        check_logs(f"{family} fast", res)
        want = trainer_launches(f"{family} fast", res, n_b, n_val, n_test)
        if launches != want:
            fail(f"the {family} fast trainer launched {launches}, expected {want}")
        head = "q_head" if family == "sqn" else "q_heads"
        with np.load(os.path.join(tmp, sub, "best_model.npz")) as saved:
            if f"{head}/kernel_am" not in saved.files or f"{head}/kernel" in saved.files:
                fail(f"the {family} fast best_model.npz is not in the lazy layout: {saved.files}")
        paths[f"trainer_{family}_fast"] = launches
        trainer_line(f"{family} fast 1 epoch via train()", res, smi, launches)
        if family == "sqn":
            leg1 = res

    full = run("sqn", 2, "sqn_fast_full", yaml=yamls["sqn"])
    if full.logs[:len(leg1.logs)] != leg1.logs:
        fail("two identical fast sqn runs differ")
    resumed = run("sqn", 2, "sqn_fast_resumed", yaml=yamls["sqn"],
                  checkpoint_dir=os.path.join(tmp, "ckpt_sqn_fast"), resume=True)
    if not (resumed.logs == full.logs[len(leg1.logs):] and resumed.test_metrics == full.test_metrics
            and (resumed.best_metric, resumed.best_epoch) == (full.best_metric, full.best_epoch)):
        fail(f"a resumed fast sqn run differs from the uninterrupted one: best "
             f"{resumed.best_metric} @ {resumed.best_epoch} against {full.best_metric} @ "
             f"{full.best_epoch}")
    print(f"[trainer] sqn fast: a second run's epoch 1 and a resumed run's epoch 2 are "
          f"bit-identical to the uninterrupted run's (best {full.best_metric:.6f} @ "
          f"{full.best_epoch})")
    paths["trainer_sqn_fast_serving"] = serve_trained(yamls["sqn"], bufs["val_buf"], "sqn fast")
    return paths


def write_jsonl(path, buf):
    """A train or eval buffer as JSON lines, written with the json module
    (no pandas): the columns the buffer files carry."""
    train = hasattr(buf, "next_state")
    with open(path, "w") as fh:
        for r in range(len(buf)):
            row = {"state": buf.state[r].tolist(), "action": int(buf.action[r])}
            if train:
                row.update(r_act=float(buf.reward[r]), next_state=buf.next_state[r].tolist())
            row["true_state_len"] = int(buf.true_len[r])
            if train:
                row.update(true_next_state_len=int(buf.true_next_len[r]),
                           is_end=bool(buf.is_end[r]))
            fh.write(json.dumps(row) + "\n")


def trainer_jsonl(tmp, yaml_path, bufs, n_b, n_val, n_test, smi):
    """The trainer phase's buffers as JSON lines, read back through the
    port's native parser (data/native.py; the counter must show all three
    files, the arrays equal those written), then gru4rec with
    ``compute_dtype: bfloat16`` for 1 epoch from a YAML naming those files:
    finite logs, launches ``PER_STEP["gru4rec bf16"]`` per step plus bf16
    B3 per eval batch, and its best model served. Returns the runs'
    launches."""
    import os

    from ikea_recommender_tpu_torch.core.config import load_experiment_config
    from ikea_recommender_tpu_torch.data import native
    from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer, ReplayBuffer
    from ikea_recommender_tpu_torch.run import trainer

    sub = os.path.join(tmp, "gru4rec_bf16_jsonl")
    os.makedirs(sub)
    t0 = time.perf_counter()
    files = {}
    for name, buf in bufs.items():
        files[name] = os.path.join(sub, name.replace("_buf", ".jsonl"))
        write_jsonl(files[name], buf)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not native.available():  # built here with the host compiler, on first use
        fail("the native JSON-lines parser did not build")
    t_build = time.perf_counter() - t0
    native.NATIVE_PARSES = 0
    t0 = time.perf_counter()
    parsed = {"train_buf": ReplayBuffer(files["train_buf"]),
              "val_buf": EvalBuffer(files["val_buf"]), "test_buf": EvalBuffer(files["test_buf"])}
    t_parse = time.perf_counter() - t0
    if native.NATIVE_PARSES != 3:
        fail(f"the JSON-lines buffers took the native parser {native.NATIVE_PARSES} times of 3")
    for name, buf in bufs.items():
        cols = ("state", "action", "true_len") + (("reward", "next_state", "true_next_len",
                                                   "is_end") if name == "train_buf" else ())
        for col in cols:
            a, b = getattr(parsed[name], col), getattr(buf, col)
            if not (np.array_equal(a, b) and a.dtype == b.dtype):
                fail(f"the native parser read {name}.{col} back other than it was written")
    print(f"[trainer] JSON lines: {sum(len(b) for b in bufs.values())} rows written with the "
          f"json module in {t_write:.2f} s, the native parser built in {t_build:.2f} s, the "
          f"files parsed back by it ({native.NATIVE_PARSES}) in {t_parse:.3f} s, every column "
          f"equal")

    yaml_bf16 = os.path.join(sub, "experiment.yaml")
    with open(yaml_path) as src, open(yaml_bf16, "w") as dst:
        text = src.read().replace("  fused_ce: true\n",
                                  '  fused_ce: true\n  compute_dtype: "bfloat16"\n')
        for name, path in files.items():
            key = name.replace("_buf", "_path")
            text = text.replace(f'{key}: "{tmp}/{name.replace("_buf", ".npz")}"',
                                f'{key}: "{path}"')
        dst.write(text.replace("  epochs: 2\n", "  epochs: 1\n").replace(
            "  eval_at: [0.5, 1]\n", "  eval_at: [1]\n").replace(
            f'  checkpoint_dir: "{tmp}/ckpt"\n', ""))
    cfg = load_experiment_config(yaml_bf16)
    cfg.exp_dir = sub
    if (cfg.train.compute_dtype, cfg.train.epochs, cfg.train.eval_at, cfg.data.train_path) != (
            "bfloat16", 1, [1], files["train_buf"]):
        fail(f"the JSON-lines YAML resolves to {cfg.train.compute_dtype}, {cfg.train.epochs} "
             f"epochs, eval at {cfg.train.eval_at}, {cfg.data.train_path}")
    native.NATIVE_PARSES = 0
    torch.cuda.synchronize()
    reset_counters()
    res = trainer.train(cfg)  # the buffers from the YAML's paths
    launches = counters()
    if native.NATIVE_PARSES != 3:
        fail(f"the trainer read its JSON-lines buffers natively {native.NATIVE_PARSES} times of 3")
    check_logs("gru4rec bf16 from JSON lines", res)
    want = trainer_launches("gru4rec bf16", res, n_b, n_val, n_test)
    if launches != want:
        fail(f"the gru4rec bf16 trainer launched {launches}, expected {want}")
    with np.load(os.path.join(sub, "best_model.npz")) as saved:
        dtypes = {saved[k].dtype for k in saved.files}
    if dtypes != {np.dtype(np.float32)}:
        fail(f"the bf16 run's best_model.npz holds {dtypes}, not float32 params")
    trainer_line("gru4rec bf16 1 epoch from JSON lines via train()", res, smi, launches)
    return {"trainer_gru4rec_bf16_jsonl": launches,
            "trainer_gru4rec_bf16_serving": serve_trained(
                yaml_bf16, bufs["val_buf"], "gru4rec bf16", b3="B3 gru_fwd bf16")}


# -- 11. the mesh: (data, model) ranks sharing the card ------------------------

# The mesh phase's width: RetailRocket's (bench.py:57-139), bidir_gru4rec at
# BidirGRU-128's (H 128, lr 0.0005, dropout 0.35); "high", fp32 Adam. The
# model is built with align = 2 (the model axis of both meshes): 70853
# embedding rows pad to 70854, the 70852 actions need none.
MESH_DEVICE = "cuda"
MESH_A, MESH_B, MESH_T, MESH_CHECK, MESH_TIMED = 70852, 256, 10, 3, 10
MESH_COINS = (0, 1, 1)
MESH_POINTS = {"gru4rec": dict(H=64, lr=0.01, dropout=0.0),
               "bidir_gru4rec": dict(H=128, lr=0.0005, dropout=0.35),
               "sqn": dict(H=64, lr=0.01, dropout=0.0), "smorl": dict(H=64, lr=0.01, dropout=0.0),
               "sarm": dict(H=64, lr=0.01, dropout=0.0)}
# (spec, the families trained on it); each rank of a spec runs them in order
MESH_RUNS = {(1, 2): ("gru4rec", "bidir_gru4rec", "sqn", "smorl", "sarm"),
             (2, 2): ("gru4rec", "smorl")}
MESH_FLOOR = 0.1  # least share of the moved param entries whose gradients are clear
# A rank's collectives give up after MESH_PG_TIMEOUT_S; a rank still
# running after MESH_TIMEOUT_S prints its threads' stacks and exits; the
# parent waits MESH_TIMEOUT_S + 60 s for each rank's result.
MESH_PG_TIMEOUT_S, MESH_TIMEOUT_S = 120, 540


def mesh_config(family):
    from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
    from ikea_recommender_tpu_torch.models.families import model_config_from_train

    pt = MESH_POINTS[family]
    tc = TrainConfig(model=family, batch_size=MESH_B, embedding_size=64,
                     hidden_state_size=pt["H"], state_size=MESH_T, learning_rate=pt["lr"],
                     dropout=pt["dropout"], fused_ce=True, head_precision="high")
    mc = model_config_from_train(tc, DataConfig(num_items=MESH_A), align=2)
    if not (mc.fused_ce and mc.padded_action_dim % 4 == 0):
        fail(f"mesh {family}: the fused CE and an action dim both meshes divide")
    return mc


def mesh_inputs(family, mc):
    """Seeded (numpy params or pair, smorl's aux, batches): the checked
    batches, the last with a padded tail of 56 rows (all on the second
    data rank of (2, 2)), then a warm-up and the timed ones."""
    from ikea_recommender_tpu_torch.convert import numpy_init_double_q, numpy_init_params

    double_q = family in ("sqn", "smorl")
    params = numpy_init_double_q(mc, (0, 1)) if double_q else numpy_init_params(mc, seed=0)
    rs = np.random.RandomState(5)
    aux = {}
    if family == "smorl":
        aux = {"div_embedding": rs.randn(MESH_A + 1, 64).astype(np.float32),
               "unpopular_mask": np.arange(MESH_A) % 10 == 0}
    batches = [bench_batch(rs, MESH_B, MESH_A, MESH_T)
               for _ in range(MESH_CHECK + 1 + MESH_TIMED)]
    batches[MESH_CHECK - 1]["valid"][200:] = False
    return params, aux, batches


def mesh_run(family, mesh=None, timed=False):
    """The family's steps on this rank of ``mesh`` (None: one process on the
    card): first-step gradients, MESH_CHECK steps (double-Q: coins
    MESH_COINS), each step's losses and first moments and the last params,
    gathered; with ``timed``, a warm-up and MESH_TIMED steps whose launches
    and collectives are counted from 0 and each timed to a synchronize."""
    from ikea_recommender_tpu_torch.convert import params_from_numpy
    from ikea_recommender_tpu_torch.core.distributed import local_rows
    from ikea_recommender_tpu_torch.parallel.sharding import gather_tree, shard_state
    from ikea_recommender_tpu_torch.train.state import make_double_q_state, make_train_state
    from ikea_recommender_tpu_torch.train.steps import (
        RLStepConfig,
        double_q_loss_and_grads,
        loss_and_grads,
        make_train_step,
        sarm_loss_and_grads,
    )

    mc = mesh_config(family)
    np_params, aux, batches = mesh_inputs(family, mc)
    lr, dev = MESH_POINTS[family]["lr"], MESH_DEVICE
    double_q = family in ("sqn", "smorl")
    if double_q:
        state, opt = make_double_q_state([params_from_numpy(p, dev) for p in np_params], mc,
                                         lr, device=dev)
        full = list(np_params)
    else:
        state, opt = make_train_state(params_from_numpy(np_params, dev), mc, lr, device=dev)
        full = [np_params]
    kw = {}
    if mesh is not None:
        state = shard_state(state, mesh)
        kw = dict(mesh=mesh, data_axis="data")
        batches = [local_rows(b, mesh) for b in batches]
    step = make_train_step(mc, opt, RLStepConfig(), device=dev, **kw, **aux)
    rl = RLStepConfig()

    def on(b):
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    def gathered(tree, like):
        if mesh is not None:
            tree = gather_tree(tree, mesh, like)
        return {k: v for k, v in named_leaves(tree).items()}

    nets = lambda s: list(s.params) if double_q else [s.params]  # noqa: E731
    moments = lambda s: [o.mu for o in s.opt_state] if double_q else [s.opt_state.mu]  # noqa
    if double_q:
        grads = double_q_loss_and_grads(state.params, on(batches[0]), mc, rl, MESH_COINS[0],
                                        step.aux, **kw)[1]
    elif family == "sarm":
        grads = sarm_loss_and_grads(state.params, on(batches[0]), mc, rl, **kw)[1]
    else:
        grads = loss_and_grads(state.params, on(batches[0]), mc, state.generator, **kw)[1]
    out = {"grads": gathered(grads, full[MESH_COINS[0] if double_q else 0]), "losses": [],
           "mu": [[gathered(m, f) for m, f in zip(moments(state), full)]]}
    for k, b in enumerate(batches[:MESH_CHECK]):
        state, m = step(state, b, **({"coin": MESH_COINS[k]} if double_q else {}))
        out["losses"].append((m["sup_loss"].item(), m["q_loss"].item()))
        if mesh is None:  # each step's moments: the gradients mesh_hold reads
            out["mu"].append([gathered(mu, f) for mu, f in zip(moments(state), full)])
    if mesh is not None:  # a mesh sends only the last moments
        out["mu"] = [[gathered(mu, f) for mu, f in zip(moments(state), full)]]
    out["params"] = [gathered(p, f) for p, f in zip(nets(state), full)]
    if timed:
        state, _ = step(state, batches[MESH_CHECK])
        torch.cuda.synchronize()
        reset_counters()
        mesh.reset_counts()
        step_ms = []
        for b in batches[MESH_CHECK + 1:]:
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        out.update(step_ms=step_ms, launches=counters(), collectives=mesh.counts(),
                   last_loss=m["sup_loss"].item())
    if mesh is not None and mesh.rank != 0:  # rank 0 returns the gathered trees
        out = {k: v for k, v in out.items() if k not in ("grads", "mu", "params")}
    return out


def mesh_serving(mesh=None):
    """One batch of 512 seeded sessions of gru4rec through Recommender (on
    ``mesh``: this rank's slice) -> top-11 values and ids."""
    from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
    from ikea_recommender_tpu_torch.parallel.sharding import shard_tree
    from ikea_recommender_tpu_torch.run.serve import Recommender

    mc = mesh_config("gru4rec")
    np_params = numpy_init_params(mc, seed=0)
    rs = np.random.RandomState(6)
    states = rs.randint(0, MESH_A + 1, (512, MESH_T)).astype(np.int32)
    lens = rs.randint(1, MESH_T + 1, 512).astype(np.int32)
    if mesh is None:
        rec = Recommender(params_from_numpy(np_params, MESH_DEVICE), mc, device=MESH_DEVICE)
    else:
        rec = Recommender(shard_tree(np_params, mesh), mc, mesh=mesh, device=MESH_DEVICE)
    if not rec.fused:
        fail("mesh serving: the model-sharded head must take the fused scan")
    v, i = rec.recommend(states, lens, k=11)
    return v.cpu(), i.cpu()


def mesh_eval(actions=None, mesh=None):
    """gru4rec's EvalProtocol over EVAL_ROWS rows at EVAL_BATCH (on
    ``mesh``: this rank's slice) -> (per batch top-21 values, ids, CE,
    labels, valid on the host; the result; the protocol). ``actions``: the
    labels (default: the buffer's)."""
    from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
    from ikea_recommender_tpu_torch.core.config import MetricsConfig
    from ikea_recommender_tpu_torch.eval.protocol import EvalProtocol
    from ikea_recommender_tpu_torch.parallel.sharding import shard_tree

    mc = mesh_config("gru4rec")
    np_params = numpy_init_params(mc, seed=0)
    rs = np.random.RandomState(2)
    buf = eval_buffer(MESH_A, MESH_T, EVAL_ROWS, rs)
    if actions is not None:
        buf.action = actions
    m = MetricsConfig()
    proto = EvalProtocol(mc, topk_hr_ndcg=m.topk_hr_ndcg, topk_cov=m.topk_cov,
                         topk_div=m.topk_div, topk_nov=m.topk_nov, nov_rew_sig=m.nov_rew_sig,
                         div_embedding=rs.randn(MESH_A + 1, 64).astype(np.float32),
                         unpopular_mask=np.arange(MESH_A) % 10 == 0, mesh=mesh,
                         device=MESH_DEVICE)
    if mesh is None:
        params = params_from_numpy(np_params, MESH_DEVICE)
    else:
        params = shard_tree(np_params, mesh)
    scores = [tuple(x.cpu() for x in s) for s in eval_scores(proto, params, buf, 21)]
    return scores, proto.evaluate(params, buf, EVAL_BATCH), proto


def mesh_probe(mesh):
    """Which collectives the mesh's backend runs on tensors on its device:
    {name: "ok" or the error}."""
    import torch.distributed as dist

    group = mesh.groups["model"]
    x = torch.ones(4, device=MESH_DEVICE)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "all_reduce max": lambda: dist.all_reduce(x.clone(), dist.ReduceOp.MAX, group=group),
        "all_reduce min": lambda: dist.all_reduce(x.clone(), dist.ReduceOp.MIN, group=group),
        "broadcast": lambda: dist.broadcast(x.clone(), src=mesh.rank - mesh.index("model"),
                                            group=group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x,
                                              group=group),
        "reduce_scatter": lambda: dist.reduce_scatter(torch.empty(2, device=MESH_DEVICE),
                                                      list(x.split(2)), group=group),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "ok"
        except (RuntimeError, ValueError) as e:  # recorded, not used: the port reduces
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    torch.cuda.synchronize()
    return out


def host_tree(tree, fn):
    """``fn`` on every tensor (or array) of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: host_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_tree(v, fn) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def pack_arrays(tree, path):
    """``tree`` with each tensor saved to the ``.npy`` files of directory
    ``path`` and replaced by its file's name. A rank's results cross to the
    parent so: a pipe moves ~1.5 GB of gathered params too slowly to
    finish, and a tensor sent through one is shared by a handle that its
    rank takes with it when it exits."""
    os.makedirs(path, exist_ok=True)
    count = iter(range(1 << 30))

    def save(t):
        name = os.path.join(path, f"{next(count)}.npy")
        np.save(name, t.detach().cpu().numpy())
        return ("npy", name)

    return host_tree(tree, save)


def unpack_arrays(tree):
    """The inverse of :func:`pack_arrays`, as CPU tensors."""
    if isinstance(tree, tuple) and len(tree) == 2 and tree[0] == "npy":
        return torch.from_numpy(np.load(tree[1]))
    if isinstance(tree, dict):
        return {k: unpack_arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unpack_arrays(v) for v in tree)
    return tree


def mesh_log(msg):
    print(f"[mesh] {msg}", file=sys.stderr, flush=True)


def mesh_rank_main(rank, world, spec, backend, store, jobs, conn):
    """One rank of a mesh on the card: the jobs in order -> the parent."""
    import datetime
    import faulthandler
    import traceback

    import torch.distributed as dist

    faulthandler.dump_traceback_later(MESH_TIMEOUT_S, exit=True)
    t0 = time.perf_counter()
    try:
        if backend == "nccl":  # one host: its bootstrap on the loopback interface
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        from ikea_recommender_tpu_torch.core.mesh import MeshSpec, make_mesh

        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=MESH_PG_TIMEOUT_S))
        mesh = make_mesh(MeshSpec(*spec), backend, MESH_DEVICE)
        out = {}
        for job, arg in jobs:
            mesh_log(f"{spec} rank {rank}: {job} {arg if isinstance(arg, str) else ''} at "
                     f"{time.perf_counter() - t0:.1f} s")
            if job == "probe":
                out[job] = mesh_probe(mesh)
            elif job == "train":
                out[f"train {arg}"] = mesh_run(arg, mesh, timed=True)
            elif job == "serve":
                out[job] = mesh_serving(mesh)
            elif job == "eval":  # one data index: every rank scores whole batches
                scores, res, _ = mesh_eval(arg, mesh)
                out[job] = (scores, res) if rank == 0 else None
            elif job == "trainer":
                out[f"trainer {arg['name']}"] = mesh_trainer_job(mesh, arg)
            elif job == "scaling":
                out[job] = scaling_job(arg)
            elif job == "nccl":
                mesh.reset_counts()
                x = torch.ones(3, device=MESH_DEVICE)
                dist.all_reduce(x)  # the default group, over nccl
                out[job] = {"all_reduce": x.tolist(), "nccl": torch.cuda.nccl.version(),
                            "step": mesh_run("gru4rec", mesh, timed=True)}
        out["loaded"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "jaxlib", "ikea_recommender_tpu"))
        mesh_log(f"{spec} rank {rank}: done at {time.perf_counter() - t0:.1f} s")
        conn.send(("ok", pack_arrays(out, f"{store}.rank{rank}")))
        dist.destroy_process_group()
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise


def mesh_spawn(spec, backend, jobs):
    """Every rank of ``spec`` in its own process on the one card, over
    ``backend`` -> each rank's results; fails on any rank's error, stops
    every process either way."""
    import multiprocessing as mp
    import tempfile

    ctx = mp.get_context("spawn")
    world = spec[0] * spec[1]
    with tempfile.TemporaryDirectory() as tmp:
        store = f"{tmp}/store"
        procs, conns = [], []
        try:
            for rank in range(world):
                parent, child = ctx.Pipe()
                # daemonic: an exit never waits on a rank that will not end
                p = ctx.Process(target=mesh_rank_main, daemon=True,
                                args=(rank, world, spec, backend, store, jobs, child))
                p.start()
                procs.append(p)
                conns.append(parent)
            results = []
            for rank, conn in enumerate(conns):
                if not conn.poll(MESH_TIMEOUT_S + 60):
                    fail(f"mesh {spec} rank {rank} gave no result in {MESH_TIMEOUT_S + 60} s")
                status, value = conn.recv()
                if status != "ok":
                    fail(f"mesh {spec} rank {rank} failed:\n{value}")
                value = unpack_arrays(value)
                if value["loaded"]:
                    fail(f"mesh {spec} rank {rank} loaded {value['loaded'][:5]}")
                results.append(value)
            return results
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)


def mesh_shard_contract():
    """B1, B2, B5 and B6 launched on each column shard as rank r of n runs
    them (``local_valid``, labels shifted by the shard's offset: negative
    past their owner, at least the shard's width before it), merged by the
    port's functions, held to the same kernel on the whole head. Returns
    the cases' worst errors."""
    from ikea_recommender_tpu_torch.ops.fused_argmax import (
        fused_linear_argmax,
        fused_weighted_multihead_argmax,
        head_values_plain,
    )
    from ikea_recommender_tpu_torch.ops.fused_ce import fused_ce_bwd, fused_ce_fwd
    from ikea_recommender_tpu_torch.ops.fused_topk import order_keys
    from ikea_recommender_tpu_torch.parallel.fused_ce import ce_from_shards
    from ikea_recommender_tpu_torch.parallel.q_kernels import argmax_from_shards

    A, B, F, P = MESH_A, MESH_B, 64, "high"
    rs = np.random.RandomState(11)
    dev = MESH_DEVICE

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    h = t(rs.randn(B, F).astype(np.float32))
    w = t((rs.randn(F, A) * 0.125).astype(np.float32))
    b = t((rs.randn(A) * 0.05).astype(np.float32))
    wq = t((rs.randn(3, F, A) * 0.125).astype(np.float32))
    bq = t((rs.randn(3, A) * 0.05).astype(np.float32))
    qw = t(np.asarray([1.0, 0.5, 2.0], np.float32))
    ct = t(rs.rand(B).astype(np.float32))
    errs = {"lse": 0.0, "label": 0.0, "dh": 0.0, "dW": 0.0, "db": 0.0, "max": 0.0}
    # (n, valid): whole catalogs of 2 and 4 shards (35426, 17713 columns),
    # and one whose last shard of 4 is all padding
    for n, valid in ((2, A), (4, A), (4, 3 * (A // 4) - 100)):
        S = A // n
        labels = rs.randint(0, valid, B)
        edges = [e for r in range(1, n) for e in (r * S - 1, r * S) if e < valid]
        labels[: len(edges)] = edges  # a label on each side of every shard edge
        labels = t(labels.astype(np.int64))
        lse_f, lbl_f = fused_ce_fwd(h, w, b, labels, valid, P)
        dh_f, dw_f, db_f = fused_ce_bwd(h, w, b, labels, lse_f, ct, valid, P)
        shards = []
        for r in range(n):
            cols = slice(r * S, (r + 1) * S)
            local_valid = min(max(valid - r * S, 0), S)
            shards.append((w[:, cols].contiguous(), b[cols].contiguous(), labels - r * S,
                           local_valid, cols))
        outs = [fused_ce_fwd(h, ws, bs, lab, lv, P) for ws, bs, lab, lv, _ in shards]
        lse, lbl = ce_from_shards(torch.stack([o[0] for o in outs]),
                                  torch.stack([o[1] for o in outs]))
        what = f"shard contract n={n} valid={valid}"
        if not (torch.isfinite(lse).all() and torch.isfinite(lbl).all()):
            fail(f"{what}: the merged lse or label logit is not finite")
        errs["lse"] = max(errs["lse"], (lse - lse_f).abs().max().item())
        errs["label"] = max(errs["label"], (lbl - lbl_f).abs().max().item())
        dh = torch.zeros_like(dh_f)
        for ws, bs, lab, lv, cols in shards:  # B2 per shard with the global lse
            dh_s, dw_s, db_s = fused_ce_bwd(h, ws, bs, lab, lse, ct, lv, P)
            dh += dh_s
            for name, got, want in (("dW", dw_s, dw_f), ("db", db_s, db_f)):
                if not torch.isfinite(got).all():
                    fail(f"{what}: a shard's {name} is not finite")
                errs[name] = max(errs[name], (got - want[..., cols]).abs().max().item()
                                 / want.abs().max().item())
        errs["dh"] = max(errs["dh"], rel_err(dh, dh_f))
        if max(errs["lse"], errs["label"]) > 1e-5 or max(errs["dh"], errs["dW"], errs["db"]) > 1e-5:
            fail(f"{what}: B1/B2 per shard against the whole head: {errs}")
        # B5 and B6 with their maxima, merged by key
        for multi in (False, True):
            if multi:
                full_i, full_m = fused_weighted_multihead_argmax(h, wq, bq, qw, valid, P,
                                                                 with_max=True)
                plain = head_values_plain(h, wq, bq, valid, P, qw)
            else:
                full_i, full_m = fused_linear_argmax(h, wq[0], bq[0], valid, P, with_max=True)
                plain = head_values_plain(h, wq[0], bq[0], valid, P)
            keys, maxima = [], []
            for r in range(n):
                cols = slice(r * S, (r + 1) * S)
                lv = min(max(valid - r * S, 0), S)
                if multi:
                    i_s, m_s = fused_weighted_multihead_argmax(
                        h, wq[:, :, cols].contiguous(), bq[:, cols].contiguous(), qw, lv, P,
                        with_max=True)
                else:
                    i_s, m_s = fused_linear_argmax(h, wq[0][:, cols].contiguous(),
                                                   bq[0][cols].contiguous(), lv, P,
                                                   with_max=True)
                if not torch.isfinite(m_s).all():
                    fail(f"{what}: a shard's max is not finite")
                keys.append(order_keys(m_s, i_s + r * S))
                maxima.append(m_s)
            ids = argmax_from_shards(torch.stack(keys))
            top2 = plain.topk(2, dim=1).values
            clear = (top2[:, 0] - top2[:, 1]) > GAP
            if (clear & (ids != full_i)).any():
                fail(f"{what}: {'B6' if multi else 'B5'} per shard picks another id")
            errs["max"] = max(errs["max"], rel_err(torch.stack(maxima).amax(dim=0), full_m))
            if errs["max"] > 1e-5:
                fail(f"{what}: the shards' maxima differ from the whole head's")
    # ties across a shard edge: integer operands, columns S - 1 and S (and
    # the last valid one) the best of every row; the lower global id wins
    hi = t(rs.randint(0, 3, (B, F)).astype(np.float32))
    for n in (2, 4):
        S = A // n
        wt = rs.randint(-2, 3, (3, F, A)).astype(np.float32)
        bt = rs.randint(-2, 3, (3, A)).astype(np.float32)
        for c in (S - 1, S, A - 1):
            wt[:, :, c], bt[:, c] = 9.0, 5.0
        wt, bt = t(wt), t(bt)
        for multi in (False, True):
            keys = []
            for r in range(n):
                cols = slice(r * S, (r + 1) * S)
                if multi:
                    i_s, m_s = fused_weighted_multihead_argmax(
                        hi, wt[:, :, cols].contiguous(), bt[:, cols].contiguous(), qw, S, P,
                        with_max=True)
                else:
                    i_s, m_s = fused_linear_argmax(hi, wt[0][:, cols].contiguous(),
                                                   bt[0][cols].contiguous(), S, P,
                                                   with_max=True)
                keys.append(order_keys(m_s, i_s + r * S))
            if not (argmax_from_shards(torch.stack(keys)) == S - 1).all():
                fail(f"tie over the edge of {n} shards: {'B6' if multi else 'B5'} merged "
                     f"past the lowest global id {S - 1}")
    print(f"[mesh] shard contract (n = 2, 4; shard widths {A // 2}, {A // 4}; a shard of "
          f"padding only; labels shifted past each shard; ties over a shard edge): worst "
          f"errors {errs} (lse, label: absolute; dh, dW, db, max: of the leaf's largest)")
    return errs


def mesh_hold(family, spec, got, ref):
    """A mesh rank 0's checked run against the single-process one: losses
    1e-4, first-step gradients and the last first moments 1e-4 of each
    leaf's largest, params after the checked steps lr / 1000 over the
    entries whose gradients (read off the single-process moments, at the
    steps that trained the net) are 0 or above 1e-6 at every step."""
    what = f"mesh {spec[0]}x{spec[1]} {family}"
    loss_err = np.abs(np.asarray(got["losses"]) - np.asarray(ref["losses"])).max()
    if not loss_err <= 1e-4:
        fail(f"{what}: losses {got['losses']} against {ref['losses']}")
    check_close([got["grads"][k] for k in ref["grads"]], list(ref["grads"].values()),
                list(ref["grads"]), f"{what}: first-step gradients", 1e-4)
    for g_mu, r_mu in zip(got["mu"][-1], ref["mu"][-1]):
        check_close([g_mu[n] for n in r_mu], list(r_mu.values()), list(r_mu),
                    f"{what}: first moments after {MESH_CHECK} steps", 1e-4)
    lr = MESH_POINTS[family]["lr"]
    compared = moved = 0
    for net in range(len(ref["params"])):
        trained = [k for k in range(MESH_CHECK)
                   if len(ref["params"]) == 1 or MESH_COINS[k] == net]
        for name, want in ref["params"][net].items():
            g = torch.stack([(ref["mu"][k + 1][net][name] - 0.9 * ref["mu"][k][net][name]) / 0.1
                             for k in trained])
            mk = (g != 0).any(dim=0)
            sure = mk & ((g == 0) | (g.abs() > 1e-6)).all(dim=0)
            err = (got["params"][net][name] - want)[sure].abs().max().item() if sure.any() else 0
            if err > lr / 1000:
                fail(f"{what}: {name} differs by {err:.3g} > lr / 1000")
            compared, moved = compared + int(sure.sum()), moved + int(mk.sum())
    share = compared / max(moved, 1)
    if share < MESH_FLOOR:
        fail(f"{what}: only {compared} of {moved} moved entries compared")
    return loss_err, share


def phase_mesh(smi):
    """The (data, model) mesh on the one card: the shard contract in this
    process, then (1, 2) and (2, 2) meshes of ranks sharing the card over
    gloo with CUDA tensors, held to this process's single-device runs, and
    a (1, 1) mesh over nccl. Returns each mesh's timed launches."""
    from ikea_recommender_tpu_torch.data.replay_buffer import num_batches

    mesh_shard_contract()
    t0 = time.perf_counter()
    refs = {family: mesh_run(family) for family in MESH_RUNS[(1, 2)]}
    ref_serve = mesh_serving()
    scores, _, _ = mesh_eval()
    # about half the labels at one of the row's top-20 ids
    rs = np.random.RandomState(3)
    top = torch.cat([i[valid] for _, i, _, _, valid in scores]).numpy()
    actions = np.asarray(eval_buffer(MESH_A, MESH_T, EVAL_ROWS, np.random.RandomState(2)).action)
    relabel = rs.rand(EVAL_ROWS) < 0.5
    actions[relabel] = top[relabel, rs.randint(0, 20, EVAL_ROWS)[relabel]]
    ref_scores, res_ref, proto = mesh_eval(actions)
    mesh_log(f"the single-process runs: {time.perf_counter() - t0:.1f} s")

    paths = {}
    for spec, families in MESH_RUNS.items():
        jobs = [("train", f) for f in families]
        if spec == (1, 2):
            jobs += [("serve", None), ("eval", actions)]
        jobs.append(("probe", None))  # last: a collective that fails cannot upset the rest
        t0 = time.perf_counter()
        ranks = mesh_spawn(spec, "gloo", jobs)
        wall = time.perf_counter() - t0
        name = f"mesh {spec[0]}x{spec[1]}"
        print(f"[mesh] {name} over gloo, CUDA tensors, {len(ranks)} ranks on one card: "
              f"collectives {ranks[0]['probe']}; {wall:.1f} s from spawn to the last result")
        total = {}
        for family in families:
            got = ranks[0][f"train {family}"]
            loss_err, share = mesh_hold(family, spec, got, refs[family])
            for r, out in enumerate(ranks):
                run = out[f"train {family}"]
                launches = {k: v for k, v in run["launches"].items() if v}
                want = {k: v * MESH_TIMED for k, v in PER_STEP[family].items()}
                if launches != want:
                    fail(f"{name} rank {r} {family}: {MESH_TIMED} steps launched {launches}, "
                         f"expected {want}")
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
                per_step = {a: {k: v / MESH_TIMED for k, v in c.items()}
                            for a, c in run["collectives"].items()}
                ms = run["step_ms"]
                print(f"[mesh] {name} rank {r} {family} A={MESH_A} H={MESH_POINTS[family]['H']} "
                      f"T={MESH_T} B={MESH_B} (this rank's rows "
                      f"{MESH_B // spec[0]}) high: {MESH_TIMED} steps, ms per step median "
                      f"{float(np.median(ms)):.3f} (min {min(ms):.3f}, max {max(ms):.3f}) on "
                      f"a card shared by {len(ranks)} ranks, not a multi-GPU speed; "
                      f"collectives per step {per_step}; launches {launches}; held to one "
                      f"process: losses within {loss_err:.3g}, params compared over {share:.3f} "
                      f"of the moved entries; last loss {run['last_loss']}; {smi}")
        paths[name] = total
        if spec == (1, 2):
            v, i = ranks[0]["serve"]
            for r in ranks[1:]:
                if not torch.equal(r["serve"][1], i):
                    fail("mesh serving: the ranks' top-k ids differ")
            check_topk(v, i, *ref_serve, 10, ref="the single-process Recommender")
            scores, res = ranks[0]["eval"]
            on = lambda batches: [tuple(x.to(MESH_DEVICE) for x in s) for s in batches]  # noqa
            ref = "the single-process protocol"
            moved = hold_eval_batches(on(scores), on(ref_scores), proto, ref)
            hold_eval_result(res, res_ref, moved, proto, MESH_T, ref)
            print(f"[mesh] {name} serving 512 sessions: top-11 equal to one process; eval "
                  f"{EVAL_ROWS} rows in {num_batches(EVAL_ROWS, EVAL_BATCH)} batches of "
                  f"{EVAL_BATCH}: loss {res.loss:.6f} HR {res.hr.tolist()} (one process "
                  f"{res_ref.loss:.6f} {res_ref.hr.tolist()}); rows moved {moved}")
    (nccl,) = mesh_spawn((1, 1), "nccl", [("nccl", None)])
    got = nccl["nccl"]
    if got["all_reduce"] != [1.0, 1.0, 1.0]:
        fail(f"nccl all_reduce over one rank gave {got['all_reduce']}")
    loss_err, _ = mesh_hold("gru4rec", (1, 1), got["step"], refs["gru4rec"])
    print(f"[mesh] 1x1 over nccl {got['nccl']}: one all_reduce and the gru4rec steps held to one "
          f"process (losses within {loss_err:.3g}); ms per step median "
          f"{float(np.median(got['step']['step_ms'])):.3f}; {smi}")
    paths["mesh 1x1 nccl"] = {k: v for k, v in got["step"]["launches"].items() if v}
    return paths


# Phase 12: the trainer and its CLI on a mesh (ROADMAP A.9b), the trainer
# phase's experiment (catalog 70852, E = H = 64, T = 10, batch 256) trained
# by ranks that share the card over gloo. A rank's metrics may differ from
# one process's by what its rows within MESH_TRAINER_GAP of a tie move
# (counted on the one-process run); fast sqn (bf16 moments, whose rounding
# a split batch's sums can flip) is held within the reference's own
# mesh-to-one-device bound besides.
MESH_TRAINER_GAP = 1e-4
MESH_TRAINER_FAST = (2e-3, 2e-4)  # rtol, atol


class TieCounting:
    """Mixed into the port's EvalProtocol: for each finalize (a train window
    or an eval pass, in call order) (valid rows whose top scores lie within
    MESH_TRAINER_GAP of each other, valid rows)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.windows, self._near, self._n = [], 0, 0

    def update(self, params, accum, state, action, true_len, valid, action_type=None):
        s, a, tl = (self._on_device(x) for x in (state, action, true_len))
        vals = self.topk_ce(params, s, tl, a, k=self._max_k + 1)[0]
        ok = self._on_device(valid, torch.bool)
        self._near += int((ok & ((vals[:, :-1] - vals[:, 1:]) <= MESH_TRAINER_GAP).any(1)).sum())
        self._n += int(ok.sum())
        return super().update(params, accum, state, action, true_len, valid, action_type)

    def finalize(self, accum):
        self.windows.append((self._near, self._n))
        self._near = self._n = 0
        return super().finalize(accum)


def tie_limit(key, near, n, n_unpop, bound=(0.0, 0.0), value=0.0):
    """How far a logged metric may move for ``near`` of ``n`` rows near a
    tie (None: a loss, held by rtol); ``bound`` (rtol, atol) adds a slack."""
    if "Loss" in key or key == "Q-Modification-Signal":
        return None
    n = max(n, 1)
    k = int(key.rsplit("@", 1)[1].split("[")[0]) if "@" in key else 1
    if "_CV@" in key:
        lim = near * k / (max(n_unpop, 1) if "NOV_CV" in key else TRAINER_A)
    elif "Div_Reward" in key:
        lim = 1e-5 + 2 * near / n
    elif "Nov_Reward" in key:
        lim = 1e-5 + near / n
    elif "_R@" in key:
        lim = near * k / n
    else:
        lim = (1e-6 if "NDCG" in key else 0.0) + near / n
    return lim + bound[1] + bound[0] * abs(value)


def hold_trainer_logs(what, got, want, windows, n_nets, n_unpop, bound=(0.0, 0.0), rtol=1e-4):
    """A mesh run's pretrain metrics, logs and test metrics (rank 0's)
    against one process's, ``windows`` the one-process run's near ties per
    finalize (pretrain; per point: train, val of each net; test). Returns
    the worst loss error (relative) and the rows near a tie."""
    worst, near_rows = 0.0, 0
    if len(got["logs"]) != len(want.logs) or len(windows) != 2 + len(want.logs) * (1 + n_nets):
        fail(f"{what}: {len(got['logs'])} eval points against {len(want.logs)}")
    points = [(got["pretrain"], want.pretrain_metrics, {"val": windows[0]}),
              (got["test"], want.test_metrics, {"val": windows[-1]})]
    for i, (g, w) in enumerate(zip(got["logs"], want.logs)):
        at = 1 + i * (1 + n_nets)
        points.append((g, w, {"train": windows[at], "val": windows[at + 1],
                              "sec": windows[at + n_nets]}))
    for g, w, kinds in points:
        if set(g) != set(w):
            fail(f"{what}: logged keys differ: {sorted(set(g) ^ set(w))}")
        near_rows += sum(k[0] for k in kinds.values())
        for key, wv in w.items():
            kind = "sec" if key.startswith("Sec_") else (
                "train" if key.startswith("Train_") else "val")
            lim = tie_limit(key, *kinds[kind], n_unpop, bound, wv)
            err = abs(g[key] - wv)
            if lim is None:
                rel = err / max(abs(wv), 1e-12)
                worst = max(worst, rel)
                if rel > max(rtol, bound[0]) and err > bound[1]:
                    fail(f"{what}: {key} {g[key]} against {wv} (rtol {rtol})")
            elif err > lim:
                fail(f"{what}: {key} {g[key]} against {wv}, beyond {lim:.3g} "
                     f"({kinds[kind]} rows near a tie)")
    return worst, near_rows


def mesh_trainer_job(mesh, arg):
    """One trainer run on this rank (``arg``: the YAML, its overrides, the
    init params' file, the run's checks) -> its logs, metrics, launches,
    collectives per train step, timing and final slice."""
    import shutil

    from ikea_recommender_tpu_torch.convert import unflatten
    from ikea_recommender_tpu_torch.core.config import ParallelConfig, load_experiment_config
    from ikea_recommender_tpu_torch.run import trainer

    cfg = load_experiment_config(arg["yaml"])
    cfg.exp_dir = arg["exp_dir"]
    os.makedirs(cfg.exp_dir, exist_ok=True)
    cfg.experiment.save_pretrained_embeddings = arg.get("embeddings", False)
    for k, v in arg["train"].items():
        setattr(cfg.train, k, v)
    cfg.parallel = ParallelConfig(*arg["spec"], **arg.get("parallel", {}))
    if arg.get("copy_ckpt"):  # this rank's checkpoint of an earlier run's epoch
        src, step = arg["copy_ckpt"]
        os.makedirs(cfg.train.checkpoint_dir, exist_ok=True)
        shutil.copy(os.path.join(src, f"ckpt_{step}.rank{mesh.rank}-of-{mesh.spec.num_devices}"
                                      f".pt"), cfg.train.checkpoint_dir)
    init = None
    if arg.get("init"):
        with np.load(arg["init"]) as f:
            init = unflatten({k: f[k] for k in f.files})
    seen = {"per_step": {a: {"calls": 0, "bytes": 0} for a in ("data", "model")}, "steps": 0,
            "rows": []}
    makers = {k: getattr(trainer, k) for k in ("make_train_step", "make_sharded_train_step",
                                               "_device_train_data_process_sharded")}

    def counted(make):
        def build(*a, **kw):
            step, run_mesh = make(*a, **kw), kw.get("mesh", a[2] if len(a) > 2 else None)

            def call(state, batch):
                before = run_mesh.counts()
                out = step(state, batch)
                for axis, c in run_mesh.counts().items():
                    for key in ("calls", "bytes"):
                        seen["per_step"][axis][key] += c[key] - before[axis][key]
                seen["steps"] += 1
                if arg.get("check_batches"):
                    seen["rows"].append(batch["state"].clone())
                return out

            return call

        return build

    def held(*a):
        out = makers["_device_train_data_process_sharded"](*a)
        seen["train_bytes"] = sum(t.numel() * t.element_size() for t in out[0].values())
        return out

    trainer.make_train_step = counted(makers["make_train_step"])
    trainer.make_sharded_train_step = counted(makers["make_sharded_train_step"])
    trainer._device_train_data_process_sharded = held
    torch.cuda.synchronize()
    reset_counters()
    try:
        out = trainer.train(cfg, init_params=init, device=MESH_DEVICE)
    finally:
        for k, v in makers.items():
            setattr(trainer, k, v)
    torch.cuda.synchronize()
    launches = {k: v for k, v in counters().items() if v}
    batches_ok = None
    if arg.get("check_batches"):  # the rows _sharded_index_matrices names for this rank
        from ikea_recommender_tpu_torch.data.replay_buffer import ReplayBuffer

        buf = ReplayBuffer(cfg.data.train_path)
        D, d = mesh.size("data"), mesh.index("data")
        n = len(buf)
        per = -(-n // D)
        padded = np.zeros((D * per,) + buf.state.shape[1:], buf.state.dtype)
        padded[:n] = buf.state
        idx, _ = trainer._sharded_index_matrices(np.random.default_rng(cfg.seed * 100_003),
                                                 n, per, D, cfg.train.batch_size)
        batches_ok = len(seen["rows"]) == len(idx) and all(
            np.array_equal(r.cpu().numpy(), padded[d * per + idx[i, d]])
            for i, r in enumerate(seen["rows"]))
    nets = out.state.params if isinstance(out.state.params, tuple) else (out.state.params,)
    steps = max(seen["steps"], 1)
    return {
        "logs": out.logs, "pretrain": out.pretrain_metrics, "test": out.test_metrics,
        "best": (out.best_metric, out.best_epoch), "launches": launches,
        "per_step": {a: {k: v / steps for k, v in c.items()} for a, c in seen["per_step"].items()},
        "steps": seen["steps"], "train_s": out.timing["dispatch"] + out.timing["sync"],
        "throughput": out.throughput_sessions_per_sec, "timing": out.timing,
        "shards": [named_leaves(p) for p in nets],
        "train_bytes": seen.get("train_bytes"), "batches_ok": batches_ok,
    }


def same_shards(a, b):
    """Whether two lists of {name: tensor} hold the same names and bits."""
    return len(a) == len(b) and all(
        set(x) == set(y) and all(torch.equal(x[k], y[k]) for k in x) for x, y in zip(a, b))


def mesh_trainer_line(name, spec, ranks, n_b, epochs, smi, extra=""):
    for r, run in enumerate(ranks):
        ms = run["train_s"] / max(run["steps"], 1) * 1e3
        print(f"[mesh-trainer] {name} on {spec[0]}x{spec[1]} rank {r} (its rows "
              f"{TRAINER_B // spec[0]} of {TRAINER_B}): {run['steps']} steps ({epochs} x {n_b} "
              f"an epoch), {ms:.3f} ms per step (train spans over their steps, train metrics "
              f"included) on a card shared by {len(ranks)} ranks over gloo, not a multi-GPU "
              f"speed; {run['throughput']:.0f} sessions/s; collectives per step "
              f"{json.dumps(run['per_step'])}; launches {json.dumps(run['launches'])}; best "
              f"{run['best'][0]:.6f} @ eval point {run['best'][1]}{extra}; {smi}")


def phase_mesh_trainer(smi):
    """The trainer on a mesh of ranks that share the card over gloo: (a)
    gru4rec on (1, 2), 2 epochs, per-rank checkpoints, held to one process
    from the same init; (b) a resume from a's epoch-1 checkpoints, a's
    second epoch bit for bit; (c) ``sharded_ce`` 1 epoch, a's first bit for
    bit; (d) fast sqn on (2, 1), the action-major B5 on each rank's 128
    rows, held to one process, replicas bit-equal; (e) gru4rec on (2, 1)
    with ``process_sharded``, each rank's rows and batches checked. Returns
    each run's launches (summed over its ranks)."""
    import tempfile

    from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
    from ikea_recommender_tpu_torch.core.config import load_experiment_config
    from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer, ReplayBuffer, num_batches
    from ikea_recommender_tpu_torch.eval.protocol import EvalProtocol
    from ikea_recommender_tpu_torch.models.families import model_config_from_train
    from ikea_recommender_tpu_torch.run import trainer

    t_phase = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_trainer_") as tmp:
        yaml_path = trainer_experiment(tmp)
        bufs = dict(train_buf=ReplayBuffer(os.path.join(tmp, "train.npz")),
                    val_buf=EvalBuffer(os.path.join(tmp, "val.npz")),
                    test_buf=EvalBuffer(os.path.join(tmp, "test.npz")))
        n_b = num_batches(len(bufs["train_buf"]), TRAINER_B)
        n_val = num_batches(len(bufs["val_buf"]), EVAL_BATCH)
        n_test = num_batches(len(bufs["test_buf"]), EVAL_BATCH)
        fast_yaml = os.path.join(tmp, "fast.yaml")
        with open(yaml_path) as src, open(fast_yaml, "w") as dst:
            dst.write(src.read().replace('model: "gru4rec"', 'model: "sqn"').replace(
                "  fused_ce: true\n", '  fused_ce: true\n  preset: "fast"\n'))
        cfg = load_experiment_config(yaml_path)
        n_unpop = len(json.load(open(os.path.join(tmp, "unpopular.json"))))
        # the (1, 2) mesh's model pads 70853 embedding rows to 70854; one
        # process takes the same params without the padding row, which no id
        # reads and no step moves
        init = numpy_init_params(model_config_from_train(cfg.train, cfg.data, align=2), cfg.seed)
        np.savez(os.path.join(tmp, "init.npz"), **{
            k: v.numpy() for k, v in named_leaves(params_from_numpy(init, "cpu")).items()})
        one = {**init, "backbone": {**init["backbone"],
                                     "embedding": init["backbone"]["embedding"][:TRAINER_A + 1]}}

        def one_process(yaml, sub, epochs, init_params=None):
            c = load_experiment_config(yaml)
            c.exp_dir = os.path.join(tmp, sub)
            c.train.epochs, c.train.checkpoint_dir = epochs, None
            c.experiment.save_pretrained_embeddings = False
            made = []

            class Counting(TieCounting, EvalProtocol):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    made.append(self)

            trainer.EvalProtocol = Counting
            try:
                res = trainer.train(c, init_params=init_params, device=MESH_DEVICE, **bufs)
            finally:
                trainer.EvalProtocol = EvalProtocol
            return res, made[0].windows

        t0 = time.perf_counter()
        ref_a, win_a = one_process(yaml_path, "one_gru4rec", 2, one)
        ref_d, win_d = one_process(fast_yaml, "one_sqn_fast", 1)
        mesh_log(f"trainer: the one-process runs {time.perf_counter() - t0:.1f} s")

        base = dict(yaml=yaml_path, embeddings=True)
        run_a = dict(base, name="a", spec=(1, 2), exp_dir=f"{tmp}/a", init=f"{tmp}/init.npz",
                     train=dict(epochs=2, checkpoint_dir=f"{tmp}/a_ckpt"))
        run_b = dict(base, name="b", spec=(1, 2), exp_dir=f"{tmp}/b", init=f"{tmp}/init.npz",
                     copy_ckpt=(f"{tmp}/a_ckpt", 1),
                     train=dict(epochs=2, checkpoint_dir=f"{tmp}/b_ckpt", resume=True))
        run_c = dict(base, name="c", spec=(1, 2), exp_dir=f"{tmp}/c", init=f"{tmp}/init.npz",
                     parallel=dict(sharded_ce=True), train=dict(epochs=1))
        run_d = dict(yaml=fast_yaml, name="d", spec=(2, 1), exp_dir=f"{tmp}/d",
                     train=dict(epochs=1))
        run_e = dict(base, name="e", spec=(2, 1), exp_dir=f"{tmp}/e", check_batches=True,
                     parallel=dict(process_sharded=True), train=dict(epochs=1))
        t0 = time.perf_counter()
        r12 = mesh_spawn((1, 2), "gloo", [("trainer", run_a), ("trainer", run_b),
                                          ("trainer", run_c)])
        r21 = mesh_spawn((2, 1), "gloo", [("trainer", run_d), ("trainer", run_e)])
        mesh_log(f"trainer: the two spawns {time.perf_counter() - t0:.1f} s")
        get = lambda ranks, name: [r[f"trainer {name}"] for r in ranks]  # noqa: E731

        # (a) held to one process; launches PER_STEP per step plus B3 per eval batch
        a = get(r12, "a")
        loss_err, near = hold_trainer_logs("mesh trainer a", a[0], ref_a, win_a, 1, n_unpop)
        if a[0]["best"][1] != ref_a.best_epoch:
            fail(f"mesh trainer a: best eval point {a[0]['best']} against one process's "
                 f"{(ref_a.best_metric, ref_a.best_epoch)}")
        per = -(-len(bufs["train_buf"]) // 2)  # each data rank's rows under process_sharded
        n_b_e = -(-per // (TRAINER_B // 2))
        for name, ranks, fam, steps in (("a", a, "gru4rec", 2 * n_b),
                                        ("c", get(r12, "c"), "gru4rec", n_b),
                                        ("d", get(r21, "d"), "sqn fast", n_b),
                                        ("e", get(r21, "e"), "gru4rec", n_b_e)):
            for r, run in enumerate(ranks):
                res = SimpleOutcome(run["test"], run["logs"])
                want = trainer_launches(fam, res, run["steps"], n_val, n_test)
                want = {k: v for k, v in want.items() if v}
                if run["launches"] != want:
                    fail(f"mesh trainer {name} rank {r}: launched {run['launches']}, expected "
                         f"{want}")
                if run["steps"] != steps:
                    fail(f"mesh trainer {name} rank {r}: {run['steps']} steps, expected {steps}")
            total = {}
            for run in ranks:
                for k, v in run["launches"].items():
                    total[k] = total.get(k, 0) + v
            paths[f"mesh trainer {name}"] = total
        for r, run in enumerate(a[1:], 1):
            if run["logs"] != a[0]["logs"] or run["test"] != a[0]["test"]:
                fail(f"mesh trainer a: rank {r} logged other numbers than rank 0")
        mesh_trainer_line("gru4rec (a)", (1, 2), a, n_b, 2, smi,
                          f"; held to one process: losses within {loss_err:.3g} (relative), "
                          f"{near} rows near a tie")

        # (b) a resume from a's epoch-1 checkpoints gives a's second epoch bit for bit
        b = get(r12, "b")
        same = all(rb["logs"] == ra["logs"][2:] and rb["test"] == ra["test"] and rb["best"] == (
            ra["best"]) and same_shards(rb["shards"], ra["shards"]) for ra, rb in zip(a, b))
        with np.load(f"{tmp}/a/best_model.npz") as fa, np.load(f"{tmp}/b/best_model.npz") as fb:
            same = same and set(fa.files) == set(fb.files) and all(
                np.array_equal(fa[k], fb[k]) for k in fa.files)
        same = same and (json.load(open(f"{tmp}/a/test_metrics.json"))
                         == json.load(open(f"{tmp}/b/test_metrics.json")))
        if not same:
            fail("mesh trainer b: the resume from a's epoch-1 checkpoints is not a's second "
                 "epoch bit for bit")
        print(f"[mesh-trainer] resume (b) on 1x2 from a's per-rank epoch-1 checkpoints: the "
              f"logs, best_model.npz, test_metrics.json and each rank's final slice equal a's "
              f"bit for bit; {smi}")

        # (c) sharded_ce: fused_ce resolved on, so the step is a's: a's first epoch
        c = get(r12, "c")
        if not all(rc["logs"] == ra["logs"][:2] for ra, rc in zip(a, c)):
            fail("mesh trainer c: sharded_ce with fused_ce on is not a's first epoch bit for "
                 "bit")
        mesh_trainer_line("gru4rec sharded_ce (c)", (1, 2), c, n_b, 1, smi,
                          "; fused_ce resolved on, so the same step as a: a's first epoch bit "
                          "for bit")

        # (d) fast sqn on (2, 1): one process's within the reference's mesh bound
        d = get(r21, "d")
        loss_err, near = hold_trainer_logs("mesh trainer d", d[0], ref_d, win_d, 2, n_unpop,
                                           bound=MESH_TRAINER_FAST)
        if not same_shards(d[0]["shards"], d[1]["shards"]):
            fail("mesh trainer d: the two ranks' replicated params differ")
        for r, run in enumerate(d):
            if run["launches"].get("B5 fused_argmax am") != run["steps"]:
                fail(f"mesh trainer d rank {r}: the action-major B5 ran "
                     f"{run['launches'].get('B5 fused_argmax am')} times in {run['steps']} steps")
        mesh_trainer_line("sqn preset fast (d)", (2, 1), d, n_b, 1, smi,
                          f"; held to one process within rtol {MESH_TRAINER_FAST[0]}, atol "
                          f"{MESH_TRAINER_FAST[1]}: losses within {loss_err:.3g}, {near} rows "
                          f"near a tie; the Q head and GRU bit-equal on both ranks")

        # (e) process_sharded on (2, 1)
        e = get(r21, "e")
        for r, run in enumerate(e):
            if not run["batches_ok"]:
                fail(f"mesh trainer e rank {r}: a batch's rows are not the ones "
                     f"_sharded_index_matrices names")
        check_logs("mesh trainer e", SimpleOutcome(e[0]["test"], e[0]["logs"], e[0]["pretrain"]))
        if not same_shards(e[0]["shards"], e[1]["shards"]):
            fail("mesh trainer e: the two ranks' params differ")
        mesh_trainer_line("gru4rec process_sharded (e)", (2, 1), e, n_b_e, 1, smi, f"; each rank holds its {per} rows, "
                          f"{[run['train_bytes'] for run in e]} bytes on the card, its batches "
                          f"the rows _sharded_index_matrices names")
    print(f"[mesh-trainer] phase: {time.perf_counter() - t_phase:.1f} s; every time above is "
          f"of ranks that share one card, not a multi-GPU speed; {smi}")
    return paths


RR_INVOCATION = "experiments/RetailRocket-Comparison/rehearsal_r5b"
RR_CATALOG = 72293  # RESULTS.md:152, the r5b invocation's catalog after the ETL
# phase 13's sqn and smorl runs: the first 1024 batches of the train rows (a
# whole epoch of smorl's ~45 ms steps takes ~320 s, and sqn's ~60 s, which
# the script's 1200 s cannot hold beside the other phases)
RR_PREFIX_STEPS = 1024
RR_SCALING_SPECS = ((1, 1), (2, 1), (1, 2))
RR_SCALING_STEPS = (3, 20)  # warm-up, timed


def scaling_job(arg):
    """``parallel/scaling_bench.py::run_scaling_bench`` on this rank (phase
    13): smorl at the bench width over ``RR_SCALING_SPECS``, its points as
    dicts, and this rank's launches and steps."""
    import dataclasses

    from ikea_recommender_tpu_torch.core.mesh import MeshSpec
    from ikea_recommender_tpu_torch.parallel.scaling_bench import run_scaling_bench

    reset_counters()
    warmup, iters = RR_SCALING_STEPS
    pts = run_scaling_bench(model="smorl", mesh_specs=[MeshSpec(*s) for s in RR_SCALING_SPECS],
                            warmup=warmup, iters=iters, backend="gloo", device=MESH_DEVICE)
    torch.cuda.synchronize()
    rank = torch.distributed.get_rank()
    points = sum(rank < s[0] * s[1] for s in RR_SCALING_SPECS)
    return {"points": [dataclasses.asdict(p) for p in pts], "launches": counters(),
            "steps": points * (warmup + iters)}


def rr_argv(tmp):
    """The r5b invocation's synth, etl and buffers argv
    (``RR_INVOCATION/command_<cmd>.json``) with paths under ``tmp``."""
    rec = {cmd: json.load(open(os.path.join(RR_INVOCATION, f"command_{cmd}.json")))
           for cmd in ("synth", "etl", "buffers")}
    s, e, b = rec["synth"], rec["etl"], rec["buffers"]
    events, data, bufs = f"{tmp}/events.csv", f"{tmp}/data", f"{tmp}/buffers"
    return bufs, {
        "synth": ["synth", "--out", events, "--num-sessions", str(s["num_sessions"]),
                  "--num-items", str(s["num_items"]), "--seed", str(s["seed"])],
        "etl": ["etl", "--events", events, "--out", data, "--click-events", *e["click_events"],
                "--buy-events", *e["buy_events"], "--min-item-count", str(e["min_item_count"]),
                "--min-session-len", str(e["min_session_len"]),
                "--sample-sessions", str(e["sample_sessions"]), "--seed", str(e["seed"])],
        "buffers": ["buffers", "--data", data, "--out", bufs, "--state-len", str(b["state_len"]),
                    "--pad-pos", b["pad_pos"], "--unpopular-quantile",
                    str(b["unpopular_quantile"])],
    }


def buffer_prefix(bufs, out, rows):
    """``bufs`` in ``out`` with the train buffer cut to its first ``rows``
    rows; the val and test buffers and the JSON files linked as they are."""
    os.makedirs(out)
    for name in os.listdir(bufs):
        if name != "replay_buffer.npz":
            os.symlink(os.path.join(bufs, name), os.path.join(out, name))
    with np.load(os.path.join(bufs, "replay_buffer.npz")) as buf:
        np.savez(os.path.join(out, "replay_buffer.npz"), **{k: buf[k][:rows] for k in buf.files})


def phase_retailrocket(smi):
    """The RetailRocket protocol without pandas (``run/retailrocket.py``)
    at the r5b invocation, gru4rec, sqn and smorl trained on it one epoch
    each on the card through ``run``, the analysis functions on the gru4rec
    model and the shared-card scaling points. Returns each path's launches."""
    import contextlib
    import io
    import tempfile

    from ikea_recommender_tpu_torch.analysis import embeddings, trajectories, visualize
    from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer, num_batches
    from ikea_recommender_tpu_torch.models.families import model_config_from_train
    from ikea_recommender_tpu_torch.run import retailrocket as rr
    from ikea_recommender_tpu_torch.run.checkpoints import load_params_npz
    from ikea_recommender_tpu_torch.run.serve import Recommender

    t_phase = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rr_") as tmp:
        bufs, argv = rr_argv(tmp)
        secs = {}
        for cmd in ("synth", "etl", "buffers"):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as said:
                rr.main(argv[cmd])
            secs[cmd] = time.perf_counter() - t0
            for line in said.getvalue().splitlines():
                print(f"[retailrocket] {line.replace(tmp, '<tmp>')}")
        meta = json.load(open(os.path.join(tmp, "data", "item_map.json")))
        if meta["num_items"] != RR_CATALOG:
            fail(f"retailrocket: the r5b invocation gave catalog {meta['num_items']}, "
                 f"not {RR_CATALOG}")
        splits = {s: rr.load_split(os.path.join(tmp, "data", f"sampled_{s}.npz"))
                  for s in ("train", "val", "test")}
        sizes = {s: {"rows": len(c["item_id"]), "sessions": len(np.unique(c["session_id"])),
                     "buys": int(c["is_buy"].sum())} for s, c in splits.items()}
        print(f"[retailrocket] r5b invocation ({RR_INVOCATION}/command_*.json): catalog "
              f"{meta['num_items']} (= {RR_CATALOG}); splits {json.dumps(sizes)}; host s "
              f"{json.dumps({k: round(v, 3) for k, v in secs.items()})}")

        # gru4rec, then sqn (B5 once a step), then smorl (B6 once a step,
        # the diversity reward read from the gru4rec run's export), one
        # epoch each at the paper point, train metrics off
        val_buf = EvalBuffer(os.path.join(bufs, "val_buffer.npz"))
        test_buf = EvalBuffer(os.path.join(bufs, "test_buffer.npz"))
        n_b = num_batches(len(np.load(os.path.join(bufs, "replay_buffer.npz"))["action"]), 256)
        n_val, n_test = num_batches(len(val_buf), 2000), num_batches(len(test_buf), 2000)
        div_emb = f"{tmp}/runs/gru4rec_run/embedding_weights.npy"
        prefix = f"{tmp}/buffers_prefix"
        buffer_prefix(bufs, prefix, RR_PREFIX_STEPS * 256)
        runs = (("gru4rec", bufs, n_b, []), ("sqn", prefix, RR_PREFIX_STEPS, []),
                ("smorl", prefix, RR_PREFIX_STEPS, ["--div-emb", div_emb]))
        for family, run_bufs, steps, extra in runs:
            out = f"{tmp}/runs/{family}_run"
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            reset_counters()
            with contextlib.redirect_stdout(io.StringIO()):
                outcome = rr.main(["run", "--buffers", run_bufs, "--family", family, "--epochs",
                                   "1", "--no-train-metrics", *extra, "--out", out])
            torch.cuda.synchronize()
            launches = counters()
            run_s = time.perf_counter() - t0
            want = trainer_launches(family, outcome, steps, n_val, n_test, train_metrics=False)
            if launches != want:
                fail(f"retailrocket run {family} launched {launches}, expected {want}")
            check_logs(f"retailrocket {family}", outcome)
            summary = json.load(open(os.path.join(out, "run_summary.json")))
            tm = summary["test_metrics"]
            paths[f"retailrocket {family}"] = launches
            said = ""
            if family == "smorl":
                if summary["div_emb"] != div_emb:
                    fail(f"retailrocket smorl read the embedding {summary['div_emb']}")
                if tm["Test_Div_Reward"] == 0:
                    fail(f"retailrocket smorl: test Div_Reward is {tm['Test_Div_Reward']}")
                said = (f", Div_Reward {tm['Test_Div_Reward']:.6f}, Nov_Reward "
                        f"{tm['Test_Nov_Reward']:.6f} (--div-emb the gru4rec run's export)")
            print(f"[retailrocket] run {family} 1 epoch (--no-train-metrics; batch 256, lr "
                  f"0.01, E=H=64, catalog {RR_CATALOG}): {steps} steps"
                  f"{' (the first train rows)' if steps < n_b else ''}, "
                  f"{summary['train_sessions_per_sec']:.0f} sessions/s of the train loop, test "
                  f"HR@10 {tm['Test_HR@10']:.6f} NDCG@10 {tm['Test_NDCG@10']:.6f}{said}, best "
                  f"{summary['best_metric']:.6f}; {run_s:.1f} s; launches "
                  f"{json.dumps(launches)}; {smi}")
            if family == "gru4rec":
                hr = tm["Test_HR@10"]

        # the analysis functions on the gru4rec model
        out = f"{tmp}/runs/gru4rec_run"
        cfg = rr.run_config(rr.get_parser().parse_args(
            ["run", "--buffers", bufs, "--family", "gru4rec", "--out", out]), None)
        mc = model_config_from_train(cfg.train, cfg.data)
        rec = Recommender(load_params_npz(os.path.join(out, "best_model.npz"), device="cuda"), mc,
                          device="cuda")
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        reset_counters()
        hits = visualize.find_hits(rec, test_buf, k=10)
        records = trajectories.predict_and_describe(
            rec, test_buf, hits[:3], k=10,
            lookup_fn=lambda ids: {int(i): {"name": f"item {i}"} for i in ids})
        html_path = visualize.render_predictions_html(records, f"{tmp}/preds.html")
        starts = test_buf.action[hits[:4]].tolist()
        trajs = trajectories.sample_trajectories(rec, starts, steps=5, state_len=10,
                                                 pad_id=RR_CATALOG, rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        launches = counters()
        n_calls = num_batches(len(test_buf), 1024) + 1 + len(starts) * 5
        if launches != {name: n_calls * (name == "B3 gru_fwd") for name in launches}:
            fail(f"the analysis' {n_calls} recommend calls launched {launches}")
        paths["analysis"] = launches
        if abs(len(hits) / len(test_buf) - hr) > 0.01:
            fail(f"find_hits' hit share {len(hits) / len(test_buf):.6f} is not the test HR@10 "
                 f"{hr:.6f}")
        if not all(r["true_action"] in [p["item"] for p in r["predictions"]] for r in records):
            fail("predict_and_describe: a hit row's true action is not in its top-10")
        if "row " not in open(html_path).read() or len(records) != 3:
            fail("render_predictions_html wrote no record")
        if not all(len(t) == 6 and all(0 <= x < RR_CATALOG for x in t) for t in trajs):
            fail(f"sample_trajectories gave {trajs}")
        emb = np.load(os.path.join(out, "embedding_weights.npy"))
        queries = np.unique(test_buf.action)[:16]
        ids, sims = embeddings.nearest_neighbors(emb, queries, k=10, device="cuda")
        ids_ref, sims_ref = embeddings.nearest_neighbors(emb, queries, k=11, device="cpu")
        check_topk(torch.as_tensor(sims), torch.as_tensor(ids), torch.as_tensor(sims_ref),
                   torch.as_tensor(ids_ref), 10, ref="the CPU's nearest_neighbors")
        if (ids == queries[:, None]).any():
            fail("nearest_neighbors returned a query as its own neighbour")
        states, lens = test_buf.state[:512], test_buf.true_len[:512]
        top1 = rec.recommend(states, lens, k=1)[1][:, 0]
        scores = rec.scores(states, lens)
        gap = (scores.max(dim=1).values - scores.gather(1, top1[:, None])[:, 0]).max().item()
        if not (torch.isfinite(scores).all() and gap <= GAP):
            fail(f"the trained model's served top-1 is not its head's argmax ({gap:.3g})")
        print(f"[retailrocket] analysis on the trained gru4rec: find_hits {len(hits)} of "
              f"{len(test_buf)} test rows ({len(hits) / len(test_buf):.6f}; HR@10 {hr:.6f}), "
              f"predict_and_describe on 3 hits, render_predictions_html, sample_trajectories "
              f"{trajs[0]}, nearest_neighbors of {len(queries)} items on the exported "
              f"{emb.shape} embedding (held to the CPU's); served top-1 the head's argmax "
              f"(gap {gap:.3g}); {time.perf_counter() - t0:.1f} s; launches "
              f"{json.dumps(launches)}")

    # the scaling bench's (1, 1) point in this process, no other rank on the card
    from ikea_recommender_tpu_torch.core.mesh import MeshSpec
    from ikea_recommender_tpu_torch.parallel.scaling_bench import run_scaling_bench

    warmup, iters = RR_SCALING_STEPS
    torch.cuda.synchronize()
    reset_counters()
    (alone,) = run_scaling_bench(model="smorl", mesh_specs=[MeshSpec(1, 1)], warmup=warmup,
                                 iters=iters, backend="gloo", device="cuda")
    torch.cuda.synchronize()
    launches = counters()
    check_launches("smorl", launches, warmup + iters)
    paths["scaling smorl, one process"] = launches
    print(f"[retailrocket] scaling smorl (1, 1) in this process: {1000 / alone.steps_per_sec:.3f} "
          f"ms a step, {alone.sessions_per_sec:.1f} sessions/s; {smi}")

    # the scaling bench on ranks that share the card
    t0 = time.perf_counter()
    ranks = mesh_spawn((2, 1), "gloo", [("scaling", None)])
    got = [r["scaling"] for r in ranks]
    if any(r["points"] != got[0]["points"] for r in got[1:]):
        fail("scaling bench: the ranks' points differ")
    for r, res in enumerate(got):
        want = {name: PER_STEP["smorl"].get(name, 0) * res["steps"] for name in res["launches"]}
        if res["launches"] != want:
            fail(f"scaling bench rank {r}: {res['steps']} smorl steps launched "
                 f"{res['launches']}, expected {want}")
    paths["scaling smorl"] = {name: sum(r["launches"][name] for r in got)
                              for name in got[0]["launches"]}
    for p in got[0]["points"]:
        if not (p["sessions_per_sec"] > 0 and p["cards"] == 1
                and p["shared_card"] == (p["mesh"]["data"] * p["mesh"]["model"] > 1)):
            fail(f"scaling bench point {p}")
        print(f"[retailrocket] scaling smorl (catalog 70852, E=H=64, 256 rows a rank) "
              f"{json.dumps(p)}; {smi}")
    print(f"[retailrocket] scaling bench {time.perf_counter() - t0:.1f} s; a point with "
          f"shared_card true is ranks time-slicing one card over gloo, not a scaling "
          f"efficiency")
    print(f"[retailrocket] phase: {time.perf_counter() - t_phase:.1f} s")
    return paths


# The IKEA rehearsal at the script's defaults (scripts/ikea_rehearsal.py), and
# what its synth and buffers give there (the script's output, numpy 2.0.2):
# the sha256 of the files, and of each buffer's arrays in sorted key order
# (name, str(dtype), C-order bytes of each, one digest a buffer).
IKEA_ACTIONS = 10000
IKEA_COUNTS = {"events": 2550083, "insp_clicks": 786870}
IKEA_META = {"num_items": 110000, "num_actions": IKEA_ACTIONS, "padding_id": 110000,
             "state_len": 10, "future_steps": 3,
             "windows": {"train": 755402, "val": 15709, "test": 15759}}
IKEA_FILE_DIGESTS = {
    "input_tokenizer.json": "bc8c5dfaa1c93860448f1ca709b2b3a9aef81f13b2ae2c5bf268360e1e79da3d",
    "output_tokenizer.json": "7171063d5de2dc75117edc1184a4234eeac9e363fa93d4e9e9185588f9af94de",
    "meta.json": "31b5476ddaf67993404eb89b1ba5a8b39efea0c667a50d769f2cc544dc17cb6c",
}
IKEA_BUFFER_DIGESTS = {
    "replay_buffer.npz": "094b2be7f543eddefbc3b6f6454462fc880599ba12e5d0da2d4b0523be8dd91b",
    "val_buffer.npz": "d940d01f6e32119c804350ff875bdfbd3b1d27df15114b3fc4ea8ea2ec560ed0",
    "test_buffer.npz": "0ca3752485f6a518c2b40c50552b6e9716ba86cdd84cc81e7c198211ebdbb178",
}
IKEA_LEGS = (("gru4rec", "0.0005"), ("smorl", "0.01"))  # the script's docstring's rates
IKEA_HR_FLOOR = 0.012  # 10x chance (12 of 10000) for the test HR@12
# the keys of the script's run_summary.json (scripts/ikea_rehearsal.py:270-285)
IKEA_SUMMARY_KEYS = {"family", "epochs", "best_metric", "best_epoch", "test_metrics",
                     "train_sessions_per_sec", "timing", "div_emb", "preset", "logs"}


def npz_digest(path):
    """sha256 over an ``.npz``'s arrays in sorted key order: each one's
    name, ``str(dtype)`` and C-order bytes."""
    import hashlib

    digest = hashlib.sha256()
    with np.load(path) as data:
        for key in sorted(data.files):
            arr = np.ascontiguousarray(data[key])
            digest.update(key.encode())
            digest.update(str(arr.dtype).encode())
            digest.update(arr.tobytes())
    return digest.hexdigest()


def ikea_data(tmp):
    """synth and buffers at the script's defaults under ``tmp``, held to
    the script's counts and digests; returns (buffers dir, host seconds)."""
    import hashlib

    from ikea_recommender_tpu_torch.run import ikea_rehearsal as ir

    data, bufs = f"{tmp}/data", f"{tmp}/buffers"
    secs = {}
    for cmd, argv in (("synth", ["synth", "--out", data]),
                      ("buffers", ["buffers", "--data", data, "--out", bufs])):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as said:
            ir.main(argv)
        secs[cmd] = time.perf_counter() - t0
        for line in said.getvalue().splitlines():
            print(f"[ikea] {line}")
    synth_meta = json.load(open(os.path.join(data, "synth_meta.json")))
    meta = json.load(open(os.path.join(bufs, "meta.json")))
    digests = {name: hashlib.sha256(open(os.path.join(bufs, name), "rb").read()).hexdigest()
               for name in IKEA_FILE_DIGESTS}
    digests.update({name: npz_digest(os.path.join(bufs, name)) for name in IKEA_BUFFER_DIGESTS})
    print(f"[ikea] digests {json.dumps(digests)}")
    if {k: synth_meta[k] for k in IKEA_COUNTS} != IKEA_COUNTS:
        fail(f"ikea synth gave {synth_meta}, not {IKEA_COUNTS}")
    if meta != IKEA_META:
        fail(f"ikea buffers gave {meta}, not {IKEA_META}")
    wrong = [n for n, d in digests.items() if d != {**IKEA_FILE_DIGESTS, **IKEA_BUFFER_DIGESTS}[n]]
    if wrong:
        fail(f"ikea buffers: {wrong} differ from the script's output")
    # the unpopular ids: the bottom 40% by train frequency (ties in any order)
    unpop = json.load(open(os.path.join(bufs, "unpopular_items.json")))
    with np.load(os.path.join(bufs, "replay_buffer.npz")) as buf:
        freq = np.bincount(buf["action"], minlength=IKEA_ACTIONS)
    chosen = np.zeros(IKEA_ACTIONS, bool)
    chosen[unpop] = True
    n_unpop = int(IKEA_ACTIONS * 0.4)
    if len(unpop) != n_unpop or chosen.sum() != n_unpop or freq[chosen].max() > freq[~chosen].min():
        fail(f"ikea unpopular_items.json: {len(unpop)} ids, the most frequent chosen "
             f"{freq[chosen].max()} against the least frequent left out {freq[~chosen].min()}")
    return bufs, secs


def phase_ikea(smi):
    """The IKEA flavor without pandas (``run/ikea_rehearsal.py``): synth and
    buffers at the script's defaults, then gru4rec and smorl one epoch each
    through ``run`` on the card. Returns each leg's launches."""
    import tempfile

    from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer, num_batches
    from ikea_recommender_tpu_torch.run import ikea_rehearsal as ir
    from ikea_recommender_tpu_torch.run.checkpoints import flatten_params

    t_phase = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ikea_") as tmp:
        bufs, secs = ikea_data(tmp)
        print(f"[ikea] synth and buffers at the script's defaults: {IKEA_COUNTS['events']} "
              f"events, {IKEA_COUNTS['insp_clicks']} clicks, windows "
              f"{json.dumps(IKEA_META['windows'])}, vocabularies {IKEA_META['num_items']} in "
              f"and {IKEA_ACTIONS} out, digests equal to the script's; host s "
              f"{json.dumps({k: round(v, 3) for k, v in secs.items()})}")
        n_b = num_batches(IKEA_META["windows"]["train"], 256)
        n_val, n_test = (num_batches(len(EvalBuffer(os.path.join(bufs, f"{s}_buffer.npz"))), 5000)
                         for s in ("val", "test"))
        for family, lr in IKEA_LEGS:
            out = f"{tmp}/runs/{family}_run"
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            reset_counters()
            with contextlib.redirect_stdout(io.StringIO()):
                outcome = ir.main(["run", "--buffers", bufs, "--family", family, "--epochs", "1",
                                   "--lr", lr, "--out", out])
            torch.cuda.synchronize()
            launches = counters()
            run_s = time.perf_counter() - t0
            want = trainer_launches(family, outcome, n_b, n_val, n_test)
            if launches != want:
                fail(f"ikea run {family} launched {launches}, expected {want}")
            check_logs(f"ikea {family}", outcome)
            paths[f"ikea {family}"] = launches
            summary = json.load(open(os.path.join(out, "run_summary.json")))
            if set(summary) != IKEA_SUMMARY_KEYS:
                fail(f"ikea {family} run_summary.json keys {sorted(summary)}")
            params = flatten_params(outcome.best_params)
            shapes = (params["sup_head/kernel"].shape, params["backbone/embedding"].shape)
            if shapes != ((64, IKEA_ACTIONS), (IKEA_META["num_items"] + 1, 64)):
                fail(f"ikea {family}: head and embedding {shapes}")
            tm = summary["test_metrics"]
            if not tm["Test_HR@12"] > IKEA_HR_FLOOR:
                fail(f"ikea {family}: test HR@12 {tm['Test_HR@12']} <= {IKEA_HR_FLOOR}")
            rewards = {k: v for k, v in tm.items() if "Div_Reward" in k or "Nov_Reward" in k}
            if family == "smorl":
                emb = np.load(summary["div_emb"], mmap_mode="r").shape
                if emb != shapes[1] or "gru4rec_run" not in summary["div_emb"]:
                    fail(f"ikea smorl read the embedding {summary['div_emb']} {emb}")
                if not any(v != 0 for k, v in rewards.items() if "Div_Reward" in k):
                    fail(f"ikea smorl: test Div_Reward is zero {rewards}")
            ranks = {f"{m}@{k}": round(tm[f"Test_{m}@{k}"], 6) for m in ("HR", "NDCG")
                     for k in (1, 6, 12)}
            print(f"[ikea] run {family} 1 epoch (lr {lr}, batch 256, val batch 5000, E=H=64, "
                  f"{IKEA_ACTIONS} output columns, train metrics on): {n_b} steps, "
                  f"{summary['train_sessions_per_sec']:.0f} sessions/s of the train loop, "
                  f"test {json.dumps(ranks)}, rewards "
                  f"{json.dumps({k: round(v, 6) for k, v in rewards.items()})}, best "
                  f"{summary['best_metric']:.6f} @ eval point {summary['best_epoch']}; "
                  f"{run_s:.1f} s; launches {json.dumps(launches)}; {smi}")
    print(f"[ikea] phase: {time.perf_counter() - t_phase:.1f} s")
    return paths


# -- 15. the experiment workflow: staging scripts and the directory sweep ------

SYNTH_ITEMS = 200  # run/prepare_synthetic.py's NUM_ITEMS


def write_sessions(path, items, sids):
    """Session rows (``session_id``, ``item_id``, ``reward`` 1) as a CSV
    file or JSON lines, written with the csv and json modules."""
    import csv

    with open(path, "w", newline="") as fh:
        if path.endswith(".csv"):
            out = csv.writer(fh, lineterminator="\n")
            out.writerow(("session_id", "item_id", "reward"))
            out.writerows((int(s), int(i), 1) for s, i in zip(sids, items))
        else:
            fh.writelines(json.dumps({"session_id": int(s), "item_id": int(i), "reward": 1}) + "\n"
                          for s, i in zip(sids, items))


def same_npz(got_path, want_path):
    """Whether two ``.npz`` files hold the same keys, dtypes and values."""
    with np.load(got_path) as got, np.load(want_path) as want:
        return sorted(got.files) == sorted(want.files) and all(
            got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
            for k in want.files)


def phase_workflow(smi):
    """The experiment workflow through the user's entry points
    (``run/{prepare_synthetic,build_replay_buffer,build_unpopular_items,
    run_all_experiments_in_dir}.py``): (a) the synthetic experiment; (b)
    phase 10's sessions as a CSV train split and JSON-lines val and test
    splits, staged into buffers equal to the ones ``trainer_experiment``
    builds, and the unpopular set of the train split; (c) the directory
    sweep over (a)'s smorl YAML and a gru4rec YAML at the RetailRocket width
    on (b)'s buffers. Returns the sweep's launches."""
    import tempfile

    from ikea_recommender_tpu_torch.core.config import load_experiment_config
    from ikea_recommender_tpu_torch.data.item_frequency import get_low_frequency_items
    from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer, ReplayBuffer, num_batches
    from ikea_recommender_tpu_torch.data.split import train_test_split_ids
    from ikea_recommender_tpu_torch.data.synthetic import synthetic_sessions
    from ikea_recommender_tpu_torch.run import build_replay_buffer, build_unpopular_items
    from ikea_recommender_tpu_torch.run import prepare_synthetic
    from ikea_recommender_tpu_torch.run import run_all_experiments_in_dir as sweep

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_workflow_") as tmp:
        # (a) the synthetic experiment, as the quick start makes it
        t0 = time.perf_counter()
        synth = os.path.join(tmp, "synth")
        with contextlib.redirect_stdout(io.StringIO()) as said:
            prepare_synthetic.main(synth)
        if sorted(os.listdir(synth)) != ["experiment.yaml", "test.npz", "train.npz",
                                         "unpopular.json", "val.npz"]:
            fail(f"prepare_synthetic wrote {sorted(os.listdir(synth))}")
        print(f"[workflow] prepare_synthetic: {said.getvalue().strip()} "
              f"({time.perf_counter() - t0:.2f} s)")

        # (b) phase 10's sessions as session files, staged into buffers
        ref = os.path.join(tmp, "trainer_experiment")
        os.makedirs(ref)
        trainer_experiment(ref)
        t0 = time.perf_counter()
        items, sids = synthetic_sessions(TRAINER_SESSIONS, TRAINER_A, mean_len=8, seed=7)
        masks = dict(zip(("train", "val", "test"),
                         train_test_split_ids(sids, ratio=TRAINER_SPLIT, seed=118)))
        files = {}
        for split, mask in masks.items():
            files[split] = os.path.join(tmp, "sessions", f"{split}.{'csv' if split == 'train' else 'jsonl'}")
            os.makedirs(os.path.dirname(files[split]), exist_ok=True)
            write_sessions(files[split], items[mask], sids[mask])
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        bufs = os.path.join(tmp, "buffers")
        staged = {}
        for split, path in files.items():
            out = os.path.join(bufs, split)
            argv = ["-f", path, "-o", out, "--padding-id", str(TRAINER_A),
                    "--state-len", str(TRAINER_T)] + (["--eval"] if split != "train" else [])
            with contextlib.redirect_stdout(io.StringIO()) as said:
                build_replay_buffer.main(argv)
            print(f"[workflow] build_replay_buffer {split}: {said.getvalue().strip()}")
            staged[split] = os.path.join(
                out, "replay_buffer.npz" if split == "train" else "eval_buffer.npz")
            if not same_npz(staged[split], os.path.join(ref, f"{split}.npz")):
                fail(f"the {split} buffer staged from {os.path.basename(path)} differs from "
                     f"trainer_experiment's")
        with contextlib.redirect_stdout(io.StringIO()):
            build_unpopular_items.main(["-f", files["train"], "-t", bufs])
        unpop = json.load(open(os.path.join(bufs, "unpopular_items.json")))
        want = [int(i) for i in get_low_frequency_items(items[masks["train"]], 0.9)]
        if unpop != want:
            fail(f"build_unpopular_items gave {len(unpop)} ids, not the train split's {len(want)}")
        t_stage = time.perf_counter() - t0
        print(f"[workflow] sessions: {sum(int(m.sum()) for m in masks.values())} rows written "
              f"(train CSV, val/test JSON lines) in {t_write:.2f} s; buffers and "
              f"{len(unpop)} unpopular ids staged in {t_stage:.2f} s, each buffer equal to "
              f"trainer_experiment's, array for array")

        # (c) the sweep: (a)'s smorl YAML, its fused head switched on at 200
        # items, and gru4rec at the RetailRocket width on (b)'s buffers
        configs, root = os.path.join(tmp, "configs"), os.path.join(tmp, "experiments")
        os.makedirs(configs)
        text = open(os.path.join(synth, "experiment.yaml")).read()
        if text.count('  model: "smorl"\n') != 1:
            fail("prepare_synthetic's YAML does not train smorl")
        with open(os.path.join(configs, "smorl-synth.yaml"), "w") as fh:
            fh.write(text.replace('  model: "smorl"\n',
                                  '  model: "smorl"\n  fused_ce_min_actions: 0\n'))
        with open(os.path.join(configs, "gru4rec-rr.yaml"), "w") as fh:
            fh.write(f"""exp_class: "workflow"
exp_name: "gru4rec-rr"
experiment:
  seed: 118
data:
  train_path: "{staged['train']}"
  val_path: "{staged['val']}"
  test_path: "{staged['test']}"
  num_items: {TRAINER_A}
train:
  model: "gru4rec"
  batch_size: {TRAINER_B}
  val_batch_size: {EVAL_BATCH}
  epochs: 1
  learning_rate: 0.01
  embedding_size: 64
  hidden_state_size: 64
  state_size: {TRAINER_T}
  fused_ce: true
  head_precision: "high"
  best_model_metric: "Val_NDCG@10"
  eval_at: [1]
metrics:
  unpopular_actions_path: "{bufs}/unpopular_items.json"
  topk_cov: [1, 5, 10, 20]
  topk_hr_ndcg: [10, 20]
""")
        outcomes = []
        train = sweep.train
        sweep.train = lambda *a, **k: outcomes.append(train(*a, **k)) or outcomes[-1]
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            torch.cuda.synchronize()
            reset_counters()
            with contextlib.redirect_stdout(out):
                rc = sweep.main([configs, "--root", root])
            torch.cuda.synchronize()
            launches = counters()
        finally:
            sweep.train = train
        t_sweep = time.perf_counter() - t0
        for line in out.getvalue().splitlines():
            print(f"[workflow] sweep: {line}")
        if rc != 0:
            fail(f"the sweep exited {rc}")
        runs = (("gru4rec", "workflow/gru4rec-rr", "gru4rec-rr.yaml", staged["train"],
                 staged["val"], staged["test"]),
                ("smorl", "synthetic/smorl-synth", "smorl-synth.yaml",
                 *(os.path.join(synth, f"{s}.npz") for s in ("train", "val", "test"))))
        if len(outcomes) != 2 or os.listdir(configs):
            fail(f"the sweep trained {len(outcomes)} experiments, left {os.listdir(configs)}")
        want = {name: 0 for name in counters()}
        for (family, sub, name, train_path, val_path, test_path), res in zip(runs, outcomes):
            exp = os.path.join(root, sub)
            for f in (name, "best_model.npz", "test_metrics.json"):
                if not os.path.exists(os.path.join(exp, f)):
                    fail(f"the sweep's {sub} holds no {f}: {sorted(os.listdir(exp))}")
            check_logs(f"workflow {family}", res)
            epochs = load_experiment_config(os.path.join(exp, name)).train.epochs
            n_b = num_batches(len(ReplayBuffer(train_path)), TRAINER_B)
            n_val, n_test = (num_batches(len(EvalBuffer(p)), EVAL_BATCH)
                             for p in (val_path, test_path))
            run_want = trainer_launches(family, res, epochs * n_b, n_val, n_test)
            want = {k: want[k] + run_want[k] for k in want}
            tm = json.load(open(os.path.join(exp, "test_metrics.json")))
            print(f"[workflow] {sub}: {family} {epochs} x {n_b} steps, "
                  f"{res.throughput_sessions_per_sec:.0f} sessions/s of the train loop, best "
                  f"{res.best_metric:.6f} @ eval point {res.best_epoch}, test HR@10 "
                  f"{tm['Test_HR@10']:.6f}; launches it owes "
                  f"{json.dumps({k: v for k, v in run_want.items() if v})}; {smi}")
        if launches != want:
            fail(f"the sweep launched {launches}, expected {want}")
        print(f"[workflow] sweep: rc 0 in {t_sweep:.1f} s; each YAML moved beside its "
              f"best_model.npz and test_metrics.json; launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}")
    print(f"[workflow] phase: {time.perf_counter() - t_phase:.1f} s")
    return {"workflow": launches}


# -- 16. the spot runs of the 16 mirrored experiment classes -------------------

# (c): main as a user runs it, over one copy of each flavor
SPOT_MAIN = ("experiments/paper/playing/play_around/play_around.yaml",
             "experiments/IKEA/first_runs/IKEA_GRU_right_tokenizer_smallerBS/"
             "IKEA_GRU_right_tokenizer_smallerBS.yaml")


def phase_spot(smi):
    """The spot runs (``run/spot_run_experiments.py``): (a) the 16 default
    configs' run copies staged by ``make_run_copy`` into a temporary root;
    (b) each copy trained in this process through ``run.cli.main`` on the
    card, rc 0, a finite ``test_metrics.json`` beside the copy, the dense
    head arm (catalogs 500 and 60 are under ``FUSED_CE_MIN_ACTIONS``) and
    exactly the launches ``trainer_launches`` owes; (c) ``main`` in a
    subprocess over ``SPOT_MAIN``, as a user runs it. Returns (b)'s
    launches."""
    import math
    import tempfile

    from ikea_recommender_tpu_torch.core.config import load_experiment_config
    from ikea_recommender_tpu_torch.data.replay_buffer import EvalBuffer, ReplayBuffer, num_batches
    from ikea_recommender_tpu_torch.data.tokenizer import Tokenizer
    from ikea_recommender_tpu_torch.models.families import model_config_from_train
    from ikea_recommender_tpu_torch.run import cli
    from ikea_recommender_tpu_torch.run import spot_run_experiments as spot

    t_phase = time.perf_counter()
    total = {name: 0 for name in counters()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spot_") as tmp:
        # (a) stage the run copies
        root = os.path.join(tmp, "spot")
        t0 = time.perf_counter()
        dsts = [spot.make_run_copy(os.path.join(spot.REPO, src), root) for src in spot.DEFAULTS]
        staged = sorted(d for d in os.listdir(root) if d != "runs")
        print(f"[spot] staged {len(dsts)} run copies and the data dirs {staged} in "
              f"{time.perf_counter() - t0:.2f} s")

        # (b) each copy through the CLI in this process, its counters reset
        outcomes = []
        train = cli.train
        cli.train = lambda *a, **k: outcomes.append(train(*a, **k)) or outcomes[-1]
        t_runs = time.perf_counter()
        try:
            for i, dst in enumerate(dsts):
                cfg = load_experiment_config(dst)
                t_cfg, what = cfg.train, f"{cfg.experiment.exp_class}/{cfg.experiment.exp_name}"
                if cfg.data.output_tokenizer:  # the trainer's action count
                    cfg.data.num_actions = len(Tokenizer.from_file(cfg.data.output_tokenizer)) - 1
                mc = model_config_from_train(t_cfg, cfg.data)
                if mc.fused_ce:
                    fail(f"spot {what}: the head took the fused arm at {mc.action_dim} actions")
                n_b = num_batches(len(ReplayBuffer(cfg.data.train_path)), t_cfg.batch_size)
                n_val, n_test = (num_batches(len(EvalBuffer(p)), t_cfg.val_batch_size)
                                 for p in (cfg.data.val_path, cfg.data.test_path))
                points = t_cfg.epochs * len({int(n_b * p) for p in t_cfg.eval_at} - {0})
                out = io.StringIO()
                t0 = time.perf_counter()
                torch.cuda.synchronize()
                reset_counters()
                with contextlib.redirect_stdout(out):
                    rc = cli.main(["-f", dst, "--device", "cuda"])
                torch.cuda.synchronize()
                launches = counters()
                secs = time.perf_counter() - t0
                if rc != 0 or len(outcomes) != i + 1:
                    fail(f"spot {what}: the CLI exited {rc}")
                res = outcomes[-1]
                check_logs(f"spot {what}", res)
                path = os.path.join(os.path.dirname(dst), "test_metrics.json")
                tm = json.load(open(path)) if os.path.exists(path) else {}
                if not tm or not all(math.isfinite(v) for v in tm.values()):
                    fail(f"spot {what}: test_metrics.json {tm or 'missing'}")
                if len(res.logs) != points:
                    fail(f"spot {what}: {len(res.logs)} eval points, expected {points}")
                if cfg.metrics.action_type_names and not any("[" in k for k in res.logs[-1]):
                    fail(f"spot {what}: no per-action-type metric logged")
                want = trainer_launches(t_cfg.model, res, t_cfg.epochs * n_b, n_val, n_test,
                                        train_metrics=cfg.metrics.train_metrics, dense=True,
                                        layers=t_cfg.gru_layers)
                if launches != want:
                    fail(f"spot {what} launched {launches}, expected {want}")
                total = {k: total[k] + launches[k] for k in total}
                print(f"[spot] {what}: {t_cfg.model} x{t_cfg.gru_layers} layer(s), E "
                      f"{t_cfg.embedding_size} H {t_cfg.hidden_state_size} T {t_cfg.state_size}, "
                      f"{n_b} steps of {t_cfg.batch_size}, {mc.action_dim} actions (dense); "
                      f"{secs:.2f} s, {res.throughput_sessions_per_sec:.0f} sessions/s of the "
                      f"train loop; best {t_cfg.best_model_metric}={res.best_metric:.6f} @ eval "
                      f"point {res.best_epoch} of {points}; launches "
                      f"{json.dumps({k: v for k, v in launches.items() if v})}; {smi}")
        finally:
            cli.train = train
        t_runs = time.perf_counter() - t_runs

    # (c) main as a user runs it, one process a copy; its staging under the
    # checkout's data/spot, as the script's
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m",
                          "ikea_recommender_tpu_torch.run.spot_run_experiments", *SPOT_MAIN],
                         cwd=spot.REPO, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    said = res.stdout.splitlines()
    for line in said:
        if line.startswith(("===", "best ", "all ", "FAILED", "  experiments/")):
            print(f"[spot] main: {line}")
    if res.returncode != 0 or not said or said[-1] != f"all {len(SPOT_MAIN)} spot-runs passed":
        fail(f"spot_run_experiments exited {res.returncode}: {res.stderr[-2000:]}")
    print(f"[spot] {len(dsts)} runs in this process {t_runs:.1f} s; main over {len(SPOT_MAIN)} "
          f"copies in a subprocess {secs:.1f} s; launches of the {len(dsts)} "
          f"{json.dumps({k: v for k, v in total.items() if v})}")
    print(f"[spot] phase: {time.perf_counter() - t_phase:.1f} s")
    return {"spot": total}


class SimpleOutcome:
    """The parts of a ``TrainOutcome`` that ``trainer_launches`` and
    ``check_logs`` read."""

    def __init__(self, test, logs=(), pretrain=None):
        self.test_metrics, self.logs = test, list(logs)
        self.pretrain_metrics = test if pretrain is None else pretrain


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    profile = "--profile" in sys.argv[1:]
    # each path's launches, its counters reset just before its timed run
    paths = {"serving": {"B3 gru_fwd": phase_serving(profile=profile)},
             "gru4rec": phase_train("gru4rec", profile=profile)}
    for family in ("sqn", "smorl"):
        paths[family] = phase_double_q(family, profile=profile)
    paths["sarm"] = phase_sarm(profile=profile)
    for family in ("sqn", "smorl", "sarm"):
        paths[f"{family} fast"] = phase_fast(family, profile=profile)
    paths["bidir_gru4rec"] = phase_train("bidir_gru4rec", profile=profile)
    # compute_dtype: bfloat16, B3 and B4 on bf16 tensors
    paths["serving bf16"] = {"B3 gru_fwd bf16": phase_serving(profile=profile, dtype="bfloat16")}
    for name in ("gru4rec bf16", "bidir2 bf16"):
        paths[name] = phase_train(name, profile=profile)
    paths["sqn fast bf16"] = phase_fast("sqn", profile=profile, dtype="bfloat16")
    paths["eval"] = phase_eval("gru4rec", smi, profile=profile)
    paths["eval_bidir_gru4rec"] = phase_eval("bidir_gru4rec", smi, profile=profile)
    paths["eval bf16"] = phase_eval("gru4rec", smi, profile=profile, dtype="bfloat16")
    paths.update(phase_trainer(smi, profile=profile))
    paths.update(phase_mesh(smi))
    paths.update(phase_mesh_trainer(smi))
    paths.update(phase_retailrocket(smi))
    paths.update(phase_ikea(smi))
    paths.update(phase_workflow(smi))
    paths.update(phase_spot(smi))
    # the card's machine has jax installed: show the port never loaded it,
    # nor pandas (the RetailRocket protocol runs without it)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "ikea_recommender_tpu", "pandas"))
    if loaded:
        fail(f"the port loaded {loaded[:5]}")
    meta = {
        "B1 fused_ce_fwd": ("fused_ce.cu", "ikea_recommender_tpu/ops/fused_ce.py:106",
                            "F.cross_entropy(addmm(b, h, W)), fp32 cuBLAS"),
        "B2 fused_ce_bwd": ("fused_ce.cu", "ikea_recommender_tpu/ops/fused_ce.py:187",
                            "the backward of that expression (autograd)"),
        "B3 gru_fwd": ("gru_fwd.cu", "ikea_recommender_tpu/ops/gru_pallas.py:92",
                       "torch.nn.GRU (cuDNN): also computes the input projection, no "
                       "mask; not the same function"),
        "B4 gru_bwd": ("gru_bwd.cu", "ikea_recommender_tpu/ops/gru_pallas.py:154",
                       "torch.nn.GRU backward (cuDNN), no mask; not the same function"),
        # the same kernels' bf16 instantiations (compute_dtype: bfloat16)
        "B3 gru_fwd bf16": ("gru_fwd.cu", "ikea_recommender_tpu/ops/gru_pallas.py:92",
                            "torch.nn.GRU in bf16 (cuDNN): also computes the input "
                            "projection, no mask; not the same function"),
        "B4 gru_bwd bf16": ("gru_bwd.cu", "ikea_recommender_tpu/ops/gru_pallas.py:154",
                            "torch.nn.GRU backward in bf16 (cuDNN), no mask; not the same "
                            "function"),
        "B5 fused_argmax": ("fused_argmax.cu", "ikea_recommender_tpu/ops/fused_argmax.py:48",
                            "argmax(addmm(b, h, W)), fp32 cuBLAS"),
        "B6 fused_wargmax": ("fused_argmax.cu", "ikea_recommender_tpu/ops/fused_argmax.py:144",
                             "argmax of the weighted sum of the dense (K, B, A) heads, "
                             "fp32 cuBLAS"),
    }
    kernels = []
    for name, (source, replaces, library) in meta.items():
        row = rows[name]
        # B5's and B6's action-major launches count as theirs
        by_path = {path: counts.get(name, 0) + counts.get(f"{name} am", 0)
                   for path, counts in paths.items()}
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"ikea_recommender_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": library,
            "shape": {k: row[k] for k in SHAPE_KEYS if k in row},
        }
        if "library_call_ms" in row:
            entry["library_call_ms"] = row["library_call_ms"]
        if name == "B3 gru_fwd":
            serving = rows["B3 serving"]
            entry.update(serving_ms=serving["ms"], serving_bound_ms=serving["bound_ms"])
            for key in ("eval", "eval bidir"):  # B = 2000: (2000, 10, 64), (2000, 10, 128)
                point = rows[f"B3 {key}"]
                entry.update({f"{key.replace(' ', '_')}_{k}": point[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        if name == "B3 gru_fwd bf16":
            for key in ("serving", "eval"):  # (512, 10, 64), (2000, 10, 64)
                point = rows[f"B3 bf16 {key}"]
                entry.update({f"{key}_{k}": point[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        if f"{name} bidir2" in rows:  # (256, 20, 128); bf16: reverse
            entry.update({f"bidir2_{k}": rows[f"{name} bidir2"][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        # the bidir_gru4rec point's figures; the action-major form's at the
        # fast points ("default"; its launches "am_launches"); the fast
        # preset's "default" and the reference preset's "highest"; the IKEA
        # train point's (A = 10000) and B3's at the IKEA eval batch (5000);
        # B1, B2 and B6 at prepare_synthetic's 200 items (the workflow); B3
        # and B4 at the spot runs' points: bidir2's eval batch (512, 20,
        # 128), batch 64 (64, 10, 64) and B4 at batch 2000 (2000, 10, 64)
        for tag, key in (("bidir", f"{name} bidir"), ("am", f"{name} am"),
                         ("default", f"{name} default"), ("highest", f"{name} highest"),
                         ("am_highest", f"{name} am highest"), ("ikea", f"{name} ikea"),
                         ("ikea_eval", f"{name} ikea eval"), ("synth", f"{name} synth"),
                         ("bidir2_eval", f"{name} bidir2 eval"), ("b64", f"{name} b64"),
                         ("b2000", f"{name} b2000")):
            if key in rows:
                entry.update({f"{tag}_{k}": rows[key][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        if f"{name} am" in rows:
            entry["am_launches"] = sum(c.get(f"{name} am", 0) for c in paths.values())
        kernels.append(entry)
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
