#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels to
their plain twins.

    python3 chip_smoke.py             # from the repository root, one card
    python3 chip_smoke.py --profile   # adds where a serving batch's and a
                                      # train step's time goes

Phases; any failure ends the run with a non-zero exit and no result line:
1. device: card name and power limit, torch and CUDA versions, TF32 off;
2. build: every CUDA kernel of the serving and train paths, one ``nvcc``
   per source in ``ikea_recommender_tpu_torch/csrc``, all started together;
3. kernels: each kernel against its plain twin on the card at the shapes
   the two paths give it and at longer, wider and padded ones, with the
   kernel's time, the twin's, its bound and one PyTorch call's as a
   yardstick: B3 gru_fwd and B4 gru_bwd (the GRU recurrence and its
   adjoint), B1 fused_ce_fwd and B2 fused_ce_bwd (the softmax CE over the
   catalog and its gradients);
4. serving: gru4rec at the RetailRocket width (catalog 70852, E=H=64,
   T=10, one layer; random weights from a seed) answers 4 batches of 512
   seeded sessions through ``run.recommend.recommend_rows``. The launch
   counters, reset just before, show the kernels ran; top-1 must be the
   argmax of the full scores, and the timed batches' records must match a
   run through the plain recurrence: scores within 1e-5 (plus the
   records' 6-digit rounding), ids wherever adjacent top-k values differ
   by > 1e-5;
5. train: the gru4rec train step at the same width (batch 256, lr 0.01,
   fused CE in "high" precision, fp32 Adam; params from a seed, batches as
   bench.py draws them plus one with a padded tail) through
   ``train.steps.make_train_step``: 3 steps held to the same 3 steps on
   CPU copies (where the twins run), then 1 warm-up and 20 timed steps,
   whose launch counters, reset just before, must show B1, B2, B3 and B4
   once per step.
   Afterwards neither jax nor the reference package may be loaded.

The card's name and power limit, as nvidia-smi prints them, come on a line
of their own; the line before the last is a JSON object listing each
kernel with its launches on the train run (B3 also on the serving run), its
error against the twin, its time, the twin's time, its bound and the
yardstick's time; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
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

SOURCES = ("gru_fwd", "gru_bwd", "fused_ce")
# Kernel against twin, for each output: max |kernel - twin| <= KERNEL_TOL *
# max |twin| (fp32, sums in other orders; B3 also elementwise, as before).
# B2's dW and db are also held on the columns that no row labels, where
# only the softmax term lands (~1e-6 there against ~1e-2 at a label).
KERNEL_TOL = 1e-5
SHAPE_KEYS = ("B", "T", "H", "F", "A", "valid", "masked", "reverse", "precision")

GAP = 1e-5  # ids are compared where adjacent top-k values differ by more


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def graph_ms(fn, n):
    """Device time per call: ``n`` calls captured in one CUDA graph,
    replayed 5 times after a warm-up; median replay / n."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
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


def gru_bound(B, T, H, mask):
    """Least time for the recurrence, over the (b, t) steps the mask lets
    through: their xw rows read once (a masked-off step only carries h),
    W_h, b_h and the mask read once, all of y and h_fin written once; and
    those steps' h W_h FMAs (gate arithmetic, ~5% more, not counted)."""
    active = B * T if mask is None else float(mask.sum())
    n_bytes = 4 * (3 * H * active + H * 3 * H + 3 * H + B * T * H + B * H)
    n_bytes += 0 if mask is None else 4 * B * T
    return bound(n_bytes, 2.0 * 3 * H * H * active, FP32_FLOPS)


def gru_bwd_bound(B, T, H, mask):
    """Least time for the adjoint recurrence: over the (b, t) steps the mask
    lets through, their xw rows and h_prev read, and three H x 3H products
    (recompute h W_h, dhw W_h^T, h^T dhw); gy, the mask, g_hfin, W_h and b_h
    read once; dxw, dW_h and db_h written once (a masked-off step only
    carries dh, and its dxw row is written as zeros)."""
    active = B * T if mask is None else float(mask.sum())
    n_bytes = 4 * (4 * H * active + B * T * H + B * H + H * 3 * H + 3 * H)
    n_bytes += 4 * (B * T * 3 * H + H * 3 * H + 3 * H)
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


def max_err(got, want):
    return max((a - w).abs().max().item() for a, w in zip(got, want))


def rel_err(got, want):
    """max |got - want| over max |want| (inf where want is 0 and got not)."""
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))


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
    from ikea_recommender_tpu_torch.ops import fused_ce, gru_cuda

    return {"B1 fused_ce_fwd": fused_ce.LAUNCHES, "B2 fused_ce_bwd": fused_ce.BWD_LAUNCHES,
            "B3 gru_fwd": gru_cuda.LAUNCHES, "B4 gru_bwd": gru_cuda.BWD_LAUNCHES}


def reset_counters():
    from ikea_recommender_tpu_torch.ops import fused_ce, gru_cuda

    fused_ce.LAUNCHES = fused_ce.BWD_LAUNCHES = 0
    gru_cuda.LAUNCHES = gru_cuda.BWD_LAUNCHES = 0


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
            if "Used" in line or "error" in line.lower():
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
    """B3 gru_fwd against gru_scan_plain; rows keyed by shape."""
    from ikea_recommender_tpu_torch.ops.gru_cuda import gru_scan, gru_scan_plain

    rows = {}
    for B, T, H, masked, reverse in [
        (256, 10, 64, True, False),  # the train point
        (512, 10, 64, True, False),  # the serving point
        (256, 200, 64, True, True),  # long sequences, reverse direction
        (256, 50, 256, False, False),  # wide: W_h from L2, unmasked
    ]:
        xw, wh, bh, mask = gru_case(B, T, H, masked)
        y, h = gru_scan(xw, wh, bh, mask, reverse=reverse)
        torch.cuda.synchronize()
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
        rows[(B, T, H)] = row
    return rows


def kernels_gru_bwd():
    """B4 gru_bwd against gru_scan_bwd_plain; the train point's row."""
    from ikea_recommender_tpu_torch.ops import gru_cuda
    from ikea_recommender_tpu_torch.ops.gru_cuda import gru_scan_bwd_plain, gru_scan_plain

    rows = []
    for B, T, H, masked, reverse in [
        (256, 10, 64, True, False),  # the train point
        (256, 200, 64, True, True),  # long sequences, reverse direction
        (256, 50, 256, False, False),  # wide: W_h from L2, unmasked
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
        torch.cuda.synchronize()
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
        rows.append(row)
    return rows[0]


def kernels_fused_ce():
    """B1 fused_ce_fwd and B2 fused_ce_bwd against their twins; the train
    point's rows ("high", no padding)."""
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
        (256, 64, 70852, 70852, "highest"),
        (256, 64, 70912, 70852, "high"),  # padded to 554 x 128, NaN in the pad
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
        torch.cuda.synchronize()
        want = fwd_plain()
        rel = check_close(got, want, ("lse", "label logit"), f"fused_ce_fwd at {shape}")
        lse = want[0]

        def bwd():
            return fused_ce_bwd(h, w, b, labels, lse, ct, valid, precision)

        def bwd_plain():
            return fused_ce_bwd_plain(h, w, b, labels, lse, ct, valid, precision)

        got_b = bwd()
        torch.cuda.synchronize()
        want_b = bwd_plain()
        rel_b = check_close(got_b, want_b, ("dh", "dw", "db"), f"fused_ce_bwd at {shape}")
        off = torch.arange(A, device="cuda") < valid  # valid columns no row labels
        off[labels] = False
        rel_b.update(check_close(
            (got_b[1][:, off], got_b[2][off]), (want_b[1][:, off], want_b[2][off]),
            ("dw off-label", "db off-label"), f"fused_ce_bwd at {shape}"))
        if not ((got_b[1][:, valid:] == 0).all() and (got_b[2][valid:] == 0).all()):
            fail(f"fused_ce_bwd at {shape}: padded columns got a gradient")

        # yardsticks: one dense fp32 head product and torch's CE, and its backward
        wv, bv = w[:, :valid].contiguous(), b[:valid].contiguous()
        lib_fwd = graph_ms(lambda: F.cross_entropy(
            torch.addmm(bv, h, wv), labels, reduction="none"), 20)
        leaves = [t.clone().requires_grad_() for t in (h, wv, bv)]
        loss = F.cross_entropy(torch.addmm(leaves[2], leaves[0], leaves[1]), labels,
                               reduction="none")
        lib_bwd = eager_ms(lambda: torch.autograd.grad(loss, leaves, ct, retain_graph=True), 20)

        for name, fn, plain, ref, errs, lib, backward in (
            ("B1 fused_ce_fwd", fwd, fwd_plain, (got, want), rel, lib_fwd, False),
            ("B2 fused_ce_bwd", bwd, bwd_plain, (got_b, want_b), rel_b, lib_bwd, True),
        ):
            bound_ms, bound_by = ce_bound(B, Fd, A, valid, precision, backward)
            row = dict(shape, max_abs_err=max_err(*ref), rel_err=errs, ms=graph_ms(fn, 20),
                       call_ms=eager_ms(fn, 20), plain_ms=graph_ms(plain, 3),
                       library_ms=lib, bound_ms=bound_ms, bound_by=bound_by)
            print(f"[kernels] {name} {json.dumps(row)}")
            rows.setdefault(name, row)
    return rows


def phase_kernels():
    """Every kernel against its twin. Returns the rows of the main paths'
    shapes: B3 at the train and serving points, B4, B1 and B2 at the train
    point."""
    b3 = kernels_gru_fwd()
    rows = {"B3 gru_fwd": b3[(256, 10, 64)], "B3 serving": b3[(512, 10, 64)],
            "B4 gru_bwd": kernels_gru_bwd()}
    rows.update(kernels_fused_ce())
    return rows


def plain_topk(params, mc, states, lens, k):
    """The serving path with the recurrence run by the plain twin."""
    from ikea_recommender_tpu_torch.models.gru import length_mask
    from ikea_recommender_tpu_torch.ops.fused_topk import blockwise_head_topk_ce
    from ikea_recommender_tpu_torch.ops.gru_cuda import gru_scan_plain

    layer = params["backbone"]["gru"][0]["fwd"]
    x = params["backbone"]["embedding"][states.long()]
    xw = torch.matmul(x, layer["wi"]) + layer["bi"]
    _, h = gru_scan_plain(xw, layer["wh"], layer["bh"], length_mask(lens, states.shape[1]))
    head = params["sup_head"]
    v, i, _ = blockwise_head_topk_ce(h, head["kernel"], head["bias"], k, mc.action_dim)
    return v, i


def check_topk(v, i, v_ref, i_ref, k, atol=1e-5):
    """Values (B, >= k) within ``atol`` of the reference's (B, k+1) over k
    columns; ids equal where the reference's adjacent values differ by more
    than GAP. Returns that (B, k) mask of separated positions."""
    if not (torch.isfinite(v).all() and v.shape[0] == v_ref.shape[0] and v.shape[1] >= k):
        fail("non-finite or misshapen top-k values")
    err = (v[:, :k] - v_ref[:, :k]).abs().max().item()
    if err > atol:
        fail(f"top-k values differ from the plain recurrence by {err:.3g}")
    d = (v_ref[:, 1:] - v_ref[:, :-1]).abs()
    left = torch.cat([torch.full_like(d[:, :1], float("inf")), d[:, : k - 1]], dim=1)
    clear = (left > GAP) & (d[:, :k] > GAP)
    if (clear & (i[:, :k] != i_ref[:, :k])).any():
        fail("top-k ids differ from the plain recurrence at separated positions")
    return clear


def phase_serving(profile=False):
    from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
    from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
    from ikea_recommender_tpu_torch.models.families import model_config_from_train
    from ikea_recommender_tpu_torch.run.recommend import pad_batch, recommend_rows
    from ikea_recommender_tpu_torch.run.serve import Recommender

    A, E, T, B, K, N_BATCHES = 70852, 64, 10, 512, 10, 4
    mc = model_config_from_train(
        TrainConfig(model="gru4rec", embedding_size=E, hidden_state_size=E, state_size=T),
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
    launches = launched.pop("B3 gru_fwd")
    if launches != N_BATCHES or any(launched.values()):
        fail(f"serving {N_BATCHES} batches launched gru_fwd {launches} times and {launched}")

    cleared = []
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
        v_ref, i_ref = plain_topk(rec.params, mc, states, lens, K + 1)
        cleared.append(check_topk(v, i, v_ref, i_ref, K).float().mean().item())
        # the timed batch's own records; scores are rounded to 6 digits there
        v_out = torch.tensor([r["scores"] for r in out], device="cuda")
        i_out = torch.tensor([r["predictions"] for r in out], device="cuda")
        check_topk(v_out, i_out, v_ref, i_ref, K, atol=1e-5 + 5e-7)
    ms = float(np.median(batch_ms))
    print(f"[serving] gru4rec A={A} E=H={E} T={T}: {N_BATCHES}x{B} sessions, "
          f"batch ms {[round(t, 3) for t in batch_ms]}, median {ms:.3f} ms = "
          f"{B / ms * 1e3:.0f} sessions/s; gru_fwd launches {launches}; ids compared "
          f"at {np.mean(cleared):.4f} of positions")
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
    """A train batch drawn as bench.py:125-138 draws it (the fields the
    step does not read are drawn too, so the sequence is the same)."""
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
    return {k: batch[k] for k in ("state", "action", "true_len", "valid")}


def named_leaves(tree, path=""):
    """{"a/b/0/c": leaf} of a params-like tree, as fp32 copies on the host
    (copies: Adam moves the CPU state's tensors in place)."""
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items() for p, t in named_leaves(v, f"{path}{k}/").items()}
    if isinstance(tree, list):
        return {p: t for i, v in enumerate(tree)
                for p, t in named_leaves(v, f"{path}{i}/").items()}
    return {path.rstrip("/"): tree.detach().float().cpu().clone()}


def phase_train(profile=False):
    """The gru4rec train step at full width: 3 steps against CPU copies,
    then 1 warm-up and 20 timed steps. Returns the timed run's launches."""
    from ikea_recommender_tpu_torch.convert import numpy_init_params, params_from_numpy
    from ikea_recommender_tpu_torch.core.config import DataConfig, TrainConfig
    from ikea_recommender_tpu_torch.models.families import model_config_from_train
    from ikea_recommender_tpu_torch.train.state import make_train_state
    from ikea_recommender_tpu_torch.train.steps import loss_and_grads, make_train_step

    A, E, T, B, LR, N_CHECK, N_TIMED = 70852, 64, 10, 256, 0.01, 3, 20
    tc = TrainConfig(model="gru4rec", batch_size=B, embedding_size=E, hidden_state_size=E,
                     state_size=T, learning_rate=LR, fused_ce=True, head_precision="high")
    mc = model_config_from_train(tc, DataConfig(num_items=A))
    if not (mc.fused_ce and mc.head_precision == "high"):
        fail("the RetailRocket width must train through the fused CE in 'high'")
    np_params = numpy_init_params(mc, seed=0)
    rs = np.random.RandomState(0)
    batches = [bench_batch(rs, B, A, T) for _ in range(N_CHECK + 1 + N_TIMED)]
    batches[N_CHECK - 1]["valid"][200:] = False  # a tail batch of 200 sessions

    # -- the same 3 steps on the card and on CPU copies, where the twins run
    states, steps = {}, {}
    for dev in ("cuda", "cpu"):
        states[dev], opt = make_train_state(params_from_numpy(np_params, dev), mc, LR, device=dev)
        steps[dev] = make_train_step(mc, opt, device=dev)
    grads = {dev: loss_and_grads(states[dev].params,
                                 {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()},
                                 mc)[1] for dev in states}
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
                           "train step: first-step gradient against the CPU twins", 1e-4)
    losses = {"cuda": [], "cpu": []}
    mus = [named_leaves(states["cpu"].opt_state.mu)]
    for b in batches[:N_CHECK]:
        for dev in states:
            states[dev], m = steps[dev](states[dev], b)
            losses[dev].append(m["sup_loss"].item())
        mus.append(named_leaves(states["cpu"].opt_state.mu))
    loss_err = max(abs(a - c) for a, c in zip(losses["cuda"], losses["cpu"]))
    if loss_err > 1e-4:  # losses near log(A) = 11.2; fp32 sums over A in other orders
        fail(f"train step: losses {losses['cuda']} differ from the CPU twins' {losses['cpu']}")
    # params after 3 steps, atol 1e-5 = lr / 1000, over the entries that some
    # step moved on the CPU side (a nonzero gradient; rows no batch touches
    # cannot differ), where each step's CPU gradient, read back from the
    # first moment, is 0 or above 1e-6 in size: Adam moves an entry near
    # zero by about +-lr whatever its size, so a summation-order difference
    # there says nothing about the kernels. The head kernel, trained through
    # B2, must be among them.
    got_p, want_p = (named_leaves(states[dev].params) for dev in ("cuda", "cpu"))
    compared, param_err = {}, 0.0
    for name, want in want_p.items():
        g = torch.stack([(mus[k + 1][name] - 0.9 * mus[k][name]) / 0.1 for k in range(N_CHECK)])
        moved = (g != 0).any(dim=0)
        sure = moved & ((g == 0) | (g.abs() > 1e-6)).all(dim=0)
        err = (got_p[name] - want)[sure].abs().max().item() if sure.any() else 0.0
        param_err = max(param_err, err)
        if err > 1e-5:
            fail(f"train step: {name} after {N_CHECK} steps differs by {err:.3g}")
        compared[name] = (int(sure.sum()), int(moved.sum()))
    n_sure, n_moved = (sum(c[i] for c in compared.values()) for i in (0, 1))
    head_sure, head_moved = compared["sup_head/kernel"]
    # this run's seeded data gives 0.339 of the moved entries and 0.299 of
    # the head kernel's (both read off the CPU side)
    if n_sure < 0.3 * n_moved or head_sure < 0.25 * head_moved:
        fail(f"train step: too few params compared: {compared} (compared, moved)")
    print(f"[train] {N_CHECK} steps on the card vs the CPU twins: losses {losses['cuda']}, "
          f"max loss diff {loss_err:.3g}; first-step grads rel diff {json.dumps(grad_err)}; "
          f"params max diff {param_err:.3g} over {n_sure} of {n_moved} moved entries "
          f"({n_sure / n_moved:.4f}; head kernel {head_sure} of {head_moved})")

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
    if any(n != N_TIMED for n in launches.values()):
        fail(f"{N_TIMED} train steps launched {launches}")
    if not torch.isfinite(torch.stack(metrics)).all():
        fail("non-finite train loss")
    ms = float(np.median(step_ms))
    print(f"[train] gru4rec A={A} E=H={E} T={T} B={B} high: {N_TIMED} steps, "
          f"ms per step median {ms:.3f} (min {min(step_ms):.3f}, max {max(step_ms):.3f}, "
          f"p90 {float(np.percentile(step_ms, 90)):.3f}) = {B / ms * 1e3:.0f} sessions/s; "
          f"launches {launches}; last loss {metrics[-1].item():.5f}")
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    profile = "--profile" in sys.argv[1:]
    serving_launches = phase_serving(profile=profile)
    launches = phase_train(profile=profile)
    # the card's machine has jax installed: show the port never loaded it
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "ikea_recommender_tpu"))
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
    }
    kernels = []
    for name, (source, replaces, library) in meta.items():
        row = rows[name]
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"ikea_recommender_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": library,
            "shape": {k: row[k] for k in SHAPE_KEYS if k in row},
        }
        if name == "B3 gru_fwd":
            serving = rows["B3 serving"]
            entry.update(serving_launches=serving_launches, serving_ms=serving["ms"],
                         serving_bound_ms=serving["bound_ms"])
        kernels.append(entry)
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
