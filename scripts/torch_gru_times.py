#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's GRU kernels, B3 (the recurrence, gru_fwd) and
B4 (its adjoint, gru_bwd), on one NVIDIA GPU.

    python3 scripts/torch_gru_times.py [--repo DIR] [--label NAME] [--sweep] [--kernels]
        [--dtype float32|bfloat16] [--save OUT.npz]
    python3 scripts/torch_gru_times.py --compare A.npz B.npz

Imports the port and ``chip_smoke``'s timers and inputs from DIR (by default
this script's repository), runs each kernel on seeded inputs at the train
point (B, T, H) = (256, 10, 64), the serving point (512, 10, 64) (B3 only),
the bidir_gru4rec point (256, 10, 128) in both directions, the bidir2 point
(256, 20, 128) reverse, long sequences (256, 200, 64) reverse and the widest
case (256, 50, 256), masked but the last, holds it to its plain twin (max
|kernel - twin| over max |twin|, per output) and prints one JSON line per case with its device time: 20 launches
in one CUDA graph, median of 5 replays, as ``chip_smoke.py`` "[kernels]"
measures. ``--sweep`` adds the unmasked points at T = 1, 10 and 20 for
H = 64 and 128, and one "[gru-sweep]" line per H that splits each kernel's
time into a fixed part and a part per step (the slope from T = 10 to 20,
and T = 1 less one step); ``--kernels`` adds each CUDA kernel's mean device
time per call under torch.profiler (B4 launches two). ``--dtype bfloat16``
runs the kernels on bf16 tensors (compute_dtype: bfloat16) against the bf16
twins. ``--save`` writes every case's kernel outputs to an ``.npz``, and
``--compare`` says whether two such files hold the same outputs bit for
bit. Run it on a commit and on its parent in one call (parent, change,
change, parent) to compare them on one card.
"""

import argparse
import json
import sys
from pathlib import Path

CASES = [  # (B, T, H, masked, reverse, with B4)
    (256, 10, 64, True, False, True),
    (512, 10, 64, True, False, False),
    (256, 10, 128, True, False, True),
    (256, 10, 128, True, True, True),
    (256, 20, 128, True, True, True),
    (256, 200, 64, True, True, True),
    (256, 50, 256, False, False, True),
]
SWEEP_T = (1, 10, 20)
SWEEP = [(256, T, H, False, False, True) for H in (64, 128) for T in SWEEP_T]


def kernel_us(fn, n=20):
    """{kernel name: mean device us per call of fn} over n calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            out[ev.key[:60]] = us / n
    return out


def split(ms_by_t):
    """(fixed us, us per step) from {T: ms} at T = 1, 10, 20."""
    step = (ms_by_t[20] - ms_by_t[10]) / 10 * 1e3
    return ms_by_t[1] * 1e3 - step, step


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args()
    import numpy as np

    if args.compare:
        with np.load(args.compare[0]) as a, np.load(args.compare[1]) as b:
            differ = sorted(k for k in a.files if k not in b.files
                            or not np.array_equal(a[k], b[k]))
            out = dict(files=args.compare, outputs=len(a.files),
                       missing=sorted(set(a.files) ^ set(b.files)), differ=differ)
        print(f"[gru-compare] {json.dumps(out)}")
        return
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    from chip_smoke import graph_ms, gru_case, rel_err
    from ikea_recommender_tpu_torch.ops import gru_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    label = args.label or args.repo
    dtype = getattr(torch, args.dtype)
    swept, saved = {}, {}
    for B, T, H, masked, reverse, with_bwd in CASES + (SWEEP if args.sweep else []):
        xw, wh, bh, mask = gru_case(B, T, H, masked)
        g = torch.Generator(device="cuda").manual_seed(T)
        gy = torch.randn(B, T, H, device="cuda", generator=g)
        ghf = torch.randn(B, H, device="cuda", generator=g)
        xw, wh, bh, gy, ghf = (t.to(dtype) for t in (xw, wh, bh, gy, ghf))
        case = f"{B}x{T}x{H}{'m' if masked else ''}{'r' if reverse else ''}"

        def fwd():
            return gru_cuda._launch(xw, wh, bh, mask, reverse)

        def bwd():
            return gru_cuda._launch_bwd(xw, wh, bh, mask, y, gy, ghf, reverse)

        with torch.no_grad():
            y, hfin = gru_cuda.gru_scan_plain(xw, wh, bh, mask, reverse=reverse)
            got = fwd()
        torch.cuda.synchronize()
        saved.update({f"{case}/{n}": a for n, a in zip(("y", "h_fin"), got)})
        row = dict(
            label=label, dtype=args.dtype, B=B, T=T, H=H, masked=masked, reverse=reverse,
            b3_rel_err=max(rel_err(a.float(), w.float()) for a, w in zip(got, (y, hfin))),
            b3_ms=graph_ms(fwd, 20),
        )
        if with_bwd:
            with torch.no_grad():
                want = gru_cuda.gru_scan_bwd_plain(xw, wh, bh, mask, y, gy, ghf, reverse)
                got = bwd()
            torch.cuda.synchronize()
            saved.update({f"{case}/{n}": a for n, a in zip(("dxw", "dwh", "dbh"), got)})
            row["b4_rel_err"] = {
                n: rel_err(a.float(), w.float())
                for a, w, n in zip(got, want, ("dxw", "dwh", "dbh"))
            }
            row["b4_ms"] = graph_ms(bwd, 20)
        if args.kernels:
            row["b3_kernel_us"] = kernel_us(fwd)
            if with_bwd:
                row["b4_kernel_us"] = kernel_us(bwd)
        row["device"] = torch.cuda.get_device_name(0)
        print(f"[gru] {json.dumps(row)}", flush=True)
        if (B, T, H, masked, reverse, with_bwd) in SWEEP:
            swept.setdefault(H, {})[T] = row
    for H, by_t in swept.items():
        out = dict(label=label, H=H)
        for k in ("b3", "b4"):
            fixed, step = split({T: by_t[T][f"{k}_ms"] for T in SWEEP_T})
            out[f"{k}_fixed_us"], out[f"{k}_step_us"] = fixed, step
        print(f"[gru-sweep] {json.dumps(out)}", flush=True)
    if args.save:  # bf16 outputs as their bits
        np.savez(args.save, **{k: (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
                               .cpu().numpy() for k, t in saved.items()})


if __name__ == "__main__":
    main()
