#!/usr/bin/env python3
"""Hold two checkouts of the PyTorch/CUDA port's head kernels to each other
on one NVIDIA GPU: B1 and B2 (the fused softmax CE, forward and backward),
B5 and B6 (the fused argmax of one head and of K = 3 weighted heads).

    python3 scripts/torch_head_parity.py save OUT.npz [--repo DIR] [--only B2 ...]
    python3 scripts/torch_head_parity.py compare A.npz B.npz

``save`` imports the port and ``chip_smoke.graph_ms`` from DIR (by default
this script's repository), runs each kernel once on seeded inputs at the
head shapes of the train steps (catalog 70852, batch 256; F = 64 for
gru4rec, sqn and smorl, F = 128 for bidir_gru4rec at hidden 64, F = 256 at
hidden 128) and writes its outputs and its device time (20 launches in one
CUDA graph) to OUT; ``--only`` runs the kernels named. A shape the
checkout refuses is left out. ``compare``
prints, for each case in both files, whether every output is equal bit for
bit and the two times; it exits 1 if any output differs. Run ``save`` on a
commit and on its parent in one call, on the same card, to show that a
change kept the kernels' results and to compare their times.
"""

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

A = 70852
CASES = [  # (kernel, F, precision)
    *[(k, 64, p) for k in ("B1", "B2", "B5", "B6") for p in ("high", "default")],
    ("B2", 128, "high"),  # two row groups a call: the second adds into dW
    ("B1", 256, "high"),
    ("B2", 256, "high"),
]


def save(out, repo, only=None):
    sys.path.insert(0, str(repo))
    import torch

    from chip_smoke import graph_ms
    from ikea_recommender_tpu_torch.ops.fused_argmax import (
        fused_linear_argmax,
        fused_weighted_multihead_argmax,
    )
    from ikea_recommender_tpu_torch.ops.fused_ce import (
        fused_ce_bwd,
        fused_ce_fwd,
        fused_ce_fwd_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    arrays = {}
    for kernel, F, precision in CASES:
        if only and kernel not in only:
            continue
        g = torch.Generator(device="cuda").manual_seed(A + F)
        K = 3 if kernel == "B6" else 1
        h = torch.randn(256, F, device="cuda", generator=g)
        w = torch.randn(K, F, A, device="cuda", generator=g) / F**0.5
        b = torch.randn(K, A, device="cuda", generator=g) * 0.1
        labels = torch.randint(0, A, (256,), device="cuda", generator=g)
        ct = torch.rand(256, device="cuda", generator=g) / 256
        w1, b1 = w[0].contiguous(), b[0].contiguous()
        q = torch.ones(K, device="cuda")
        lse, _ = fused_ce_fwd_plain(h, w1, b1, labels, A, precision)
        fn = {
            "B1": lambda: fused_ce_fwd(h, w1, b1, labels, A, precision),
            "B2": lambda: fused_ce_bwd(h, w1, b1, labels, lse, ct, A, precision),
            "B5": lambda: fused_linear_argmax(h, w1, b1, A, precision, with_max=True),
            "B6": lambda: fused_weighted_multihead_argmax(h, w, b, q, A, precision, with_max=True),
        }[kernel]
        case = f"{kernel} F={F} {precision}"
        try:
            outputs = fn()
        except ValueError as err:  # a width this checkout does not take
            print(f"{case}: refused ({err})", flush=True)
            continue
        torch.cuda.synchronize()
        for i, x in enumerate(outputs):
            arrays[f"{case}/{i}"] = x.cpu().numpy()
        arrays[f"{case}/ms"] = np.float64(graph_ms(fn, 20))
        print(f"{case}: {float(arrays[f'{case}/ms']):.6f} ms", flush=True)
    np.savez(out, **arrays)


def compare(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    cases = sorted({k.rsplit("/", 1)[0] for k in a.files} & {k.rsplit("/", 1)[0] for k in b.files})
    differ = 0
    for case in cases:
        outs = sorted(k for k in a.files if k.startswith(case + "/") and not k.endswith("/ms"))
        same = all(k in b.files and np.array_equal(a[k], b[k], equal_nan=True) for k in outs)
        differ += not same
        print(f"{case}: {'bit-identical' if same else 'DIFFERENT'}; "
              f"ms {float(a[case + '/ms']):.6f} and {float(b[case + '/ms']):.6f}")
    return 1 if differ else 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("save")
    s.add_argument("out")
    s.add_argument("--repo", type=Path, default=Path(__file__).resolve().parent.parent)
    s.add_argument("--only", nargs="+", choices=("B1", "B2", "B5", "B6"))
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    if args.cmd == "compare":
        return compare(args.a, args.b)
    import torch

    if not torch.cuda.is_available():
        print("torch_head_parity: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    save(args.out, args.repo.resolve(), args.only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
