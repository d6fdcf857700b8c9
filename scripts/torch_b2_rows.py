#!/usr/bin/env python3
"""Time B2 (the fused softmax-CE backward of the PyTorch/CUDA port) at the
head widths of gru4rec and bidir_gru4rec for 64, 128 and 256 rows, on one
NVIDIA GPU.

    python3 scripts/torch_b2_rows.py      # from the repository root

B2 takes rows in groups, one launch each, where h's planes and the dh
accumulator of all rows do not fit in shared memory beside W's chunk
(``csrc/fused_ce.cu``: ``bwd_mma_group_rows``); every group after the
first adds into dW and db. At catalog 70852 in "high" and "default", F =
256 (bidir at hidden 128) takes one 64-row tile a launch
(``ce_bwd_mma_sliced_kernel``), F = 128 (bidir at hidden 64) two launches
for B = 256, and F = 64 (gru4rec) one. So B = 64, 128 and 256 show what one
launch costs and what the groups after it add. 10 launches in one CUDA
graph a sample (``chip_smoke.graph_ms``). Prints the card's name and
power limit, then one JSON line per row.
"""

import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import graph_ms  # noqa: E402
from ikea_recommender_tpu_torch.ops.fused_ce import (  # noqa: E402
    fused_ce_bwd,
    fused_ce_fwd_plain,
)

A = 70852


def main():
    if not torch.cuda.is_available():
        print("torch_b2_rows: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    for precision in ("high", "default"):
        for F in (64, 128, 256):
            for B in (64, 128, 256):
                g = torch.Generator(device="cuda").manual_seed(A)
                h = torch.randn(B, F, device="cuda", generator=g)
                w = torch.randn(F, A, device="cuda", generator=g) / F**0.5
                b = torch.randn(A, device="cuda", generator=g) * 0.1
                labels = torch.randint(0, A, (B,), device="cuda", generator=g)
                ct = torch.rand(B, device="cuda", generator=g) / B
                lse, _ = fused_ce_fwd_plain(h, w, b, labels, A, precision)
                ms = graph_ms(lambda: fused_ce_bwd(h, w, b, labels, lse, ct, A, precision), 10)
                print(json.dumps(dict(B=B, F=F, A=A, precision=precision, ms=ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
