#!/usr/bin/env python3
"""Time B6 (the weighted multi-head argmax of the PyTorch/CUDA port) with
its block's column count forced to 128, 64 and 32, on one NVIDIA GPU.

    python3 scripts/torch_b6_columns.py      # from the repository root

``csrc/fused_argmax.cu`` picks the columns a block owns
(``wargmax_cols``: the widest at which two blocks share an SM, else the
widest that fits one). This script copies the sources into
``ikea_recommender_tpu_torch/_build/b6_columns/``, makes ``wargmax_cols``
return each forced count in turn, builds each copy with the port's nvcc
flags, and times each at smorl's train point (B=256, F=64, A=70852, K=3)
in "high" and "default" against the port's own build, in turns (port,
forced..., forced..., port), 20 launches in one CUDA graph a sample. Every
variant's ids and maxima must equal the port's build, bit for bit. Prints
the card's name and power limit, then one JSON line per precision.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ikea_recommender_tpu_torch.ops import build, fused_argmax  # noqa: E402

COLUMNS = (128, 64, 32)
B, F, A, K = 256, 64, 70852, 3


def build_forced(cols):
    """The library of fused_argmax.cu with wargmax_cols returning ``cols``."""
    out = build.BUILD_DIR / "b6_columns" / str(cols)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, out)
    src = out / "fused_argmax.cu"
    text, n = re.subn(r"(int wargmax_cols\(int F, int K, int P\) \{)",
                      rf"\1\n  return {cols};", src.read_text())
    if n != 1:
        raise SystemExit("wargmax_cols not found in csrc/fused_argmax.cu")
    src.write_text(text)
    lib = out / "libfused_argmax.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn, scratch = lib.fused_argmax, lib.fused_argmax_scratch
    fn.argtypes, fn.restype = [ptr] * 8 + [i32] * 7 + [ptr], i32
    scratch.argtypes, scratch.restype = [i32] * 6, ctypes.c_longlong
    return fn, scratch


def runner(fns, h, w, b, q, precision):
    fn, scratch = fns
    p = fused_argmax.PRECISIONS.index(precision)
    n = scratch(B, F, A, K, 1, p)
    idx = torch.empty(B, dtype=torch.int64, device="cuda")
    mx = torch.empty(B, device="cuda")
    part_max = torch.empty(n, device="cuda")
    part_idx = torch.empty(n, dtype=torch.int32, device="cuda")

    def run():
        err = fn(h.data_ptr(), w.data_ptr(), b.data_ptr(), q.data_ptr(), idx.data_ptr(),
                 mx.data_ptr(), part_max.data_ptr(), part_idx.data_ptr(), B, F, A, K, A, p,
                 0, torch.cuda.current_stream().cuda_stream)  # 0: the canonical layout
        if err != 0:
            raise SystemExit(f"fused_argmax failed with CUDA error {err}")
        return idx, mx

    return run


def graph_ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def main():
    if not torch.cuda.is_available():
        print("torch_b6_columns: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(B, F, device="cuda", generator=g)
    w = torch.randn(K, F, A, device="cuda", generator=g) / F**0.5
    b = torch.randn(K, A, device="cuda", generator=g) * 0.1
    q = torch.ones(K, device="cuda")
    port = bind(build.load("fused_argmax"))
    forced = {cols: bind(build_forced(cols)) for cols in COLUMNS}
    for precision in ("high", "default"):
        runs = {"port": runner(port, h, w, b, q, precision)}
        runs.update({cols: runner(fns, h, w, b, q, precision) for cols, fns in forced.items()})
        want = [t.clone() for t in runs["port"]()]
        for name, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise SystemExit(f"{name} columns differ from the port's build in {precision}")
        order = list(runs) + list(runs)[::-1]
        ms = {name: [] for name in runs}
        for name in order:
            ms[name].append(graph_ms(runs[name]))
        print(json.dumps({"precision": precision, "B": B, "F": F, "A": A, "K": K,
                          "ms": {str(k): v for k, v in ms.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
