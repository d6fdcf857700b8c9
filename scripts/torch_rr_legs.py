#!/usr/bin/env python3
"""ROADMAP A.10's RetailRocket accuracy legs on the PyTorch/CUDA port at
r5b's invocation (``experiments/RetailRocket-Comparison/rehearsal_r5b``),
and their comparison with r5b's record of the same legs.

    python3 scripts/torch_rr_legs.py stage ROOT
    python3 scripts/torch_rr_legs.py run ROOT --legs gru4rec gru4rec_fast ... \
        --record DIR [--keep DIR] [--epochs N]
    python3 scripts/torch_rr_legs.py compare RECORD

``stage`` writes ``ROOT/{events.csv,data,buffers}`` through the port's
``run/retailrocket.py`` {synth, etl, buffers} at r5b's
``command_{synth,etl,buffers}.json`` (``chip_smoke.rr_argv``) and fails
unless the catalog is 72293 (``chip_smoke.RR_CATALOG``).

``run`` trains each leg named (``<family>`` or ``<family>_fast``) on the
card with ``python -m ikea_recommender_tpu_torch.run.retailrocket run`` at
the flags of r5b's ``<leg>_command_run.json`` (family, epochs, preset,
seed, train metrics, checkpoint, and for smorl the diversity embedding: the
default gru4rec leg's ``ROOT/runs/gru4rec/embedding_weights.npy``) on
``ROOT/buffers``, one process a leg, in the order given, each leg's output
in ``ROOT/runs/<leg>`` and its printed lines in ``ROOT/runs/<leg>.log``; a
leg that fails is reported, the next one runs, and the command then exits
1. ``--epochs N`` cuts every leg named at N epochs (N eval points), where a
leg of r5b's length does not fit the time at hand; the smorl legs need
``ROOT/runs/gru4rec`` first, which a gru4rec leg cut at 3 epochs gives (its
best eval point is 2 at 30). It copies each leg's ``run_summary.json`` and
``command_run.json`` into ``--record`` as ``<leg>_run_summary.json`` and
``<leg>_command_run.json`` where ``compare`` can hold them: the run passes
r5b's best eval point and the record holds no longer run of the leg. It
appends to ``--record/legs.jsonl`` the leg's wall seconds, ``cut_at``
(null for an uncut leg) beside r5b's epochs, whether it was recorded, its
best eval point and metric, its test HR@10 and NDCG@10, its Val NDCG@10
curve, and the card's name and power limit; and
copies an exported ``embedding_weights.npy`` into ``--keep``, with its
sha256 and, for a cut leg, whether it equals the export of the record's
uncut line of the same leg.

``compare`` holds each leg of RECORD to r5b's leg of the same name: test
HR@10, test NDCG@10 and the best Val NDCG@10 within 0.01, Val NDCG@10
within 0.015 at every eval point both runs have, and for each family with
both arms the fast arm's lead in test NDCG@10 positive and within 0.01 of
r5b's. A cut leg ("cut at N of 30") is held at the eval points it has, by
the best model within its cut, and must reach past r5b's best eval point.
It prints a line a leg and a family and exits 1 if any bound fails.
"""

import argparse
import contextlib
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
R5B = REPO / "experiments" / "RetailRocket-Comparison" / "rehearsal_r5b"
METRIC = "Val_NDCG@10"
TEST_KEYS = ("Test_HR@10", "Test_NDCG@10")
BOUND = 0.01  # test metrics, best Val, the fast arm's lead
CURVE_BOUND = 0.015  # Val NDCG@10 at each shared eval point


def card():
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def stage(root):
    from chip_smoke import RR_CATALOG, rr_argv
    from ikea_recommender_tpu_torch.run import retailrocket

    with contextlib.chdir(REPO):  # rr_argv's invocation path is relative to it
        bufs, argv = rr_argv(str(root))
    for cmd in ("synth", "etl", "buffers"):
        t0 = time.perf_counter()
        retailrocket.main(argv[cmd])
        print(f"[legs] {cmd}: {time.perf_counter() - t0:.3f} s host")
    got = json.loads((Path(bufs) / "meta.json").read_text())["num_items"]
    if got != RR_CATALOG:
        raise SystemExit(f"[legs] the invocation gave catalog {got}, not {RR_CATALOG}")
    print(f"[legs] catalog {got}")


def leg_argv(leg, buffers, out, epochs=None):
    """``run``'s argv for ``leg`` at the flags r5b's ``command_run.json``
    records, cut at ``epochs`` where given. r5b's ``div_emb`` (smorl's)
    names a leg beside its ``out``; the argv names the same leg beside
    ``out``."""
    rec = json.loads((R5B / f"{leg}_command_run.json").read_text())
    argv = ["run", "--buffers", str(buffers), "--family", rec["family"],
            "--epochs", str(epochs or rec["epochs"]), "--seed", str(rec["seed"]),
            "--out", str(out)]
    if rec.get("preset"):
        argv += ["--preset", rec["preset"]]
    if rec.get("no_train_metrics"):
        argv.append("--no-train-metrics")
    if rec.get("checkpoint"):
        argv.append("--checkpoint")
    if rec.get("div_emb"):
        argv += ["--div-emb",
                 str(Path(out).parent / Path(rec["div_emb"]).relative_to(Path(rec["out"]).parent))]
    return argv


def run_legs(root, legs, record, keep, epochs=None):
    record.mkdir(parents=True, exist_ok=True)
    smi = card()
    failed = []
    for leg in legs:
        out = root / "runs" / leg
        argv = leg_argv(leg, root / "buffers", out, epochs)
        want = json.loads((R5B / f"{leg}_run_summary.json").read_text())
        log = root / "runs" / f"{leg}.log"
        log.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with open(log, "w") as fh:
            rc = subprocess.run([sys.executable, "-m", "ikea_recommender_tpu_torch.run.retailrocket",
                                 *argv], cwd=REPO, stdout=fh, stderr=subprocess.STDOUT).returncode
        wall = time.perf_counter() - t0
        if rc != 0:
            print(log.read_text()[-4000:])
            print(f"[legs] {leg} exited {rc} after {wall:.1f} s", flush=True)
            failed.append(leg)
            continue
        summary = json.loads((out / "run_summary.json").read_text())
        # the record keeps what ``compare`` can hold: a run past r5b's best
        # eval point and no shorter than the run of the leg it holds
        held = record / f"{leg}_run_summary.json"
        recorded = summary["epochs"] > want["best_epoch"] and not (
            held.exists() and json.loads(held.read_text())["epochs"] > summary["epochs"])
        if recorded:
            for name in ("run_summary.json", "command_run.json"):
                shutil.copy(out / name, record / f"{leg}_{name}")
        cut = summary["epochs"] if summary["epochs"] < want["epochs"] else None
        tm = summary["test_metrics"]
        entry = {"leg": leg, "argv": argv, "wall_s": wall, "card": smi, "cut_at": cut,
                 "r5b_epochs": want["epochs"], "recorded": recorded,
                 "best_epoch": summary["best_epoch"], "best_metric": summary["best_metric"],
                 "test_metrics": {k: tm[k] for k in TEST_KEYS},
                 "val_curve": [point[METRIC] for point in summary["logs"]],
                 "train_sessions_per_sec": summary["train_sessions_per_sec"],
                 "timing": summary["timing"]}
        emb = out / "embedding_weights.npy"
        said = ""
        if keep and emb.exists():
            keep.mkdir(parents=True, exist_ok=True)
            shutil.copy(emb, keep / f"{leg}_embedding_weights.npy")
            entry["embedding_sha256"] = hashlib.sha256(emb.read_bytes()).hexdigest()
            lines = record / "legs.jsonl"
            uncut = [e["embedding_sha256"] for e in map(json.loads, lines.read_text().splitlines())
                     if e["leg"] == leg and not e.get("cut_at") and "embedding_sha256" in e
                     ] if lines.exists() else []
            if cut and uncut:
                same = entry["embedding_sha256"] == uncut[-1]
                entry["embedding_equals_uncut"] = same
                said = f"; its export {'equals' if same else 'differs from'} the uncut leg's"
        with open(record / "legs.jsonl", "a") as fh:
            fh.write(json.dumps(entry) + "\n")
        said += (f"; recorded as {held.name}" if recorded else "; not recorded (short of "
                 f"r5b's best eval point {want['best_epoch']}, or a longer run held)")
        of = f" cut at {cut} of {want['epochs']}" if cut else ""
        print(f"[legs] {leg}{of}: "
              f"{wall / 60:.2f} min, {summary['train_sessions_per_sec']:.0f} "
              f"sessions/s of the train loop, test HR@10 {tm['Test_HR@10']:.6f} NDCG@10 "
              f"{tm['Test_NDCG@10']:.6f}, best {METRIC} {summary['best_metric']:.6f} @ eval "
              f"point {summary['best_epoch']}{said}; {smi}", flush=True)
    return failed


def compare_leg(got, want):
    """The figures of one leg against its reference leg: each test metric,
    the best Val NDCG@10 and its eval point, and the largest gap of the Val
    NDCG@10 curves over the eval points both runs have. A cut leg must pass
    the reference's best eval point."""
    curve = [abs(a[METRIC] - b[METRIC]) for a, b in zip(got["logs"], want["logs"])]
    rows = {k: (got["test_metrics"][k], want["test_metrics"][k]) for k in TEST_KEYS}
    rows["best " + METRIC] = (got["best_metric"], want["best_metric"])
    worst = max(range(len(curve)), key=curve.__getitem__)
    return {
        "metrics": rows,
        "best_epoch": (got["best_epoch"], want["best_epoch"]),
        "eval_points": len(curve),
        "cut": got["epochs"] < want["epochs"],
        "curve_gap": curve[worst],
        "curve_gap_at": worst,
        "ok": (all(abs(a - b) <= BOUND for a, b in rows.values()) and curve[worst] <= CURVE_BOUND
               and len(got["logs"]) > want["best_epoch"]),
    }


def fast_lead(summaries, family):
    """The fast arm's lead over the default arm in test NDCG@10."""
    return (summaries[f"{family}_fast"]["test_metrics"]["Test_NDCG@10"]
            - summaries[family]["test_metrics"]["Test_NDCG@10"])


def load_summaries(directory):
    return {p.name[: -len("_run_summary.json")]: json.loads(p.read_text())
            for p in sorted(Path(directory).glob("*_run_summary.json"))}


def compare(record):
    got, want = load_summaries(record), load_summaries(R5B)
    ok = True
    for leg in sorted(set(got) & set(want)):
        c = compare_leg(got[leg], want[leg])
        ok &= c["ok"]
        figures = "; ".join(f"{k} {a:.6f} vs {b:.6f} ({a - b:+.6f})"
                            for k, (a, b) in c["metrics"].items())
        cut = (f"cut at {got[leg]['epochs']} of {want[leg]['epochs']} (r5b's best point "
               f"{want[leg]['best_epoch']}); " if c["cut"] else "")
        print(f"[compare] {leg}: {cut}{figures}; best eval point {c['best_epoch'][0]} vs "
              f"{c['best_epoch'][1]}; largest {METRIC} gap {c['curve_gap']:.6f} at eval point "
              f"{c['curve_gap_at']} of {c['eval_points']}; "
              f"{'within' if c['ok'] else 'OUTSIDE'} the bounds")
    for family in sorted({leg.removesuffix("_fast") for leg in got}):
        arms = (family, f"{family}_fast")
        if all(a in got and a in want for a in arms):
            a, b = fast_lead(got, family), fast_lead(want, family)
            inside = a > 0 and abs(a - b) <= BOUND
            ok &= inside
            print(f"[compare] {family} fast minus default, test NDCG@10: {a:+.6f} vs "
                  f"{b:+.6f} ({a - b:+.6f}); {'within' if inside else 'OUTSIDE'} the bounds")
    return ok


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("stage").add_argument("root")
    r = sub.add_parser("run")
    r.add_argument("root")
    r.add_argument("--legs", nargs="+", required=True)
    r.add_argument("--record", required=True)
    r.add_argument("--keep", default=None)
    r.add_argument("--epochs", type=int, default=None,
                   help="cut every leg named at this many epochs (default: r5b's)")
    sub.add_parser("compare").add_argument("record")
    args = p.parse_args(argv)
    if args.cmd == "compare":
        return 0 if compare(args.record) else 1
    sys.path.insert(0, str(REPO))
    if args.cmd == "stage":
        stage(Path(args.root).resolve())
        return 0
    keep = Path(args.keep).resolve() if args.keep else None
    return 1 if run_legs(Path(args.root).resolve(), args.legs, Path(args.record).resolve(),
                         keep, args.epochs) else 0


if __name__ == "__main__":
    sys.exit(main())
