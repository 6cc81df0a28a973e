"""Fixed fill budgets of ``tools/muse_bench.py``'s cube on the port, held
against the JAX package's TPU runs of that tool (``results/muse_*.stats.json``).

    # on the card: seed 1 at 100, 1,000 and 4,223 spaxels, the budget
    # stepped by factors of 2 from 1,024 towards the TPU run's evaluations
    # until two budgets bracket them (or 256 or 8,192 is reached); then
    # seeds 2-3 (2-5 at 100 spaxels) at the bracketing budgets; one fit at
    # a time, for at most --stop-after seconds; --have: fits made earlier
    python3 tools/muse_tpu_budget.py sweep --out-dir out/budget3 \
        --have out/budget1/fits out/budget2/fits --stop-after 3300
    # listed fits instead of the search
    python3 tools/muse_tpu_budget.py sweep --out-dir out/budget4 \
        --only 4223:1024:3 100:1024:2
    # the record and the verdict
    python3 tools/muse_tpu_budget.py record out/budget*/fits \
        --out muse_tpu_budget.json
    # a rehearsal on the CPU (seconds): two fixed budgets
    python3 tools/muse_tpu_budget.py sweep --device cpu --out-dir r \
        --only 16:2:1 16:16:1 --cap 200 \
        --bench-args="--nspec 64 --nlive 50 --chunk-iters 50"

Each fit is one ``tools/torch_muse_bench.py`` process at the tool's own
options but ``--dispatch-target 0 --fill-budget B --cap 100000 --seed s``:
without the wall-clock budget a fit's counts do not depend on the wall.
A fit's rc 1 is its failed ``jax_run.ndraws`` bar (evaluations within
[0.5, 2] x the TPU run's), expected at budgets off the bracket.

The record gives, for each (spaxels, budget), the minimum, median and
maximum over seeds of ``STATS``, their ratios to the TPU run's, and the
bars on the seed median (``bars``): (i) evaluations within ``RATIO_BAR`` x
the TPU run's; (ii) iterations at least ``MIN_ITERATIONS`` (every TPU run
ran to the 100,000 cap); (iii) member overflows and pile peak within
``RATIO_BAR`` x the TPU run's, or where several TPU runs exist (100
spaxels) within their range widened 2 x each way. B*(D) are the budgets
that meet all. The outcome is ``open`` while the search still wants fits
(``not_run``); once it wants none, (A) every D has a B* and a choice that
does not grow with D exists (the TPU's seconds per round do not fall as D
grows), (B) no D has one, (C) otherwise; ``outcome_so_far`` is that label
on the fits in hand. Where a D has no B*, the bars that fail there at the
budget nearest the TPU run's evaluations are named.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shlex
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "tools", "torch_muse_bench.py")
SPAXELS = (100, 1000, 4223)
START, FLOOR, CEIL = 1024, 256, 8192  # the integrators' floor, the tool's
STAGE2_SEEDS = {100: (2, 3, 4, 5)}  # where several TPU runs exist
STAGE2_SEEDS_DEFAULT = (2, 3)
CAP = 100000
RATIO_BAR = (0.5, 2.0)
RANGE_WIDEN = 2.0
MIN_ITERATIONS = 90000
STATS = ("niter", "ndraws", "member_overflow", "pile_peak", "stalled",
         "running_at_cap", "fill_rounds", "advances", "peak_mem_GB")
TPU_STATS = ("niter", "ndraws", "member_overflow", "pile_peak", "stalled")
FIT_NAME = re.compile(r"D(\d+)_B(\d+)_s(\d+)\.json$")
TPU_NAME = re.compile(r"muse_(\d+)(_[a-z]+)?\.stats\.json$")


# ---------------------------------------------------------------- records

def tpu_runs(root=ROOT) -> dict:
    """The JAX package's TPU runs of ``tools/muse_bench.py``
    (``results/muse_<N>[_<name>].stats.json``), by spaxel count (their
    ``ndata``), each with its file and ``TPU_STATS``; the run that
    ``tools/torch_muse_bench.py`` holds a fit to first."""
    from tools.torch_muse_bench import JAX_RUNS

    ref = {os.path.basename(p) for p in JAX_RUNS.values()}
    out = {}
    folder = os.path.join(root, "results")
    for name in sorted(os.listdir(folder)):
        if not TPU_NAME.fullmatch(name):
            continue
        with open(os.path.join(folder, name)) as fh:
            rec = json.load(fh)
        run = dict(file=f"results/{name}", **{k: rec[k] for k in TPU_STATS})
        runs = out.setdefault(rec["ndata"], [])
        runs.insert(0, run) if name in ref else runs.append(run)
    return out


def fit_summary(line: dict, rc=None) -> dict:
    """One ``tools/torch_muse_bench.py --out`` line, cut to what the
    record keeps."""
    o = line["options"]
    return dict(n_spaxels=o["n_spaxels"], fill_budget=o["fill_budget"],
                seed=o["seed"], cap=o["cap"],
                dispatch_target=o["dispatch_target"], rc=rc,
                **{k: line.get(k) for k in STATS + (
                    "evals_per_advance", "budget_bound_chunks",
                    "first_budget_bound_chunk", "at_tolerance", "nan_logZ",
                    "n_stalled_datasets", "chunks", "wall_s", "bars",
                    "ndraws_over_jax_run", "card", "cube_sha256")})


def load_fits(paths) -> list:
    """The fits in ``paths`` (files or directories of ``D<N>_B<B>_s<s>.json``
    lines), one per (spaxels, budget, seed): a later path's replaces an
    earlier one's. A sweep's ``status.json`` beside them gives each its rc."""
    found = {}
    for path in paths:
        files = [path] if os.path.isfile(path) else [
            os.path.join(path, f) for f in sorted(os.listdir(path))
            if FIT_NAME.fullmatch(f)]
        status = os.path.join(os.path.dirname(files[0]) if files else path,
                              "..", "status.json")
        rcs = {}
        if os.path.exists(status):
            with open(status) as fh:
                rcs = {d["name"]: d["rc"] for d in json.load(fh)["done"]}
        for f in files:
            with open(f) as fh:
                s = fit_summary(json.load(fh), rcs.get(os.path.basename(f)))
            found[(s["n_spaxels"], s["fill_budget"], s["seed"])] = s
    return [found[k] for k in sorted(found)]


def spread(values) -> dict | None:
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    return dict(min=min(vals), median=statistics.median(vals),
                max=max(vals))


def summarize(fits) -> dict:
    """``{spaxels: {budget: {seeds, stat: {min, median, max}}}}`` over the
    seeds of each (spaxels, budget)."""
    out = {}
    for f in fits:
        out.setdefault(f["n_spaxels"], {}).setdefault(
            f["fill_budget"], []).append(f)
    return {d: {b: dict(seeds=sorted(f["seed"] for f in group),
                        **{k: spread(f[k] for f in group) for k in STATS})
                for b, group in sorted(by_b.items())}
            for d, by_b in sorted(out.items())}


def ratios(summary: dict, tpu: list) -> dict:
    """Each statistic's minimum, median and maximum over seeds, over the
    TPU run's (``tpu[0]``)."""
    ref = tpu[0]
    return {k: {q: (v / ref[k] if ref[k] else None)
                for q, v in summary[k].items()}
            for k in TPU_STATS if summary.get(k)}


def bars(median: dict, tpu: list) -> dict:
    """The bars (i)-(iii) on a (spaxels, budget)'s seed medians against
    the TPU runs at that spaxel count (``tpu[0]`` the run of record):
    name -> held, and ``met`` (all held)."""
    lo, hi = RATIO_BAR
    held = dict(evaluations=lo <= median["ndraws"] / tpu[0]["ndraws"] <= hi,
                iterations=median["niter"] >= MIN_ITERATIONS)
    for k in ("member_overflow", "pile_peak"):
        if len(tpu) > 1:
            vals = [r[k] for r in tpu]
            held[k] = (min(vals) / RANGE_WIDEN <= median[k]
                       <= max(vals) * RANGE_WIDEN)
        else:
            held[k] = lo <= median[k] / tpu[0][k] <= hi
    held["met"] = all(held.values())
    return held


def nearest(medians: dict, target: float):
    """The budget whose evaluations lie nearest ``target`` (in ratio)."""
    return min(medians, key=lambda b: (abs(math.log(medians[b] / target)), b))


def consistent_choice(met: dict):
    """A budget per spaxel count from ``met`` ({spaxels: [budgets]}) that
    does not grow with the spaxel count (the largest such), or None."""
    choice, ceiling = {}, math.inf
    for d in sorted(met):
        ok = [b for b in met[d] if b <= ceiling]
        if not ok:
            return None
        choice[d] = ceiling = max(ok)
    return choice


def verdict(held: dict, medians: dict, tpu: dict, pending=()) -> dict:
    """B*(D) and the outcome from the bars of each (spaxels, budget)
    (``held``: {spaxels: {budget: bars}}), the seed-median evaluations
    (``medians``: {spaxels: {budget: E}}) and the TPU runs. While the
    search still wants fits (``pending``) the outcome is ``"open"``, and
    ``outcome_so_far`` the one the fits in hand give."""
    met = {d: sorted(b for b, h in by_b.items() if h["met"])
           for d, by_b in held.items()}
    choice = consistent_choice(met)
    common = sorted(set.intersection(*(set(v) for v in met.values()))) \
        if met else []
    if met and all(met.values()):
        so_far = "A" if choice else "C"
    elif not any(met.values()):
        so_far = "B"
    else:
        so_far = "C"
    parts = {}
    for d, by_b in held.items():
        if met[d]:
            continue
        b = nearest(medians[d], tpu[d][0]["ndraws"])
        parts[d] = dict(nearest_budget=b, failed=[
            k for k, v in by_b[b].items() if k != "met" and not v],
            failed_at_every_budget=[
                k for k in by_b[b] if k != "met"
                and not any(h[k] for h in by_b.values())])
    return dict(b_star=met, consistent=choice, one_budget=common,
                outcome="open" if pending else so_far,
                outcome_so_far=so_far, pending=len(pending), parts=parts,
                grows_with_d=bool(met and all(met.values()) and not choice))


def record(fits: list, tpu: dict) -> dict:
    """The whole record: the TPU runs, every fit, the statistics, ratios
    and bars of each (spaxels, budget), the verdict, and the fits the
    search still wants (``not_run``)."""
    summ = summarize(fits)
    by_d, held, medians = {}, {}, {}
    for d, by_b in summ.items():
        if d not in tpu:
            raise SystemExit(f"no TPU run at {d} spaxels")
        by_d[d] = {}
        for b, s in by_b.items():
            med = {k: v["median"] for k, v in s.items()
                   if isinstance(v, dict)}
            h = bars(med, tpu[d])
            by_d[d][b] = dict(s, ratios=ratios(s, tpu[d]), bars=h)
            held.setdefault(d, {})[b] = h
            medians.setdefault(d, {})[b] = med["ndraws"]
    cards = sorted({f["card"] for f in fits if f.get("card")})
    done = {(f["n_spaxels"], f["fill_budget"], f["seed"]): f["ndraws"]
            for f in fits}
    not_run = [fit_name(k) for k in wanted(done, tpu, sorted(summ))]
    return dict(
        card=cards[0] if len(cards) == 1 else cards,
        options="tools/torch_muse_bench.py's own but --dispatch-target 0 "
                "--fill-budget B --cap 100000 --seed s",
        bar_rules=dict(ratio=RATIO_BAR, range_widen=RANGE_WIDEN,
                       min_iterations=MIN_ITERATIONS),
        tpu_runs={d: tpu[d] for d in summ},
        by_spaxels=by_d, verdict=verdict(held, medians, tpu, not_run),
        not_run=not_run, fits=fits)


# ------------------------------------------------------------------ sweep

def next_stage1(es: dict, target: float, start=START, floor=FLOOR,
                ceil=CEIL):
    """The next budget at which to fit seed 1, given its evaluations at the
    budgets fitted so far (``es``: {budget: E}): ``start`` first, then by
    factors of 2 towards ``target``; None once two budgets bracket it or
    the step would pass ``floor`` or ``ceil``."""
    if not es:
        return start
    below = [b for b, e in es.items() if e < target]
    above = [b for b, e in es.items() if e >= target]
    if below and above:
        return None
    b = max(below) * 2 if below else min(above) // 2
    return b if floor <= b <= ceil else None


def stage2_budgets(es: dict, target: float) -> list:
    """The two budgets that bracket ``target`` (the largest below it, the
    smallest at or above it), else the nearest one."""
    below = [b for b, e in es.items() if e < target]
    above = [b for b, e in es.items() if e >= target]
    if below and above:
        return [max(below), min(above)]
    return [nearest(es, target)]


def wanted(done: dict, tpu: dict, spaxels) -> list:
    """The fits (spaxels, budget, seed) still wanted by the search, given
    the evaluations of the fits done (``done``: {(d, b, s): E}): seed 1's
    next budget at each spaxel count, then, once its budgets bracket the
    TPU run's (or the search ended), the stage-2 seeds there."""
    out = []
    for d in spaxels:
        target = tpu[d][0]["ndraws"]
        es = {b: e for (dd, b, s), e in done.items() if dd == d and s == 1}
        nxt = next_stage1(es, target)
        if nxt is not None:
            out.append((d, nxt, 1))
            continue
        seeds = STAGE2_SEEDS.get(d, STAGE2_SEEDS_DEFAULT)
        out += [(d, b, s) for b in stage2_budgets(es, target) for s in seeds]
    return [k for k in out if k not in done]


def fit_name(key):
    return "D{}_B{}_s{}.json".format(*key)


def plan(args, tpu):
    """The fits to run: ``--only``'s, else the search (``wanted``)."""
    def todo(done):
        if not args.only:
            return wanted(done, tpu, SPAXELS)
        keys = (tuple(int(x) for x in e.split(":")) for e in args.only)
        return [k for k in keys if k not in done]
    return todo


def sweep(args) -> int:
    """The fits one at a time, each its own ``tools/torch_muse_bench.py``
    process, until the plan is done or ``--stop-after`` seconds have
    passed (a fit still running then is ended); ``status.json`` lists
    each fit's rc and wall."""
    fits = os.path.join(args.out_dir, "fits")
    logs = os.path.join(args.out_dir, "logs")
    os.makedirs(fits, exist_ok=True)
    os.makedirs(logs, exist_ok=True)
    done = {(f["n_spaxels"], f["fill_budget"], f["seed"]): f["ndraws"]
            for f in load_fits(args.have)}
    status = dict(card=None, done=[], killed=None, queue=[])
    if args.device == "cuda":
        status["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(status["card"], flush=True)
    todo = plan(args, None if args.only else tpu_runs())
    t0 = time.time()
    while todo(done):
        key = todo(done)[0]
        left = args.stop_after - (time.time() - t0)
        if left <= 0:
            break
        out = os.path.join(fits, fit_name(key))
        d, b, seed = key
        cmd = [sys.executable, BENCH, "--device", args.device,
               "--n-spaxels", str(d), "--fill-budget", str(b),
               "--seed", str(seed), "--cap", str(args.cap),
               "--dispatch-target", "0", "--out", out] \
            + shlex.split(args.bench_args)
        print(f"[{time.time() - t0:8.1f} s] start {fit_name(key)}",
              flush=True)
        start = time.time()
        with open(os.path.join(logs, fit_name(key)[:-5] + ".log"),
                  "w") as log:
            try:
                rc = subprocess.run(
                    cmd, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
                    timeout=None if math.isinf(left) else left).returncode
            except subprocess.TimeoutExpired:
                status["killed"] = dict(name=fit_name(key),
                                        ran_s=time.time() - start)
                break
        entry = dict(name=fit_name(key), rc=rc, wall_s=time.time() - start)
        status["done"].append(entry)
        print(f"[{time.time() - t0:8.1f} s] end {entry}", flush=True)
        if not os.path.exists(out):  # no line: the search cannot go on
            break
        with open(out) as fh:
            done[key] = entry["ndraws"] = json.load(fh)["ndraws"]
        with open(os.path.join(args.out_dir, "status.json"), "w") as fh:
            json.dump(status, fh, indent=1)
    status["queue"] = [fit_name(k) for k in todo(done)]
    with open(os.path.join(args.out_dir, "status.json"), "w") as fh:
        json.dump(status, fh, indent=1)
    print(json.dumps(dict(done=len(status["done"]),
                          killed=status["killed"],
                          queue=status["queue"])), flush=True)
    return 0


# ------------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("sweep", help="run the fits (on the card)")
    s.add_argument("--out-dir", required=True)
    s.add_argument("--only", nargs="*", default=[],
                   help="these fits instead of the search, as "
                        "SPAXELS:BUDGET:SEED")
    s.add_argument("--have", nargs="*", default=[],
                   help="directories of fits of an earlier run")
    s.add_argument("--cap", type=int, default=CAP)
    s.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    s.add_argument("--stop-after", type=float, default=math.inf,
                   help="start no fit after these seconds, and end the "
                        "one running then")
    s.add_argument("--bench-args", default="",
                   help="more tools/torch_muse_bench.py options")
    r = sub.add_parser("record", help="gather the fits, write the verdict")
    r.add_argument("paths", nargs="+")
    r.add_argument("--repeat", nargs="*", default=[],
                   help="status.json files whose 'repeat' (a fit run again "
                        "alone, held to its run beside others) the record "
                        "carries")
    r.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.cmd == "sweep":
        if args.device == "cuda":
            import torch

            if not torch.cuda.is_available():
                print("muse_tpu_budget: no CUDA card (pass --device cpu to "
                      "rehearse)", file=sys.stderr)
                return 1
        return sweep(args)
    rec = record(load_fits(args.paths), tpu_runs())
    reps = []
    for path in args.repeat:
        with open(path) as fh:
            reps.append(json.load(fh).get("repeat"))
    rec["repeats"] = reps
    with open(args.out, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps(dict(verdict=rec["verdict"], card=rec["card"],
                          file=args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
