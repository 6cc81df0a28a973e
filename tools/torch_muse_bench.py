"""The MUSE headline benchmark on the port: the counterpart of
``tools/muse_bench.py``.

    # on the card, 4,223 spaxels at muse_bench.py's options (its first 2
    # chunks also run eagerly and held bit for bit)
    python3 tools/torch_muse_bench.py --eager-chunks 2 --out muse_bench_4223.json
    # in pieces of at most 20 chunks (exit 75: interrupted, run it again)
    while python3 tools/torch_muse_bench.py --checkpoint-dir ck \
        --max-chunks 20; [ $? -eq 75 ]; do :; done
    # at the options of the JAX package's CPU record, held to it
    python3 tools/torch_muse_bench.py --cap 800 --dispatch-target 0 \
        --checkpoint-dir ck --jax-record muse_bench_4223_jax.json
    # a rehearsal on the CPU (seconds)
    python3 tools/torch_muse_bench.py --device cpu --n-spaxels 20 \
        --nspec 64 --nlive 50 --cap 100

The cube and templates are ``tools/muse_bench.py``'s, made with the port's
``synth``: a ``side`` x ``side`` field with side = ceil(sqrt(N / 0.75)) + 1
(77 at N = 4,223), ``make_synthetic_cube(nspec=3600, seed=1)`` (a
continuum of amplitude 0.5-2.0 with no template behind it, noise 0.05),
``make_template_files(n_wl=1200)``, loaded as ``run_musefit`` loads it
(``maxdata=N``, the real-MUSE bad windows) and fitted by ``fit_muse``
with the FULL model over z in [0, 0.3] (``run_musefit`` without its HDF5
output, which needs h5py). The options are ``tools/muse_bench.py:26-71``
and ``:113-129``'s defaults, as flags: nlive 400, a 100,000-iteration
cap, eval batch 128, proposal and column-proposal pools of 8,192, a
fill budget of 8,192 rounds, chunks of 400 iterations, lookahead 2,
column rounds after 2 unfilled rounds, the wall-clock budget's target 12
s per chunk (``--dispatch-target 0``: off, the fixed budget alone), a
checkpoint every 2 chunks. None is read from the environment.

It prints one JSON line: the JAX tool's fields and its ``.stats.json``'s
(evaluations, iterations, stalled, member overflow, pile peak, wall,
evaluations per second), fill rounds, label refreshes and the largest
group count, the host seconds of the labels and of the tail, peak device
memory, both kernels' launches, every option, the cube's SHA-256, the
fit's progress (``advance_summary``: spaxel advances, the dead rows with
``idx >= 0``; evaluations per advance; the chunks that used their whole
fill budget and the first of them; the mean budget per chunk; the
quantiles of the advances per spaxel), and a record per chunk
(``torch_muse_validate.chunk_records``); ``--out`` writes it too.
``held_to_seeds`` holds one package's seeds against the other's
(``tools/muse_seed_spread.py``, ``tools/muse_rounds_from_state.py
--combine``). The wall is the fits' (the cube's making and the kernels'
build excluded), summed over the legs of a run resumed from
``--checkpoint-dir`` (each leg appends to ``legs.jsonl`` there; the
first writes the options and the cube's SHA-256 to ``bench_run.json``,
and a later leg with others is refused). Beside it
stand the counts of the JAX package's committed run at this spaxel count
(``results/muse_N.stats.json``; its walls were TPU walls and are not
printed). The paper's 140 h for 4,223 spaxels was the original code's, on
an unspecified CPU.

Bars (``bars`` in the line; exit 1 if one fails, 75 if the run was
interrupted, else 0): no NaN logZ and every spaxel stopped at tolerance
or at the cap; with ``--jax-record`` (``tools/jax_muse_rounds.py --cube
bench``'s output at the same options), iterations, evaluations and fill
rounds within [0.5, 2] x its own (the ratios per chunk printed too; the
advances and evaluations per advance beside them, no bar); at
muse_bench.py's own cap and spaxel count, evaluations within [0.5, 2] x
the committed JAX run's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTERRUPTED = 75
LEGS = "legs.jsonl"
RUN = "bench_run.json"  # the options and cube of a --checkpoint-dir's run
RATIO_BAR = (0.5, 2.0)
ZLO, ZHI = 0.0, 0.3
N_WL = 1200
# the JAX package's committed runs of tools/muse_bench.py, by spaxel count
JAX_RUNS = {100: "results/muse_100_completed.stats.json",
            1000: "results/muse_1000.stats.json",
            4223: "results/muse_4223.stats.json"}
JAX_RUN_CAP = 100000  # tools/muse_bench.py's MAXSAMPLES
# the reference's published MUSE figures (pres/massivens4.lyx:2230): the
# original code, on an unspecified CPU
PAPER = {100: dict(hours=14.9, evaluations=2.8e6),
         4223: dict(hours=140.0, evaluations=14.4e6)}


def add_options(ap):
    """``tools/muse_bench.py``'s options, at its defaults."""
    ap.add_argument("--n-spaxels", type=int, default=4223)
    ap.add_argument("--nspec", type=int, default=3600)
    ap.add_argument("--nlive", type=int, default=400)
    ap.add_argument("--cap", type=int, default=100000,
                    help="iteration cap (max_samples)")
    ap.add_argument("--eval-batch", type=int, default=128)
    ap.add_argument("--proposal-batch", type=int, default=8192,
                    help="region and column proposal pools")
    ap.add_argument("--fill-budget", type=int, default=8192,
                    help="fill rounds per chunk (chunk_fill_budget)")
    ap.add_argument("--chunk-iters", type=int, default=400)
    ap.add_argument("--lookahead", type=int, default=2)
    ap.add_argument("--fallback-rounds", type=int, default=2,
                    help="column_focus_fallback_rounds")
    ap.add_argument("--dispatch-target", type=float, default=12.0,
                    help="wall-clock budget's seconds per chunk (0: off)")
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)


def defaults() -> dict:
    """``options`` at ``tools/muse_bench.py``'s defaults."""
    ap = argparse.ArgumentParser()
    add_options(ap)
    return options(ap.parse_args([]))


def options(args) -> dict:
    return {k: getattr(args, k) for k in (
        "n_spaxels", "nspec", "nlive", "cap", "eval_batch",
        "proposal_batch", "fill_budget", "chunk_iters", "lookahead",
        "fallback_rounds", "dispatch_target", "checkpoint_every", "seed")}


def config_fields(opts: dict) -> dict:
    """The ``RunConfig`` fields of the options (both packages' configs
    take them): ``tools/muse_bench.py``'s ``run_musefit`` call, tolerance
    0.5, no eval-batch escalation."""
    return dict(nlive_points=opts["nlive"], tolerance=0.5,
                max_samples=opts["cap"], seed=opts["seed"],
                chunk_fill_budget=opts["fill_budget"],
                chunk_iters=opts["chunk_iters"],
                pipeline_lookahead=opts["lookahead"],
                eval_batch=opts["eval_batch"],
                proposal_batch=opts["proposal_batch"],
                column_proposal_batch=opts["proposal_batch"],
                column_focus_fallback_rounds=opts["fallback_rounds"])


def bench_side(n_spaxels: int) -> int:
    """``tools/muse_bench.py``'s field side: the ds9 circle covers about
    pi/4 of the field, so that at least ``n_spaxels`` lie inside."""
    return max(2, math.ceil(math.sqrt(n_spaxels / 0.75)) + 1)


def build_bench_cube(tmp, n_spaxels=4223, nspec=3600):
    """``tools/muse_bench.py``'s cube, region and templates, made with the
    port's ``synth`` in ``tmp``: ``(cube_path, region_path, templates)``."""
    from massivedatans_tpu_torch.muse import synth

    side = bench_side(n_spaxels)
    cube_path = os.path.join(tmp, f"cube_{n_spaxels}.fits")
    region_path = os.path.join(tmp, f"sel_{n_spaxels}.reg")
    synth.make_synthetic_cube(cube_path, region_path, nspec=nspec, ny=side,
                              nx=side, seed=1)
    tpl = synth.make_template_files(os.path.join(tmp, "templates"),
                                    n_wl=N_WL)
    return cube_path, region_path, tpl


def load_bench_cube(tmp, n_spaxels=4223, nspec=3600):
    """``build_bench_cube`` loaded as ``run_musefit`` loads it (``maxdata``
    the spaxel count, the real-MUSE bad windows): ``(cube, templates)``."""
    from massivedatans_tpu_torch.muse.pipeline import load_muse_cube

    cube_path, region_path, tpl = build_bench_cube(tmp, n_spaxels, nspec)
    cube = load_muse_cube(cube_path, region_path, maxdata=n_spaxels,
                          bad_windows=None)
    assert cube.y.shape[1] == n_spaxels, cube.y.shape
    return cube, tpl


def cube_sha256(cube) -> str:
    """SHA-256 of a loaded cube's data and variance as little-endian
    float64."""
    import numpy as np

    return hashlib.sha256(
        np.ascontiguousarray(cube.y, "<f8").tobytes()
        + np.ascontiguousarray(cube.var, "<f8").tobytes()).hexdigest()


def group_every(nlive: int, n_spaxels: int) -> int:
    """The integrator's label cadence (``group_refresh_chunks`` 0: every
    chunk while K*D <= 2^20, else every 4th)."""
    return 1 if nlive * n_spaxels <= 1 << 20 else 4


def jax_counts(n_spaxels: int):
    """The committed JAX run's counts at this spaxel count, or None."""
    path = JAX_RUNS.get(n_spaxels)
    if path is None:
        return None
    with open(os.path.join(ROOT, path)) as fh:
        rec = json.load(fh)
    return dict(source=path, cap=JAX_RUN_CAP, **{k: rec[k] for k in (
        "ndraws", "niter", "stalled", "member_overflow", "pile_peak")})


QUANTILES = dict(min=0.0, q05=0.05, q50=0.5, q95=0.95, max=1.0)
# the statistics held_to_seeds compares, and its bars: the port's median
# within SEED_MEDIAN_BAR x the JAX package's, and a two-sided Mann-Whitney
# U test over the seeds at p >= SEED_P_BAR
SEED_KEYS = ("ndraws", "advances", "evals_per_advance",
             "first_budget_bound_chunk")
SEED_MEDIAN_BAR = (0.5, 2.0)
SEED_P_BAR = 0.01


def advance_summary(per_chunk: list, per_spaxel, ndraws: int) -> dict:
    """A fit's progress from its per-chunk records (``torch_muse_validate
    .ChunkRows``) and each spaxel's advances (``per_spaxel``): the
    advances, the evaluations per advance, the chunks that used their
    whole fill budget and the first of them (None: none did), the mean
    budget per chunk, and the quantiles of the advances per spaxel.
    Records without advances (written before they were counted) give None
    for each."""
    import numpy as np

    if not per_chunk or any("advances" not in r for r in per_chunk):
        return dict(advances=None, evals_per_advance=None,
                    budget_bound_chunks=None, first_budget_bound_chunk=None,
                    mean_budget=None, advance_quantiles=None)
    total = sum(r["advances"] for r in per_chunk)
    bound = [r["chunk"] for r in per_chunk if r["budget_bound"]]
    budgets = [r["budget"] for r in per_chunk if r["budget"]]
    return dict(
        advances=total, evals_per_advance=ndraws / total if total else None,
        budget_bound_chunks=len(bound),
        first_budget_bound_chunk=bound[0] if bound else None,
        mean_budget=sum(budgets) / len(budgets) if budgets else None,
        advance_quantiles=None if per_spaxel is None else {
            k: float(np.quantile(per_spaxel, q))
            for k, q in QUANTILES.items()})


def with_totals(per_chunk: list) -> list:
    """Copies of a fit's per-chunk records, each with ``advances_total``,
    the advances through its chunk; records without advances are copied
    as they are."""
    out, total = [], 0
    for r in per_chunk:
        if "advances" not in r:
            return [dict(r) for r in per_chunk]
        total += r["advances"]
        out.append(dict(r, advances_total=total))
    return out


def held_to_seeds(port: list, jax: list, keys=SEED_KEYS) -> dict:
    """The port's fits over the JAX package's, seed against seed spread:
    for each statistic of ``keys`` (fit summaries' fields), both medians,
    their ratio, the two-sided Mann-Whitney U test's p over the seeds, and
    whether the port matches (``held``: ratio within ``SEED_MEDIAN_BAR``
    and p >= ``SEED_P_BAR``). A fit with no budget-bound chunk counts its
    onset as the chunk after its last. A statistic that either side has
    for no fit is None."""
    import numpy as np
    from scipy.stats import mannwhitneyu

    def values(fits, key):
        out = []
        for f in fits:
            v = f.get(key)
            if v is None and key == "first_budget_bound_chunk" \
                    and f.get("budget_bound_chunks") is not None:
                v = f["per_chunk"][-1]["chunk"] + 1
            if v is not None:
                out.append(float(v))
        return out

    lo, hi = SEED_MEDIAN_BAR
    out = {}
    for key in keys:
        p_vals, j_vals = values(port, key), values(jax, key)
        if not p_vals or not j_vals:
            out[key] = None
            continue
        pm, jm = float(np.median(p_vals)), float(np.median(j_vals))
        ratio = pm / jm
        p = float(mannwhitneyu(p_vals, j_vals,
                               alternative="two-sided").pvalue)
        out[key] = dict(port_median=pm, jax_median=jm, ratio=ratio, p=p,
                        n_port=len(p_vals), n_jax=len(j_vals),
                        held=bool(lo <= ratio <= hi and p >= SEED_P_BAR))
    return out


def held_to_record(line: dict, record: dict) -> dict:
    """The fit's counts over the JAX CPU record's (its seed-matched fit,
    else its first), in total and per chunk, and whether each total lies
    within ``RATIO_BAR``. A fit capped below the record's cap is held at
    the chunk that ends at its cap, in both. The advances and the
    evaluations per advance stand beside them (None where a record was
    written before they were counted) and are no bar."""
    fits = record["fits"]
    ref = next((f for f in fits if f["seed"] == line["options"]["seed"]),
               fits[0])
    keys = ("niter", "ndraws", "fill_rounds")
    jax_rows = {r["chunk"]: r for r in ref.get("per_chunk", [])}
    mine, theirs, total = line, ref, "advances"
    cap = line["options"].get("cap", record["cap"])
    if cap != record["cap"]:
        mine = next(r for r in line["per_chunk"] if r["niter"] == cap)
        theirs = jax_rows[mine["chunk"]]
        assert theirs["niter"] == mine["niter"], (theirs, mine)
        total = "advances_total"

    def progress(counts):
        adv = counts.get(total)
        return dict(advances=adv, evals_per_advance=(
            counts["ndraws"] / adv if adv else None))

    ratios = {k: mine[k] / theirs[k] for k in keys}
    mp, tp = progress(mine), progress(theirs)
    per_chunk = [dict(chunk=r["chunk"], **{
        k: r[k] / jax_rows[r["chunk"]][k] for k in keys
        if jax_rows[r["chunk"]][k]}) for r in line["per_chunk"]
        if r["chunk"] in jax_rows]
    lo, hi = RATIO_BAR
    return dict(jax_seed=ref["seed"], at_niter=mine["niter"],
                jax={k: theirs[k] for k in keys},
                port={k: mine[k] for k in keys}, ratios=ratios,
                progress=dict(jax=tp, port=mp, ratios={
                    k: mp[k] / tp[k] if mp[k] and tp[k] else None
                    for k in mp}),
                per_chunk=per_chunk,
                held={k: lo <= v <= hi for k, v in ratios.items()})


def claim_checkpoint_dir(ck, opts, sha):
    """Write the run's options and cube SHA-256 into ``ck`` on its first
    leg; on a later leg, refuse (``SystemExit``) a directory whose run had
    other options or another cube, or that this tool did not start."""
    path = os.path.join(ck, RUN)
    mine = dict(options=opts, cube_sha256=sha)
    if not os.path.exists(path):
        from massivedatans_tpu_torch.io import checkpoint as ckpt

        if ckpt.has_checkpoint(ck):
            raise SystemExit(f"{ck} holds a checkpoint of another run "
                             f"(no {RUN}): give a fresh --checkpoint-dir")
        os.makedirs(ck, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(mine, fh, indent=1)
        return
    with open(path) as fh:
        theirs = json.load(fh)
    if theirs != mine:
        raise SystemExit(f"{ck} holds a run with other options or another "
                         f"cube ({RUN}: {theirs}): give a fresh "
                         "--checkpoint-dir")


def eager_check(cube, tpl, cfg, device, chunks, tmp):
    """The fit's first ``chunks`` chunks on the captured path and again
    eagerly from the same seed: their digests and both kernels' launches,
    and whether they are equal bit for bit."""
    from chip_smoke import _bitwise, _fit_digest
    from massivedatans_tpu_torch.muse.pipeline import fit_muse
    from massivedatans_tpu_torch.ops import neighbors

    runs = {}
    for eager in (False, True):
        neighbors.count_within.launches = 0
        neighbors.bootstrapped_sq_radius.launches = 0
        t0 = time.perf_counter()
        res, _ = fit_muse(cube, tpl, ZLO, ZHI, "FULL", cfg, device=device,
                          eager=eager, max_chunks=chunks,
                          checkpoint_dir=os.path.join(tmp, f"eager{eager}"))
        runs[eager] = dict(
            digest=_fit_digest(res), path=res.stats["chunk_path"],
            wall_s=time.perf_counter() - t0,
            launches=dict(count_within=neighbors.count_within.launches,
                          bootstrapped_sq_radius=neighbors
                          .bootstrapped_sq_radius.launches))
    g, e = runs[False], runs[True]
    bitwise = _bitwise(g["digest"], e["digest"])
    bitwise["launches"] = g["launches"] == e["launches"]
    return dict(chunks=chunks, paths=[g["path"], e["path"]],
                walls_s=[g["wall_s"], e["wall_s"]],
                launches=g["launches"], niter=g["digest"]["niter"],
                ndraws=g["digest"]["ndraws"], bitwise=bitwise,
                held=all(bitwise.values()))


def run(args, device, card=None):
    """One leg of the benchmark (``args`` from ``main``'s parser); returns
    the printed line."""
    import numpy as np
    import torch

    from massivedatans_tpu_torch.config import RunConfig
    from massivedatans_tpu_torch.io import checkpoint as ckpt
    from massivedatans_tpu_torch.muse.pipeline import fit_muse
    from massivedatans_tpu_torch.ops import neighbors
    from tools.torch_muse_validate import chunk_records

    opts = options(args)
    cfg = RunConfig(**config_fields(opts))
    ck = args.checkpoint_dir
    done = ckpt.load_meta(ck)["chunk_index"] if (
        ck is not None and ckpt.has_checkpoint(ck)) else 0
    run_opts = dict(dispatch_target_s=args.dispatch_target or None,
                    checkpoint_every=args.checkpoint_every)
    if ck is not None:
        run_opts.update(checkpoint_dir=ck)
        if args.max_chunks is not None:
            run_opts.update(max_chunks=done + args.max_chunks)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cube, tpl = load_bench_cube(tmp, args.n_spaxels, args.nspec)
        cube_s = time.perf_counter() - t0
        sha = cube_sha256(cube)
        if ck is not None:
            claim_checkpoint_dir(ck, opts, sha)
        eager = None
        if args.eager_chunks and not done:
            eager = eager_check(cube, tpl, cfg, device, args.eager_chunks,
                                tmp)
            print(json.dumps(dict(eager_check=eager)), flush=True)
        neighbors.count_within.launches = 0
        neighbors.bootstrapped_sq_radius.launches = 0
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with chunk_records(first_chunk=done, group_every=group_every(
                args.nlive, args.n_spaxels)) as per_chunk:
            result, problem = fit_muse(cube, tpl, ZLO, ZHI, "FULL", cfg,
                                       device=device, progress=args.progress,
                                       **run_opts)
        wall = time.perf_counter() - t0
    st = result.stats
    leg = dict(chunks=[done, st["chunks"]], wall_s=wall,
               niter=result.niterations, ndraws=result.ndraws,
               group_refreshes=st["group_refreshes"],
               n_groups_max=st["n_groups_max"], timing=st["timing"],
               steps=st["steps"], peak_mem_GB=(
                   torch.cuda.max_memory_allocated() / 1e9
                   if device == "cuda" else None),
               launches=dict(count_within=neighbors.count_within.launches,
                             bootstrapped_sq_radius=neighbors
                             .bootstrapped_sq_radius.launches),
               eager_check=eager)
    leg["per_spaxel"] = (None if per_chunk.per_spaxel is None
                         else per_chunk.per_spaxel.tolist())
    legs = [leg]
    if ck is not None:
        with open(os.path.join(ck, LEGS), "a") as fh:
            fh.write(json.dumps(dict(leg, per_chunk=per_chunk)) + "\n")
        with open(os.path.join(ck, LEGS)) as fh:
            legs = [json.loads(line) for line in fh]
    total = sum(lg["wall_s"] for lg in legs)

    def summed(key):
        out = {}
        for lg in legs:
            for k, v in lg[key].items():
                out[k] = out.get(k, 0) + v
        return out

    logZ = np.asarray(result.logZ)
    term = np.asarray(result.mask)[:result.niterations].sum(axis=0)
    capped = int((term > args.cap).sum()) if result.niterations > args.cap \
        else 0
    timing = summed("timing")
    per_chunk = [r for lg in legs[:-1] for r in lg.get("per_chunk", [])] \
        + per_chunk
    spax = [lg.get("per_spaxel") for lg in legs]
    spax = (None if any(v is None for v in spax)
            else np.sum([np.asarray(v) for v in spax], axis=0))
    peaks = [lg["peak_mem_GB"] for lg in legs if lg["peak_mem_GB"]]
    line = dict(
        metric=f"MUSE pipeline, {problem.ndata} spaxels, nspec={args.nspec}",
        ndraws=result.ndraws, niter=result.niterations,
        stalled=st["stalled"], n_stalled_datasets=int(np.sum(
            st["stalled_mask"])),
        member_overflow=st["member_overflow"], pile_peak=st["pile_peak"],
        fill_rounds=st["fill_rounds"],
        **advance_summary(per_chunk, spax, result.ndraws), wall_s=total,
        evals_per_s=result.ndraws / total if total else None,
        interrupted=st["interrupted"], chunks=st["chunks"],
        group_refreshes=sum(lg["group_refreshes"] for lg in legs),
        n_groups_max=max(lg["n_groups_max"] for lg in legs),
        labels_s=timing["groups_s"], tail_s=st["timing"]["tail_s"],
        timing=timing, peak_mem_GB=max(peaks) if peaks else None,
        launches=summed("launches"), steps=summed("steps"),
        chunk_path=st["chunk_path"],
        fill_budget_last=st["fill_budget_last"],
        graph_pool_GB=st["graph_pool_bytes"] / 1e9,
        nan_logZ=int(np.isnan(logZ).sum()),
        running_at_cap=capped, at_tolerance=int(problem.ndata - capped),
        options=opts, cube_sha256=sha, cube_s=cube_s, device=device,
        card=card, legs=[{k: lg[k] for k in ("chunks", "wall_s", "niter",
                                             "ndraws")} for lg in legs],
        eager_check=legs[0]["eager_check"],
        per_chunk=with_totals(per_chunk),
        jax_run=jax_counts(args.n_spaxels),
        paper=PAPER.get(args.n_spaxels) and dict(
            PAPER[args.n_spaxels],
            note="the original code's wall, on an unspecified CPU"))
    return line


def bars(line, record=None) -> dict:
    """The bars of a finished run (name -> held)."""
    held = dict(finite_logZ=line["nan_logZ"] == 0,
                stopped=line["niter"] == line["options"]["cap"] + 1
                or line["running_at_cap"] == 0)
    if record is not None:
        line["against_jax_record"] = held_to_record(line, record)
        held.update({f"jax_record.{k}": v for k, v in
                     line["against_jax_record"]["held"].items()})
    jax = line["jax_run"]
    if jax is not None and line["options"]["cap"] == jax["cap"]:
        lo, hi = RATIO_BAR
        line["ndraws_over_jax_run"] = line["ndraws"] / jax["ndraws"]
        held["jax_run.ndraws"] = lo <= line["ndraws_over_jax_run"] <= hi
    return held


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_options(ap)
    ap.add_argument("--max-chunks", type=int, default=None,
                    help="chunks this call may run before it checkpoints")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--eager-chunks", type=int, default=0,
                    help="run the first chunks eagerly too, bit for bit")
    ap.add_argument("--jax-record", default=None,
                    help="tools/jax_muse_rounds.py --cube bench's output")
    ap.add_argument("--progress", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.max_chunks is not None and args.checkpoint_dir is None:
        ap.error("--max-chunks needs --checkpoint-dir")
    sys.path.insert(0, ROOT)
    import torch

    from massivedatans_tpu_torch.ops import _build

    card = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_muse_bench: no CUDA card (pass --device cpu to "
                  "rehearse)", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        print(card, flush=True)
        _build.load()
        _build.load_host()
    record = None
    if args.jax_record:
        with open(args.jax_record) as fh:
            record = json.load(fh)
    line = run(args, args.device, card)
    if not line["interrupted"]:
        line["bars"] = bars(line, record)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(line, fh, indent=1)
    print(json.dumps(line), flush=True)
    if line["interrupted"]:
        return INTERRUPTED
    eager_ok = line["eager_check"] is None or line["eager_check"]["held"]
    return 0 if all(line["bars"].values()) and eager_ok else 1


if __name__ == "__main__":
    sys.exit(main())
