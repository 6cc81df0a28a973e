"""MUSE model-family validation on the port, fitted to tolerance in
resumable pieces: the counterpart of ``tools/muse_validate.py``.

    # on the card, pieces of at most 20 chunks until the fit is done
    # (exit 75 means "interrupted, go on"; 0 done and every bar held;
    # 1 a bar failed)
    while python3 tools/torch_muse_validate.py --checkpoint-dir ck \
        --max-chunks 20 --out MUSE_VALIDATION_TORCH.json; [ $? -eq 75 ]; do :; done
    # the same fit in one process, without a checkpoint
    python3 tools/torch_muse_validate.py
    # a rehearsal on the CPU at a tiny size (about a minute)
    python3 tools/torch_muse_validate.py --device cpu --side 3 --nspec 100 \
        --n-wl 100 --nlive 50 --flux 0.05 0.3 --out /tmp/v.json

The fixture is the JAX tool's, built with the port's ``synth`` as
``chip_smoke.muse_fixture`` builds it: 7 Z x 111 ages x ``--n-wl``
templates, a ``--side`` x ``--side`` cube drawn from the FULL model's
prior (nspec 3600, seed 11, flux 0.1-1.0, no bad-window inflation);
``build_fixture`` makes it, for ``chip_smoke.py`` too. The
options are the JAX run's (``tools/muse_validate.py:49,249-259``): nlive
400, tolerance 0.5, ``max_samples`` 300,000, no eval-batch escalation and
``dispatch_target_s`` 20, on the captured path. The fixture is made anew
from its seed in every piece. With ``dispatch_target_s`` on, a resumed run
is not bitwise the uninterrupted one (the budget follows the wall clock
and restarts at 512 rounds in each piece).

Each piece prints one JSON line (chunks, iterations, fill rounds,
evaluations, spaxels still running, the fill budget, both kernels'
launches, its wall, and ``per_chunk``: each chunk's counts as
``chunk_records`` takes them, the layout of
``tools/jax_muse_rounds.py``'s JAX records) and appends it to
``pieces.jsonl`` in the checkpoint directory; the output gathers the
pieces' ``per_chunk``. The piece that finishes computes ``analyze``: the
JAX tool's statistics (SBC rank KS per parameter, pull coverage, Z-bin
accuracy, the no-star identity, chi^2/dof), from the ``NSResult`` in
memory, and adds
the counts beside the JAX run's, the late-run fill rounds per iteration
and evaluations per round (from the pieces), and the bars:

- |median(logZ + yy/2)| <= 1.0 over the empty spaxels (JAX 0.25);
- median chi^2/dof in [0.98, 1.02] (JAX 0.9962);
- ``frac_chi2_z_below_5`` >= 0.95 (JAX 1.0);
- 3 sigma pull coverage of z and of EBV >= 0.80 (JAX 0.896, 0.859).

SBC and the Z / logSFtau coverage are reported only: they are the
reference's known miscalibration.

A spaxel counts as capped only if the run stopped at ``max_samples`` (the
integrator stops those still running one iteration past the cap) and it
was still running then. ``tools/muse_validate.py:116`` counts every
spaxel still running at the last dead row as capped, which in a run that
stops at tolerance misfiles those that stop at the last tolerance check:
its ``n_capped`` is not comparable with this tool's.

The JAX run of record (``MUSE_VALIDATION.json``, its checkpoint in
``muse_valid_out/ckpt_100``) did not run to tolerance: its state stops at
iteration 7,001 with 30 spaxels' termination iteration at 7,001, the
``iteration > max_samples`` stop of a cap at 7,000, after 44,652 fill
rounds (about 319 per 50-iteration chunk: the adaptive budget of its
device). ``--max-samples 7000 --chunk-fill-budget 319
--dispatch-target-s 0`` runs the port under that cap and that budget, the
like-for-like witness of its counts. The counts of the JAX run are read
from that checkpoint with numpy (``jax_run_counts``).

The card's name and power limit come first on a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTERRUPTED = 75
PIECES = "pieces.jsonl"
# the JAX run of record: its checkpoint's EngineState leaves, in the
# field order of massivedatans_tpu/ns/engine.py:42-94
JAX_STATE = os.path.join(ROOT, "muse_valid_out", "ckpt_100", "state.npz")
JAX_LEAVES = dict(iteration=18, ndraws=19, term_iter=26, fill_rounds=29)
JAX_CHUNK_ITERS = 50
# priors' spans of the FULL model (tools/muse_validate.py:150-151)
PRIOR_SPAN = {"Z": 3.0, "logSFtau": math.log10(4000 / 1),
              "SFage": 13.0, "z": 0.5, "EBV": 2.0}
BARS = dict(identity=1.0, chi2_dof=(0.98, 1.02), chi2_z_below_5=0.95,
            coverage_3sigma=0.80)


def build_fixture(tmp, side=10, nspec=3600, seed=11, flux=(0.1, 1.0),
                  n_wl=400):
    """The JAX tool's fixture, made with the port's ``synth`` in ``tmp``:
    ``(cube, templates, truths)``; ``chip_smoke.py``'s MUSE fixture at
    its defaults. The cube's wavelength step keeps the 4,500 A span of
    nspec 3600 at any ``nspec``."""
    from massivedatans_tpu_torch.muse import synth
    from massivedatans_tpu_torch.muse.pipeline import load_muse_cube

    tpl = synth.make_template_files(os.path.join(tmp, "templates"),
                                    n_wl=n_wl)
    n = side * side
    cube_path, reg, truths_path = synth.make_model_cube(
        os.path.join(tmp, f"model_cube_{n}.fits"),
        os.path.join(tmp, f"sel_{n}.reg"), tpl,
        os.path.join(tmp, f"truths_{n}.json"), ny=side, nx=side,
        nspec=nspec, seed=seed, flux_lo=flux[0], flux_hi=flux[1],
        cd3=1.25 * 3600 / nspec)
    # the synthetic cube has no sky residuals: no bad-window inflation
    cube = load_muse_cube(cube_path, reg, maxdata=n, bad_windows=[])
    with open(truths_path) as fh:
        truths = json.load(fh)
    return cube, tpl, truths


def termination_iters(mask, niter):
    """Per dataset, the iteration at which it stopped running: its count
    of running dead rows (the first ``niter`` rows of ``mask``)."""
    return mask[:niter].sum(axis=0)


def capped_mask(mask, niter, max_samples):
    """The datasets stopped by the ``max_samples`` cap: a capped run stops
    those still running at iteration ``max_samples + 1``, and only
    those."""
    import numpy as np

    if not max_samples:
        return np.zeros(mask.shape[1], bool)
    return termination_iters(mask, niter) > max_samples


def jax_run_counts(path=JAX_STATE):
    """The JAX run of record's counts, from its checkpoint's state:
    iterations, evaluations, fill rounds and each spaxel's termination
    iteration (``-1`` while running)."""
    import numpy as np

    with np.load(path) as z:
        leaf = {k: z[f"leaf_{i:03d}"] for k, i in JAX_LEAVES.items()}
    niter = int(leaf["iteration"])
    return dict(niter=niter, ndraws=int(leaf["ndraws"]),
                fill_rounds=int(leaf["fill_rounds"]),
                term_iter=leaf["term_iter"].astype(int),
                rounds_per_chunk=float(leaf["fill_rounds"])
                / (niter // JAX_CHUNK_ITERS))


def analyze(out, truths, capped, nlive, result_stats=None, wall=0.0,
            S=2000):
    """``tools/muse_validate.py::analyze``'s statistics from a result held
    in memory (``out``: ``logZ``, ``x``, ``L``, ``w``, ``mask``), with the
    same draws (``default_rng(0)``, ``S`` per spaxel in order) and the same
    rounding; ``capped`` is ``capped_mask``'s classification."""
    import numpy as np
    import scipy.stats

    from massivedatans_tpu_torch import postprocess
    from massivedatans_tpu_torch.muse.model import _Z_GRID

    D = len(out["logZ"])
    theta = np.asarray(truths["params"], np.float64)[:D]
    empty = np.asarray(truths["empty"], bool)[:D]
    yy = np.asarray(truths["yy"], np.float64)[:D]
    names = truths["param_names"]
    nspec = int(truths["nspec"])
    rng = np.random.default_rng(0)
    samp = np.stack([postprocess.posterior_samples(out, d, size=S, rng=rng)
                     for d in range(D)])  # [D, S, ndim]
    fit = np.where(~empty)[0]
    fit_done = np.where(~empty & ~capped)[0]

    def ks_uniform(r):
        ks = scipy.stats.kstest(r, "uniform")
        return {"ks_stat": round(float(ks.statistic), 4),
                "ks_pvalue": round(float(ks.pvalue), 4)}

    rank_ks, rank_ks_done, pulls = {}, {}, {}
    for j, nm in enumerate(names):
        rank_ks[nm] = ks_uniform(
            (samp[fit, :, j] < theta[fit, j][:, None]).mean(axis=1))
        if len(fit_done) >= 5:
            rank_ks_done[nm] = ks_uniform(
                (samp[fit_done, :, j]
                 < theta[fit_done, j][:, None]).mean(axis=1))
    for j, nm in enumerate(names):
        mean = samp[fit, :, j].mean(axis=1)
        std = samp[fit, :, j].std(axis=1)
        constrained = std < PRIOR_SPAN[nm] / np.sqrt(12.0) * 0.5
        if constrained.sum() < 3:
            pulls[nm] = {"n_constrained": int(constrained.sum())}
            continue
        resid = mean[constrained] - theta[fit, j][constrained]
        p = np.abs(resid) / np.maximum(std[constrained], 1e-9)
        pulls[nm] = {
            "n_constrained": int(constrained.sum()),
            "median_abs_err": round(float(np.median(np.abs(resid))), 5),
            "frac_within_1sigma": round(float((p < 1).mean()), 3),
            "frac_within_2sigma": round(float((p < 2).mean()), 3),
            "frac_within_3sigma": round(float((p < 3).mean()), 3),
        }

    # Z acts through the largest grid Z <= Z: the posterior mode's bin
    zg = np.asarray(_Z_GRID)

    def zbin(v):
        return np.clip(np.searchsorted(zg, v, side="right") - 1, 0,
                       len(zg) - 1)

    true_bin = zbin(theta[fit, 0])
    mode_bin = np.array([
        np.bincount(zbin(samp[d, :, 0]), minlength=len(zg)).argmax()
        for d in fit])
    evidence_check = None
    if empty.any():  # the no-star evidence of pure noise: logZ ~ -yy/2
        dz = out["logZ"][empty] + 0.5 * yy[empty]
        evidence_check = {
            "n_empty": int(empty.sum()),
            "median_logZ_plus_half_yy": round(float(np.median(dz)), 2),
            "max_abs": round(float(np.abs(dz).max()), 2),
        }
    # goodness of fit: the best dead point's chi^2 against nspec - 6
    Lmat = out["L"]
    Lbest = np.where(out["mask"], Lmat, -np.inf).max(axis=0)
    chi2_best = -2.0 * Lbest[fit]
    chi2_z = (chi2_best - (nspec - 6)) / np.sqrt(2.0 * nspec)
    gof = {
        "median_chi2_over_dof": round(
            float(np.median(chi2_best / (nspec - 6))), 4),
        "frac_chi2_z_below_5": round(float((chi2_z < 5).mean()), 3),
        "max_chi2_z": round(float(chi2_z.max()), 2),
    }
    stats = {k: (float(v) if isinstance(v, (float, np.floating)) else int(v))
             for k, v in (result_stats or {}).items()
             if isinstance(v, (int, float, np.integer, np.floating, bool,
                               np.bool_))}
    return {
        "metric": f"MUSE model-family truth recovery, {D} spaxels "
                  f"nspec={nspec} nlive={nlive}",
        "value": rank_ks_done.get("z", rank_ks["z"])["ks_pvalue"],
        "unit": "KS p-value of redshift SBC ranks vs U(0,1) "
                "(tolerance-terminated subset when >= 5 spaxels)",
        "vs_baseline": 0.0,
        "extra": {
            "wall_s": round(wall, 1),
            "n_fit": int(len(fit)),
            "n_tolerance_terminated": int(len(fit_done)),
            "n_capped": int((~empty & capped).sum()),
            "sbc_rank_ks_tolerance_terminated": rank_ks_done,
            "stats": stats,
            "sbc_rank_ks": rank_ks,
            "pull_coverage": pulls,
            "zbin_mode_accuracy": round(float((mode_bin == true_bin).mean()),
                                        3),
            "zbin_mode_within1": round(
                float((np.abs(mode_bin - true_bin) <= 1).mean()), 3),
            "empty_evidence_identity": evidence_check,
            "goodness_of_fit": gof,
        },
    }


def bars(payload):
    """The pass bars on ``analyze``'s payload, none stronger than the
    JAX run met; name -> held."""
    ex = payload["extra"]
    gof, ident = ex["goodness_of_fit"], ex["empty_evidence_identity"]
    lo, hi = BARS["chi2_dof"]
    held = {
        "identity": ident is not None
        and abs(ident["median_logZ_plus_half_yy"]) <= BARS["identity"],
        "chi2_dof": lo <= gof["median_chi2_over_dof"] <= hi,
        "chi2_z_below_5": gof["frac_chi2_z_below_5"]
        >= BARS["chi2_z_below_5"],
    }
    for nm in ("z", "EBV"):
        cov = ex["pull_coverage"][nm].get("frac_within_3sigma")
        held[f"coverage_3sigma_{nm}"] = (
            cov is not None and cov >= BARS["coverage_3sigma"])
    return held


def late_run(pieces, eval_batch):
    """Fill rounds per iteration and evaluations per round (and their
    share of ``eval_batch``) in each piece, from the cumulative counts
    that the pieces print."""
    rows, prev = [], dict(niter=0, fill_rounds=0, ndraws=0)
    for p in pieces:
        di = p["niter"] - prev["niter"]
        dr = p["fill_rounds"] - prev["fill_rounds"]
        dn = p["ndraws"] - prev["ndraws"]
        rows.append(dict(
            iterations=[prev["niter"], p["niter"]], running=p["running"],
            rounds_per_iter=dr / di if di else None,
            evals_per_round=dn / dr if dr else None,
            valid_share=dn / (dr * eval_batch) if dr else None))
        prev = p
    return rows


class ChunkRows(list):
    """A fit's per-chunk records, oldest first, with each spaxel's
    advances over the chunks recorded (``per_spaxel``, an int64 array;
    None before the first chunk)."""

    per_spaxel = None

    def add(self, row, budget):
        """Append a chunk's record with its fill rounds (unless set, from
        the cumulative count of the row before), its budget, whether it
        used the whole of it (``budget_bound``) and its advances, none
        until ``add_advances`` counts them."""
        if "rounds" not in row:
            prev = self[-1]["fill_rounds"] if self else 0
            row["rounds"] = row["fill_rounds"] - prev
        row.update(budget=budget, advances=0,
                   budget_bound=bool(budget) and row["rounds"] >= budget)
        self.append(row)

    def add_advances(self, idx):
        """Add the last chunk's advances, its dead rows with ``idx >= 0``
        (``idx`` their ``[rows, D]`` host array), to its record and to
        each spaxel's count."""
        import numpy as np

        adv = (np.asarray(idx) >= 0).sum(axis=0, dtype=np.int64)
        if self.per_spaxel is None:
            self.per_spaxel = np.zeros(adv.shape, np.int64)
        self.per_spaxel += adv
        self[-1]["advances"] += int(adv.sum())


@contextlib.contextmanager
def chunk_records(first_chunk=0, group_every=1):
    """Record each chunk of the port's fits made inside the block: a
    ``ChunkRows`` of dicts (chunk, iterations, evaluations and fill rounds
    so far, spaxels running, member overflow, the group count of the
    labels made from its report, host wall since the block began; the
    chunk's advances, fill rounds, budget and ``budget_bound`` as
    ``ChunkRows`` counts them, from its dead rows, and the
    launches of its round steps by kind, ``round_steps``), in chunk order.
    It reads each chunk's state and dead rows when the chunk has finished,
    which adds a host read and changes nothing in the fit.
    ``first_chunk``: the chunks a resumed fit starts after;
    ``group_every``: the integrator's label cadence (labels come from the
    reports of the chunks dispatched at a multiple of it), by which each
    group count finds its chunk."""
    import collections

    from massivedatans_tpu_torch.ns import engine, subsets

    rows, groups, t0 = ChunkRows(), [], time.perf_counter()
    finish, labels = engine.ChunkRunner.finish, subsets.component_labels
    kinds = ("region", "focus", "column")
    seen = collections.Counter()

    def finish_recorded(self):
        prog = self._active
        st, dead, n = finish(self)
        steps = sum((p.steps for p in self.programs.values()),
                    collections.Counter())
        rows.add(dict(
            chunk=len(rows) + 1, niter=int(st.iteration),
            ndraws=int(st.ndraws), fill_rounds=int(st.fill_rounds),
            running=int(st.running.sum()),
            member_overflow=int(st.member_overflow),
            wall_s=time.perf_counter() - t0,
            rounds=int(prog.carry.chunk_rounds),
            round_steps={k: steps[k] - seen[k] for k in kinds}),
            int(prog.carry.budget_in))
        seen.update({k: steps[k] - seen[k] for k in kinds})
        rows.add_advances(dead.idx[:n].cpu().numpy())
        return st, dead, n

    def labels_recorded(*args, **kw):
        out = labels(*args, **kw)
        groups.append(int(out[1]))
        return out

    engine.ChunkRunner.finish = finish_recorded
    subsets.component_labels = labels_recorded
    try:
        yield rows
    finally:
        engine.ChunkRunner.finish = finish
        subsets.component_labels = labels
        first = -(-first_chunk // group_every) * group_every - first_chunk
        for i, r in enumerate(rows):
            r["chunk"] += first_chunk
            k, off = divmod(i - first, group_every)
            r["n_groups"] = (groups[k] if i >= first and off == 0
                             and k < len(groups) else None)


def _launches(neighbors):
    return dict(count_within=neighbors.count_within.launches,
                bootstrapped_sq_radius=neighbors.bootstrapped_sq_radius.launches)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--max-chunks", type=int, default=None,
                    help="chunks this call may run before it checkpoints")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "MUSE_VALIDATION_TORCH.json"))
    ap.add_argument("--side", type=int, default=10)
    ap.add_argument("--nspec", type=int, default=3600)
    ap.add_argument("--n-wl", type=int, default=400)
    ap.add_argument("--flux", type=float, nargs=2, default=(0.1, 1.0))
    ap.add_argument("--fit-seed", type=int, default=1,
                    help="RunConfig.seed: the sampler's generator")
    ap.add_argument("--nlive", type=int, default=400)
    ap.add_argument("--max-samples", type=int, default=300000)
    ap.add_argument("--eval-batch-max", type=int, default=0)
    ap.add_argument("--chunk-fill-budget", type=int, default=0)
    ap.add_argument("--dispatch-target-s", type=float, default=20.0,
                    help="adaptive fill budget's target seconds per chunk "
                         "(0: off)")
    args = ap.parse_args(argv)
    if args.max_chunks is not None and args.checkpoint_dir is None:
        ap.error("--max-chunks needs --checkpoint-dir")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from massivedatans_tpu_torch.config import RunConfig
    from massivedatans_tpu_torch.io import checkpoint as ckpt
    from massivedatans_tpu_torch.muse.pipeline import fit_muse
    from massivedatans_tpu_torch.ops import _build, neighbors

    card = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_muse_validate: no CUDA card (pass --device cpu to "
                  "rehearse)", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        print(card, flush=True)
        _build.load()
        _build.load_host()
    ck = args.checkpoint_dir
    done = (ckpt.load_meta(ck)["chunk_index"]
            if ckpt.has_checkpoint(ck) else 0)
    cfg = RunConfig(nlive_points=args.nlive, tolerance=0.5, seed=args.fit_seed,
                    max_samples=args.max_samples,
                    eval_batch_max=args.eval_batch_max,
                    chunk_fill_budget=args.chunk_fill_budget)
    run_opts = dict(dispatch_target_s=args.dispatch_target_s or None)
    if ck is not None:
        run_opts.update(checkpoint_dir=ck)
        if args.max_chunks is not None:
            run_opts.update(max_chunks=done + args.max_chunks)
    neighbors.count_within.launches = 0
    neighbors.bootstrapped_sq_radius.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cube, tpl, truths = build_fixture(
            tmp, args.side, args.nspec, flux=tuple(args.flux), n_wl=args.n_wl)
        fixture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with chunk_records(first_chunk=done) as per_chunk:
            result, problem = fit_muse(cube, tpl, 0.0, 0.5, "FULL", cfg,
                                       device=args.device, progress=True,
                                       **run_opts)
        wall = time.perf_counter() - t0
    stats = result.stats
    running = (int(ckpt.load_host(ck)["running"].sum()) if ck is not None
               else 0)
    piece = dict(
        fit=f"MUSE FULL spaxels={problem.ndata} nspec={args.nspec} "
            f"nlive={args.nlive} max_samples={args.max_samples} "
            f"eval_batch_max={args.eval_batch_max} "
            f"chunk_fill_budget={args.chunk_fill_budget} "
            f"dispatch_target_s={args.dispatch_target_s}",
        chunks=[done, stats["chunks"]], niter=result.niterations,
        fill_rounds=stats["fill_rounds"], ndraws=result.ndraws,
        running=running, stalled=stats["stalled"],
        fill_budget_last=stats["fill_budget_last"],
        big_batch_chunks=stats["big_batch_chunks"],
        chunk_path=stats["chunk_path"], launches=_launches(neighbors),
        wall_s=wall, fixture_s=fixture_s, timing=stats["timing"],
        interrupted=stats["interrupted"],
        per_chunk=per_chunk)
    pieces = []
    if ck is not None:
        with open(os.path.join(ck, PIECES), "a") as fh:
            fh.write(json.dumps(piece) + "\n")
        with open(os.path.join(ck, PIECES)) as fh:
            pieces = [json.loads(line) for line in fh]
    print(json.dumps(piece), flush=True)
    if stats["interrupted"]:
        return INTERRUPTED

    out = dict(logZ=result.logZ, logZerr=result.logZerr, x=result.x,
               L=result.L, w=result.w, mask=result.mask)
    capped = capped_mask(result.mask, result.niterations, args.max_samples)
    payload = analyze(out, truths, capped, args.nlive, stats,
                      sum(p["wall_s"] for p in pieces) if pieces else wall)
    held = bars(payload)
    term = termination_iters(result.mask, result.niterations)
    empty = np.asarray(truths["empty"], bool)[:problem.ndata]
    jax = jax_run_counts()
    at_jax_stop = next((p for p in pieces if p["niter"] >= jax["niter"] - 1),
                       None)
    payload["extra"].update(
        interrupted=False, niter=result.niterations,
        rows=int(result.u.shape[0]), ndraws=result.ndraws,
        fill_rounds=stats["fill_rounds"],
        terminated_by="max_samples_cap" if capped.any() else "tolerance",
        n_stalled=int(np.sum(stats["stalled_mask"])),
        termination_iter_quantiles={
            q: float(np.quantile(term[~empty], q / 100))
            for q in (10, 50, 90, 100)} if (~empty).any() else None,
        options=dict(nlive=args.nlive, tolerance=0.5, fit_seed=args.fit_seed,
                     max_samples=args.max_samples,
                     eval_batch_max=args.eval_batch_max,
                     chunk_fill_budget=args.chunk_fill_budget,
                     dispatch_target_s=args.dispatch_target_s,
                     device=args.device, chunk_path=stats["chunk_path"]),
        pieces=pieces, late_run=late_run(pieces or [piece], cfg.eval_batch),
        per_chunk=[c for p in pieces or [piece]
                   for c in p.get("per_chunk", [])],
        jax_run=dict(
            niter=jax["niter"], ndraws=jax["ndraws"],
            fill_rounds=jax["fill_rounds"],
            rounds_per_chunk=jax["rounds_per_chunk"],
            still_running_at_stop=int((jax["term_iter"] == jax["niter"])
                                      .sum()),
            source="muse_valid_out/ckpt_100/state.npz"),
        at_jax_stop=at_jax_stop and {k: at_jax_stop[k] for k in (
            "niter", "ndraws", "fill_rounds", "running")},
        ratio_to_jax=dict(niter=result.niterations / jax["niter"],
                          ndraws=result.ndraws / jax["ndraws"],
                          fill_rounds=stats["fill_rounds"]
                          / jax["fill_rounds"]),
        bars=held, card=card)
    with open(args.out, "w") as fh:
        json.dump(payload, fh, indent=1)
    print(json.dumps(payload), flush=True)
    return 0 if all(held.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
