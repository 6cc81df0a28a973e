"""Both packages' counts on one MUSE model-family cube, at the same
options: the CPU comparison behind ROADMAP queue 3's MUSE rounds check.

    JAX_PLATFORMS=cpu python3 tools/jax_muse_rounds.py [--out FILE]
    # the JAX package alone at full size, the witness's options (about
    # 75 min on 8 shared cores), its states kept every 10 chunks
    JAX_PLATFORMS=cpu python3 tools/jax_muse_rounds.py --side 10 \
        --nspec 3600 --nlive 400 --seeds 1 --options budget --budget 319 \
        --cap 7000 --packages jax --checkpoint-dir muse_rounds_ck \
        --out muse_rounds_full_jax.json

    # the JAX package's record of tools/muse_bench.py's cube at 4,223
    # spaxels and known options (the wall-clock budget off), per chunk
    JAX_PLATFORMS=cpu python3 tools/jax_muse_rounds.py --cube bench \
        --n-spaxels 4223 --nspec 3600 --nlive 400 --seeds 1 --cap 4800 \
        --packages jax --checkpoint-dir muse_bench_ck \
        --out muse_bench_4223_jax.json

``--cube bench`` takes ``tools/torch_muse_bench.py``'s cube (its
``build_bench_cube``, the port's ``synth``, loaded with the real-MUSE bad
windows, z in [0, 0.3]) and its options (``bench_options``: those of
``tools/muse_bench.py``, checkpoints every 2 chunks included, with
``--nlive``, ``--cap`` and ``--fill-budget``, and no wall-clock budget);
``--options`` and ``--budget`` do not apply, and the port's fits run it
on the CPU at the same options. Otherwise the tool builds
``tools/torch_muse_validate.py``'s fixture (``build_fixture``: 400
template wavelengths, seed 11, flux 0.1-1.0, no bad-window inflation)
once with the port's ``synth``, at ``--side`` x ``--side`` spaxels and
``--nspec`` channels, and fits that one cube with the JAX package's
integrator and with the port's ``fit_muse`` on the CPU, at
``RunConfig(nlive_points, tolerance=0.5, seed, eval_batch_max,
chunk_fill_budget, max_samples)`` for each seed and each option set:

- ``budget``: ``--budget`` fill rounds per chunk and a ``--cap``
  iteration cap, the like-for-like shape of the JAX MUSE run of record
  (319 rounds per 50-iteration chunk, capped at 7,000);
- ``tolerance``: to tolerance, no budget, no escalation;
- ``escalated``: to tolerance with ``eval_batch_max`` 512.

No wall-clock fill budget (``dispatch_target_s``) is on in either
package, so both runs are fixed by their seeds. ``--packages`` picks the
packages (the port's CPU fits are about 10 x slower than the JAX
package's: at full size its counts come from the card,
``tools/torch_muse_validate.py``). One JSON line per fit (package, option
set, seed, iterations, evaluations, fill rounds, evaluations per round,
member overflows, the progress of ``torch_muse_bench.advance_summary``:
spaxel advances, evaluations per advance, the chunks that used their
whole fill budget and the first of them, the mean budget and the
quantiles of the advances per spaxel; the spaxels still running at the
cap, the sorted termination iterations, the CPU wall) is printed, and one
per JAX chunk as it ends; the whole, each fit with its record per chunk
(iterations, evaluations and fill rounds so far, spaxels running, member
overflow, the group count of the labels made from its report, wall; the
chunk's advances, fill rounds, budget and ``budget_bound``), is written
to ``--out`` with the cube's SHA-256. ``--checkpoint-dir`` keeps each
JAX fit's state at each checkpoint, every 10 chunks (every 2 with
``--cube bench``), in ``DIR/OPTIONS_seedN/chunk_NNNNN``, from which
``tools/muse_rounds_from_state.py --state`` starts. The walls are CPU
walls, not times of either package on a device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTION_SETS = ("budget", "tolerance", "escalated")


def option_set(name, budget, cap):
    """The ``RunConfig`` fields of one option set."""
    return dict(budget=dict(chunk_fill_budget=budget, max_samples=cap),
                tolerance={}, escalated=dict(eval_batch_max=512))[name]


def bench_options(args) -> dict:
    """``tools/torch_muse_bench.py``'s options at its defaults (those of
    ``tools/muse_bench.py``) with this tool's spaxels, channels, nlive and
    cap, and no wall-clock budget: the fixed fill budget alone."""
    from tools import torch_muse_bench as bench

    opts = bench.defaults()
    opts.update(n_spaxels=args.n_spaxels, nspec=args.nspec,
                nlive=args.nlive, cap=args.cap, fill_budget=args.fill_budget,
                dispatch_target=0.0)
    return opts


def bench_fields(opts) -> dict:
    """The ``RunConfig`` fields of the bench options that the seed, nlive
    and tolerance leave (this tool sets those)."""
    from tools import torch_muse_bench as bench

    return {k: v for k, v in bench.config_fields(opts).items()
            if k not in ("nlive_points", "seed", "tolerance")}


def cube_sha256(cube):
    """SHA-256 of a cube's data and variance as little-endian float64
    (``tools/torch_muse_bench.cube_sha256``)."""
    from tools.torch_muse_bench import cube_sha256 as sha

    return sha(cube)


def summary(package, name, seed, opts, result, wall, per_chunk):
    """One fit's counts, in the same layout for both packages, with its
    progress (``torch_muse_bench.advance_summary``) from its per-chunk
    records."""
    import numpy as np

    from tools.torch_muse_bench import advance_summary

    rounds = int(result.stats["fill_rounds"])
    cap = opts.get("max_samples", 0)
    term = np.sort(np.asarray(result.mask)[:result.niterations].sum(axis=0))
    return dict(package=package, options=name, seed=seed, **opts,
                niter=int(result.niterations), ndraws=int(result.ndraws),
                fill_rounds=rounds,
                evals_per_round=int(result.ndraws) / max(rounds, 1),
                member_overflow=int(result.stats["member_overflow"]),
                **advance_summary(per_chunk, per_chunk.per_spaxel,
                                  int(result.ndraws)),
                running_at_cap=int((term > cap).sum()) if cap else 0,
                termination_iters=[int(t) for t in term], wall_s=wall)


@contextlib.contextmanager
def jax_chunk_records(checkpoint_dir=None, fill_budget=0):
    """Record each chunk of the JAX package's fits made inside the block,
    in the layout of ``torch_muse_validate.chunk_records`` (the counts of
    its report, the group count of the labels made from it, the host wall
    since the block began; its advances, the dead rows with ``idx >= 0``
    of the report's dead block, where the integrator's
    ``MDT_DEBUG_TIMING`` line counts them, its fill rounds and whether
    they reached ``fill_budget``, the fixed budget of every chunk),
    printing each as a JSON line. With ``checkpoint_dir``, each state the
    integrator saves there (every 10 chunks) is also kept in
    ``checkpoint_dir/chunk_NNNNN``, loadable by
    ``io.checkpoint.load_state`` (``tools/muse_rounds_from_state.py
    --state``). Nothing in the fit changes."""
    from massivedatans_tpu.io import checkpoint as ckpt
    from massivedatans_tpu.ns import engine, subsets
    from tools.torch_muse_validate import ChunkRows

    rows, groups, t0 = ChunkRows(), [], time.perf_counter()
    parse, dead_block, labels, save = (
        engine.parse_meta, engine.parse_dead_block,
        subsets.component_labels, ckpt.save_state)

    def parse_recorded(meta, D, K):
        rep = parse(meta, D, K)
        if rows:
            print(json.dumps(dict(package="jax", **rows[-1])), flush=True)
        rows.add(dict(
            chunk=len(rows) + 1, niter=rep["iteration"],
            ndraws=rep["ndraws"], fill_rounds=rep["fill_rounds"],
            running=int(rep["running_final"].sum()),
            member_overflow=rep["member_overflow"],
            wall_s=time.perf_counter() - t0), fill_budget)
        return rep

    def dead_block_recorded(block, n):
        out = dead_block(block, n)
        rows.add_advances(out["idx"][:n])
        return out

    def labels_recorded(*args, **kw):
        out = labels(*args, **kw)
        groups.append((len(rows), int(out[1])))  # from the last report
        return out

    def save_kept(path, state, host_ctx, meta):
        save(path, state, host_ctx, meta)
        save(os.path.join(path, f"chunk_{meta['chunk_index']:05d}"), state,
             host_ctx, meta)

    engine.parse_meta, subsets.component_labels = parse_recorded, \
        labels_recorded
    engine.parse_dead_block, ckpt.save_state = dead_block_recorded, save_kept
    try:
        yield rows
    finally:
        engine.parse_meta, subsets.component_labels = parse, labels
        engine.parse_dead_block, ckpt.save_state = dead_block, save
        if rows:
            print(json.dumps(dict(package="jax", **rows[-1])), flush=True)
        found = dict(groups)
        for r in rows:
            r["n_groups"] = found.get(r["chunk"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=4)
    ap.add_argument("--nspec", type=int, default=600)
    ap.add_argument("--nlive", type=int, default=100)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--options", nargs="+", choices=OPTION_SETS,
                    default=list(OPTION_SETS))
    ap.add_argument("--budget", type=int, default=300,
                    help="fill rounds per chunk of the 'budget' set")
    ap.add_argument("--cap", type=int, default=800,
                    help="iteration cap of the 'budget' set")
    ap.add_argument("--packages", nargs="+", choices=("jax", "torch"),
                    default=["jax", "torch"])
    ap.add_argument("--checkpoint-dir", default=None,
                    help="keep the JAX fits' states every 10 chunks here, "
                         "one directory per option set and seed")
    ap.add_argument("--cube", choices=("fixture", "bench"),
                    default="fixture",
                    help="bench: tools/torch_muse_bench.py's cube of "
                         "--n-spaxels spaxels at its options, the "
                         "wall-clock budget off (--cap, --seeds, --nlive "
                         "and --nspec still apply)")
    ap.add_argument("--n-spaxels", type=int, default=4223)
    ap.add_argument("--fill-budget", type=int, default=8192,
                    help="fill rounds per chunk with --cube bench "
                         "(tools/muse_bench.py's 8,192)")
    ap.add_argument("--out", default=os.path.join(ROOT,
                                                  "muse_rounds_cpu.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from massivedatans_tpu.config import RunConfig as JaxRunConfig
    from massivedatans_tpu.muse.likelihood import make_muse_problem
    from massivedatans_tpu.muse.model import load_template_grid
    from massivedatans_tpu.ns.integrator import multi_nested_integrator
    from massivedatans_tpu_torch.config import RunConfig
    from massivedatans_tpu_torch.muse.pipeline import fit_muse
    from tools import torch_muse_bench as bench
    from tools.torch_muse_validate import build_fixture, chunk_records

    rows, zhi, fit_kw = [], 0.5, {}
    if args.cube == "bench":
        args.options, zhi = ["bench"], bench.ZHI
        bench_opts = bench_options(args)
        fit_kw = dict(checkpoint_every=bench_opts["checkpoint_every"])
    with tempfile.TemporaryDirectory() as tmp:
        if args.cube == "bench":
            cube, tpl = bench.load_bench_cube(tmp, args.n_spaxels,
                                              args.nspec)
        else:
            cube, tpl, _ = build_fixture(tmp, args.side, args.nspec)
        md = load_template_grid(tpl, data_wl_nm=cube.wavelength_nm, zlo=0.0,
                                zhi=zhi)
        problem = make_muse_problem(md, cube.y, cube.var)
        cube_sha = cube_sha256(cube)
        for name in args.options:
            opts = (bench_fields(bench_opts) if name == "bench"
                    else option_set(name, args.budget, args.cap))
            for seed in args.seeds:
                kw = dict(nlive_points=args.nlive, tolerance=0.5, seed=seed,
                          **opts)
                for package in args.packages:
                    t0 = time.perf_counter()
                    if package == "jax":
                        ck = args.checkpoint_dir and os.path.join(
                            args.checkpoint_dir, f"{name}_seed{seed}")
                        with jax_chunk_records(
                                ck, kw.get("chunk_fill_budget", 0)) \
                                as per_chunk:
                            res = multi_nested_integrator(
                                problem, JaxRunConfig(**kw), progress=False,
                                checkpoint_dir=ck, **fit_kw)
                    else:
                        with chunk_records(group_every=bench.group_every(
                                args.nlive, problem.ndata)) as per_chunk:
                            res, _ = fit_muse(cube, tpl, 0.0, zhi, "FULL",
                                              RunConfig(**kw), device="cpu",
                                              **fit_kw)
                    rows.append(summary(package, name, seed, opts, res,
                                        time.perf_counter() - t0, per_chunk))
                    print(json.dumps(rows[-1]), flush=True)
                    rows[-1]["per_chunk"] = bench.with_totals(per_chunk)
    ratios = {}
    for name in args.options:
        for seed in args.seeds if len(args.packages) == 2 else ():
            jax, port = (next(r for r in rows if r["package"] == p
                              and r["options"] == name and r["seed"] == seed)
                         for p in ("jax", "torch"))
            ratios[f"{name} seed {seed}"] = {
                k: port[k] / jax[k] for k in ("niter", "ndraws",
                                              "fill_rounds")}
    shape = (f"tools/muse_bench.py's cube, {problem.ndata} spaxels"
             if args.cube == "bench" else
             f"MUSE FULL {args.side}x{args.side} spaxels")
    record = dict(
        comparison=f"{shape}, nspec {args.nspec}, nlive {args.nlive}, "
                   f"seeds {args.seeds}: {' and '.join(args.packages)} on "
                   "one cube",
        cube=args.cube, n_spaxels=problem.ndata,
        options=bench_opts if args.cube == "bench" else None,
        packages=args.packages,
        side=args.side, nspec=args.nspec, nlive=args.nlive,
        seeds=args.seeds, cube_sha256=cube_sha, budget=args.budget,
        cap=args.cap, port_over_jax=ratios, fits=rows,
        run="CPU runs (walls are CPU walls, not device times)")
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    print(json.dumps(dict(port_over_jax=ratios, file=args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
