"""Both packages' counts on one MUSE model-family cube, at the same
options: the CPU comparison behind ROADMAP queue 3's MUSE rounds check.

    JAX_PLATFORMS=cpu python3 tools/jax_muse_rounds.py [--out FILE]
    # the JAX package alone at full size, the witness's options (about
    # 75 min on 8 shared cores), its states kept every 10 chunks
    JAX_PLATFORMS=cpu python3 tools/jax_muse_rounds.py --side 10 \
        --nspec 3600 --nlive 400 --seeds 1 --options budget --budget 319 \
        --cap 7000 --packages jax --checkpoint-dir muse_rounds_ck \
        --out muse_rounds_full_jax.json

Builds ``tools/torch_muse_validate.py``'s fixture (``build_fixture``: 400
template wavelengths, seed 11, flux 0.1-1.0, no bad-window inflation) once
with the port's ``synth``, at ``--side`` x ``--side`` spaxels and
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
the spaxels still running at the cap, the sorted termination iterations,
the CPU wall) is printed, and one per JAX chunk as it ends; the whole,
each fit with its record per chunk (iterations, evaluations and fill
rounds so far, spaxels running, member overflow, the group count of the
labels made from its report, wall), is written to ``--out`` with the
cube's SHA-256. ``--checkpoint-dir`` keeps each JAX fit's state every 10
chunks (``DIR/OPTIONS_seedN/chunk_NNNNN``), from which
``tools/muse_rounds_from_state.py --state`` starts. The walls are CPU
walls, not times of either package on a device.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
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


def cube_sha256(cube):
    """SHA-256 of a cube's data and variance as little-endian float64."""
    import numpy as np

    return hashlib.sha256(
        np.ascontiguousarray(cube.y, "<f8").tobytes()
        + np.ascontiguousarray(cube.var, "<f8").tobytes()).hexdigest()


def summary(package, name, seed, opts, result, wall):
    """One fit's counts, in the same layout for both packages."""
    import numpy as np

    rounds = int(result.stats["fill_rounds"])
    cap = opts.get("max_samples", 0)
    term = np.sort(np.asarray(result.mask)[:result.niterations].sum(axis=0))
    return dict(package=package, options=name, seed=seed, **opts,
                niter=int(result.niterations), ndraws=int(result.ndraws),
                fill_rounds=rounds,
                evals_per_round=int(result.ndraws) / max(rounds, 1),
                running_at_cap=int((term > cap).sum()) if cap else 0,
                termination_iters=[int(t) for t in term], wall_s=wall)


@contextlib.contextmanager
def jax_chunk_records(checkpoint_dir=None):
    """Record each chunk of the JAX package's fits made inside the block,
    in the layout of ``torch_muse_validate.chunk_records`` (the counts of
    its report, the group count of the labels made from it, the host wall
    since the block began), printing each as a JSON line. With
    ``checkpoint_dir``, each state the integrator saves there (every 10
    chunks) is also kept in ``checkpoint_dir/chunk_NNNNN``, loadable by
    ``io.checkpoint.load_state`` (``tools/muse_rounds_from_state.py
    --state``). Nothing in the fit changes."""
    from massivedatans_tpu.io import checkpoint as ckpt
    from massivedatans_tpu.ns import engine, subsets

    rows, groups, t0 = [], [], time.perf_counter()
    parse, labels, save = (engine.parse_meta, subsets.component_labels,
                           ckpt.save_state)

    def parse_recorded(meta, D, K):
        rep = parse(meta, D, K)
        rows.append(dict(
            chunk=len(rows) + 1, niter=rep["iteration"],
            ndraws=rep["ndraws"], fill_rounds=rep["fill_rounds"],
            running=int(rep["running_final"].sum()),
            member_overflow=rep["member_overflow"],
            wall_s=time.perf_counter() - t0))
        print(json.dumps(dict(package="jax", **rows[-1])), flush=True)
        return rep

    def labels_recorded(*args, **kw):
        out = labels(*args, **kw)
        groups.append(int(out[1]))
        return out

    def save_kept(path, state, host_ctx, meta):
        save(path, state, host_ctx, meta)
        save(os.path.join(path, f"chunk_{meta['chunk_index']:05d}"), state,
             host_ctx, meta)

    engine.parse_meta, subsets.component_labels = parse_recorded, \
        labels_recorded
    ckpt.save_state = save_kept
    try:
        yield rows
    finally:
        engine.parse_meta, subsets.component_labels = parse, labels
        ckpt.save_state = save
        for r, g in zip(rows, groups + [None] * len(rows)):
            r["n_groups"] = g


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
    from tools.torch_muse_validate import build_fixture, chunk_records

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        cube, tpl, _ = build_fixture(tmp, args.side, args.nspec)
        md = load_template_grid(tpl, data_wl_nm=cube.wavelength_nm, zlo=0.0,
                                zhi=0.5)
        problem = make_muse_problem(md, cube.y, cube.var)
        cube_sha = cube_sha256(cube)
        for name in args.options:
            opts = option_set(name, args.budget, args.cap)
            for seed in args.seeds:
                kw = dict(nlive_points=args.nlive, tolerance=0.5, seed=seed,
                          **opts)
                for package in args.packages:
                    t0 = time.perf_counter()
                    if package == "jax":
                        ck = args.checkpoint_dir and os.path.join(
                            args.checkpoint_dir, f"{name}_seed{seed}")
                        with jax_chunk_records(ck) as per_chunk:
                            res = multi_nested_integrator(
                                problem, JaxRunConfig(**kw), progress=False,
                                checkpoint_dir=ck)
                    else:
                        with chunk_records() as per_chunk:
                            res, _ = fit_muse(cube, tpl, 0.0, 0.5, "FULL",
                                              RunConfig(**kw), device="cpu")
                    rows.append(summary(package, name, seed, opts, res,
                                        time.perf_counter() - t0))
                    print(json.dumps(rows[-1]), flush=True)
                    rows[-1]["per_chunk"] = per_chunk
    ratios = {}
    for name in args.options:
        for seed in args.seeds if len(args.packages) == 2 else ():
            jax, port = (next(r for r in rows if r["package"] == p
                              and r["options"] == name and r["seed"] == seed)
                         for p in ("jax", "torch"))
            ratios[f"{name} seed {seed}"] = {
                k: port[k] / jax[k] for k in ("niter", "ndraws",
                                              "fill_rounds")}
    record = dict(
        comparison=f"MUSE FULL {args.side}x{args.side} spaxels, nspec "
                   f"{args.nspec}, nlive {args.nlive}, seeds {args.seeds}: "
                   f"{' and '.join(args.packages)} on one cube",
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
