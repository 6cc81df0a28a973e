"""Both packages' counts on one small MUSE model-family cube, at the same
options: the CPU comparison behind ROADMAP queue 3's MUSE rounds check.

    JAX_PLATFORMS=cpu python3 tools/jax_muse_rounds.py [--out FILE]

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
package, so both runs are fixed by their seeds. One JSON line per fit
(package, option set, seed, iterations, evaluations, fill rounds,
evaluations per round, the spaxels still running at the cap, the sorted
termination iterations, the CPU wall) is printed and the whole is written
to ``--out`` with the cube's SHA-256. The walls are CPU walls, not
times of either package on a device.
"""

from __future__ import annotations

import argparse
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
    from tools.torch_muse_validate import build_fixture

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
                for package in ("jax", "torch"):
                    t0 = time.perf_counter()
                    if package == "jax":
                        res = multi_nested_integrator(
                            problem, JaxRunConfig(**kw), progress=False)
                    else:
                        res, _ = fit_muse(cube, tpl, 0.0, 0.5, "FULL",
                                          RunConfig(**kw), device="cpu")
                    rows.append(summary(package, name, seed, opts, res,
                                        time.perf_counter() - t0))
                    print(json.dumps(rows[-1]), flush=True)
    ratios = {}
    for name in args.options:
        for seed in args.seeds:
            jax, port = (next(r for r in rows if r["package"] == p
                              and r["options"] == name and r["seed"] == seed)
                         for p in ("jax", "torch"))
            ratios[f"{name} seed {seed}"] = {
                k: port[k] / jax[k] for k in ("niter", "ndraws",
                                              "fill_rounds")}
    record = dict(
        comparison=f"MUSE FULL {args.side}x{args.side} spaxels, nspec "
                   f"{args.nspec}, nlive {args.nlive}, seeds {args.seeds}: "
                   "jax and torch on one cube",
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
