"""Quadrature-bar counts of the JAX package's strategies on the horns spectra.

    JAX_PLATFORMS=cpu python3 tools/jax_strategy_counts.py --constrainer GALILEAN \
        --ndata 100 1000 --seeds 1 2 3

Fits the first ``ndata`` spectra of ``gen_horns(1000)`` with the JAX
package's ``multi_nested_integrator`` at the default ``RunConfig`` (nlive
400, tolerance 0.5) with the given constrainer and
``key=jax.random.key(seed)``, and prints one JSON line per fit: the seed,
iterations, fill rounds, evaluations, wall seconds, how many of the first
100 datasets lie within 3 logZerr + 0.5 of ``quad_logZ.json`` (the bar of
``bench.py`` and ``chip_smoke.py``), and the median and largest |dlogZ|.
The last line sums the counts up per (constrainer, ndata): least, most and
mean. This is the reference that the port's bar for a strategy rests on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--constrainer", nargs="+", default=["GALILEAN"])
    ap.add_argument("--ndata", type=int, nargs="+", default=[1000])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax
    import numpy as np

    from massivedatans_tpu.config import RunConfig
    from massivedatans_tpu.datagen.generators import gen_horns
    from massivedatans_tpu.models.gaussline import make_gaussline_problem
    from massivedatans_tpu.ns.integrator import multi_nested_integrator

    data = gen_horns(1000)
    with open(os.path.join(ROOT, "quad_logZ.json")) as fh:
        quad = np.asarray(json.load(fh)["logZ"], float)
    summary = {}
    for name in args.constrainer:
        for ndata in args.ndata:
            problem = make_gaussline_problem(
                data["x"], data["y"][:, :ndata],
                noise_level=data["noise_level"])
            counts = []
            for seed in args.seeds:
                t0 = time.perf_counter()
                result = multi_nested_integrator(
                    problem, RunConfig(constrainer=name),
                    key=jax.random.key(seed), progress=False)
                wall = time.perf_counter() - t0
                nq = min(len(quad), ndata)
                dq = np.abs(result.logZ[:nq] - quad[:nq])
                within = int((dq < 3 * result.logZerr[:nq] + 0.5).sum())
                counts.append(within)
                print(json.dumps(dict(
                    constrainer=name, ndata=ndata, seed=seed, wall_s=wall,
                    niter=result.niterations,
                    fill_rounds=int(result.stats["fill_rounds"]),
                    ndraws=result.ndraws,
                    quad_within=within, quad_n=nq,
                    median_dlogZ=float(np.median(dq)),
                    max_dlogZ=float(dq.max()))), flush=True)
            summary[f"{name} ndata={ndata}"] = dict(
                seeds=args.seeds, counts=counts, least=min(counts),
                most=max(counts), mean=float(np.mean(counts)))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
