"""The JAX package's records that the port's validation tools are held to.

    JAX_PLATFORMS=cpu python3 tools/jax_validation_records.py \
        [--part calib100 recovery calib10000]

Runs the JAX package on the CPU and writes one committed JSON file per
part at the root of the repo:

- ``calib100`` -> ``calib_jax_nothing100.json``: the no-signal calibration
  of ``tools/calib_parity.py`` (its default run): ``gen_nothing(1000)[:,
  :100]``, nlive 400, tolerance 0.5, ``chunk_iters=1024, eval_batch=128,
  proposal_batch=512, shelf_capacity=8``, ``jax.random.key(1)``; each
  dataset's logZ and logZerr, and the median, largest and positive share
  of log10 B = (logZ - logZ0) / ln 10 with logZ0 = sum(-(y/sigma)^2 / 2)
  (plotevidences.py:17-36);
- ``recovery`` -> ``recovery_jax_simple100.json``: the posterior truth
  recovery of ``tools/posterior_recovery.py`` on ``gen_simple(100)`` at
  ``RunConfig(nlive_points=400, chunk_iters=100, pipeline_lookahead=4)``
  for keys 1 and 2, with that tool's arithmetic through the JAX package's
  ``postprocess``: the constrained datasets, each one's recovered z
  (mean and standard deviation of 1,000 posterior draws), the KS
  statistic of the recovered z against Beta(2, 7), the median |z_rec -
  z_true|; and the share of the datasets constrained under both keys whose
  means agree within the larger of the two sigmas (key 2 against key 1);
- ``calib10000`` -> ``calib_jax_nothing10000.json``: the headline
  no-signal run, all of ``gen_nothing(10000)`` at the default
  ``RunConfig``, key 1: the log10 B median, largest and positive share,
  records, iterations and evaluations. The median of ``calib_out/``'s run
  (-1.31, quoted in ``tools/calib_parity.py`` and ``SCALING.md``) is not
  recoverable from the committed files, which hold only its counts and a
  plot.

Each file holds the SHA-256 of its input stream (the port tool's
``stream_sha256``: x and the fitted columns of y as little-endian
float64), the wall of each fit and the platform (``cpu``), so that the
port's tools can check that they read the record of the stream they
generate. The statistics are the port tools' (``stream_sha256``,
``log10_bayes``, ``agreement``, ``recovery_stats``), the recovery ones
through the JAX package's ``postprocess``. Walls are CPU walls of this
JAX package, not times of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("calib100", "recovery", "calib10000")
CALIB_CFG = dict(nlive_points=400, tolerance=0.5, chunk_iters=1024,
                 eval_batch=128, proposal_batch=512, shelf_capacity=8)
RECOVERY_CFG = dict(nlive_points=400, chunk_iters=100, pipeline_lookahead=4)
RECOVERY_KEYS = (1, 2)


def _fit(x, y, noise, cfg, key):
    import jax

    from massivedatans_tpu.models.gaussline import make_gaussline_problem
    from massivedatans_tpu.ns.integrator import multi_nested_integrator

    problem = make_gaussline_problem(x, y, noise)
    t0 = time.perf_counter()
    result = multi_nested_integrator(problem, cfg, key=jax.random.key(key),
                                     progress=False)
    return result, time.perf_counter() - t0


def _counts(result, wall):
    return dict(niter=int(result.niterations), rows=int(result.u.shape[0]),
                ndraws=int(result.ndraws),
                fill_rounds=int(result.stats["fill_rounds"]),
                stalled=int(result.stats["stalled"]), wall_s=wall)


def calib_record(n_gen, ndata, cfg_kw, key=1):
    import jax
    import numpy as np

    from massivedatans_tpu.config import RunConfig
    from massivedatans_tpu.datagen.generators import gen_nothing
    from tools.torch_calib_parity import log10_bayes, stream_sha256

    data = gen_nothing(n_gen)
    y = np.asarray(data["y"])[:, :ndata]
    result, wall = _fit(data["x"], y, data["noise_level"],
                        RunConfig(**cfg_kw), key)
    B = log10_bayes(result.logZ, y, data["noise_level"])
    rec = dict(
        protocol=f"gen_nothing({n_gen})[:, :{ndata}], RunConfig({cfg_kw}), "
                 f"jax.random.key({key}) (plotevidences.py:17-36)",
        n_gen=n_gen, ndata=ndata, key=key, config=cfg_kw,
        input_sha256=stream_sha256(data["x"], y),
        median_log10B=float(np.median(B)), max_log10B=float(B.max()),
        frac_positive=float((B > 0).mean()),
        **_counts(result, wall),
        platform=jax.devices()[0].platform, run="CPU run of the JAX package")
    if ndata <= 1000:  # per-dataset values for the paired bar
        rec.update(logZ=[float(v) for v in result.logZ],
                   logZerr=[float(v) for v in result.logZerr])
    return rec


def recovery_record():
    import jax

    from massivedatans_tpu import postprocess
    from massivedatans_tpu.config import RunConfig
    from massivedatans_tpu.datagen.generators import gen_simple
    from tools.torch_calib_parity import stream_sha256
    from tools.torch_posterior_recovery import agreement, recovery_stats

    data = gen_simple(100)
    keys = {}
    for key in RECOVERY_KEYS:
        result, wall = _fit(data["x"], data["y"], data["noise_level"],
                            RunConfig(**RECOVERY_CFG), key)
        keys[str(key)] = dict(
            recovery_stats(result, data["z"], postprocess),
            **_counts(result, wall))
    return dict(
        protocol=f"gen_simple(100), RunConfig({RECOVERY_CFG}), "
                 f"jax.random.key(k) for k in {RECOVERY_KEYS} "
                 "(tools/posterior_recovery.py)",
        n_gen=100, config=RECOVERY_CFG,
        input_sha256=stream_sha256(data["x"], data["y"]), keys=keys,
        key2_vs_key1=agreement(keys["2"], keys["1"]),
        platform=jax.devices()[0].platform, run="CPU run of the JAX package")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", nargs="+", choices=PARTS, default=list(PARTS))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    for part in args.part:
        if part == "calib100":
            rec, name = calib_record(1000, 100, CALIB_CFG), \
                "calib_jax_nothing100.json"
        elif part == "recovery":
            rec, name = recovery_record(), "recovery_jax_simple100.json"
        else:
            rec, name = calib_record(10000, 10000, {}), \
                "calib_jax_nothing10000.json"
        with open(os.path.join(ROOT, name), "w") as fh:
            json.dump(rec, fh, indent=1)
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("logZ", "logZerr", "keys")}
                         | {"file": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
