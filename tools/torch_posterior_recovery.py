"""Posterior truth recovery on the ``gensimple`` suite, on the port: the
counterpart of ``tools/posterior_recovery.py`` (plotposterior.py:19-33,
57-67).

    python3 tools/torch_posterior_recovery.py [--out FILE]
    python3 tools/torch_posterior_recovery.py --device cpu --n 4 --nlive 30 \
        --max-samples 300                # a rehearsal, a few seconds

Fits the port's ``gen_simple(100)`` (z ~ Beta(2, 7)) with ``run_fit`` at
``RunConfig(nlive_points=400, chunk_iters=100, pipeline_lookahead=4)``, a
generator seeded 1, then does the JAX tool's arithmetic from the result in
memory (``recovery_stats``): ``recovered_redshifts`` (the computation of
``plot_posterior_z``) gives the constrained datasets and their recovered
z; then, per constrained dataset, z_rec = mu/440 - 1 over 1,000
``posterior_samples`` drawn from one ``default_rng(0)``, its mean and
standard deviation; the median |z_rec - z_true|, the pulls, and the KS
statistic of the recovered z against Beta(2, 7). Pulls are reported only:
the fitted model is one Gaussian, the injected line two
(``tools/posterior_recovery.py:77-84``).

Bars, against the JAX package's record ``recovery_jax_simple100.json``
(key 1; key 2 for the agreement share), where the stream is the record's
and the options the protocol's:

- the constrained sets differ by at most 2 datasets;
- the share of datasets constrained in both whose z means lie within the
  larger of the two sigmas is at least the JAX package's key 2 against
  key 1, less 0.05;
- the KS statistic within 0.05 of the JAX package's;
- the median |z_rec - z_true| at most 1.5 x the JAX package's.

Prints the card's name and power limit first on a card, then one JSON
line of the run, its statistics and bars; exits 1 if a bar fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(nlive_points=400, chunk_iters=100, pipeline_lookahead=4)
RECORD = "recovery_jax_simple100.json"
SEED = 1  # the JAX tool's jax.random.key(1)
SET_DIFF, SHARE_SLACK, KS_TOL, ERR_FACTOR = 2, 0.05, 0.05, 1.5


def recovery_stats(result, z_true, postprocess=None):
    """``tools/posterior_recovery.py``'s statistics of a fit held in
    memory, in the record's layout (``tools/jax_validation_records.py``):
    ``plot_posterior_z``'s constrained mask and recovered z (through
    ``recovered_redshifts``, its computation), then per constrained
    dataset the mean and std of z_rec = mu/440 - 1 over 1,000 posterior
    draws from one ``default_rng(0)``. ``postprocess`` is the module that
    does the post-processing: the port's by default, the JAX package's
    for its records."""
    import numpy as np
    import scipy.stats

    if postprocess is None:
        from massivedatans_tpu_torch import postprocess

    out = dict(logZ=result.logZ, w=result.w, L=result.L, x=result.x)
    zs, mask = postprocess.recovered_redshifts(out)
    rng = np.random.default_rng(0)
    idx = np.where(mask)[0]
    z_mean, z_sigma = [], []
    for d in idx:
        mu = postprocess.posterior_samples(out, int(d), size=1000,
                                           rng=rng)[:, 1]
        z_rec = mu / 440.0 - 1.0
        z_mean.append(float(z_rec.mean()))
        z_sigma.append(float(z_rec.std()))
    resid = np.asarray(z_mean) - np.asarray(z_true)[idx]
    pull = resid / np.maximum(np.asarray(z_sigma), 1e-6)
    ks = scipy.stats.kstest(zs, scipy.stats.beta(2.0, 7.0).cdf)
    return dict(constrained=[int(d) for d in idx], z_mean=z_mean,
                z_sigma=z_sigma, ks_stat=float(ks.statistic),
                ks_pvalue=float(ks.pvalue),
                median_abs_z_err=float(np.median(np.abs(resid))),
                median_abs_pull=float(np.median(np.abs(pull))),
                frac_within_3sigma=float((np.abs(pull) < 3).mean()))


def agreement(a, b):
    """Of the datasets constrained in both, the share whose z means lie
    within the larger of their two sigmas; and how many are constrained in
    one only."""
    import numpy as np

    ia = {d: i for i, d in enumerate(a["constrained"])}
    ib = {d: i for i, d in enumerate(b["constrained"])}
    both = sorted(set(ia) & set(ib))
    ok = [abs(a["z_mean"][ia[d]] - b["z_mean"][ib[d]])
          <= max(a["z_sigma"][ia[d]], b["z_sigma"][ib[d]]) for d in both]
    return dict(share=float(np.mean(ok)) if ok else 0.0, n_both=len(both),
                n_differ=len(set(ia) ^ set(ib)))


def recovery_bars(stats, jax):
    """The four bars of ``stats`` against the JAX record ``jax``."""
    ref = jax["keys"]["1"]
    agree = agreement(stats, ref)
    need = jax["key2_vs_key1"]["share"] - SHARE_SLACK
    return agree, {
        "constrained sets": agree["n_differ"] <= SET_DIFF,
        "z within max sigma": agree["share"] >= need,
        "KS statistic": abs(stats["ks_stat"] - ref["ks_stat"]) <= KS_TOL,
        "median |z err|":
            stats["median_abs_z_err"] <= ERR_FACTOR * ref["median_abs_z_err"],
    }


def fit(device, n=100, nlive=None, neighbors=None, max_samples=0):
    """Fit ``gen_simple(n)`` at the protocol's options (``nlive`` replaces
    its nlive; ``max_samples`` caps it: gen_simple's lines are bright, so
    its posteriors are deep); returns ``(record, result, z_true)``. With
    ``neighbors``, the launch counters are set to 0 first and read into
    the record."""
    import numpy as np
    import torch

    from massivedatans_tpu_torch.cli import run_fit
    from massivedatans_tpu_torch.config import RunConfig
    from massivedatans_tpu_torch.datagen.generators import gen_simple
    from tools.torch_calib_parity import stream_sha256

    data = gen_simple(n)
    cfg_kw = (CFG | ({} if nlive is None else dict(nlive_points=nlive))
              | (dict(max_samples=max_samples) if max_samples else {}))
    if neighbors is not None:
        neighbors.count_within.launches = 0
        neighbors.bootstrapped_sq_radius.launches = 0
    gen = torch.Generator(device=device).manual_seed(SEED)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_fit(data["x"], data["y"], RunConfig(**cfg_kw), device,
                  noise_level=data["noise_level"], generator=gen)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = dict(fit=f"gen_simple({n}) RunConfig({cfg_kw})", n=n,
               config=cfg_kw,
               input_sha256=stream_sha256(data["x"], data["y"]),
               wall_s=wall, niter=res.niterations, ndraws=res.ndraws,
               fill_rounds=res.stats["fill_rounds"],
               stalled=int(np.sum(res.stats["stalled_mask"])),
               chunk_path=res.stats["chunk_path"])
    if neighbors is not None:
        rec["launches"] = dict(
            count_within=neighbors.count_within.launches,
            bootstrapped_sq_radius=neighbors.bootstrapped_sq_radius.launches)
    return rec, res, np.asarray(data["z"])


def evaluate(rec, res, z_true):
    """Add the statistics (without the per-dataset lists) and, where the
    run is the record's, the agreement and bars to ``rec``; returns the
    bars."""
    stats = recovery_stats(res, z_true)
    rec.update({k: v for k, v in stats.items()
                if k not in ("constrained", "z_mean", "z_sigma")},
               n_constrained=len(stats["constrained"]))
    path = os.path.join(ROOT, RECORD)
    if not os.path.exists(path):
        rec["record"] = f"{RECORD} missing: no bar"
        return {}
    with open(path) as fh:
        jax = json.load(fh)
    if rec["input_sha256"] != jax["input_sha256"] \
            or rec["config"] != jax["config"]:
        return {}
    agree, held = recovery_bars(stats, jax)
    ref = jax["keys"]["1"]
    rec.update(agreement_with_jax=agree,
               jax=dict(ks_stat=ref["ks_stat"],
                        median_abs_z_err=ref["median_abs_z_err"],
                        n_constrained=len(ref["constrained"]),
                        key2_vs_key1=jax["key2_vs_key1"]))
    return held


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--nlive", type=int, default=None)
    ap.add_argument("--max-samples", type=int, default=0,
                    help="iteration cap (a rehearsal's; the protocol has none)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from massivedatans_tpu_torch.ops import _build, neighbors

    card = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_posterior_recovery: no CUDA card (pass --device cpu "
                  "to rehearse)", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        print(card, flush=True)
        _build.load()
        _build.load_host()
    rec, res, z_true = fit(args.device, args.n, args.nlive, neighbors,
                           args.max_samples)
    held = evaluate(rec, res, z_true)
    rec.update(bars=held, card=card)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
    print(json.dumps(rec))
    return 0 if all(held.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
