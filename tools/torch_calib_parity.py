"""No-signal evidence calibration on the port: the counterpart of
``tools/calib_parity.py`` (the reference's acceptance standard,
plotevidences.py:17-36).

    python3 tools/torch_calib_parity.py [--out FILE]
    python3 tools/torch_calib_parity.py --device cpu --n-gen 20 --ndata 6 \
        --headline-n 8 --nlive 50          # a rehearsal, about 20 s

The line model is fitted to pure-noise spectra of the port's
``gen_nothing`` and each logZ compared with the analytic no-signal
evidence logZ0 = sum(-(y/sigma)^2 / 2) as log10 B = (logZ - logZ0) / ln 10.
Negative values mean no false line detection.

- ``paired``: ``gen_nothing(1000)[:, :100]`` at the JAX tool's default run
  (nlive 400, tolerance 0.5, ``chunk_iters=1024, eval_batch=128,
  proposal_batch=512, shelf_capacity=8``), a generator seeded 1. Bars: the
  median within 0.1 of the JAX package's and of the original code's
  (``calib_jax_nothing100.json``, ``calib_parity.json``); no log10 B > 0;
  at least 95 of the 100 datasets with |logZ - logZ_jax| <= 3
  sqrt(logZerr^2 + logZerr_jax^2), against the JAX package's per-dataset
  record. The original code's per-dataset evidences are never paired: at
  ndata 100 they were misassigned (``ref_defect.json``), so only their
  median, which ignores order, is used.
- ``headline``: all of ``gen_nothing(10000)`` (its own stream: the
  generator seeds with N) at the default ``RunConfig``, the BASELINE run
  ``sample.py data_nothing_10000.hdf5 10000``. Bars: records (iterations
  plus the nlive tail, as the stats files count them) and evaluations
  within [0.5, 2] x those of the JAX run in ``calib_out/``; the median
  within 0.1 of the JAX package's (``calib_jax_nothing10000.json``). The
  largest log10 B and the share above 0 are reported only.

The bars apply where the stream is the record's (its SHA-256 matches) and
the options are the protocol's; a rehearsal at other sizes reports its
statistics only. Each fit's record holds both region kernels' launches.
Prints the card's name and power limit first on a card, one JSON line per
run and a last JSON line of the bars; exits 1 if one fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRED_CFG = dict(nlive_points=400, tolerance=0.5, chunk_iters=1024,
                  eval_batch=128, proposal_batch=512, shelf_capacity=8)
PAIRED_RECORD = "calib_jax_nothing100.json"
HEADLINE_RECORD = "calib_jax_nothing10000.json"
HEADLINE_COUNTS = "calib_out/calib_stats.json"  # the JAX run of calib_out/
SEED = 1  # the JAX tool's jax.random.key(1)
MEDIAN_TOL = 0.1
PAIRED_SHARE = 0.95
RATIO_BAR = (0.5, 2.0)


def stream_sha256(x, y):
    """SHA-256 of a fit's input: x, then y, as little-endian float64 (the
    digest the JAX records hold, ``tools/jax_validation_records.py``)."""
    import numpy as np

    h = hashlib.sha256()
    for a in (x, y):
        h.update(np.ascontiguousarray(a, "<f8").tobytes())
    return h.hexdigest()


def log10_bayes(logZ, y, noise):
    """log10 B against the analytic no-signal evidence."""
    import numpy as np

    y = np.asarray(y, float)
    logZ0 = (-0.5 * (y / float(noise)) ** 2).sum(axis=0)
    return (np.asarray(logZ, float) - logZ0) / np.log(10.0)


def calib_stats(B):
    import numpy as np

    return dict(median_log10B=float(np.median(B)), max_log10B=float(B.max()),
                frac_positive=float((B > 0).mean()))


def paired_within(logZ, logZerr, ref_logZ, ref_logZerr):
    """How many datasets lie within 3 sqrt(err^2 + err_ref^2) of the
    reference's logZ."""
    import numpy as np

    ref_logZ, ref_logZerr = np.asarray(ref_logZ), np.asarray(ref_logZerr)
    return int((np.abs(logZ - ref_logZ)
                <= 3 * np.hypot(logZerr, ref_logZerr)).sum())


def _record(name):
    with open(os.path.join(ROOT, name)) as fh:
        return json.load(fh)


def fit(device, n_gen, ndata, cfg_kw, neighbors=None):
    """Fit ``gen_nothing(n_gen)[:, :ndata]`` with ``run_fit`` at
    ``RunConfig(**cfg_kw)``, a generator seeded ``SEED``; returns
    ``(record, result)``. With ``neighbors``, the launch counters are set
    to 0 first and read into the record."""
    import numpy as np
    import torch

    from massivedatans_tpu_torch.cli import run_fit
    from massivedatans_tpu_torch.config import RunConfig
    from massivedatans_tpu_torch.datagen.generators import gen_nothing

    data = gen_nothing(n_gen)
    y = np.asarray(data["y"])[:, :ndata]
    cfg = RunConfig(**cfg_kw)
    if neighbors is not None:
        neighbors.count_within.launches = 0
        neighbors.bootstrapped_sq_radius.launches = 0
    gen = torch.Generator(device=device).manual_seed(SEED)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_fit(data["x"], y, cfg, device, noise_level=data["noise_level"],
                  generator=gen)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    B = log10_bayes(res.logZ, y, data["noise_level"])
    rec = dict(
        fit=f"gen_nothing({n_gen})[:, :{ndata}] RunConfig({cfg_kw})",
        n_gen=n_gen, ndata=ndata, config=cfg_kw,
        input_sha256=stream_sha256(data["x"], y), wall_s=wall,
        niter=res.niterations, rows=int(res.u.shape[0]), ndraws=res.ndraws,
        fill_rounds=res.stats["fill_rounds"],
        stalled=int(np.sum(res.stats["stalled_mask"])),
        chunk_path=res.stats["chunk_path"], **calib_stats(B))
    if neighbors is not None:
        rec["launches"] = dict(
            count_within=neighbors.count_within.launches,
            bootstrapped_sq_radius=neighbors.bootstrapped_sq_radius.launches)
    return rec, res


def paired_bars(rec, res):
    """The paired run's bars against the JAX package's record and the
    original code's median; {} where the run is not the record's."""
    jax = _record(PAIRED_RECORD)
    if (rec["input_sha256"] != jax["input_sha256"]
            or rec["config"] != jax["config"]):
        return {}
    ref_median = _record("calib_parity.json")["reference"]["median_log10B"]
    within = paired_within(res.logZ, res.logZerr, jax["logZ"], jax["logZerr"])
    rec.update(jax_median_log10B=jax["median_log10B"],
               reference_median_log10B=ref_median, paired_within=within)
    m = rec["median_log10B"]
    return {
        "paired median vs JAX": abs(m - jax["median_log10B"]) <= MEDIAN_TOL,
        "paired median vs original": abs(m - ref_median) <= MEDIAN_TOL,
        "paired no positive log10 B": rec["max_log10B"] <= 0,
        "paired logZ within 3 sigma of JAX":
            within >= PAIRED_SHARE * rec["ndata"],
    }


def headline_bars(rec):
    """The headline run's bars against the JAX runs of its stream; {}
    where the run is not the record's."""
    jax = _record(HEADLINE_RECORD)
    if rec["input_sha256"] != jax["input_sha256"] or rec["config"]:
        return {}
    counts = _record(HEADLINE_COUNTS)
    ratios = dict(rows=rec["rows"] / counts["niter"],
                  ndraws=rec["ndraws"] / counts["ndraws"])
    rec.update(jax_median_log10B=jax["median_log10B"],
               jax_counts=dict(rows=counts["niter"], ndraws=counts["ndraws"],
                               source=HEADLINE_COUNTS),
               jax_counts_rerun=dict(rows=jax["rows"], ndraws=jax["ndraws"],
                                     source=HEADLINE_RECORD),
               ratio_to_jax=ratios)
    lo, hi = RATIO_BAR
    return {
        "headline records ratio": lo <= ratios["rows"] <= hi,
        "headline ndraws ratio": lo <= ratios["ndraws"] <= hi,
        "headline median vs JAX":
            abs(rec["median_log10B"] - jax["median_log10B"]) <= MEDIAN_TOL,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n-gen", type=int, default=1000)
    ap.add_argument("--ndata", type=int, default=100)
    ap.add_argument("--headline-n", type=int, default=10000)
    ap.add_argument("--nlive", type=int, default=None,
                    help="nlive of both runs (default: the protocol's)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from massivedatans_tpu_torch.ops import _build, neighbors

    card = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_calib_parity: no CUDA card (pass --device cpu to "
                  "rehearse)", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        print(card, flush=True)
        _build.load()
        _build.load_host()
    live = {} if args.nlive is None else dict(nlive_points=args.nlive)
    rec, res = fit(args.device, args.n_gen, args.ndata, PAIRED_CFG | live,
                   neighbors)
    held = paired_bars(rec, res)
    runs = dict(paired=rec)
    print(json.dumps(rec), flush=True)
    del res
    rec, _ = fit(args.device, args.headline_n, args.headline_n, live,
                 neighbors)
    held.update(headline_bars(rec))
    runs["headline"] = rec
    print(json.dumps(rec), flush=True)
    out = dict(runs=runs, bars=held, card=card)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(dict(bars=held, card=card)))
    return 0 if all(held.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
