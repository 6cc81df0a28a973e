"""Model evaluations against the number of datasets N, on the port: the
counterpart of ``tools/scaling_bench.py`` (the reference's headline
experiment, ``plotscaling.py``; the paper's claim is ~O(sqrt(N))).

    python3 tools/torch_scaling_bench.py [--out DIR] [--ns 10 100 1000 10000]
                                         # DIR: scaling_torch_out/
    python3 tools/torch_scaling_bench.py --device cpu --ns 2 4 --nlive 50

One ``gen_horns(max(NS))`` stream (the port's generator copy), sliced
``[:, :N]`` for each N, is fitted with ``run_fit`` at ``RunConfig(
nlive_points=400)`` (``--nlive``), each fit from a ``torch.Generator`` on
the device seeded with 1 (the JAX tool's key). Each N
writes ``DIR/scaling_N.stats.json`` with the keys of the JAX tool's files
(``ndraws``, ``niter``, ``ndata``, ``duration``, ``wall``, ``logZ0``,
``stalled_total``, ``member_overflow``, ``fill_rounds``, ``pile_peak``,
``timing`` ...) and the port's own: ``chunk_path``, graph replays and host
syncs per iteration, ``steps`` by kind, the largest ``n_groups`` seen
(``n_groups_max``), ``group_refreshes``, ``chunks``, the captured steps'
graph pool (``graph_pool_bytes``), the peak device memory, the process's
peak resident host memory and both region kernels' launches. The plot is drawn with the port's
``postprocess.plot_scaling`` (``DIR/scaling.pdf``) where matplotlib is
installed (the card's machine has none: ``plot-scaling`` draws it from
the stats files).

Then one table: each N's ndraws and niter beside the JAX package's counts
of the same protocol (``scaling_out/scaling_N.stats.json``; their
``wall`` and ``duration`` were taken on another device and are not
printed), the fitted exponent of ndraws against N, and the bars, as one
JSON line:

- quadrature: where the stream is ``gen_horns(10000)``, the datasets among
  the first 100 are held to ``quad_logZ_horns10000.json``, at least 95 % of
  them (9 of 10 at N = 10) within ``3 logZerr + 0.5``;
- no dataset stalled at any N;
- at nlive 400: each N's ndraws and niter within [0.5, 2] x the JAX
  package's, and the exponent over N in {100, 1000, 10000} at most 0.5.

Exits 1 if a bar fails. On a card the card's name and power limit come
first; ``--device cpu`` rehearses it.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = "quad_logZ_horns10000.json"
JAX_DIR = os.path.join(ROOT, "scaling_out")
RATIO_BAR = (0.5, 2.0)
EXPONENT_BAR = 0.5
EXPONENT_NS = (100, 1000, 10000)
SEED = 1  # the JAX tool's jax.random.key(1)


def quad_within(logZ, logZerr, quad):
    """Of the first ``len(quad)`` datasets (at most those fitted), how many
    lie within ``3 logZerr + 0.5`` of the oracle, and how many must."""
    n = min(len(quad), len(logZ))
    dq = abs(logZ[:n] - quad[:n])
    return int((dq < 3 * logZerr[:n] + 0.5).sum()), (95 * n) // 100


def exponent(ns, draws):
    """The slope of log(ndraws) against log(N)."""
    import numpy as np

    return float(np.polyfit(np.log(ns), np.log(draws), 1)[0])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "scaling_torch_out"))
    ap.add_argument("--ns", type=int, nargs="+", default=[10, 100, 1000, 10000])
    ap.add_argument("--nlive", type=int, default=400)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from massivedatans_tpu_torch.cli import run_fit
    from massivedatans_tpu_torch.config import RunConfig
    from massivedatans_tpu_torch.datagen.generators import gen_horns
    from massivedatans_tpu_torch.ops import _build, neighbors
    from massivedatans_tpu_torch.postprocess import plot_scaling

    on_card = args.device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card (pass --device cpu to rehearse)")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        _build.load()
        _build.load_host()
    os.makedirs(args.out, exist_ok=True)
    n_gen = max(args.ns)
    data = gen_horns(n_gen)
    with open(os.path.join(ROOT, ORACLE)) as fh:
        oracle = json.load(fh)
    quad = (np.asarray(oracle["logZ"], float) if oracle["n_gen"] == n_gen
            else None)
    cfg = RunConfig(nlive_points=args.nlive)
    rows, files, bars = [], [], {}
    for N in args.ns:
        neighbors.count_within.launches = 0
        neighbors.bootstrapped_sq_radius.launches = 0
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=args.device).manual_seed(SEED)
        t0 = time.time()
        res = run_fit(data["x"], data["y"][:, :N], cfg, args.device,
                      noise_level=data["noise_level"], generator=gen)
        wall = time.time() - t0
        stats = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in res.stats.items()}
        # per-dataset arrays are bulky at N = 10^4: summarised, as the JAX
        # tool does
        stats["stalled_total"] = int(np.sum(res.stats["stalled_mask"]))
        stats.pop("stall_count")
        stats.pop("stalled_mask")
        n = max(res.niterations, 1)
        stats.update(
            wall=wall, logZ0=float(res.logZ[0]),
            graph_replays_per_iter=stats["graph_replays"] / n,
            host_syncs_per_iter=stats["host_syncs"] / n,
            peak_mem_GB=(torch.cuda.max_memory_allocated() / 1e9
                         if on_card else None),
            # the process's peak resident set so far (kB on Linux): the
            # largest N's result and report copies set it
            host_peak_rss_GB=resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1e6,
            launches=dict(
                count_within=neighbors.count_within.launches,
                bootstrapped_sq_radius=neighbors.bootstrapped_sq_radius.launches))
        if quad is not None:
            within, need = quad_within(res.logZ, res.logZerr, quad)
            stats["quad_within"], stats["quad_held"] = within, min(N, len(quad))
            bars[f"quad N={N}"] = within >= need
        bars[f"no stall N={N}"] = stats["stalled_total"] == 0
        fn = os.path.join(args.out, f"scaling_{N}.stats.json")
        with open(fn, "w") as fh:
            json.dump(stats, fh, indent=1)
        files.append(fn)
        jax_fn = os.path.join(JAX_DIR, f"scaling_{N}.stats.json")
        ref = None
        if os.path.exists(jax_fn):
            with open(jax_fn) as fh:
                ref = json.load(fh)
        rows.append((N, res.ndraws, res.niterations, ref))
        print(json.dumps({k: stats[k] for k in (
            "ndata", "wall", "niter", "ndraws", "fill_rounds", "chunks",
            "group_refreshes", "n_groups_max", "stalled_total",
            "member_overflow", "pile_peak", "chunk_path",
            "graph_replays_per_iter", "host_syncs_per_iter", "steps",
            "peak_mem_GB", "host_peak_rss_GB", "graph_pool_bytes", "launches",
            "timing")}
            | {k: stats[k] for k in ("quad_within", "quad_held")
               if k in stats}), flush=True)
        del res

    try:
        Ns, draws = plot_scaling(files,
                                 path=os.path.join(args.out, "scaling.pdf"))
    except ModuleNotFoundError as e:  # no matplotlib on the card's machine
        print(f"no plot ({e}): draw it with `python -m "
              f"massivedatans_tpu_torch plot-scaling {args.out}/*.stats.json`")
        Ns = np.array([r[0] for r in rows], float)
        draws = np.array([r[1] for r in rows], float)
    print(f"{'N':>6} {'ndraws':>9} {'JAX ndraws':>10} {'ratio':>6} "
          f"{'niter':>6} {'JAX niter':>9} {'ratio':>6}")
    for N, nd, ni, ref in rows:
        if ref is None:
            print(f"{N:6d} {nd:9d} {'-':>10} {'-':>6} {ni:6d} {'-':>9} "
                  f"{'-':>6}")
            continue
        rd, ri = nd / ref["ndraws"], ni / ref["niter"]
        print(f"{N:6d} {nd:9d} {ref['ndraws']:10d} {rd:6.3f} {ni:6d} "
              f"{ref['niter']:9d} {ri:6.3f}")
        if args.nlive == 400:  # the JAX tool's protocol
            bars[f"ndraws ratio N={N}"] = RATIO_BAR[0] <= rd <= RATIO_BAR[1]
            bars[f"niter ratio N={N}"] = RATIO_BAR[0] <= ri <= RATIO_BAR[1]
    out = dict(exponent=exponent(Ns, draws) if len(Ns) >= 2 else None)
    ref_rows = [r for r in rows if r[3] is not None]
    if len(ref_rows) >= 2:
        out["exponent_jax"] = exponent([r[0] for r in ref_rows],
                                       [r[3]["ndraws"] for r in ref_rows])
    held = [r for r in rows if r[0] in EXPONENT_NS]
    if len(held) == len(EXPONENT_NS):
        out["exponent_100_10000"] = exponent([r[0] for r in held],
                                             [r[1] for r in held])
        if args.nlive == 400:
            bars["exponent 100-10000"] = (out["exponent_100_10000"]
                                          <= EXPONENT_BAR)
    print(f"scaling exponent: evals ~ N^{out['exponent']:.3f} over "
          f"{[int(n) for n in Ns]} (1.0 = linear, 0.5 = the paper's sqrt "
          "claim)")
    print(json.dumps(dict(scaling=out, bars=bars)))
    return 0 if all(bars.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
