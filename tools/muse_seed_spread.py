"""Both packages' seed spread at one setting of ``tools/muse_bench.py``'s
cube where the fill budget binds, held to each other.

    # the JAX package's fits (tools/jax_muse_rounds.py --cube bench, one
    # file per seed) and the port's (tools/torch_muse_bench.py --out, one
    # file per seed) at the same options, cube and cap
    python3 tools/muse_seed_spread.py --jax j_seed*.json --port p_seed*.json \
        --out muse_seeds_100_budget1024.json
    # with earlier records of the same setting: each new fit is compared
    # with the earlier one of its package and seed, count for count
    python3 tools/muse_seed_spread.py --jax j1.json --port p*.json \
        --previous muse_bench_4223_jax.json \
        muse_bench_4223_torch_c_seed1.json --out muse_seeds_4223.json

Every fit must have the same cube (SHA-256) and the same options but its
seed. For each fit the record keeps its evaluations E, advances A (the
dead rows with ``idx >= 0``), E/A, iterations, fill rounds, member
overflows, the chunks that used their whole fill budget and the first of
them (the onset), the quantiles of the advances per spaxel, its wall and
its records per chunk; a JAX fit's wall is a CPU wall, a port fit's the
card's (``card``). ``held_to_seeds`` (``tools/torch_muse_bench.py``)
holds the port's seeds against the JAX package's on E, A, E/A and the
onset: the medians within [0.5, 2] x and a two-sided Mann-Whitney U test
at p >= 0.01. A fit written before the advances were counted has None
for them and is left out of those statistics. ``--previous`` records
(either tool's) are matched to the new fits by package and seed:
``repeats`` says whether iterations, evaluations, fill rounds, member
overflows and the evaluations of every chunk are equal. One table per
package is printed, then the comparison; the whole goes to ``--out``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_KEYS = ("seed", "niter", "ndraws", "advances", "evals_per_advance",
            "fill_rounds", "member_overflow", "budget_bound_chunks",
            "first_budget_bound_chunk", "mean_budget", "advance_quantiles",
            "running_at_cap", "wall_s")
REPEAT_KEYS = ("niter", "ndraws", "fill_rounds", "member_overflow")
# the options that a setting fixes (each fit has its own seed)
SETTING_KEYS = ("n_spaxels", "nspec", "nlive", "cap", "eval_batch",
                "proposal_batch", "fill_budget", "chunk_iters", "lookahead",
                "fallback_rounds", "dispatch_target", "checkpoint_every")


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def jax_fits(path):
    """The fits of one ``tools/jax_muse_rounds.py --cube bench`` record,
    each with the record's options and cube."""
    rec = _load(path)
    if rec.get("cube") != "bench":
        raise SystemExit(f"{path}: not a --cube bench record")
    out = []
    for f in rec["fits"]:
        if f["package"] != "jax":
            continue
        fit = {k: f.get(k) for k in FIT_KEYS}
        per_chunk = f.get("per_chunk", [])
        if fit["member_overflow"] is None and per_chunk:  # older records
            fit["member_overflow"] = per_chunk[-1]["member_overflow"]
        fit.update(package="jax", file=os.path.relpath(path, ROOT),
                   per_chunk=per_chunk,
                   options=dict(rec["options"], seed=f["seed"]),
                   cube_sha256=rec["cube_sha256"])
        out.append(fit)
    return out


def port_fit(path):
    """One ``tools/torch_muse_bench.py --out`` line as a fit."""
    line = _load(path)
    fit = {k: line.get(k) for k in FIT_KEYS if k != "seed"}
    fit.update(package="torch", seed=line["options"]["seed"],
               file=os.path.relpath(path, ROOT),
               per_chunk=line.get("per_chunk", []), options=line["options"],
               cube_sha256=line["cube_sha256"], card=line.get("card"),
               chunk_path=line.get("chunk_path"), bars=line.get("bars"),
               eager_check=line.get("eager_check"))
    return fit


def load_any(path):
    """The fits of a record of either tool."""
    rec = _load(path)
    return jax_fits(path) if "fits" in rec else [port_fit(path)]


def setting_of(fit):
    return {k: fit["options"][k] for k in SETTING_KEYS}


def repeats(fit, previous):
    """Whether ``fit`` repeats ``previous`` (same package and seed) count
    for count, per chunk too."""
    same = {k: fit[k] == previous[k] for k in REPEAT_KEYS}
    mine = [r["ndraws"] for r in fit["per_chunk"]]
    theirs = [r["ndraws"] for r in previous["per_chunk"]]
    same["per_chunk_ndraws"] = mine == theirs
    return dict(file=previous["file"], equal=all(same.values()),
                keys=same, new={k: fit[k] for k in REPEAT_KEYS},
                previous={k: previous[k] for k in REPEAT_KEYS})


def spread(jax, port, previous=()):
    """The record: the setting, every fit, ``held_to_seeds`` and the
    repeats of earlier records."""
    from tools.torch_muse_bench import held_to_seeds

    fits = jax + port
    if not fits:
        raise SystemExit("no fits")
    setting, sha = setting_of(fits[0]), fits[0]["cube_sha256"]
    for f in fits:
        if f["cube_sha256"] != sha:
            raise SystemExit(f"{f['file']}: another cube")
        if setting_of(f) != setting:
            raise SystemExit(f"{f['file']}: other options "
                             f"({setting_of(f)} != {setting})")
    reps = []
    for f in fits:
        for p in previous:
            if (p["package"], p["seed"]) == (f["package"], f["seed"]):
                reps.append(dict(package=f["package"], seed=f["seed"],
                                 **repeats(f, p)))
    cards = sorted({f["card"] for f in port if f.get("card")})
    return dict(
        setting=setting, cube_sha256=sha,
        seeds=dict(jax=[f["seed"] for f in jax],
                   torch=[f["seed"] for f in port]),
        walls="JAX fits: CPU walls of the JAX package; port fits: the "
              "card's walls",
        card=cards, held_to_seeds=held_to_seeds(port, jax),
        repeats=reps, fits=fits)


def table(fits):
    """Markdown rows of the fits, seed by seed."""
    rows = ["| seed | E | A | E/A | rounds | overflows | onset | bound "
            "chunks | A per spaxel (min/5/50/95/max %) | wall s |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for f in sorted(fits, key=lambda f: f["seed"]):
        q, a = f["advance_quantiles"], f["advances"]
        qs = "/".join(f"{q[k]:g}" for k in ("min", "q05", "q50", "q95",
                                            "max")) if q else "-"
        progress = f"{a:,} | {f['evals_per_advance']:.4f}" if a else "- | -"
        rows.append(f"| {f['seed']} | {f['ndraws']:,} | {progress} | "
                    f"{f['fill_rounds']:,} | {f['member_overflow']} | "
                    f"{f['first_budget_bound_chunk']} | "
                    f"{f['budget_bound_chunks']} | {qs} | "
                    f"{f['wall_s']:.1f} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax", nargs="*", default=[],
                    help="tools/jax_muse_rounds.py --cube bench records")
    ap.add_argument("--port", nargs="*", default=[],
                    help="tools/torch_muse_bench.py --out lines")
    ap.add_argument("--previous", nargs="*", default=[],
                    help="earlier records of the same setting")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    jax = [f for p in args.jax for f in jax_fits(p)]
    port = [port_fit(p) for p in args.port]
    previous = [f for p in args.previous for f in load_any(p)]
    rec = spread(jax, port, previous)
    with open(args.out, "w") as fh:
        json.dump(rec, fh, indent=1)
    for name, fits in (("jax", jax), ("torch", port)):
        if fits:
            print(f"{name}:\n{table(fits)}\n")
    print(json.dumps(dict(setting=rec["setting"],
                          held_to_seeds=rec["held_to_seeds"],
                          repeats=[{k: r[k] for k in ("package", "seed",
                                                      "equal")}
                                   for r in rec["repeats"]],
                          file=args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
