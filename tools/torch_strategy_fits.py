"""Fit the horns spectra with the port's strategies.

    python3 tools/torch_strategy_fits.py                      # SLICE, 1000 spectra
    python3 tools/torch_strategy_fits.py --constrainer SLICE GALILEAN --ndata 1000 100
    python3 tools/torch_strategy_fits.py --constrainer GALILEAN --ndata 100 \
        --seeds 1 2 3 --device cpu
    python3 tools/torch_strategy_fits.py --ndata 100 --max-samples 2000 --device cpu

Each fit is ``chip_smoke.strategy_fit``, to tolerance or to the iteration
cap ``--max-samples`` (then only the datasets that stopped at tolerance
before the cap count, as in the smoke): the first ``ndata``
spectra of ``gen_horns(1000)``, the default ``RunConfig`` with the given
constrainer and seed, one JSON line with the wall, iterations, fill
rounds, evaluations, host timing split and the count of the first 100
datasets within 3 logZerr + 0.5 of ``quad_logZ.json``. It asserts what the
smoke asserts of the path (no region kernel, finite evidences), not the
quadrature bar. On a card, the card's name and power limit come first.
``tools/jax_strategy_counts.py`` makes the same fits with the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--constrainer", nargs="+", default=["SLICE"])
    ap.add_argument("--ndata", type=int, nargs="+", default=[1000])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--max-samples", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_strategy_fits: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from massivedatans_tpu_torch.cli import run_fit
    from massivedatans_tpu_torch.config import RunConfig, set_fp32_precision
    from massivedatans_tpu_torch.datagen.generators import gen_horns
    from massivedatans_tpu_torch.ops import neighbors

    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    set_fp32_precision()
    data = gen_horns(1000)
    with open(os.path.join(ROOT, "quad_logZ.json")) as fh:
        quad = np.asarray(json.load(fh)["logZ"], float)
    for name in args.constrainer:
        for ndata in args.ndata:
            for seed in args.seeds:
                neighbors.count_within.launches = 0
                neighbors.bootstrapped_sq_radius.launches = 0
                chip_smoke.strategy_fit(
                    run_fit, RunConfig(constrainer=name, seed=seed,
                                       max_samples=args.max_samples),
                    data, ndata, quad, neighbors, [], device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
