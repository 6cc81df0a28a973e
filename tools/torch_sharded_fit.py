"""Fit the 1000 horns spectra on one card, then on meshes of ranks.

    python3 tools/torch_sharded_fit.py                     # NCCL on every card
    python3 tools/torch_sharded_fit.py --runs 1:nccl 2:gloo 4:nccl
    python3 tools/torch_sharded_fit.py --runs 2:gloo --device cpu

The single-device fit is ``run_fit`` with the default ``RunConfig`` (the
horns fit of ``chip_smoke.py`` phase 4); each run ``WORLD:BACKEND`` is
``chip_smoke.sharded_fit``: the same fit on a dataset mesh of WORLD ranks
(NCCL: one card per rank; gloo: the ranks share the cards, collectives
staged through the host), held to it bit for bit at one rank, to the
quadrature bar of ``quad_logZ.json`` always, with both region kernels
launched on every rank. One JSON line per run: walls, iterations,
evaluations, fill rounds, collective calls and wall per fill round,
launches per rank. The default runs NCCL across every card of the
machine (at most 4). On a card, the card's name and power limit come
first; ``--device cpu`` rehearses the control flow, and stops at the
launch check (CPU tensors launch no kernel).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", default=None,
                    help="WORLD:BACKEND, e.g. 4:nccl (default: every card, "
                         "at most 4, with nccl)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke
    from massivedatans_tpu_torch.cli import run_fit
    from massivedatans_tpu_torch.config import RunConfig, set_fp32_precision
    from massivedatans_tpu_torch.datagen.generators import gen_horns
    from massivedatans_tpu_torch.ns import region
    from massivedatans_tpu_torch.ops import _build, neighbors

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card (pass --device cpu to rehearse)")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        chip_smoke._build_all(_build)
    chip_smoke.DEVICE = args.device
    runs = args.runs or [f"{min(torch.cuda.device_count(), 4)}:nccl"]
    set_fp32_precision()
    rounds = chip_smoke._count_rounds(region)
    neighbors.count_within.launches = 0
    neighbors.bootstrapped_sq_radius.launches = 0
    cfg = RunConfig()
    data = gen_horns(1000)
    chip_smoke._sync()
    t0 = time.perf_counter()
    single = run_fit(data["x"], data["y"], cfg, args.device,
                     noise_level=data["noise_level"])
    chip_smoke._sync()
    wall = time.perf_counter() - t0
    launches = dict(count_within=neighbors.count_within.launches,
                    bootstrapped_sq_radius=neighbors.bootstrapped_sq_radius.launches,
                    region_rounds=len(rounds))
    print(json.dumps(dict(fit="horns ndata=1000 nlive=400, one device",
                          wall_s=wall, niter=single.niterations,
                          ndraws=single.ndraws,
                          fill_rounds=single.stats["fill_rounds"],
                          launches=launches)))
    with open(os.path.join(ROOT, "quad_logZ.json")) as fh:
        quad = np.asarray(json.load(fh)["logZ"], float)
    for run in runs:
        world, backend = run.split(":")
        chip_smoke.sharded_fit(int(world), backend, data, cfg, single,
                               launches, wall, quad)
    return 0


if __name__ == "__main__":
    sys.exit(main())
