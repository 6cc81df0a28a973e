"""Fit the 1000 (or 10^4) horns spectra on one card, then on meshes of ranks.

    python3 tools/torch_sharded_fit.py                     # NCCL on every card
    python3 tools/torch_sharded_fit.py --runs 1:nccl 2:gloo 4:nccl 4:nccl:2
    python3 tools/torch_sharded_fit.py --runs 4:nccl --eager
    python3 tools/torch_sharded_fit.py --ndata 10000 --runs 4:nccl
    python3 tools/torch_sharded_fit.py --runs 2:gloo --device cpu

The single-device fit is ``run_fit`` with the default ``RunConfig`` (the
horns fit of ``chip_smoke.py`` phase 4); each run
``WORLD:BACKEND[:MODEL_PARALLEL]`` is ``chip_smoke.sharded_fit``: the
same fit on a mesh of WORLD ranks, MODEL_PARALLEL (default 1) of them on
the spectral axis (NCCL: one card per rank, the chunks captured as CUDA
graphs; gloo: the ranks share the cards, collectives staged through the
host, the chunks eager), held to it bit for bit at one rank, to the
quadrature bar always, with both region kernels launched on every rank.
``--ndata`` picks the stream and its oracle: ``gen_horns(1000)`` and
``quad_logZ.json`` (the default), or ``gen_horns(10000)`` and
``quad_logZ_horns10000.json`` (the reference's headline scale, where the
group labels refresh every 4th chunk). ``--eager`` runs each mesh a second time with its
steps eager and holds the two bit for bit (``chip_smoke.hold_paths``:
the result, and every rank's launches and collective calls). One JSON
line per run: chunk path, graph replays and host syncs per iteration,
walls, iterations, evaluations, fill rounds, collective calls and wall
per fill round, launches per rank. The default runs NCCL across every
card of the machine (at most 4). On a card, the card's name and power
limit come first; ``--device cpu`` rehearses the control flow, and stops
at the launch check (CPU tensors launch no kernel).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLES = {1000: "quad_logZ.json", 10000: "quad_logZ_horns10000.json"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", default=None,
                    help="WORLD:BACKEND[:MODEL_PARALLEL], e.g. 4:nccl or "
                         "4:nccl:2 (default: every card, at most 4, with "
                         "nccl)")
    ap.add_argument("--eager", action="store_true",
                    help="also run each mesh with its steps eager and hold "
                         "the two bit for bit")
    ap.add_argument("--ndata", type=int, default=1000, choices=sorted(ORACLES),
                    help="the horns stream gen_horns(NDATA), all of it "
                         "fitted, and its quadrature oracle")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke
    from massivedatans_tpu_torch.cli import run_fit
    from massivedatans_tpu_torch.config import RunConfig, set_fp32_precision
    from massivedatans_tpu_torch.datagen.generators import gen_horns
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
    neighbors.count_within.launches = 0
    neighbors.bootstrapped_sq_radius.launches = 0
    cfg = RunConfig()
    data = gen_horns(args.ndata)
    chip_smoke._sync()
    t0 = time.perf_counter()
    single = run_fit(data["x"], data["y"], cfg, args.device,
                     noise_level=data["noise_level"])
    chip_smoke._sync()
    wall = time.perf_counter() - t0
    launches = chip_smoke.launch_counts(neighbors, single)
    with open(os.path.join(ROOT, ORACLES[args.ndata])) as fh:
        quad = np.asarray(json.load(fh)["logZ"], float)
    nq = len(quad)
    within = int((np.abs(single.logZ[:nq] - quad)
                  < 3 * single.logZerr[:nq] + 0.5).sum())
    st = single.stats
    print(json.dumps(dict(fit=f"horns ndata={args.ndata} nlive=400, one device",
                          wall_s=wall, niter=single.niterations,
                          ndraws=single.ndraws, fill_rounds=st["fill_rounds"],
                          chunk_path=st["chunk_path"], chunks=st["chunks"],
                          group_refreshes=st["group_refreshes"],
                          launches=launches, quad_within=within, quad_held=nq,
                          timing=st["timing"])))
    assert within >= int(np.ceil(0.95 * nq)), (within, nq)
    for run in runs:
        world, backend, *mp = run.split(":")
        recs = [chip_smoke.sharded_fit(int(world), backend, data, cfg, single,
                                       launches, wall, quad,
                                       int(mp[0]) if mp else 1, eager)
                for eager in ((False, True) if args.eager else (False,))]
        if args.eager:
            chip_smoke.hold_paths(*recs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
