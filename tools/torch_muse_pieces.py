"""Fit the MUSE validation fixture to tolerance in resumable pieces.

    # one piece: at most 10 more chunks, then checkpoint and stop
    python3 tools/torch_muse_pieces.py --checkpoint-dir ck --max-chunks 10 \
        --eval-batch-max 512
    # pieces until the fit is done (exit 75 means "interrupted, go on")
    while python3 tools/torch_muse_pieces.py --checkpoint-dir ck \
        --max-chunks 10 --eval-batch-max 512; [ $? -eq 75 ]; do :; done

The fixture is ``tools/muse_validate.py``'s, built with the port's
``synth`` as ``chip_smoke.muse_fixture`` builds it (100 spaxels, nspec
3600, FULL model, nlive 400, tolerance 0.5, seed 11, no iteration cap);
the fixture is made anew from its seed in every piece. Each call resumes
from ``--checkpoint-dir`` (if it holds a checkpoint), runs at most
``--max-chunks`` more chunks, checkpoints and prints one JSON line: the
chunks, iterations, fill rounds and evaluations so far, the spaxels still
running, the escalated chunks of this piece and its wall. The piece that
finishes adds the no-star identity over the empty spaxels
(median and max of |logZ + yy/2|). Progress lines go to stderr. Exits 0
when the fit is done, 75 when it was interrupted. The card's name and
power limit come first. A rehearsal on the CPU patches ``chip_smoke``'s
fixture constants and ``DEVICE`` as one of ``chip_smoke.py`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTERRUPTED = 75


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--max-chunks", type=int, required=True,
                    help="chunks this call may run before it checkpoints")
    ap.add_argument("--eval-batch-max", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_muse_pieces: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from massivedatans_tpu_torch.io import checkpoint as ckpt

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    done = (ckpt.load_meta(args.checkpoint_dir)["chunk_index"]
            if ckpt.has_checkpoint(args.checkpoint_dir) else 0)
    with tempfile.TemporaryDirectory() as tmp:
        fixture = chip_smoke.muse_fixture(tmp)
        cube, _, truths = fixture
        t0 = time.perf_counter()
        result, problem = chip_smoke.muse_fit(
            fixture, 0, progress=True, run_opts=dict(
                checkpoint_dir=args.checkpoint_dir,
                max_chunks=done + args.max_chunks),
            eval_batch_max=args.eval_batch_max)
        wall = time.perf_counter() - t0
    stats = result.stats
    rec = dict(
        fit=f"MUSE FULL spaxels={problem.ndata} nspec={cube.y.shape[0]} "
            f"nlive={chip_smoke.MUSE_NLIVE} eval_batch_max={args.eval_batch_max}",
        chunks=[done, stats["chunks"]], niter=result.niterations,
        fill_rounds=stats["fill_rounds"], ndraws=result.ndraws,
        running=int(ckpt.load_host(args.checkpoint_dir)["running"].sum()),
        big_batch_chunks=stats["big_batch_chunks"], wall_s=wall,
        timing=stats["timing"], interrupted=stats["interrupted"])
    if not stats["interrupted"]:
        n = problem.ndata
        empty = np.asarray(truths["empty"], bool)[:n]
        yy = np.asarray(truths["yy"], np.float64)[:n]
        identity = result.logZ[empty] + yy[empty] / 2
        rec.update(n_empty=int(empty.sum()),
                   median_logZ_plus_half_yy=float(np.median(identity)),
                   max_abs_logZ_plus_half_yy=float(np.abs(identity).max()),
                   logZ_finite=bool(np.isfinite(result.logZ).all()))
    print(json.dumps(rec), flush=True)
    return INTERRUPTED if stats["interrupted"] else 0


if __name__ == "__main__":
    sys.exit(main())
