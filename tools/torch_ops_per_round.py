"""Count the torch operations that one fill round issues, by part.

    python3 tools/torch_ops_per_round.py                 # every strategy, CPU
    python3 tools/torch_ops_per_round.py SLICE GALILEAN

A fill round's operations are what the port's eager path dispatches from the
host one by one, and what a captured round graph holds on the card. This
fits nothing: it makes the chunk program (``ns/engine.ChunkProgram``) of
the default ``RunConfig`` fit of 100 horns spectra, opens an iteration's
fill (its ``start`` and ``begin`` steps) and runs ``ROUNDS`` region rounds
(the ``region`` step) under a ``TorchDispatchMode`` that counts every
operation the dispatcher sees, split into the engine's own, the
likelihood's (prior transform and log-likelihood) and the strategy's
(``propose``, ``observe``, ``refresh``), and into views and scalars (no
kernel) and the rest. It prints one JSON line per strategy, per round
step. These are counts on the CPU, not times; a card runs the same Python
calls, though a composite operation may dispatch other internals there.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 10
# operations that launch no kernel on a card
NO_KERNEL = ("aten.unsqueeze", "aten.slice", "aten.select", "aten.view",
             "aten.expand", "aten.t.", "aten.transpose", "aten.alias",
             "aten._local_scalar_dense", "aten.scalar_tensor", "aten.detach",
             "aten.squeeze", "aten.as_strided", "aten.lift_fresh")


def count_round_ops(name: str, rounds: int, ndata: int = 100) -> dict:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from massivedatans_tpu_torch.config import RunConfig
    from massivedatans_tpu_torch.datagen.generators import gen_horns
    from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem
    from massivedatans_tpu_torch.ns import engine, strategies

    part = ["engine"]
    counts = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kind = "views" if str(func).startswith(NO_KERNEL) else "ops"
            counts[f"{part[-1]}_{kind}"] += 1
            return func(*args, **(kwargs or {}))

    def tagged(fn, tag):
        def run(*a, **k):
            part.append(tag)
            try:
                return fn(*a, **k)
            finally:
                part.pop()
        return run

    data = gen_horns(1000)
    problem = make_gaussline_problem(data["x"], data["y"][:, :ndata],
                                     noise_level=data["noise_level"],
                                     device="cpu")
    problem.loglike = tagged(problem.loglike, "likelihood")
    problem.transform_batch = tagged(problem.transform_batch, "likelihood")
    cfg = RunConfig(constrainer=name)
    s = strategies.make_strategy(cfg)
    s = strategies.Strategy(
        s.build, tagged(s.propose, "strategy"), s.init_chains,
        tagged(s.observe, "strategy"), tagged(s.refresh, "strategy"), s.norm)
    gen = torch.Generator().manual_seed(0)
    state = engine.init_state(problem, gen, cfg)
    mc = cfg.resolve_member_capacity(ndata)
    prog = engine.ChunkProgram(problem, cfg, s, mc, 1, gen, state)
    prog._step("start")
    prog.carry.budget.fill_(rounds)
    prog._step("begin")
    with Count():
        for _ in range(rounds):
            prog._step("region")
    n = rounds
    rec = {k: v / n for k, v in sorted(counts.items())}
    rec.update(constrainer=name, rounds=n,
               rounds_on=int(prog.carry.state.fill_rounds),
               total=sum(counts.values()) / n,
               kernels=sum(v for k, v in counts.items()
                           if k.endswith("_ops")) / n)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("constrainer", nargs="*",
                    default=["MLFRIENDS", "MULTIELLIPSOIDS", "SLICE", "GALILEAN"])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    for name in args.constrainer:
        print(json.dumps(count_round_ops(name, ROUNDS)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
