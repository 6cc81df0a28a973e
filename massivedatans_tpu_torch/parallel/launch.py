"""Start the ranks of a sharded run: one process per rank.

The JAX package is single-controller, so it has no counterpart of this
module. ``spawn_ranks`` starts ``world`` processes with
``torch.multiprocessing.spawn``, joins them into one default process group
through a ``FileStore`` in a fresh temporary directory (no TCP port to
race for when several runs start at once), calls ``fn`` in each and
returns what every rank returned, in rank order.

The backend is an explicit argument and nothing switches it:

- ``nccl`` with ``device_type="cuda"``: one card per rank (rank r on
  ``cuda:r``); NCCL refuses two ranks on one card, so a world larger than
  the card count raises. The process group is bound to the rank's card,
  so its communicator is made at once rather than at the first collective
  (which may be inside a CUDA graph capture, where none can be made);
- ``gloo`` with ``device_type="cpu"``: ranks compute on the CPU;
- ``gloo`` with ``device_type="cuda"``: ranks compute on the cards (rank r
  on ``cuda:r % count``, so several ranks may share one card) and every
  collective stages its tensors through host memory
  (``sharded._staged``).

Every collective runs under ``timeout_s``: a rank that drifts out of step
fails the run instead of hanging it. An eager collective is watched by
the process group itself; collectives replayed inside CUDA graphs are
not, so the engine waits for each replayed block's status under the same
timeout and raises ``TimeoutError`` when it passes
(``engine.ChunkProgram``). A rank that raises ends the run and
``spawn_ranks`` raises its error; the other ranks are stopped. Under
NCCL the failed rank's process ends at once, without tearing its process
group down: that would wait for collectives no peer will join.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist

BACKENDS = {"nccl": "cuda", "gloo": "cpu"}  # backend -> where it reduces
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Rank:
    """What ``fn`` is told about its process."""

    rank: int
    world: int
    device: torch.device      # where this rank computes
    mesh_device_type: str     # where the collectives run (``make_mesh``)


def _rank_device(rank: int, backend: str, device_type: str) -> torch.device:
    if device_type == "cpu":
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} cannot run on the CPU; "
                             "use gloo")
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _check_world(world: int, backend: str, device_type: str) -> None:
    """Raise for a request the backend cannot serve."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: choose one of "
                         f"{sorted(BACKENDS)}")
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device type {device_type!r}: cpu or cuda")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device type cuda: torch.cuda.is_available() is "
                           "False")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("nccl needs device_type='cuda'")
        if world > torch.cuda.device_count():
            raise ValueError(
                f"nccl needs one card per rank: world {world} > "
                f"{torch.cuda.device_count()} cards (two ranks on one card "
                "run with gloo)")


def spawn_ranks(fn, world: int, backend: str, device_type: str,
                timeout_s: float = DEFAULT_TIMEOUT_S, *args) -> list:
    """``[fn(Rank(0, ...), *args), ..., fn(Rank(world - 1, ...), *args)]``,
    each computed in its own process inside one process group. ``fn`` and
    ``args`` are pickled to the processes (``fn`` must be importable by
    name) and so is each rank's return value back."""
    _check_world(world, backend, device_type)
    with tempfile.TemporaryDirectory(prefix="mdt_ranks_") as tmp:
        try:
            torch.multiprocessing.spawn(
                _rank_main, args=(fn, world, backend, device_type, timeout_s,
                                  tmp, args),
                nprocs=world, join=True)
        except torch.multiprocessing.ProcessExitedException:
            failed = [r for r in range(world) if os.path.exists(
                os.path.join(tmp, f"rank{r}.err"))]
            if not failed:
                raise
            with open(os.path.join(tmp, f"rank{failed[0]}.err")) as fh:
                raise RuntimeError(f"rank {failed[0]} failed:\n"
                                   f"{fh.read()}") from None
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
    return out


def run_sharded(problem, cfg, world: int, backend: str, device_type: str,
                model_parallel: int = 1, timeout_s: float = DEFAULT_TIMEOUT_S,
                **run_opts):
    """``multi_nested_integrator(problem, cfg, mesh=...)`` in each rank of
    a fresh mesh of ``world`` ranks (``model_parallel`` on the spectral
    axis); returns rank 0's ``NSResult``, which holds every dataset.
    Every rank's generator is seeded from ``cfg.seed``; ``run_opts`` go
    to the integrator (``progress`` reports from rank 0 only)."""
    return spawn_ranks(_integrate_rank, world, backend, device_type,
                       timeout_s, problem, cfg, model_parallel, run_opts)[0]


def _integrate_rank(rank, problem, cfg, model_parallel, run_opts):
    from massivedatans_tpu_torch.config import set_fp32_precision
    from massivedatans_tpu_torch.ns.integrator import multi_nested_integrator
    from massivedatans_tpu_torch.parallel.sharded import make_mesh

    set_fp32_precision()
    mesh = make_mesh(rank.world, model_parallel, rank.mesh_device_type)
    return multi_nested_integrator(
        problem, cfg, device=rank.device, mesh=mesh,
        **(dict(progress=False) | run_opts))


def _rank_main(rank, fn, world, backend, device_type, timeout_s, tmp, args):
    device = _rank_device(rank, backend, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=device if backend == "nccl" else None)
    try:
        result = fn(Rank(rank, world, device, BACKENDS[backend]), *args)
    except BaseException:
        if backend != "nccl":
            dist.destroy_process_group()
            raise
        # collectives left in flight that no peer will join (a replayed
        # graph's, once a rank is out of step) hold up an orderly teardown
        # and an abort of the communicators alike: leave the error for
        # spawn_ranks and end the process at once, as the process group's
        # watchdog does when an eager collective times out
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)
