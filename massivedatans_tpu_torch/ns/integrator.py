"""Host-side nested-sampling loop, single device.

Counterpart of ``massivedatans_tpu/ns/integrator.py`` (reference
``multi_nested_integrator.py:80-175``). The per-iteration work (fill,
advance, logZ/H update, termination) runs on the device in chunks of
``cfg.chunk_iters`` iterations (``engine.run_chunk``); the dead rows of a
chunk collect in device buffers and come back in one device-to-host fetch
per chunk. The host then

- accumulates the dead-point stream into the posterior weight record,
- refreshes the advisory group labels (``ns/subsets.component_labels``),
- compacts the point pile when it nears capacity,
- captures the live-point tails once at the end (terminated datasets'
  live points are frozen by the running mask),
- and, on request, checkpoints at chunk boundaries (``io/checkpoint.py``),
  escalates the eval batch and adapts the per-chunk fill budget.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from massivedatans_tpu_torch.config import RunConfig, require_run_config
from massivedatans_tpu_torch.io import checkpoint as ckpt
from massivedatans_tpu_torch.models.base import Problem
from massivedatans_tpu_torch.ns import engine as engine_lib
from massivedatans_tpu_torch.ns import subsets as subsets_lib
from massivedatans_tpu_torch.ns.engine import EngineState
from massivedatans_tpu_torch.ns.strategies import make_strategy
from massivedatans_tpu_torch.utils.progress import ProgressReporter

log = logging.getLogger("massivedatans_tpu_torch")


@dataclasses.dataclass
class NSResult:
    """Reference output contract (sample.py:202-217)."""

    logZ: np.ndarray        # [D]
    logZerr: np.ndarray     # [D]
    u: np.ndarray           # [niter + nlive, D, ndim]
    x: np.ndarray           # [niter + nlive, D, ndim]
    L: np.ndarray           # [niter + nlive, D]
    w: np.ndarray           # [niter + nlive, D] log-widths
    mask: np.ndarray        # [niter + nlive, D] running mask per record
    information: np.ndarray  # [D] H
    niterations: int
    ndraws: int
    duration: float
    stats: dict


def fetch(tensors) -> list:
    """Bring several device tensors to the host in ONE copy: they travel
    as one float64 buffer (exact for float32, int32, bool and the int64
    counters, all below 2^53) and are cast back to their own dtypes."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    out, o = [], 0
    for t in tensors:
        n = t.numel()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(host[o:o + n].reshape(tuple(t.shape)).astype(dtype))
        o += n
    return out


def compact_pile(state: EngineState) -> EngineState:
    """Drop pile entries no longer referenced by live points, shelves or
    phantoms; dead points have already been streamed out."""
    live_idx, shelf_idx, phantom_idx = fetch(
        [state.live_idx, state.shelves.idx, state.phantom_idx])
    refs = np.unique(np.concatenate([
        live_idx.ravel(), shelf_idx[shelf_idx >= 0],
        phantom_idx[phantom_idx >= 0],
    ]))
    n = len(refs)
    device = state.pile_u.device
    refs_dev = torch.as_tensor(refs, dtype=torch.int64, device=device)
    new_u = torch.zeros_like(state.pile_u)
    new_x = torch.zeros_like(state.pile_x)
    new_u[:n] = state.pile_u[refs_dev]
    new_x[:n] = state.pile_x[refs_dev]

    def remap(idx):
        out = np.where(idx >= 0, np.searchsorted(refs, np.maximum(idx, 0)), -1)
        return torch.as_tensor(out.astype(np.int32), device=device)

    log.info("pile compaction: %d -> %d (cap %d)", int(state.pile_size), n,
             state.pile_capacity)
    return state.replace(
        pile_u=new_u,
        pile_x=new_x,
        pile_size=torch.tensor(n, dtype=torch.int32, device=device),
        live_idx=remap(live_idx),
        shelves=dataclasses.replace(state.shelves, idx=remap(shelf_idx)),
        phantom_idx=remap(phantom_idx),
    )


def reject_unported(mesh=None) -> None:
    """Raise for the one option of the JAX integrator that this port does
    not carry yet: the multi-device mesh (ROADMAP.md queue 1, item 15)."""
    if mesh is not None:
        raise NotImplementedError(
            "the multi-device mesh is not ported to massivedatans_tpu_torch "
            "yet (ROADMAP.md queue 1, item 15)")


def escalated_config(cfg: RunConfig) -> RunConfig:
    """The configuration of an escalated chunk (``cfg.eval_batch_max``):
    the eval batch at its ceiling and the proposal pools scaled alike."""
    scale = max(1, cfg.eval_batch_max // cfg.eval_batch)
    return dataclasses.replace(
        cfg, eval_batch=cfg.eval_batch_max,
        proposal_batch=cfg.proposal_batch * scale,
        column_proposal_batch=cfg.column_proposal_batch * scale)


def multi_nested_integrator(
    problem: Problem,
    cfg: Optional[RunConfig] = None,
    *,
    device,
    generator: Optional[torch.Generator] = None,
    tolerance: Optional[float] = None,
    max_samples: Optional[int] = None,
    min_samples: Optional[int] = None,
    progress: bool = True,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 10,
    max_chunks: Optional[int] = None,
    dispatch_target_s: Optional[float] = None,
) -> NSResult:
    """Run the joint sampler to termination (or graceful preemption) on
    ``device``.

    ``generator`` is a ``torch.Generator`` on ``device``; by default one is
    made there and seeded from ``cfg.seed``. ``problem`` is moved to
    ``device``. ``mesh`` (several devices) is not ported yet and raises.

    ``checkpoint_dir``: save the state, the generator and the dead-point
    stream there (``io/checkpoint.py``) every ``checkpoint_every`` chunks,
    at the end, and at ``max_chunks``; a directory that holds a checkpoint
    is resumed from it. ``max_chunks`` (needs ``checkpoint_dir``): stop
    after this many chunks in all, checkpoint, and return the partial
    result with ``stats["interrupted"] = True``. The state saved is the
    one the next chunk starts from (pile compacted, group labels applied),
    so a resumed run is bit for bit the uninterrupted one, as the JAX
    package's with ``pipeline_lookahead=0``; that holds only with
    escalation and the adaptive budget off, since neither the escalation
    switch nor the budget is saved and the budget follows the wall clock.

    ``cfg.eval_batch_max > cfg.eval_batch``: a chunk whose fill rounds per
    iteration exceed 2.5 makes the next chunks run at the escalated batch
    (``escalated_config``, with its own strategy, since SLICE and GALILEAN
    size their chains from the eval batch), until a chunk needs at most
    1.05 rounds per iteration (``stats["big_batch_chunks"]``).

    ``dispatch_target_s``: adapt each chunk's fill-round budget so that a
    chunk takes about this many seconds: the budget starts at 512 rounds,
    follows the last chunk's seconds per round, grows at most 1.5x per
    chunk and stays within 256 and ``cfg.chunk_fill_budget or 65536``
    (``stats["fill_budget_last"]``). The first chunk of a call is not
    measured, for escalation either.
    """
    cfg = require_run_config(cfg or RunConfig())
    overrides = {k: v for k, v in dict(
        tolerance=tolerance, max_samples=max_samples, min_samples=min_samples,
    ).items() if v is not None}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    reject_unported(mesh)
    if max_chunks is not None and checkpoint_dir is None:
        raise ValueError("max_chunks (graceful preemption) requires "
                         "checkpoint_dir to persist the partial run")
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    problem = problem.to(device)

    D, K, ndim = problem.ndata, cfg.nlive_points, problem.ndim
    member_capacity = cfg.resolve_member_capacity(D)
    runs = [(cfg, make_strategy(cfg))]
    if cfg.eval_batch_max > cfg.eval_batch:
        cfg_big = escalated_config(cfg)
        runs.append((cfg_big, make_strategy(cfg_big)))
    big_active, big_batch_chunks = False, 0
    adaptive = dispatch_target_s is not None
    budget_ceil = cfg.chunk_fill_budget or 65536
    budget_floor = min(256, budget_ceil)
    budget = max(budget_floor, min(budget_ceil, 512))
    prev_rounds = None  # fill rounds at the last chunk's end; None: first chunk

    t0 = time.time()
    timing = dict(init_s=0.0, chunk_s=0.0, fetch_s=0.0, groups_s=0.0,
                  checkpoint_s=0.0, tail_s=0.0)
    state = engine_lib.init_state(problem, generator, cfg)
    pile_cap = state.pile_capacity

    dead_u, dead_x, dead_L, dead_w, dead_mask = [], [], [], [], []
    pending_idx = []  # dead pile indices whose coordinates are not fetched yet

    def resolve_pending(st, pile_size):
        if not pending_idx:
            return
        pile_u, pile_x = fetch([st.pile_u[:pile_size], st.pile_x[:pile_size]])
        for idx in pending_idx:
            u = pile_u[np.maximum(idx, 0)]
            x = pile_x[np.maximum(idx, 0)]
            u[idx < 0] = 0.0
            x[idx < 0] = 0.0
            dead_u.append(u)
            dead_x.append(x)
        pending_idx.clear()

    running = np.ones(D, bool)
    chunk_index = 0
    if checkpoint_dir is not None and ckpt.has_checkpoint(checkpoint_dir):
        log.info("resuming from checkpoint %s", checkpoint_dir)
        state = ckpt.load_state(checkpoint_dir, state, generator)
        running = ckpt.load_host(checkpoint_dir)["running"]
        chunk_index = int(ckpt.load_meta(checkpoint_dir)["chunk_index"])
        for c in ckpt.load_chunks(checkpoint_dir)[:chunk_index]:
            dead_u.append(c["u"])
            dead_x.append(c["x"])
            dead_L.append(c["L"])
            dead_w.append(c["w"])
            dead_mask.append(c["mask"])
    saved_chunks = chunk_index
    timing["init_s"] = time.time() - t0

    reporter = ProgressReporter(enabled=progress, ndata=D)
    # the [K, D] live_idx feeds the advisory group labels; at large K*D it
    # is refreshed on a cadence (config.group_refresh_chunks)
    group_every = cfg.group_refresh_chunks or (1 if K * D <= 1 << 20 else 4)
    interrupted = False
    while running.any():
        t_c0 = time.time()
        run_cfg, strategy = runs[big_active]
        big_batch_chunks += big_active
        state, dead, rows = engine_lib.run_chunk(
            problem, state, run_cfg, member_capacity, cfg.chunk_iters,
            generator, strategy, fill_budget=budget if adaptive else None)
        t_c1 = time.time()
        with_groups = cfg.use_groups and D > 1 and chunk_index % group_every == 0
        parts = fetch([
            dead.idx[:rows], dead.L[:rows], dead.logwidth[:rows],
            dead.running[:rows], state.running, state.iteration,
            state.ndraws, state.pile_size, state.stall_count,
            state.fill_rounds, state.logZ, state.rem_logZ,
        ] + ([state.live_idx] if with_groups else []))
        t_c2 = time.time()
        rep = dict(zip(
            ("idx", "L", "logwidth", "rows_running", "running", "iteration",
             "ndraws", "pile_size", "stall_count", "fill_rounds", "logZ",
             "rem_logZ", "live_idx"), parts))
        pending_idx.append(rep["idx"])
        dead_L.append(rep["L"])
        dead_w.append(np.where(rep["rows_running"], rep["logwidth"],
                               -np.inf).astype(np.float32))
        dead_mask.append(rep["rows_running"])
        chunk_index += 1
        rounds = int(rep["fill_rounds"])
        if prev_rounds is not None:
            used = rounds - prev_rounds
            if adaptive and used > 0:
                # seconds per fill round of this chunk -> the budget that
                # fits the target; growth damped, decrease immediate
                want = int(dispatch_target_s * used / max(t_c2 - t_c0, 1e-4))
                budget = max(budget_floor,
                             min(budget_ceil, int(budget * 1.5), want))
            if len(runs) > 1:
                rpi = used / rows
                if not big_active and rpi > 2.5:
                    big_active = True
                    log.info("fill rounds/iter %.1f: escalating eval_batch "
                             "%d -> %d", rpi, cfg.eval_batch, cfg.eval_batch_max)
                elif big_active and rpi <= 1.05:
                    big_active = False
                    log.info("fill rounds/iter %.2f: back to eval_batch %d",
                             rpi, cfg.eval_batch)
        prev_rounds = rounds
        newly_done = running & ~rep["running"]
        running = rep["running"].copy()
        stalled_out = newly_done & (
            rep["stall_count"] > engine_lib.resolve_stall_limit(cfg))
        if stalled_out.any():
            log.warning("%d datasets force-terminated after stalling "
                        "(stall counts up to %d)", int(stalled_out.sum()),
                        int(rep["stall_count"][stalled_out].max()))
        reporter.update(
            it=int(rep["iteration"]), ndraws=int(rep["ndraws"]),
            running=int(running.sum()),
            logZ0=float(np.logaddexp(rep["logZ"][0], rep["rem_logZ"][0])))
        ps = int(rep["pile_size"])
        if ps >= pile_cap:
            log.warning("point pile hit capacity (%d); accepted candidates "
                        "were dropped — raise cfg.pile_capacity", pile_cap)
        if running.any() and ps > 0.85 * pile_cap:
            resolve_pending(state, ps)  # indices reference the old pile
            state = compact_pile(state)
            ps = int(state.pile_size)
        if running.any() and "live_idx" in rep:
            labels, n_groups = subsets_lib.component_labels(
                rep["live_idx"], selected=running, nlive_points=K)
            state = state.replace(
                group_id=torch.as_tensor(np.maximum(labels, 0),
                                         dtype=torch.int32, device=device),
                n_groups=max(int(n_groups), 1))
        t_c3 = time.time()
        hit_max_chunks = (max_chunks is not None and chunk_index >= max_chunks
                          and running.any())
        if checkpoint_dir is not None and (
                chunk_index % checkpoint_every == 0 or not running.any()
                or hit_max_chunks):
            # the state the next chunk starts from; chunk files hold
            # coordinates, so the pending indices are resolved first
            resolve_pending(state, ps)
            while saved_chunks < chunk_index:
                ckpt.save_chunk(checkpoint_dir, saved_chunks, dict(
                    u=dead_u[saved_chunks], x=dead_x[saved_chunks],
                    L=dead_L[saved_chunks], w=dead_w[saved_chunks],
                    mask=dead_mask[saved_chunks]))
                saved_chunks += 1
            ckpt.save_state(
                checkpoint_dir, state, generator,
                host_ctx=dict(running=running),
                meta=dict(chunk_index=chunk_index, ndata=D, nlive=K,
                          iteration=int(rep["iteration"])))
        timing["chunk_s"] += t_c1 - t_c0
        timing["fetch_s"] += t_c2 - t_c1
        timing["groups_s"] += t_c3 - t_c2
        timing["checkpoint_s"] += time.time() - t_c3
        if hit_max_chunks:
            log.info("max_chunks=%d reached: checkpointed and stopping",
                     max_chunks)
            interrupted = True
            break

    t_tail0 = time.time()
    ps = int(state.pile_size)
    resolve_pending(state, ps)
    (ti, tL, pile_u, pile_x, niter, ndraws, stall_count, member_overflow,
     fill_rounds, run_logZ, final_H, rem_logZ, rem_logZerr,
     last_logwidth) = fetch([
         *engine_lib.capture_tails_idx(state), state.pile_u[:ps],
         state.pile_x[:ps], state.iteration, state.ndraws, state.stall_count,
         state.member_overflow, state.fill_rounds, state.logZ, state.H,
         state.rem_logZ, state.rem_logZerr, state.last_logwidth])
    timing["tail_s"] = time.time() - t_tail0

    niter, ndraws = int(niter), int(ndraws)
    final_H = final_H.astype(np.float64)
    u = np.concatenate(dead_u + [pile_u[ti]], axis=0)
    x = np.concatenate(dead_x + [pile_x[ti]], axis=0)
    L = np.concatenate(dead_L + [tL], axis=0)
    tails_w = np.broadcast_to(last_logwidth[None, :], (K, D))
    w = np.concatenate(dead_w + [tails_w.astype(np.float32)], axis=0)
    mask = np.concatenate(dead_mask + [np.ones((K, D), bool)], axis=0)

    logZ = np.logaddexp(run_logZ.astype(np.float64),
                        rem_logZ.astype(np.float64))
    logZerr = (np.sqrt(np.maximum(final_H, 0.0) / K)
               + rem_logZerr.astype(np.float64))
    duration = time.time() - t0
    reporter.finish(niter=niter, ndraws=ndraws, duration=duration)
    stall_count = stall_count.astype(np.int64)
    return NSResult(
        logZ=logZ,
        logZerr=logZerr,
        u=u,
        x=x,
        L=L,
        w=w,
        mask=mask,
        information=final_H,
        niterations=niter,
        ndraws=ndraws,
        duration=duration,
        stats=dict(
            ndraws=ndraws,
            duration=duration,
            ndata=D,
            niter=niter,
            stalled=int(stall_count.max(initial=0)),
            member_overflow=int(member_overflow),
            fill_rounds=int(fill_rounds),
            pile_peak=ps,
            interrupted=interrupted,
            stall_count=stall_count,
            stalled_mask=stall_count > engine_lib.resolve_stall_limit(cfg),
            chunks=chunk_index,
            big_batch_chunks=big_batch_chunks,
            fill_budget_last=budget if adaptive else None,
            timing={k: round(v, 3) for k, v in timing.items()},
            device=str(device),
        ),
    )
