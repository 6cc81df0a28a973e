"""Both packages' MUSE fill rounds from one shared late state, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/muse_rounds_from_state.py [--out FILE]
    # from a JAX state kept by tools/jax_muse_rounds.py --checkpoint-dir
    JAX_PLATFORMS=cpu python3 tools/muse_rounds_from_state.py \\
        --state muse_rounds_ck/budget_seed1/chunk_00040 --out FILE
    # from a state of tools/jax_muse_rounds.py --cube bench (its options;
    # the live-L checks on 32 of the 4,223 spaxels; about 20 min)
    JAX_PLATFORMS=cpu python3 tools/muse_rounds_from_state.py --cube bench \\
        --state muse_bench_ck/bench_seed1/chunk_00012 --parts A B \\
        --batches 100 --live-spaxels 32 --out muse_bench_state_rounds.json
    # (C) a package at a time: the JAX package on the CPU, the port on a
    # card (no JAX there: no cube check, no (A) or (B)), then compared
    JAX_PLATFORMS=cpu python3 tools/muse_rounds_from_state.py --cube bench \
        --state DIR --parts C --packages jax --seeds 1 --out j1.json
    python3 tools/muse_rounds_from_state.py --cube bench --state DIR \
        --parts C --packages torch --device cuda --seeds 1 2 --out t.json
    python3 tools/muse_rounds_from_state.py --combine j1.json t.json \
        --out c.json
    # a rehearsal at a small size (about a minute)
    JAX_PLATFORMS=cpu python3 tools/muse_rounds_from_state.py --side 4 \\
        --nspec 600 --state DIR --batches 20 --candidates 512 --seeds 1 \\
        --chunks 1 --out /tmp/s.json

Builds ``tools/torch_muse_validate.py``'s fixture once with the port's
``synth`` (``build_fixture``: 10 x 10 spaxels, nspec 3600, seed 11) and
loads one JAX ``EngineState`` checkpoint (by default the JAX MUSE run of
record's, ``muse_valid_out/ckpt_100``: iteration 7,001) into both
packages: the JAX package through ``io.checkpoint.load_state`` on an
``init_state`` template (nlive 400, shelf capacity 16), the port through
``convert.state_from_numpy`` with ``LEAF_NAMES``, the map from the
checkpoint's leaf numbers to the fields (the order of the JAX package's
``_flatten_state``), kept here with numpy only so that ``chip_smoke.py``
loads the state on a card without JAX. A state saved after its run
stopped at a cap holds no running spaxel; the spaxels that the cap stopped
(``term_iter == iteration``) are made running again (``reopen``).

Then, in order (each package's own functions on the same state):

1. **The cube check.** Each running spaxel's ``live_L`` is recomputed from
   ``pile_x[live_idx]`` with each package's likelihood and held to the
   stored ``live_L`` and to a float64 witness at ``chip_smoke.MUSE_CANCEL``
   * yy. If either misses, the fixture is not the state's cube: the tool
   writes what it found and exits 1.
2. **(A) Likelihood decisions.** ``--candidates`` points drawn from the
   state's region (the port's geometry from the running spaxels) are
   scored by both packages and in float64: the largest |dL| between the
   packages and against float64 over the running spaxels, and the count
   of (candidate, running spaxel) pairs whose ``L > insertion threshold``
   differs between the packages. Then at the contour
   (``live_decisions``): each running spaxel's live points against the
   thresholds its insertion threshold takes (its lowest live L), the
   decisions that differ between the packages and against float64.
3. **(B) Proposals by round kind.** ``--batches`` independent batches per
   kind and package, each with its own key or generator: ``region`` (a
   geometry built from the running spaxels, as a rebuild builds it),
   ``focus`` (a refocus build on the empty-shelf spaxels, batch ``i`` on
   group ``i % n_groups`` as the cycle visits them) and ``column``
   (``_column_proposals`` on the state's empty set). Per batch: the valid
   share of the eval batch, the valid candidates that some running spaxel
   accepts (the engine's ``acc``: valid, shelf space, above the threshold,
   a column candidate only in its own column), the radius and the member
   overflow (a column round has neither: ``None``).
4. **(C) Engine totals.** ``--chunks`` chunks of each engine from the
   state, at the witness's options (chunk_iters 50, chunk_fill_budget 319,
   eval batch 128, no escalation, no wall-clock budget; no cap, which the
   state has passed), for each of ``--seeds``, the group labels made from
   each chunk's live points as the integrators make them: iterations, fill
   rounds, evaluations, spaxel advances (the dead rows with ``idx >= 0``)
   and running spaxels after each chunk, one process per seed. The totals
   compared are what the chunks added to the state's counts, and the
   spaxels still running. ``--packages`` runs one package's chunks alone
   (the port's on ``--device``), and ``--combine`` compares such records
   from the same state and cube on the seeds both ran, over the chunks
   all ran (``combine``), and holds the seeds' evaluations, advances and
   evaluations per advance to each other with
   ``tools/torch_muse_bench.held_to_seeds``.

Means come with standard errors; a kind (or a total) ``differs`` when the
means part by more than 4 standard errors and by more than 10 % of the
larger. One JSON record goes to ``--out`` with the cube's and the state
file's SHA-256. Every wall in it is a CPU wall.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE_DIR = os.path.join(ROOT, "muse_valid_out", "ckpt_100")
# the JAX EngineState's leaves in jax.tree.flatten order
# (massivedatans_tpu/ns/engine.py:42-94; Shelves' three fields in place)
LEAF_NAMES = (
    "key", "pile_u", "pile_x", "pile_size", "live_idx", "live_L",
    "shelves.idx", "shelves.L", "shelves.count", "running", "Lmax", "logZ",
    "H", "logVolremaining", "logwidth", "last_logwidth", "rem_logZ",
    "rem_logZerr", "iteration", "ndraws", "prev_scale", "prev_radius",
    "group_id", "n_groups", "phantom_idx", "phantom_L", "term_iter",
    "stall_count", "member_overflow", "fill_rounds", "draws_at_rebuild")
KINDS = ("region", "focus", "column")
# the witness's options (MUSE_WITNESS_TORCH.json), without its cap; nlive
# and the shelf capacity are the state's own (``state_options``)
OPTIONS = dict(tolerance=0.5, chunk_iters=50, chunk_fill_budget=319,
               eval_batch=128)
DIFF_SE, DIFF_REL = 4.0, 0.10


# --- statistics --------------------------------------------------------------

def mean_se(x):
    """Mean and standard error of the mean (``se`` 0 for one value)."""
    x = np.asarray(x, np.float64)
    n = len(x)
    return float(x.mean()), (float(x.std(ddof=1) / math.sqrt(n)) if n > 1
                             else 0.0)


def ratio_se(num, den):
    """``sum(num) / sum(den)`` over batches and its standard error (the
    ratio estimator's linearisation); ``(nan, nan)`` when ``den`` sums to
    0."""
    a, v = np.asarray(num, np.float64), np.asarray(den, np.float64)
    n, tot = len(a), v.sum()
    if tot <= 0:
        return float("nan"), float("nan")
    r = a.sum() / tot
    if n < 2:
        return float(r), 0.0
    resid = a - r * v
    return float(r), float(math.sqrt((resid ** 2).sum() / (n * (n - 1)))
                           / v.mean())


def differs(a, b, k=DIFF_SE, rel=DIFF_REL):
    """Whether two ``(mean, se)`` pairs part by more than ``k`` combined
    standard errors and by more than ``rel`` of the larger mean."""
    (ma, sa), (mb, sb) = a, b
    if not (np.isfinite(ma) and np.isfinite(mb)):
        return bool(np.isfinite(ma) != np.isfinite(mb))
    gap = abs(ma - mb)
    return bool(gap > k * math.hypot(sa, sb)
                and gap > rel * max(abs(ma), abs(mb)))


def summarize(batches):
    """One kind's per-batch records (``valid``, ``accepted``, ``radius``,
    ``overflow``, ``eval_batch``) as means with standard errors."""
    valid = [b["valid"] for b in batches]
    out = dict(
        batches=len(batches),
        valid_share=mean_se([b["valid"] / b["eval_batch"] for b in batches]),
        accepted_share=ratio_se([b["accepted"] for b in batches], valid),
        accepted_per_batch=mean_se([b["accepted"] for b in batches]))
    for k in ("radius", "overflow"):
        vals = [b[k] for b in batches if b[k] is not None]
        out[k] = mean_se(vals) if vals else None
    return out


def compare_kinds(jax_kinds, port_kinds):
    """Per kind and statistic: whether the packages differ."""
    return {kind: {k: differs(jax_kinds[kind][k], port_kinds[kind][k])
                   for k in ("valid_share", "accepted_share", "radius",
                             "overflow")
                   if jax_kinds[kind][k] is not None
                   and port_kinds[kind][k] is not None}
            for kind in jax_kinds}


TOTALS = ("niter", "fill_rounds", "ndraws", "running", "advances")


def chunk_totals(runs, start):
    """Per seed, what its chunks added to the state's ``start`` counts
    (iterations, fill rounds, evaluations; the advances, counted from 0)
    and the spaxels still running after the last chunk. A key that the
    runs lack (advances, in records written before they were counted) is
    left out."""
    return {k: [r[-1][k] - start.get(k, 0) if k != "running" else
                r[-1][k] for r in runs]
            for k in TOTALS if all(k in r[-1] for r in runs)}


def compare_totals(jax_runs, port_runs, start):
    """``chunk_totals`` over seeds, as means with standard errors, with
    whether they differ."""
    jt, pt = chunk_totals(jax_runs, start), chunk_totals(port_runs, start)
    out = {}
    for k in TOTALS:
        if k in jt and k in pt:
            j, p = mean_se(jt[k]), mean_se(pt[k])
            out[k] = dict(jax=j, torch=p, differs=differs(j, p))
    return out


def seed_totals(runs, start):
    """``chunk_totals`` as one dict per seed, with the evaluations per
    advance where the advances were counted: the fits that
    ``torch_muse_bench.held_to_seeds`` compares."""
    totals = chunk_totals(runs, start)
    fits = [{k: v[i] for k, v in totals.items()} for i in range(len(runs))]
    for f in fits:
        if f.get("advances"):
            f["evals_per_advance"] = f["ndraws"] / f["advances"]
    return fits


def state_start(arrays):
    """The state's own counts, from which the chunks' totals are taken."""
    return dict(niter=int(arrays["iteration"]),
                fill_rounds=int(arrays["fill_rounds"]),
                ndraws=int(arrays["ndraws"]))


# --- the state, with numpy ---------------------------------------------------

def sha256_file(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def state_arrays(state_dir):
    """The checkpoint's leaves by field name (``LEAF_NAMES``; the key's
    raw data under ``key``), and its pile capacity."""
    with np.load(os.path.join(state_dir, "state.npz")) as z:
        out = {}
        for i, name in enumerate(LEAF_NAMES):
            key = f"leaf_{i:03d}"
            out[name] = z[key + "__key"] if name == "key" else z[key]
        return out, int(z["pile_capacity"])


def reopen(arrays):
    """The state with the spaxels that a cap stopped running again: those
    whose ``term_iter`` is the state's iteration (the integrator stops the
    datasets still running at iteration ``max_samples + 1``). A state
    that has running spaxels is returned as it is."""
    a = dict(arrays)
    if a["running"].any():
        return a
    capped = a["term_iter"] == a["iteration"]
    a["running"] = capped.copy()
    a["term_iter"] = np.where(capped, -1, a["term_iter"]).astype(np.int32)
    return a


def port_state(arrays, pile_capacity, device="cpu"):
    """The port's ``EngineState`` from ``state_arrays`` (pile padded to
    its capacity; ``convert.state_from_numpy`` adds the write-sink row)."""
    from massivedatans_tpu_torch import convert

    fields = {k: v for k, v in arrays.items()
              if k != "key" and not k.startswith("shelves.")}
    fields["shelves"] = {k: arrays[f"shelves.{k}"]
                         for k in ("idx", "L", "count")}
    for k in ("pile_u", "pile_x"):
        pile = np.zeros((pile_capacity, arrays[k].shape[1]), np.float32)
        pile[:len(arrays[k])] = arrays[k]
        fields[k] = pile
    return convert.state_from_numpy(fields, device)


def state_options(arrays):
    """``OPTIONS`` with the state's nlive and shelf capacity."""
    return dict(OPTIONS, nlive_points=int(arrays["live_L"].shape[0]),
                shelf_capacity=int(arrays["shelves.idx"].shape[0]))


def port_config(arrays, **changes):
    from massivedatans_tpu_torch.config import RunConfig

    return RunConfig(**{**state_options(arrays), **changes})


def port_problem(cube, tpl, device="cpu", zhi=0.5):
    from massivedatans_tpu_torch.config import set_fp32_precision
    from massivedatans_tpu_torch.muse.likelihood import make_muse_problem
    from massivedatans_tpu_torch.muse.model import load_template_grid

    set_fp32_precision()
    md = load_template_grid(tpl, data_wl_nm=cube.wavelength_nm, zlo=0.0,
                            zhi=zhi, device=device)
    return make_muse_problem(md, cube.y, cube.var)


def port_labels(state, K):
    """The state with the group labels made from its live points, as the
    integrator makes them after each chunk."""
    import torch

    from massivedatans_tpu_torch.ns import subsets

    running = state.running.cpu().numpy()
    if not running.any():
        return state
    labels, n = subsets.component_labels(state.live_idx.cpu().numpy(),
                                         selected=running, nlive_points=K)
    return state.replace(
        group_id=torch.as_tensor(np.maximum(labels, 0), dtype=torch.int32,
                                 device=state.live_idx.device),
        n_groups=max(int(n), 1))


def float64_loglike(problem, cube, x):
    """The port's MUSE likelihood of ``x`` in float64 (``chip_smoke``'s
    witness) and the spaxels' ``yy``."""
    import copy

    import torch

    from massivedatans_tpu_torch.muse.likelihood import (
        muse_weights,
        scaled_loglike_batch,
    )

    f64 = dict(dtype=torch.float64, device=x.device)
    y_over_v, inv_v, yy = (torch.as_tensor(a, **f64)
                           for a in muse_weights(cube.y, cube.var))
    md64 = copy.deepcopy(problem.md).double()
    return scaled_loglike_batch(md64, y_over_v, inv_v, yy, x.double()), yy


# --- the port's measurements -------------------------------------------------

def port_thresholds(state, cfg):
    from massivedatans_tpu_torch.ns import shelves as shelves_lib

    bot = shelves_lib.live_bottom(state.live_L, cfg.shelf_capacity)
    return shelves_lib.insertion_thresholds(bot, state.shelves)


def port_round(problem, state, cfg, kind, generator, index=0):
    """One batch of round kind ``kind`` from ``state`` (nothing in it
    changes): the counts of ``summarize``."""
    import torch

    from massivedatans_tpu_torch.ns import engine
    from massivedatans_tpu_torch.ns.strategies import make_strategy

    strategy = make_strategy(cfg)
    D = state.live_L.shape[1]
    empty = state.running & (state.shelves.count == 0)
    radius = overflow = src = None
    if kind == "column":
        B_raw = max(cfg.column_proposal_batch or cfg.proposal_batch,
                    cfg.eval_batch)
        u, ok, cols = engine._column_proposals(
            state.pile_u, state.live_idx, empty, generator, B_raw,
            norm=strategy.norm, n_slots=cfg.column_slots)
        take = torch.argsort((~ok).to(torch.uint8),
                             stable=True)[:cfg.eval_batch]
        u, valid, src = u[take], ok[take], cols[take]
    else:
        if kind == "region":
            mask, carry = state.running, True
        else:
            grp = empty & (state.group_id == index % state.n_groups)
            use = state.n_groups <= cfg.column_focus_groups and bool(grp.any())
            mask, carry = (grp if use else empty), False
        geom, ovf = engine._build_geometry_from(
            strategy, state, mask, generator, cfg,
            cfg.resolve_member_capacity(D), carry_cap=carry)
        u, valid, _ = strategy.propose(
            geom, strategy.init_chains(geom, generator), generator)
        radius, overflow = float(geom.radius), int(ovf)
    L = problem.loglike(problem.transform_batch(u))
    acc = (valid[:, None] & (state.shelves.count < cfg.shelf_capacity)[None]
           & state.running[None] & (L > port_thresholds(state, cfg)[None]))
    if src is not None:
        acc &= src[:, None] == torch.arange(D, device=L.device)[None]
    return dict(valid=int(valid.sum()), accepted=int(acc.any(dim=1).sum()),
                radius=radius, overflow=overflow, eval_batch=cfg.eval_batch)


def port_kinds(problem, state, cfg, batches, seed=1, kinds=KINDS):
    import torch

    out = {}
    for j, kind in enumerate(kinds):
        gen = torch.Generator(device=state.live_L.device).manual_seed(
            1000 * seed + j)
        out[kind] = summarize([port_round(problem, state, cfg, kind, gen, i)
                               for i in range(batches)])
    return out


def port_chunks(problem, arrays, pile_capacity, cfg, seed, n_chunks,
                device="cpu", eager=False):
    """``n_chunks`` chunks of the port's engine from the state (loaded
    afresh: a chunk writes its state in place), the generator seeded
    ``seed``; the counts after each. On a card the chunks run captured
    unless ``eager``."""
    import torch

    from massivedatans_tpu_torch.ns import engine
    from massivedatans_tpu_torch.ns.strategies import make_strategy

    state = port_labels(port_state(arrays, pile_capacity, device),
                        cfg.nlive_points)
    gen = torch.Generator(device=device).manual_seed(seed)
    D = state.live_L.shape[1]
    runner = engine.ChunkRunner(problem, cfg.resolve_member_capacity(D),
                                cfg.chunk_iters, gen, eager=eager)
    strategy, rows, t0 = make_strategy(cfg), [], time.perf_counter()
    advances = 0
    for _ in range(n_chunks):
        runner.start(state, cfg, strategy)
        state, dead, n = runner.finish()
        advances += int((dead.idx[:n] >= 0).sum())
        rows.append(dict(niter=int(state.iteration), advances=advances,
                         fill_rounds=int(state.fill_rounds),
                         ndraws=int(state.ndraws),
                         running=int(state.running.sum()),
                         member_overflow=int(state.member_overflow),
                         n_groups=state.n_groups,
                         wall_s=time.perf_counter() - t0))
        state = port_labels(state, cfg.nlive_points)
    # the pile's used rows only: its sink row takes whichever dropped
    # candidate the device writes last
    rows[-1]["digest"] = hashlib.sha256(b"".join(
        t.cpu().numpy().tobytes() for t in (
            state.live_idx, state.live_L, state.logZ,
            state.pile_u[:int(state.pile_size)]))).hexdigest()
    return rows


# --- the JAX package's measurements ------------------------------------------

def jax_setup(cube, tpl, state_dir, arrays, zhi=0.5, **changes):
    """The JAX problem, configuration (``state_options`` with
    ``changes``) and state (the checkpoint loaded on an ``init_state``
    template, reopened like ``arrays``)."""
    import jax
    import jax.numpy as jnp

    from massivedatans_tpu.config import RunConfig
    from massivedatans_tpu.io import checkpoint as ckpt
    from massivedatans_tpu.muse.likelihood import make_muse_problem
    from massivedatans_tpu.muse.model import load_template_grid
    from massivedatans_tpu.ns import engine

    md = load_template_grid(tpl, data_wl_nm=cube.wavelength_nm, zlo=0.0,
                            zhi=zhi)
    problem = make_muse_problem(md, cube.y, cube.var)
    cfg = RunConfig(**{**state_options(arrays), **changes})
    template = engine.init_state(problem, jax.random.key(0), cfg)
    state = ckpt.load_state(state_dir, template)
    state = state._replace(running=jnp.asarray(arrays["running"]),
                           term_iter=jnp.asarray(arrays["term_iter"]))
    return problem, cfg, state


def jax_labels(state, K):
    import jax.numpy as jnp

    from massivedatans_tpu.ns import subsets

    running = np.asarray(state.running)
    if not running.any():
        return state
    labels, n = subsets.component_labels(np.asarray(state.live_idx),
                                         selected=running, nlive_points=K)
    return state._replace(group_id=jnp.asarray(np.maximum(labels, 0),
                                               jnp.int32),
                          n_groups=jnp.int32(max(int(n), 1)))


def jax_round_fn(problem, cfg, kind):
    """A jitted batch of round kind ``kind``: ``(state, key, index) ->
    (valid, accepted, radius, overflow)``."""
    import jax
    import jax.numpy as jnp

    from massivedatans_tpu.ns import engine
    from massivedatans_tpu.ns import shelves as shelves_lib
    from massivedatans_tpu.ns.strategies import make_strategy

    strategy = make_strategy(cfg)

    def one(state, key, index):
        D = state.live_L.shape[1]
        empty = state.running & (state.shelves.count == 0)
        k_geom, k_chain, k_prop = jax.random.split(key, 3)
        radius = overflow = jnp.float32(jnp.nan)
        src = None
        if kind == "column":
            B_raw = max(cfg.column_proposal_batch or cfg.proposal_batch,
                        cfg.eval_batch)
            u, ok, cols = engine._column_proposals(
                state.pile_u, state.live_idx, empty, k_prop, B_raw,
                norm=strategy.norm, n_slots=cfg.column_slots)
            take = jnp.argsort(~ok)[:cfg.eval_batch]
            u, valid, src = u[take], ok[take], cols[take]
        else:
            if kind == "region":
                mask, carry = state.running, True
            else:
                grp = empty & (state.group_id
                               == index % jnp.maximum(state.n_groups, 1))
                use = (state.n_groups <= cfg.column_focus_groups) & grp.any()
                mask, carry = jnp.where(use, grp, empty), False
            geom, ovf = engine._build_geometry_from(
                strategy, state, mask, k_geom, cfg,
                cfg.resolve_member_capacity(D), carry_cap=carry)
            u, valid, _ = strategy.propose(
                geom, strategy.init_chains(geom, k_chain), k_prop)
            radius, overflow = geom.radius, ovf.astype(jnp.float32)
        L = problem.loglike(problem.transform_batch(u))
        bot = shelves_lib.live_bottom(state.live_L, cfg.shelf_capacity)
        thresh = shelves_lib.insertion_thresholds(bot, state.shelves)
        acc = (valid[:, None]
               & (state.shelves.count < cfg.shelf_capacity)[None]
               & state.running[None] & (L > thresh[None]))
        if src is not None:
            acc = acc & (src[:, None] == jnp.arange(D)[None])
        return valid.sum(), acc.any(axis=1).sum(), radius, overflow

    return jax.jit(one)


def jax_kinds(problem, cfg, state, batches, seed=1, kinds=KINDS):
    import jax

    out = {}
    for j, kind in enumerate(kinds):
        fn = jax_round_fn(problem, cfg, kind)
        keys = jax.random.split(jax.random.key(1000 * seed + j), batches)
        rows = []
        for i in range(batches):
            v, a, r, o = (np.asarray(t) for t in fn(state, keys[i], i))
            rows.append(dict(
                valid=int(v), accepted=int(a),
                radius=None if kind == "column" else float(r),
                overflow=None if kind == "column" else int(o),
                eval_batch=cfg.eval_batch))
        out[kind] = summarize(rows)
    return out


def jax_chunks(problem, cfg, state, seed, n_chunks):
    """``n_chunks`` chunks of the JAX engine from ``state``, keyed by
    ``seed``; the counts after each."""
    import jax

    from massivedatans_tpu.ns import engine

    state = jax_labels(state._replace(key=jax.random.key(seed)),
                       cfg.nlive_points)
    D = state.live_L.shape[1]
    rows, t0, advances = [], time.perf_counter(), 0
    for _ in range(n_chunks):
        it0 = int(state.iteration)
        state, dead = engine.run_chunk(problem, state, cfg,
                                       cfg.resolve_member_capacity(D),
                                       cfg.chunk_iters)
        n = int(state.iteration) - it0
        advances += int((np.asarray(dead.idx)[:n] >= 0).sum())
        rows.append(dict(niter=int(state.iteration), advances=advances,
                         fill_rounds=int(state.fill_rounds),
                         ndraws=int(state.ndraws),
                         running=int(np.asarray(state.running).sum()),
                         member_overflow=int(state.member_overflow),
                         n_groups=int(state.n_groups),
                         wall_s=time.perf_counter() - t0))
        print(json.dumps(dict(package="jax", seed=seed, **rows[-1])),
              flush=True)
        state = jax_labels(state, cfg.nlive_points)
    return rows


# --- (A) and the cube check --------------------------------------------------

def checked_spaxels(arrays, limit=0):
    """The running spaxels, or ``limit`` of them evenly spaced (each
    check scores every spaxel's live points against all D spaxels)."""
    running = np.flatnonzero(arrays["running"])
    if limit and len(running) > limit:
        running = running[np.linspace(0, len(running) - 1, limit)
                          .astype(int)]
    return running


def live_check(pproblem, cube, arrays, cancel, jproblem=None, limit=0):
    """Each running spaxel's ``live_L`` (``limit``: of that many,
    ``checked_spaxels``) recomputed by the port (on its problem's device),
    by the JAX package (``jproblem``, if given) and in float64, against
    the stored values; held at ``cancel`` * yy."""
    import torch

    running = checked_spaxels(arrays, limit)
    live_idx, live_L = arrays["live_idx"], arrays["live_L"]
    device = pproblem.yy.device
    worst, over = {}, {}
    for d in running:
        x = arrays["pile_x"][live_idx[:, d]]
        xt = torch.as_tensor(x, device=device)
        got = dict(torch=pproblem.loglike(xt)[:, d].cpu().numpy())
        if jproblem is not None:
            import jax.numpy as jnp

            got["jax"] = np.asarray(jproblem.loglike(jnp.asarray(x)))[:, d]
        l64, yy = float64_loglike(pproblem, cube, xt)
        l64, bar = l64[:, d].cpu().numpy(), cancel * float(yy[d])
        pairs = dict(stored_vs_f64=(live_L[:, d], l64))
        for k, v in got.items():
            pairs.update({f"{k}_vs_stored": (v, live_L[:, d]),
                          f"{k}_vs_f64": (v, l64)})
        for k, (a, b) in pairs.items():
            err = np.abs(a.astype(np.float64) - b)
            worst[k] = max(worst.get(k, 0.0), float(err.max()))
            over[k] = over.get(k, 0) + int((err > bar).sum())
    return dict(spaxels=len(running), rows_per_spaxel=int(live_idx.shape[0]),
                max_abs_err=worst, beyond_bar=over, bar="MUSE_CANCEL * yy",
                held=not any(over.values()))


def live_decisions(pproblem, cube, arrays, cancel, jproblem=None, limit=0):
    """The likelihood at the contour: each running spaxel's (``limit``: of
    that many, ``checked_spaxels``) live points
    scored by the port (on its problem's device), by the JAX package
    (``jproblem``, if given) and in float64 (all spaxels' columns held at
    ``cancel`` * yy), and, per running spaxel, the decisions ``L > t`` of
    its live points at the thresholds ``t`` its insertion threshold takes
    (its ``shelf_capacity`` lowest live L): how many differ between the
    packages and between each package and float64."""
    import torch

    running = checked_spaxels(arrays, limit)
    live_idx, live_L = arrays["live_idx"], arrays["live_L"]
    thresholds = np.sort(live_L, axis=0)[:arrays["shelves.idx"].shape[0]]
    names = ("torch",) if jproblem is None else ("jax", "torch")
    differ = {f"{a}_vs_{b}": 0 for a, b in (("jax", "torch"),
                                             ("jax", "f64"),
                                             ("torch", "f64"))
              if a in names}
    worst = dict.fromkeys(names, 0.0)
    held = True
    for d in running:
        x = arrays["pile_x"][live_idx[:, d]]
        xt = torch.as_tensor(x, device=pproblem.yy.device)
        L = dict(torch=pproblem.loglike(xt).cpu().numpy().astype(np.float64))
        if jproblem is not None:
            import jax.numpy as jnp

            L["jax"] = np.asarray(jproblem.loglike(jnp.asarray(x))).astype(
                np.float64)
        l64, yy = float64_loglike(pproblem, cube, xt)
        L["f64"] = l64.cpu().numpy()
        fin = np.isfinite(L["f64"])
        bar = np.broadcast_to(cancel * yy.cpu().numpy()[None], fin.shape)
        for k in names:
            err = np.abs(L[k] - L["f64"])[fin]
            worst[k] = max(worst[k], float(err.max()))
            held &= bool((err <= bar[fin]).all())
        above = {k: v[:, d, None] > thresholds[None, :, d]
                 for k, v in L.items()}
        for k in differ:
            a, b = k.split("_vs_")
            differ[k] += int((above[a] != above[b]).sum())
    return dict(spaxels=len(running), candidates_per_spaxel=len(live_idx),
                thresholds_per_spaxel=len(thresholds),
                pairs=int(len(running) * len(live_idx) * len(thresholds)),
                decisions_differ=differ, max_abs_err_vs_f64=worst,
                bar="MUSE_CANCEL * yy", held=held)


def decisions(jproblem, pproblem, cube, pstate, cfg, n, seed=7):
    """(A): ``n`` candidates drawn from the state's region, scored by both
    packages and in float64."""
    import jax.numpy as jnp
    import torch

    from massivedatans_tpu_torch.ns import engine
    from massivedatans_tpu_torch.ns.region import sample_region
    from massivedatans_tpu_torch.ns.strategies import make_strategy

    gen = torch.Generator().manual_seed(seed)
    D = pstate.live_L.shape[1]
    geom, _ = engine._build_geometry_from(
        make_strategy(cfg), pstate, pstate.running, gen, cfg,
        cfg.resolve_member_capacity(D))
    us = []
    while sum(len(u) for u in us) < n:
        u, ok = sample_region(geom, gen, 4 * n)
        us.append(u[ok])
    u = torch.cat(us)[:n]
    xp = pproblem.transform_batch(u)
    xj = np.asarray(jproblem.transform_batch(jnp.asarray(u.numpy())))
    lp = pproblem.loglike(xp).numpy().astype(np.float64)
    lj = np.asarray(jproblem.loglike(jnp.asarray(xj))).astype(np.float64)
    l64, yy = float64_loglike(pproblem, cube, xp)
    l64 = l64.numpy()
    run = pstate.running.numpy()
    thresh = port_thresholds(pstate, cfg).numpy().astype(np.float64)
    # the candidates' L over the running spaxels; -inf rows (no stars)
    # compare as equal
    fin = np.isfinite(lp[:, run]) & np.isfinite(lj[:, run])

    def gap(a, b):
        return float(np.abs(a[:, run] - b[:, run])[fin].max())

    dec_j, dec_p = lj[:, run] > thresh[run], lp[:, run] > thresh[run]
    return dict(
        candidates=int(n), running=int(run.sum()),
        x_max_abs_diff=float(np.abs(xp.numpy() - xj).max()),
        max_abs_dL=dict(jax_vs_torch=gap(lj, lp), jax_vs_f64=gap(lj, l64),
                        torch_vs_f64=gap(lp, l64)),
        above_threshold=dict(jax=int(dec_j.sum()), torch=int(dec_p.sum()),
                             f64=int((l64[:, run] > thresh[run]).sum())),
        decisions_differ=int((dec_j != dec_p).sum()),
        yy_max=float(yy.numpy()[run].max()))


def make_cube(tmp, kind, side, nspec, n_spaxels):
    """The state's cube, built in ``tmp`` with the port's ``synth``:
    ``(cube, templates, zhi, changes)``, ``changes`` the options that
    differ from ``OPTIONS``. ``fixture``: ``build_fixture`` at ``side`` x
    ``side``; ``bench``: ``tools/torch_muse_bench.py``'s cube of
    ``n_spaxels`` spaxels and its options, without the wall-clock budget
    and the cap (the fields ``tools/jax_muse_rounds.py --cube bench``
    runs)."""
    if kind == "fixture":
        from tools.torch_muse_validate import build_fixture

        cube, tpl, _ = build_fixture(tmp, side, nspec)
        return cube, tpl, 0.5, {}
    from tools import torch_muse_bench as bench

    cube, tpl = bench.load_bench_cube(tmp, n_spaxels, nspec)
    fields = bench.config_fields(bench.defaults())
    changes = {k: v for k, v in fields.items() if k not in (
        "nlive_points", "seed", "tolerance", "max_samples")}
    return cube, tpl, bench.ZHI, changes


def seed_chunks(job):
    """(C) for one seed (on the CPU in a process of its own): the chunks
    of each package of ``packages`` from the state, on a cube built here;
    the port's on ``device``. Each chunk's counts are printed as it
    ends."""
    state_dir, cube_args, seed, n_chunks, threads, packages, device = job
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(threads)
    raw, pile_cap = state_arrays(state_dir)
    arrays = reopen(raw)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cube, tpl, zhi, changes = make_cube(tmp, *cube_args)
        if "jax" in packages:
            jproblem, jcfg, jstate = jax_setup(cube, tpl, state_dir, arrays,
                                               zhi, **changes)
        if "torch" in packages:
            pproblem = port_problem(cube, tpl, device, zhi=zhi)
    if "jax" in packages:
        out["jax"] = jax_chunks(jproblem, jcfg, jstate, seed, n_chunks)
    if "torch" in packages:
        out["torch"] = port_chunks(pproblem, arrays, pile_cap,
                                   port_config(arrays, **changes), seed,
                                   n_chunks, device)
    print(json.dumps(dict(seed=seed, **{p: r[-1] for p, r in out.items()})),
          flush=True)
    return out


def combine(paths, out):
    """One record of (C) from this tool's records ``paths``, each of one
    package's runs (``--packages``) from the same state file and cube, on
    seeds of its own: the seeds that both packages ran, their first
    chunks (as many as every record ran), and the totals compared.
    Returns the record."""
    from tools.torch_muse_bench import held_to_seeds

    recs = []
    for path in paths:
        with open(path) as fh:
            recs.append(json.load(fh))
    first = recs[0]
    for r in recs[1:]:
        for k in ("state_sha256", "cube_sha256"):
            if r[k] != first[k]:
                raise SystemExit(f"another {k} in the records")
    chunks = min(r["C"]["chunks"] for r in recs)
    by_seed = {"jax": {}, "torch": {}}
    for r in recs:
        for p, runs in r["C"]["runs"].items():
            by_seed[p].update((s, run[:chunks])
                              for s, run in zip(r["C"]["seeds"], runs))
    seeds = sorted(set(by_seed["jax"]) & set(by_seed["torch"]))
    runs = {p: [by_seed[p][s] for s in seeds] for p in by_seed}
    rec = {k: first[k] for k in ("state", "state_sha256", "iteration",
                                 "running", "cube", "n_spaxels",
                                 "cube_sha256", "options")}
    rec["C"] = dict(seeds=seeds, chunks=chunks, runs=runs,
                    start=first["C"]["start"],
                    totals=compare_totals(runs["jax"], runs["torch"],
                                          first["C"]["start"]),
                    records=[dict(file=os.path.relpath(p, ROOT),
                                  run=r["run"], seeds=r["C"]["seeds"],
                                  chunks=r["C"]["chunks"])
                             for p, r in zip(paths, recs)])
    rec["C"]["held_to_seeds"] = held_to_seeds(
        seed_totals(runs["torch"], first["C"]["start"]),
        seed_totals(runs["jax"], first["C"]["start"]),
        keys=("ndraws", "advances", "evals_per_advance"))
    rec["differences"] = dict(C=sorted(
        k for k, v in rec["C"]["totals"].items() if v["differs"]))
    with open(out, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps(dict(differences=rec["differences"], seeds=seeds,
                          held_to_seeds=rec["C"]["held_to_seeds"],
                          file=out)), flush=True)
    return rec


# --- main --------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", default=STATE_DIR,
                    help="directory of a JAX checkpoint's state.npz")
    ap.add_argument("--cube", choices=("fixture", "bench"),
                    default="fixture",
                    help="bench: tools/torch_muse_bench.py's cube and "
                         "options (a state of tools/jax_muse_rounds.py "
                         "--cube bench)")
    ap.add_argument("--side", type=int, default=10)
    ap.add_argument("--n-spaxels", type=int, default=4223)
    ap.add_argument("--nspec", type=int, default=3600)
    ap.add_argument("--candidates", type=int, default=4096)
    ap.add_argument("--live-spaxels", type=int, default=0,
                    help="check the live L and the contour decisions on "
                         "this many running spaxels (0: all)")
    ap.add_argument("--batches", type=int, default=200)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    ap.add_argument("--chunks", type=int, default=5)
    ap.add_argument("--parts", nargs="+", choices=("A", "B", "C"),
                    default=["A", "B", "C"],
                    help="what to measure after the cube check")
    ap.add_argument("--packages", nargs="+", choices=("jax", "torch"),
                    default=["jax", "torch"],
                    help="(C)'s packages; without jax only (C) runs, "
                         "without the cube check")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="the port's device in (C)")
    ap.add_argument("--combine", nargs="+", default=None, metavar="FILE",
                    help="measure nothing: compare the (C) runs of these "
                         "records of one package each (see combine)")
    ap.add_argument("--out", default=os.path.join(ROOT,
                                                  "muse_state_rounds.json"))
    args = ap.parse_args(argv)
    if args.combine:
        combine(args.combine, args.out)
        return 0
    if "jax" not in args.packages and args.parts != ["C"]:
        ap.error("without jax only --parts C runs")
    if args.device == "cuda" and args.packages != ["torch"]:
        ap.error("--device cuda runs the port alone (--packages torch)")
    sys.path.insert(0, ROOT)
    import torch

    from tools.torch_muse_bench import cube_sha256

    torch.manual_seed(0)
    cube_args = (args.cube, args.side, args.nspec, args.n_spaxels)
    state_file = os.path.join(args.state, "state.npz")
    raw, pile_cap = state_arrays(args.state)
    arrays = reopen(raw)
    rec = dict(
        state=os.path.relpath(state_file, ROOT),
        state_sha256=sha256_file(state_file),
        iteration=int(arrays["iteration"]),
        running=int(arrays["running"].sum()),
        reopened=bool(not raw["running"].any()),
        empty=int((arrays["running"]
                   & (arrays["shelves.count"] == 0)).sum()),
        pile_size=int(arrays["pile_size"]), options=state_options(arrays),
        run="CPU runs of " + (
            "both packages" if len(args.packages) == 2 else
            "the JAX package" if args.packages == ["jax"] else "the port")
        + " (walls are CPU walls)")
    t_all = time.perf_counter()
    if "C" in args.parts:
        # one process per seed: the port's eager CPU chunks are slow, and
        # they run beside (A) and (B) here; on a card its kernels are
        # built once, before the seeds' processes load them
        import multiprocessing

        if args.device == "cuda":
            from massivedatans_tpu_torch.ops import _build

            _build.load()
            _build.load_host()
            rec["run"] = f"the port on {torch.cuda.get_device_name(0)}"
        pool = multiprocessing.get_context("spawn").Pool(len(args.seeds))
        threads = max(1, (os.cpu_count() or 1) // len(args.seeds))
        pending = pool.map_async(seed_chunks, [
            (args.state, cube_args, seed, args.chunks, threads,
             args.packages, args.device) for seed in args.seeds])
        t_c = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cube, tpl, zhi, changes = make_cube(tmp, *cube_args)
        rec.update(cube=args.cube, side=args.side, nspec=args.nspec,
                   n_spaxels=cube.y.shape[1], cube_sha256=cube_sha256(cube),
                   options=dict(rec["options"], **changes))
        if "jax" in args.packages:
            measure_on_cpu(rec, args, cube, tpl, zhi, changes, arrays,
                           pile_cap)
            if not rec["live_check"]["held"]:
                rec["verdict"] = "the fixture is not the state's cube"
                with open(args.out, "w") as fh:
                    json.dump(rec, fh, indent=1)
                return 1
    if "C" in args.parts:
        by_seed = pending.get()
        pool.close()
        runs = {p: [r[p] for r in by_seed] for p in args.packages}
        rec["C"] = dict(seeds=args.seeds, chunks=args.chunks,
                        packages=args.packages, runs=runs,
                        start=state_start(arrays),
                        wall_s=time.perf_counter() - t_c)
        if len(args.packages) == 2:
            rec["C"]["totals"] = compare_totals(
                rec["C"]["runs"]["jax"], rec["C"]["runs"]["torch"],
                rec["C"]["start"])
    rec["differences"] = dict(
        A=rec["A"]["decisions_differ"] if "A" in rec else None,
        B=sorted(f"{kind}.{k}" for kind, d in rec["B"]["differs"].items()
                 for k, v in d.items() if v) if "B" in rec else None,
        C=sorted(k for k, v in rec["C"]["totals"].items() if v["differs"])
        if "totals" in rec.get("C", {}) else None)
    rec["wall_s"] = time.perf_counter() - t_all
    with open(args.out, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps(dict(differences=rec["differences"], file=args.out)),
          flush=True)
    return 0


def measure_on_cpu(rec, args, cube, tpl, zhi, changes, arrays, pile_cap):
    """The cube check, then (A) and (B) as ``args.parts`` asks, both
    packages on the CPU; each into ``rec``."""
    from chip_smoke import MUSE_CANCEL

    pproblem = port_problem(cube, tpl, zhi=zhi)
    jproblem, jcfg, jstate = jax_setup(cube, tpl, args.state, arrays, zhi,
                                       **changes)
    cfg = port_config(arrays, **changes)
    pstate = port_labels(port_state(arrays, pile_cap), cfg.nlive_points)
    jstate = jax_labels(jstate, cfg.nlive_points)
    rec["n_groups"] = dict(jax=int(jstate.n_groups), torch=pstate.n_groups)
    t0 = time.perf_counter()
    rec["live_check"] = live_check(pproblem, cube, arrays, MUSE_CANCEL,
                                   jproblem, args.live_spaxels)
    print(json.dumps(dict(live_check=rec["live_check"])), flush=True)
    if not rec["live_check"]["held"]:
        return
    if "A" in args.parts:
        rec["A"] = decisions(jproblem, pproblem, cube, pstate, cfg,
                             args.candidates)
        rec["A"]["at_the_contour"] = live_decisions(
            pproblem, cube, arrays, MUSE_CANCEL, jproblem, args.live_spaxels)
        rec["A"]["wall_s"] = time.perf_counter() - t0
        print(json.dumps(dict(A=rec["A"])), flush=True)
    t0 = time.perf_counter()
    if "B" in args.parts:
        kinds = dict(jax=jax_kinds(jproblem, jcfg, jstate, args.batches),
                     torch=port_kinds(pproblem, pstate, cfg, args.batches))
        rec["B"] = dict(kinds, differs=compare_kinds(kinds["jax"],
                                                     kinds["torch"]),
                        wall_s=time.perf_counter() - t0)
        print(json.dumps(dict(B=rec["B"])), flush=True)


if __name__ == "__main__":
    sys.exit(main())
