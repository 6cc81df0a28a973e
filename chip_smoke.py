"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py                 # full check, as described below
    python3 chip_smoke.py --muse-max-samples 0   # MUSE fit to tolerance
    python3 chip_smoke.py --profile-out profile.txt

Drives the port's two entry paths after building the two CUDA kernels of
``massivedatans_tpu_torch/csrc`` and holding each against its plain PyTorch
version on the card:

- horns: ``gen horns 1000`` in memory, then ``run_fit`` (the function
  behind ``python -m massivedatans_tpu_torch fit``) with the default
  ``RunConfig`` (nlive 400, tolerance 0.5, MLFRIENDS) over all 1000
  spectra;
- strategies: the same 1000 horns spectra fitted again with the default
  ``RunConfig`` but ``constrainer`` MULTIELLIPSOIDS, SLICE (``iterate``
  directions) and GALILEAN. SLICE is capped at ``SLICE_MAX_SAMPLES``
  iterations (2000): to tolerance it takes
  about 9 min on the H100 (28.6 fill rounds per iteration, each a few ms
  of host issue), and with 100 spectra no less, since the rounds per
  iteration do not fall with fewer datasets
  (``tools/torch_strategy_fits.py`` times both);
- MUSE: the ``tools/muse_validate.py`` fixture (7 Z x 111 ages x 400 wl
  templates, a 10x10 model-family cube of nspec 3600, seed 11, flux
  0.1-1.0) built with the port's ``synth``, then ``fit_muse`` (the core of
  ``python -m massivedatans_tpu_torch musefit``) with the FULL model (ndim
  5), nlive 400, tolerance 0.5, capped at ``--muse-max-samples``
  iterations (default 2000, about 30 s on the H100, to make room for the
  strategy fits: the 500 iterations after it take about 2 min; 0 runs to
  tolerance);
- resume: the horns fit of phase 4 again, preempted (``max_chunks``) at
  half its chunks with a checkpoint, then resumed from it;
- escalation: the MUSE fit again at the same cap with ``eval_batch_max``
  512 (``bench.py``'s value);
- gradient backends: ``run_hmc`` and ``run_vi`` (``infer/``) on the
  analytic oracle of ``tests/test_infer.py`` at D = 1000, then
  ``run_refine`` (the function behind ``python -m massivedatans_tpu_torch
  refine``) at its defaults (HMC 300 / 300 / 24, VI 1500 steps) on the
  horns fit of phase 4, and with HMC cut to 150 / 150 iterations on the
  MUSE fit of phase 6, both held in memory;
- sharded: the horns fit of phase 4 on a dataset mesh
  (``parallel/``), each rank a process of its own: one rank under NCCL
  (its chunks captured as CUDA graphs with the collectives inside), then
  two ranks sharing the card under gloo (staged through the host, the
  chunks eager), and NCCL across the cards where there are two or more
  (captured); then the model-parallel likelihoods on a (data 1, model 2)
  mesh on the card;
- horns at the reference's headline scale: ``gen_horns(10000)`` (the
  stream of ``tools/scaling_bench.py`` and of ``bench.py``'s third
  workload), all 10^4 spectra fitted by ``run_fit`` at the default
  ``RunConfig`` on the captured path, where the group labels refresh
  every 4th chunk;
- validation: the reference's no-signal calibration (``gen_nothing``,
  100 of 1000 spectra and all 10^4) and posterior recovery
  (``gen_simple(100)``) through ``tools/torch_calib_parity.py`` and
  ``tools/torch_posterior_recovery.py``, held to the JAX package's
  records;
- the MUSE late state: the fill rounds of each kind and a few chunks of
  the engine from the JAX MUSE run of record's last state, held to the
  JAX package's rounds from the same state
  (``tools/muse_rounds_from_state.py``);
- the MUSE headline cube: ``tools/muse_bench.py``'s 4,223 spaxels fitted
  by ``fit_muse`` at that tool's options without its wall-clock budget,
  capped, held to the JAX package's counts at the same options
  (``tools/torch_muse_bench.py``, ``tools/jax_muse_rounds.py --cube
  bench``).

Phases, each of which raises on failure:

1. require ``torch.cuda.is_available()``; print the card's name and power
   limit; turn TF32 off and assert it;
2. build the CUDA kernels (nvcc) and the host union-find (the host C++
   compiler) at the same time and print the build seconds;
3. hold each kernel bitwise against its plain version at ndim 3 (horns)
   and 5 (MUSE FULL), at the member cap M=1664 and at M=16384, the radius
   also at nb 3 and 32 (its generic instantiation), the count also at
   N=2048 and M=1664 (a round of an escalated chunk); time each of those
   ten cases (CUDA events, and profiler device time where the profiler
   records the device, kernel and plain) and print its bound (operations
   or bytes, from this run's inputs, against the H100's published fp32 and
   memory rates); check in a CUDA graph capture that a call of either
   wrapper enqueues its kernel and nothing else (no zero-fill);
4. reset the launch counters, run the horns fit, read the counters (each
   kernel must have launched, and ``count_within`` exactly once per region
   proposal round, replayed or eager), check the result's shapes, that
   logZ is finite, and that >= 95 of the first 100 datasets lie within
   3 logZerr + 0.5 of the quadrature oracle ``quad_logZ.json``. The fit
   runs on the captured path (CUDA graph replays, ``stats["chunk_path"]``
   "graph"); its first ``HORNS_EAGER_CHUNKS`` chunks then run on both
   paths, eagerly with ``eager=True`` (the same steps dispatched one operation
   at a time) from the same seed, and logZ, logZerr, the L, u, w and mask
   records, iterations, fill rounds, evaluations and both kernels'
   launches must be equal bit for bit (``compare_paths``). The fit runs again at ``pipeline_lookahead``
   0 (phase 4's is the default, 1) and holds the same bar, and a slice of
   ``PATH_PROFILE_SAMPLES`` iterations is profiled on both paths
   (``path_profile``: busy share, kernels and host launches per
   iteration);
5. for each strategy, reset the counters, run its fit, read the counters
   (neither region kernel may launch: these strategies build no
   union-of-balls region), print one JSON line (wall, iterations, fill
   rounds and rounds per iteration, evaluations, the host timing split),
   and check that logZ is finite with logZerr > 0 and that at least the
   share ``STRATEGY_BAR`` of the datasets held lie within 3 logZerr + 0.5
   of ``quad_logZ.json`` (GALILEAN's bar rests on the JAX package's own
   counts on these spectra, ROADMAP.md queue 3). The datasets held are the
   first 100, but in the capped SLICE fit only those of them that stopped
   at tolerance before the cap: a dataset still running at the cap has
   the live points' remainder bracket in its logZerr, many nats wide. At
   least ``SLICE_MIN_HELD`` must have stopped. Each strategy's first
   ``STRATEGY_EAGER_CHUNKS`` chunks (``max_chunks``) run on both paths and
   are held bit for bit as in 4, and a slice is profiled on both;
6. reset the counters, run the MUSE fit, read the counters (as in 4),
   check the shapes, that logZ is finite with logZerr > 0, and the no-star
   identity on the empty spaxels: |median(logZ + yy/2)| <= 1; its first
   ``MUSE_EAGER_CHUNKS`` chunks held bit for bit against their eager run
   as in 4; a slice profiled;
7. reset the counters, preempt and resume the horns fit of phase 4 at
   ``pipeline_lookahead`` 0 on the captured path, read the counters (as
   in 4), print both legs' walls and the checkpoint's bytes on disk, and
   check that the resumed result is that fit's bit for bit (logZ,
   logZerr, L, u, x, w, mask, iterations, evaluations, fill rounds); then
   reset the counters, run the escalated MUSE fit, read the counters,
   check it as in 6 and that it ran escalated chunks, print its rounds,
   evaluations, wall and launches beside phase 6's, and hold it bit for
   bit against its eager run as in 4. Print one JSON line
   ``{"paths": [...], "profiles": [...]}`` of the comparisons and
   profiles of phases 4-7;
8. reset the counters, run the gradient backends, and check that neither
   region kernel launched (HMC and VI build no region). The analytic
   oracle is held, bar by bar (accept in (0.4, 1], |mean - c| < 0.1,
   |std - sigma| < 0.6 sigma, elbo < logZ + 0.2, |logZ_IW - logZ| < 0.25,
   logZ_IW >= elbo - 0.2), to the JAX package's count of datasets meeting
   each bar at D = 1000 less 3 (``ANALYTIC_JAX_COUNTS``); the horns refine
   to every logZ_IW finite and the JAX package's count of the first 100
   within 3 logZerr + 0.5 of ``quad_logZ.json`` less 5
   (``HORNS_IW_JAX_COUNT``); the MUSE refine to |median(logZ_IW + yy/2)|
   <= 1 over the empty spaxels and to the JAX package's counts, less 3, of
   finite logZ_IW and of spaxels with a star within 3 logZerr + 0.5 of
   their NS logZ; each refine's HMC to the JAX package's median accept
   (less 0.05) and share of finite logp (less 0.01). Check that TF32
   is still off, and print one JSON line ``{"backends": [...]}``: each
   run's wall, peak device memory and, from the profiler on a short slice
   of the same run, CUDA kernels per leapfrog step (per VI step) and the
   busy share; for HMC, its gradient evaluations and their rate and the
   mean wall of a warmup and of a sampling iteration; for VI, the walls of
   its fit loop and of its final ELBO and importance weights, steps per
   second and the mean wall of a step of the fit loop;
9. the sharded path (``sharded_phase``): each rank sets its launch and
   collective counters to 0, runs the horns fit of phase 4 on the mesh and
   reads them (a replayed graph counts the collectives and launches its
   capture recorded). Under NCCL the chunks must run captured
   (``chunk_path`` "graph", graph replays in every rank), under gloo
   eagerly. At one NCCL rank every collective is an identity: logZ,
   logZerr, L, u, w and mask (by SHA-256), iterations, evaluations, fill
   rounds and both kernels' launches must be phase 4's captured fit's bit
   for bit. Two ranks on the card (gloo) and, with two or more cards, NCCL
   across min(cards, 4) of them must hold phase 4's quadrature bar; in
   every run each rank must launch both kernels, ``count_within`` once per
   region or focus round it ran. Then two ranks on the card (data 1 x
   model 2, gloo) evaluate the gaussline and MUSE likelihoods of
   ``MP_BATCH`` candidates (phase
   4's spectra, phase 6's cube): the gaussline model-parallel one is held
   to the single-device one at the JAX test's rtol and atol; the MUSE
   single-device and model-parallel ones to a float64 witness from the
   same templates, spectra and candidates at the JAX test's rtol and atol
   plus ``MUSE_CANCEL`` * yy, which a TF32 contraction of the same
   candidates must fail (``_against``). Print one JSON line
   ``{"sharded": [...]}``: per run its world, backend, chunk path, graph
   replays and host syncs per iteration, walls, evaluations, fill rounds,
   collective calls per fill round, wall per round, launches per rank and
   its bars;
10. horns ndata=10^4 (``horns10k_phase``): reset the counters, run the
   10^4 fit to tolerance on the captured path, read the counters (as in
   4), print its wall, iterations, evaluations (and per dataset), fill
   rounds, member overflow, pile peak, chunks, group refreshes, the
   largest ``n_groups``, steps by kind, graph replays and host syncs per
   iteration, the graph pool, peak device memory and the host timing
   split; check the shapes ``(niter + 400, 10^4, 3)``, finite logZ,
   logZerr > 0, no stalled dataset, >= 95 of the 100 datasets of
   ``quad_logZ_horns10000.json`` within 3 logZerr + 0.5, and fewer group
   refreshes than chunks (the cadence branch ran); then hold its first
   ``HORNS10K_EAGER_CHUNKS`` chunks bit for bit against their eager run
   as in 4;
11. the reference's validation protocols (``validation_phase``), through
   their tools, on the captured path: first ``tools/torch_muse_validate.py``'s
   analysis of phase 6's capped MUSE fit, printed with no bar (the MUSE
   validation to tolerance is too long for this script: it is the tool's
   own run); then the no-signal calibration of
   ``tools/torch_calib_parity.py`` (``gen_nothing(1000)[:, :100]`` at the
   JAX tool's options: median log10 B within 0.1 of the JAX package's and
   of the original code's, none above 0, >= 95 of 100 within 3 sigma of
   the JAX package's per-dataset logZ; all of ``gen_nothing(10000)`` at the
   default ``RunConfig``: records and evaluations within [0.5, 2] x the
   JAX run's, median within 0.1 of the JAX package's), the posterior
   recovery of ``tools/torch_posterior_recovery.py`` on ``gen_simple(100)``
   (its four bars against the JAX package's record), each fit reading the
   counters (as in 4);
12. the MUSE late state (``late_state_phase``): the JAX MUSE run of
   record's checkpoint (iteration 7,001) loaded into the port with numpy,
   its 30 capped spaxels running again; their live L recomputed on the
   card against float64 and the stored values at ``MUSE_CANCEL`` * yy,
   and the threshold decisions at their lowest live L that the card and
   float64 disagree on counted beside the JAX package's CPU count;
   reset the counters, run ``LATE_BATCHES`` batches of each round kind
   (region, focus, column) and ``LATE_CHUNKS`` captured chunks from the
   state, read the counters (both kernels must launch); the chunks again
   eagerly, bit for bit; each kind's valid share, accepted share and
   radius and the chunks' evaluations, fill rounds and running spaxels
   held to the JAX package's CPU numbers in ``muse_state_rounds.json``
   (``tools/muse_rounds_from_state.py``), within 4 standard errors or 10
   %, and printed beside them;
13. ``tools/muse_bench.py``'s cube (``muse_bench_phase``): 4,223
   spaxels at nspec 3600, built as ``tools/torch_muse_bench.py`` builds
   it and identified by the SHA-256 of ``BENCH_RECORD`` (the JAX
   package's CPU record at the same options); each kernel held bit for bit
   against its plain version at this fit's shapes (the count at N = 8,192,
   the proposal pool, and M = 1,664, timed; the radius at M = 1,664;
   ndim 5); reset the counters, fit the cube on the captured path at the
   record's options capped at ``BENCH_CAP``, read the counters (as in 4);
   check the shapes and finite logZ, hold its iterations, evaluations and
   fill rounds within [0.5, 2] x the record's at that iteration, and its
   first ``BENCH_EAGER_CHUNKS`` chunks bit for bit against their eager run
   as in 4; the count is also timed at ndim 3, the horns model's, at the
   same N and M;
14. the setting of both packages' seed spread where the fill budget binds
   (``muse_seeds_phase``, ``SEEDS_RECORD``): the same cube at 100
   spaxels, a fill budget of 1,024, the wall-clock budget off, capped past
   the onset of budget-bound chunks; reset the counters, fit seed 1 on the
   captured path, read the counters (as in 4); hold its evaluations,
   advances and evaluations per advance within the JAX package's seeds'
   range widened 1.5 x each way, and its first ``SEEDS_EAGER_CHUNKS``
   chunks bit for bit against their eager run as in 4;
15. print one JSON line of kernel records, then the card's line, then the
   ``{"ok": true, ...}`` line last.

Exits non-zero without a result line when there is no CUDA card or the
package is missing.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import hashlib
import json
import os
import resource
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TIMING_LAUNCHES = 100
TIMING_LAUNCHES_LARGE = 20   # M=16384: the plain radius is ~1 GB per round
MAIN_M, LARGE_M = 1664, 16384  # member cap (2 x nlive 400 rounded up), large
COUNT_N = 512     # proposal_batch: both halves of a round in one call
ESCALATED_N = 2048  # the same at eval_batch_max 512 (proposal_batch x 4)
MUSE_EVAL_BATCH_MAX = 512  # bench.py's escalation ceiling
NBOOT = 10        # RunConfig.nbootstraps
MUSE_SIDE, MUSE_NSPEC, MUSE_SEED = 10, 3600, 11  # tools/muse_validate.py
MUSE_FLUX = (0.1, 1.0)
MUSE_NLIVE = 400
PROFILE_SAMPLES, PROFILE_SAMPLES_MUSE = 300, 2000  # the MUSE fit's costly
# rounds come late: it reaches 2,000 iterations in about 30 s on the H100
EMPTY_IDENTITY_BAR = 1.0  # |median(logZ + yy/2)| over empty spaxels
# the ellipsoid and stateful strategies, and the least share of the
# datasets held that must lie within the quadrature bar (GALILEAN: the JAX
# package's own fits of these 1000 spectra put 76-89 of the first 100 there
# over seeds 1-5, tools/jax_strategy_counts.py, so the bar is its least
# count less 3; ROADMAP.md queue 3)
STRATEGIES = ("MULTIELLIPSOIDS", "SLICE", "GALILEAN")
STRATEGY_BAR = {"MULTIELLIPSOIDS": 0.95, "SLICE": 0.95, "GALILEAN": 0.73}
SLICE_MAX_SAMPLES = 2000  # SLICE's depth cut
SLICE_MIN_HELD = 40  # of the first 100, stopped at tolerance before the cap
# the eager reference of each strategy fit, cut in depth to its first
# chunks (max_chunks, 50 iterations each) to keep the smoke inside its
# time aim: at least 5 (SLICE's rounds are the dearest, and it keeps 4)
STRATEGY_EAGER_CHUNKS = {"MULTIELLIPSOIDS": 5, "SLICE": 4, "GALILEAN": 5}
# the horns fit's and the MUSE fit's eager references, cut alike to keep
# the smoke inside its time aim, to the 5 chunks every bitwise check keeps
# (phase 9's one NCCL rank holds the eager code against phase 4's captured
# fit at full depth); the escalated MUSE fit's runs to the cap, to hold
# its escalated chunks
HORNS_EAGER_CHUNKS, MUSE_EAGER_CHUNKS = 5, 5
# the reference's headline scale (phase 10): the first 10^4 spectra of
# gen_horns(10000), the stream of tools/scaling_bench.py and bench.py's
# third workload, held to its own oracle; the eager reference cut to the
# first chunks, as at 1,000
HORNS10K_NDATA = 10000
HORNS10K_ORACLE = "quad_logZ_horns10000.json"
HORNS10K_EAGER_CHUNKS = 5
# the capped slices profiled on both paths (busy share, kernels dispatched
# from the host per iteration); each is run four times (both paths, timed
# and traced)
PATH_PROFILE_SAMPLES = {"horns": 50, "MULTIELLIPSOIDS": 50, "SLICE": 10,
                        "GALILEAN": 25, "MUSE": 50}
# the escalated MUSE fit against phase 6's on the spaxels with a star that
# ran escalated rounds and stopped at tolerance before the cap in both: the
# share within 3 sqrt(errA^2 + errB^2) + 0.5 of each other, and the least
# number held (7 of them on the H100: the others are done before the first
# switch, or still running at the cap in one of the fits)
MUSE_ESCALATED_BAR = 0.95
MUSE_MIN_HELD = 5
# the gradient backends (phase 8). The analytic oracle of
# tests/test_infer.py (ndim 3, sigma 0.05, centres uniform(0.3, 0.7) from
# seed 3) at D = 1000 with that test's settings and bars. Set at D = 6,
# they do not hold on every one of 1000 datasets in the JAX package either:
# its run_hmc / run_vi on the CPU put 999 within the std bar
# (tools/jax_refine_counts.py), so the port is held to the JAX package's
# count for each bar, less 3; the horns refine of phase 4's fit at run_refine's defaults (HMC
# 300 / 300 / 24, VI 1500 steps), held to the JAX package's own count of
# the first 100 datasets whose logZ_IW lies within 3 logZerr + 0.5 of
# quad_logZ.json, less 5 (tools/jax_refine_counts.py, on the CPU: the JAX
# package's fit and refine of the same 1000 spectra at the same settings
# put HORNS_IW_JAX_COUNT there, and 97 of them within the bar by their NS
# logZ); the MUSE refine of phase 6's fit, held to
# the no-star identity of phase 6: |median(logZ_IW + yy/2)| <= 1
ANALYTIC_D, ANALYTIC_SIGMA = 1000, 0.05
ANALYTIC_HMC = dict(num_warmup=400, num_samples=400, num_leapfrog=16)
ANALYTIC_VI = dict(steps=1200, lr=3e-2)
ANALYTIC_JAX_COUNTS = dict(accept_in_bar=1000, mean_in_bar=1000,
                           std_in_bar=999, elbo_in_bar=1000, iw_in_bar=1000,
                           iw_over_elbo=1000)
ANALYTIC_SLACK = 3
HORNS_IW_JAX_COUNT = 56
HORNS_IW_SLACK = 5
# MUSE's HMC cut in depth, to keep the smoke well inside its time limit:
# at run_refine's 300 / 300 it took 90.48 s of a 749.6 s smoke on the H100
MUSE_REFINE_HMC = dict(num_warmup=150, num_samples=150)
# each refine's HMC held to the JAX package's run of the same refine on the
# CPU (tools/jax_refine_counts.py; MUSE at MUSE_REFINE_HMC): the median
# accept at most HMC_ACCEPT_SLACK below it (the dual averaging targets 0.8,
# and the port met the JAX horns median to 4 digits), the share of finite
# logp at most HMC_FINITE_SLACK below it
HORNS_HMC_JAX = dict(median_accept=0.9567, finite_logp_share=1.0)
MUSE_HMC_JAX = dict(median_accept=0.8467, finite_logp_share=1.0)
HMC_ACCEPT_SLACK = 0.05
HMC_FINITE_SLACK = 0.01
# the MUSE refine's VI, held to the JAX package's counts less MUSE_IW_SLACK:
# of finite logZ_IW, and of spaxels with a star whose logZ_IW lies within
# 3 logZerr + 0.5 of their NS logZ. The JAX package's run_vi from the
# port's chain seeds of this fit leaves spaxels 33, 63 and 79 NaN and puts
# 47 of the 85 spaxels with a star within the bar (97 finite;
# tools/jax_muse_vi_witness.py); from its own fit and seeds 100 finite and
# 41 within (tools/jax_refine_counts.py): the lower count is the reference
MUSE_IW_JAX_FINITE = 97
MUSE_STAR_JAX_WITHIN = 41
MUSE_IW_SLACK = 3
# NVIDIA H100 SXM data sheet, at its 700 W limit: fp32 outside the tensor
# cores (neither kernel has work for them) and HBM3
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
DEVICE = "cuda"
# the sharded phase: a collective waiting longer than this fails the run
SHARDED_TIMEOUT_S = 300
MP_BATCH = 128  # RunConfig.eval_batch: one fill round's candidates
# model-parallel likelihood tolerances: tests/test_parallel.py:151
# (gaussline) and tests/test_muse.py:232 (MUSE)
MP_TOL = {"gaussline": (2e-5, 2e-4), "muse": (1e-4, 1e-3)}
# A float32 MUSE chi^2 cancels from terms of the size of yy (up to 1e7 on
# phase 6's cube, where one float32 ulp is 1), so no float32 path meets
# atol + rtol |L| against float64. The single-device and the sharded
# likelihoods are held to a float64 witness at that bar plus
# MUSE_CANCEL * yy: 2^-17 lies halfway, in binary digits, between
# float32's unit roundoff 2^-24 and TF32's 2^-11 (rounded up), and a
# TF32 contraction must fail it.
MUSE_CANCEL = 2.0 ** -17
# phase 12: the JAX package's CPU record of the late state's rounds
# (tools/muse_rounds_from_state.py), and what the card runs from it
LATE_RECORD = "muse_state_rounds.json"
LATE_BATCHES = 200  # per round kind, as in the record
LATE_CHUNKS = 5
LATE_SEED = 1
LATE_HELD = ("valid_share", "accepted_share", "radius")
# phase 13: tools/muse_bench.py's cube at 4,223 spaxels, at the options of
# the JAX package's CPU record of it (tools/jax_muse_rounds.py --cube
# bench: muse_bench.py's, the wall-clock budget off) and capped at
# BENCH_CAP iterations, before the transition to chunks that the fill
# budget bounds (from about iteration 3,200 the rounds and evaluations
# per chunk depend on the seed in both packages); at 2,800 each of the
# eight fits on record, three of the JAX package's and five of the
# port's, lies within 15 % of the record's evaluations and 1.73 x its
# fill rounds, so the captured fit is held within
# tools/torch_muse_bench.RATIO_BAR x the record's counts at its chunk that
# ends at BENCH_CAP, and its first chunks bitwise their eager run
BENCH_RECORD = "muse_bench_4223_jax.json"
BENCH_CAP = 2800
BENCH_EAGER_CHUNKS = 1
# phase 14: the setting of both packages' seed spread where the fill budget
# binds (tools/muse_seed_spread.py): tools/muse_bench.py's cube at 100
# spaxels and its options, a fill budget of 1,024 rounds, the wall-clock
# budget off, capped past the onset; seed 1's evaluations E, advances A
# and E/A are held within the JAX package's seeds' range, widened by
# SEEDS_WIDEN each way, and its first SEEDS_EAGER_CHUNKS chunks bitwise
# their eager run
SEEDS_RECORD = "muse_seeds_100_budget1024.json"
SEEDS_SEED = 1
SEEDS_WIDEN = 1.5
SEEDS_HELD = ("ndraws", "advances", "evals_per_advance")
SEEDS_EAGER_CHUNKS = 2


def _time_ms(fn, n=TIMING_LAUNCHES):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _device_ms(fn, n=TIMING_LAUNCHES):
    """Device time per call: the summed duration of the CUDA kernels that
    ``n`` calls launch, from a profiler trace (host gaps excluded); None
    when no trace holds a device record (the profiler's device tracing is
    unavailable), with a note: ``_time_ms`` still times the calls.

    The trace on the card now and then loses kernel records. Every call
    launches the same kernels, so a whole trace holds each kernel a
    multiple of ``n`` times; a trace that does not is taken again. After
    five such traces, each kernel's mean duration times its launches per
    call (its count over ``n``, rounded) stands in, with a warning."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    # device records only: the host ops of the plain versions would be
    # most of the trace and of its processing time
    acts = [ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(5):
        with torch_profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.count, e.self_device_time_total)
                   for e in prof.key_averages() if e.device_type == cuda]
        if kernels and all(c % n == 0 for c, _ in kernels):
            return sum(us for _, us in kernels) / n / 1e3
    if not kernels:
        print("  note: five profiler traces held no device records; device "
              "time not measured (CUDA-event times stand)")
        return None
    print(f"  warning: 5 traces lost kernel records; device time from the "
          f"mean kernel durations of the last ({kernels})")
    return sum(us / c * max(1, round(c / n)) for c, us in kernels) / 1e3


def _kernel_us(events):
    """Summed device time of the kernel records (not of the ops that
    launched them, which would count each kernel twice)."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in events
               if e.device_type == cuda)


def _timed(rec, kernel, plain, n):
    """Host-clock CUDA-event time and device time per call, in turns."""
    rec["ms"] = _time_ms(kernel, n)
    rec["plain_ms"] = _time_ms(plain, n)
    rec["device_ms"] = _device_ms(kernel, n)
    rec["plain_device_ms"] = _device_ms(plain, n)
    rec["bound_share"] = (None if rec["device_ms"] is None
                          else rec["bound_ms"] / rec["device_ms"])
    print("  timing", json.dumps({k: rec[k] for k in (
        "ms", "plain_ms", "device_ms", "plain_device_ms", "bound_ms",
        "bound_by", "bound_share")}))


def _bound(rec, ops, nbytes):
    """The least time of the work on the card: the larger of its operations
    over the fp32 rate and its bytes (each input read once, each output
    written once) over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    rec.update(ops=ops, bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes")


def check_count_within(neighbors, gen, N, M, ndim, timed=False):
    dev = DEVICE
    members = torch.randn((M, ndim), generator=gen, device=dev)
    mask = torch.arange(M, device=dev) < (M - M // 7)  # non-divisible count
    points = 3.0 * (2.0 * torch.rand((N, ndim), generator=gen, device=dev) - 1.0)
    # points meet a few members each at ndim 3 and 5
    radius = torch.tensor(0.25 * ndim, device=dev)
    got = neighbors.count_within(members, mask, points, radius)
    want = neighbors.count_within_plain(members, mask, points, radius)
    torch.cuda.synchronize()
    diff = (got.long() - want.long()).abs()
    rec = dict(shape=f"N={N} M={M} ndim={ndim}", max_abs_err=int(diff.max()),
               mismatches=int((diff > 0).sum()), counted=int(want.sum()))
    # per pair of a point and a valid member: ndim subtractions, ndim
    # squares, ndim - 1 additions, one compare, one masked add
    n_valid = int(mask.sum())
    _bound(rec, ops=N * n_valid * (3 * ndim + 1),
           nbytes=4 * (N + M) * ndim + M + 4 + 4 * N)
    print("count_within", json.dumps(rec))
    assert got.shape == (N,) and got.dtype == torch.int32
    assert rec["mismatches"] == 0 and rec["counted"] > 0, rec  # bitwise
    if timed:
        _timed(rec, lambda: neighbors.count_within(members, mask, points, radius),
               lambda: neighbors.count_within_plain(members, mask, points, radius),
               TIMING_LAUNCHES if M <= MAIN_M else TIMING_LAUNCHES_LARGE)
    return rec


def check_radius(neighbors, region, gen, M, ndim, nb, timed=False):
    dev = DEVICE
    w = torch.randn((M, ndim), generator=gen, device=dev)
    mask = torch.arange(M, device=dev) < (M - M // 5)
    inbag = region.bootstrap_inbag_rounds(mask, gen, nb)
    got = neighbors.bootstrapped_sq_radius(w, mask, inbag)
    want = neighbors.bootstrapped_sq_radius_plain(w, mask, inbag)
    torch.cuda.synchronize()
    err = abs(float(got) - float(want))
    rec = dict(shape=f"M={M} ndim={ndim} nb={nb}", got=float(got),
               want=float(want), max_abs_err=err)
    # what this run's inputs need: a distance (3 ndim - 1 operations) for
    # each row and each column in some bag, and a select and a min for each
    # row and each (column, round) in the bag
    cols = int(inbag.any(dim=0).sum())
    _bound(rec, ops=M * cols * (3 * ndim - 1) + 2 * M * int(inbag.sum()),
           nbytes=4 * M * ndim + M + nb * M + 4)
    print("bootstrapped_sq_radius", json.dumps(rec))
    assert got.shape == () and got.dtype == torch.float32
    assert np.isfinite(float(got)) and float(got) > 0, rec
    assert err == 0.0, rec  # bitwise
    if timed:
        _timed(rec, lambda: neighbors.bootstrapped_sq_radius(w, mask, inbag),
               lambda: neighbors.bootstrapped_sq_radius_plain(w, mask, inbag),
               TIMING_LAUNCHES if M <= MAIN_M else TIMING_LAUNCHES_LARGE)
    return rec


def check_launch_alone(neighbors, region, gen, dump_dir):
    """One call of either wrapper enqueues its own kernel and nothing else
    on the device: no zero-fill launch before it, no copy. Each call is
    captured in a CUDA graph, whose node list (written by
    ``cudaGraphDebugDotPrint`` into ``dump_dir``) holds every piece of work
    the call put on the stream; unlike a profiler trace it loses none."""
    members = torch.randn((MAIN_M, 3), generator=gen, device=DEVICE)
    mask = torch.ones(MAIN_M, dtype=torch.bool, device=DEVICE)
    points = torch.rand((COUNT_N, 3), generator=gen, device=DEVICE)
    radius = torch.tensor(0.3, device=DEVICE)
    inbag = region.bootstrap_inbag_rounds(mask, gen, NBOOT)
    calls = {
        "count_within": lambda: neighbors.count_within(
            members, mask, points, radius),
        "bootstrap_radius": lambda: neighbors.bootstrapped_sq_radius(
            members, mask, inbag)}
    stream = torch.cuda.Stream()
    # a first call on the capture stream outside the capture: the radius
    # wrapper zeroes its stream's merge workspace once, at its first call
    with torch.cuda.stream(stream):
        for call in calls.values():
            call()
    torch.cuda.synchronize()
    found = {}
    for name, call in calls.items():
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # not instantiated
        graph.enable_debug_mode()
        with torch.cuda.graph(graph, stream=stream):
            call()
        path = os.path.join(dump_dir, f"{name}.dot")
        graph.debug_dump(path)
        with open(path) as fh:
            found[name] = _graph_nodes(fh.read())
        del graph
    print("device work of one call of each wrapper (CUDA graph nodes):",
          json.dumps(found))
    for name, nodes in found.items():
        assert len(nodes) == 1 and nodes[0][0] == "KERNEL" \
            and name in nodes[0][1], (name, nodes)


_NODE_TYPES = ("KERNEL", "MEMCPY", "MEMSET", "HOST", "EMPTY", "GRAPH",
               "EVENT_RECORD", "WAIT_EVENT", "EXT_SEMAS_SIGNAL",
               "EXT_SEMAS_WAIT", "MEM_ALLOC", "MEM_FREE", "BATCH_MEM_OP",
               "CONDITIONAL")


def _graph_nodes(dot):
    """``[(type, name), ...]``, one per node of a graph that
    ``cudaGraphDebugDotPrint`` wrote: the node's type and, for a kernel,
    its mangled name (else the node's label)."""
    import re

    starts = [m.start() for m in re.finditer(
        r'^\s*"?graph_\d+_node_\d+"?\s*\[', dot, re.M)]
    nodes = []
    for a, b in zip(starts, starts[1:] + [len(dot)]):
        block = dot[a:b]
        kind = re.search(r"\b(" + "|".join(_NODE_TYPES) + r")\b", block)
        name = re.search(r"_Z\w+", block)
        nodes.append((kind.group(1) if kind else "?",
                      name.group(0) if name else " ".join(block.split())[:200]))
    return nodes


def launch_counts(neighbors, result, regions=True):
    """Both kernels' launches since the counters were set to 0, and the
    region proposal rounds of ``result``'s run: with a friends constrainer
    (``regions``), its ``region`` and ``focus`` steps, replayed or run
    eagerly (each samples the union-of-balls region once, with one
    ``count_within``); the other constrainers sample none."""
    steps = result.stats["steps"]
    return dict(count_within=neighbors.count_within.launches,
                bootstrapped_sq_radius=neighbors.bootstrapped_sq_radius.launches,
                region_rounds=(steps.get("region", 0) + steps.get("focus", 0)
                               if regions else 0))


def path_stats(result):
    """The chunk path a fit ran and what it took per iteration."""
    st, n = result.stats, max(result.niterations, 1)
    return dict(chunk_path=st["chunk_path"],
                graph_replays_per_iter=st["graph_replays"] / n,
                host_syncs_per_iter=st["host_syncs"] / n,
                capture_s=st["capture_s"])


def compare_paths(label, fit, neighbors, graph=None, regions=True):
    """A fit on the captured path (``graph``: its result, wall and launch
    counts, or run here as ``fit(eager=False)``) against ``fit(eager=True)``,
    the eager run of the same steps on the card from the same seed: the
    digests (``_fit_digest``: logZ, logZerr, iterations, evaluations, fill
    rounds, the L, u, w and mask records) and both kernels' launches must
    be equal bit for bit (``regions``: as in ``launch_counts``). Prints
    and returns the record."""
    runs = []
    for eager in (False, True):
        if graph is not None and not eager:
            runs.append(graph)
            continue
        neighbors.count_within.launches = 0
        neighbors.bootstrapped_sq_radius.launches = 0
        _sync()
        t0 = time.perf_counter()
        r = fit(eager)
        _sync()
        runs.append((r, time.perf_counter() - t0,
                     launch_counts(neighbors, r, regions)))
    (g, wall_g, n_g), (e, wall_e, n_e) = runs
    bitwise = _bitwise(_fit_digest(g), _fit_digest(e)) | dict(
        launches=n_g == n_e)
    rec = dict(fit=label, wall_s_graph=wall_g, wall_s_eager=wall_e,
               niter=g.niterations, fill_rounds=g.stats["fill_rounds"],
               ndraws=g.ndraws, launches=n_g,
               graph=path_stats(g), eager=path_stats(e), bitwise=bitwise)
    print(json.dumps(rec))
    assert g.stats["chunk_path"] == "graph" and e.stats["chunk_path"] == "eager"
    assert all(bitwise.values()), (label, bitwise, n_g, n_e)
    return rec


def path_profile(label, fit):
    """A capped fit on each path, once timed and once under the profiler:
    the busy share (kernel time over the unprofiled wall), the kernels per
    iteration, and the kernel and graph launches the host dispatched per
    iteration (runtime API calls in the trace). On the captured path the
    profiler starts once the fit's graphs are captured (a capture under
    the profiler fails), so its trace lacks the capture. The eager path is
    traced with device activity only (its host ops would be most of the
    trace and of its processing time); its launches are the runtime calls
    that activity records, None where it records none."""
    cuda = torch.autograd.DeviceType.CUDA
    rec = dict(fit=label)
    for eager in (False, True):
        _sync()
        t0 = time.perf_counter()
        r = fit(eager)
        _sync()
        wall = time.perf_counter() - t0
        events = _profiled(lambda: fit(eager), captures=not eager,
                           host=not eager)

        n = max(r.niterations, 1)
        kernels = sum(e.count for e in events if e.device_type == cuda)
        launched = sum(e.count for e in events if e.device_type != cuda
                       and e.key.startswith(("cudaLaunchKernel",
                                             "cuLaunchKernel")))
        graphs = sum(e.count for e in events if e.key == "cudaGraphLaunch")
        traced = launched + graphs > 0
        rec["eager" if eager else "graph"] = dict(
            niter=r.niterations, wall_s=wall,
            busy_share=(_kernel_us(events) / 1e6 / wall) if kernels else None,
            kernels_per_iter=kernels / n,
            host_kernel_launches_per_iter=launched / n if traced else None,
            host_graph_launches_per_iter=graphs / n if traced else None,
            **path_stats(r))
    print(json.dumps(rec))
    return rec


def _profiled(fn, captures=True, host=True):
    """``fn()`` under the profiler (device activity, and host activity
    where ``host``), its event averages. Where ``fn`` captures CUDA graphs
    the profiler starts once the first program is captured: a capture
    under the profiler fails."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from massivedatans_tpu_torch.ns import engine

    on_card = DEVICE == "cuda"
    prof = torch_profile(activities=([ProfilerActivity.CUDA] if on_card
                                     else []) + (
        [ProfilerActivity.CPU] if host or not on_card else []))
    capture = engine.ChunkProgram._capture
    started = []

    def capture_then_profile(self):
        capture(self)
        if not started:
            prof.start()
            started.append(True)

    if captures and DEVICE == "cuda":
        engine.ChunkProgram._capture = capture_then_profile
    else:
        prof.start()
        started.append(True)
    try:
        fn()
        _sync()
    finally:
        engine.ChunkProgram._capture = capture
        if started:
            prof.stop()
    assert started, "the captured path captured nothing"
    return prof.key_averages()


def _count_steps(engine):
    """Wrap ``engine.ChunkProgram._launch`` with counters of the chunk
    steps run, by name, and of those among them replayed from a captured
    graph; returns the two counters. Under a mesh every rank counts its
    own (the result, with its stats, is rank 0's only)."""
    run, replayed = collections.Counter(), collections.Counter()
    launch = engine.ChunkProgram._launch

    def counted(self, name):
        run[name] += 1
        replayed[name] += name in self.graphs
        return launch(self, name)

    engine.ChunkProgram._launch = counted
    return run, replayed


def _build_all(_build):
    """Both native libraries, built at the same time; returns seconds."""
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(fn,))
               for fn in (_build.load, _build.load_host)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile-out", default=None,
                    help="also profile capped horns and MUSE fits "
                         f"({PROFILE_SAMPLES} and {PROFILE_SAMPLES_MUSE} "
                         "iterations) and write the kernel tables here")
    ap.add_argument("--muse-max-samples", type=int, default=2000,
                    help="iteration cap of the MUSE fit (0: run to "
                         "tolerance)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    phase_s = {}  # each phase's own seconds, by title

    def phase(title):
        now = time.perf_counter() - t_start
        if phase_s:
            last = next(reversed(phase_s))
            phase_s[last] = now - phase_s[last]
            print(f"    ({last}: {phase_s[last]:.1f} s)")
        phase_s[title] = now
        print(f"--- {title} (at {now:.1f} s)")

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "massivedatans_tpu_torch")):
        print(f"chip_smoke: no massivedatans_tpu_torch package beside "
              f"{__file__}; run it from the root of a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from massivedatans_tpu_torch.cli import run_fit
    from massivedatans_tpu_torch.config import RunConfig, set_fp32_precision
    from massivedatans_tpu_torch.datagen.generators import gen_horns
    from massivedatans_tpu_torch.ns import region, subsets
    from massivedatans_tpu_torch.ops import _build, neighbors

    # --- phase 1: the card ---
    phase("phase 1: the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    set_fp32_precision()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False

    # --- phase 2: build ---
    phase("phase 2: build")
    build_s = _build_all(_build)
    print(f"build of both libraries, in parallel: {build_s:.2f} s "
          f"({os.path.relpath(_build.library_path(), ROOT)}, "
          f"{os.path.relpath(_build.host_library_path(), ROOT)})")
    assert subsets._load_native() is not None  # native labels on the path

    # --- phase 3: kernels vs plain versions ---
    phase("phase 3: kernels vs plain versions")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    # the horns main-path shape of each kernel first
    timed = {"count_within": [], "bootstrapped_sq_radius": []}
    for ndim in (3, 5):  # horns, MUSE FULL
        for M in (MAIN_M, LARGE_M):
            timed["count_within"].append(check_count_within(
                neighbors, gen, COUNT_N, M, ndim, timed=True))
            timed["bootstrapped_sq_radius"].append(check_radius(
                neighbors, region, gen, M, ndim, NBOOT, timed=True))
    for ndim in (3, 5):  # a round of an escalated chunk
        timed["count_within"].append(check_count_within(
            neighbors, gen, ESCALATED_N, MAIN_M, ndim, timed=True))
    for nb in (3, 32):  # the generic instantiation
        check_radius(neighbors, region, gen, MAIN_M, 3, nb)
    with tempfile.TemporaryDirectory() as tmp:
        check_launch_alone(neighbors, region, gen, tmp)

    def reset_counts():
        neighbors.count_within.launches = 0
        neighbors.bootstrapped_sq_radius.launches = 0

    def read_counts(result):
        counts = launch_counts(neighbors, result)
        assert counts["count_within"] > 0, counts
        assert counts["bootstrapped_sq_radius"] > 0, counts
        # one count launch per region proposal round, nothing else
        assert counts["count_within"] == counts["region_rounds"], counts
        return counts

    # --- phase 4: the horns path ---
    phase("phase 4: the horns path")
    cfg = RunConfig()
    data = gen_horns(1000)

    def horns(cfg_, eager=False, **run_opts):
        return run_fit(data["x"], data["y"], cfg_, DEVICE,
                       noise_level=data["noise_level"], eager=eager,
                       **run_opts)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = horns(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(result)
    print(json.dumps(dict(
        fit=f"horns ndata={data['y'].shape[1]} nlive={cfg.nlive_points}",
        wall_s=wall, niter=result.niterations, ndraws=result.ndraws,
        fill_rounds=result.stats["fill_rounds"], launches=launches,
        member_overflow=result.stats["member_overflow"],
        **path_stats(result), timing=result.stats["timing"],
        peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9)))
    D, K = data["y"].shape[1], cfg.nlive_points
    rows = result.niterations + K
    assert result.u.shape == (rows, D, 3), result.u.shape
    assert result.x.shape == (rows, D, 3) and result.L.shape == (rows, D)
    assert result.w.shape == (rows, D) and result.mask.shape == (rows, D)
    assert result.logZ.shape == (D,) and np.isfinite(result.logZ).all()
    assert (result.logZerr > 0).all()
    with open(os.path.join(ROOT, "quad_logZ.json")) as fh:
        quad = np.asarray(json.load(fh)["logZ"], float)
    nq = len(quad)
    dq = np.abs(result.logZ[:nq] - quad)
    within = int((dq < 3 * result.logZerr[:nq] + 0.5).sum())
    print(f"quadrature oracle: {within}/{nq} datasets within "
          f"3 logZerr + 0.5 (median |dlogZ| {np.median(dq):.3f}, "
          f"max {dq.max():.3f})")
    assert within >= int(np.ceil(0.95 * nq)), (within, nq)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [compare_paths(
            f"horns, first {HORNS_EAGER_CHUNKS} chunks", lambda eager: horns(
                cfg, eager, checkpoint_dir=os.path.join(
                    tmp, "eager" if eager else "graph"),
                max_chunks=HORNS_EAGER_CHUNKS), neighbors)]
    # again at pipeline_lookahead 0 (phase 4 ran at the default, 1)
    cfg0 = dataclasses.replace(cfg, pipeline_lookahead=0)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result0 = horns(cfg0)
    torch.cuda.synchronize()
    wall0 = time.perf_counter() - t0
    read_counts(result0)
    within0 = int((np.abs(result0.logZ[:nq] - quad)
                   < 3 * result0.logZerr[:nq] + 0.5).sum())
    print(json.dumps(dict(
        fit="horns, pipeline_lookahead 0 and 1", wall_s=[wall0, wall],
        niter=[result0.niterations, result.niterations],
        quad_within=[within0, within],
        bitwise_equal=bool(np.array_equal(result0.L, result.L)),
        **{k: [path_stats(result0)[k], path_stats(result)[k]]
           for k in ("host_syncs_per_iter", "graph_replays_per_iter")},
        timing=[result0.stats["timing"], result.stats["timing"]])))
    assert within0 >= int(np.ceil(0.95 * nq)), (within0, nq)
    profiles = [path_profile("horns", lambda eager: horns(dataclasses.replace(
        cfg, max_samples=PATH_PROFILE_SAMPLES["horns"]), eager))]

    # --- phase 5: the other strategies ---
    phase("phase 5: the other strategies")
    strategy_launches = {}
    for name in STRATEGIES:
        cap = SLICE_MAX_SAMPLES if name == "SLICE" else 0
        cfg_s = dataclasses.replace(cfg, constrainer=name, max_samples=cap)
        reset_counts()
        strategy_launches[name], within, held = strategy_fit(
            run_fit, cfg_s, data, D, quad, neighbors)
        assert held >= (SLICE_MIN_HELD if cap else nq), (name, held)
        assert within >= np.ceil(STRATEGY_BAR[name] * held), (
            name, within, held)
        with tempfile.TemporaryDirectory() as tmp:
            cut = STRATEGY_EAGER_CHUNKS[name]
            paths.append(compare_paths(
                f"{name}, first {cut} chunks", lambda eager: horns(
                    cfg_s, eager, checkpoint_dir=os.path.join(
                        tmp, "eager" if eager else "graph"),
                    max_chunks=cut), neighbors, regions=False))
        profiles.append(path_profile(name, lambda eager: horns(
            dataclasses.replace(cfg_s,
                                max_samples=PATH_PROFILE_SAMPLES[name]),
            eager)))

    # --- phase 6: the MUSE path ---
    phase("phase 6: the MUSE path")
    with tempfile.TemporaryDirectory() as tmp:
        fixture = muse_fixture(tmp)
        reset_counts()
        muse_rec, muse_res = muse_check(fixture, args.muse_max_samples)
        muse_launches = read_counts(muse_res)
        print("MUSE launches:", json.dumps(muse_launches))
        paths.append(compare_paths(
            f"MUSE, first {MUSE_EAGER_CHUNKS} chunks", lambda eager: muse_fit(
                fixture, args.muse_max_samples, run_opts=dict(
                    eager=eager, max_chunks=MUSE_EAGER_CHUNKS,
                    checkpoint_dir=os.path.join(
                        tmp, "muse_eager" if eager else "muse_graph")))[0],
            neighbors))
        profiles.append(path_profile("MUSE", lambda eager: muse_fit(
            fixture, PATH_PROFILE_SAMPLES["MUSE"],
            run_opts=dict(eager=eager))[0]))
        if args.profile_out:
            profile(lambda: run_fit(data["x"], data["y"], dataclasses.replace(
                cfg, max_samples=PROFILE_SAMPLES), DEVICE,
                noise_level=data["noise_level"]), args.profile_out)
            root, ext = os.path.splitext(args.profile_out)
            profile(lambda: muse_fit(fixture, PROFILE_SAMPLES_MUSE),
                    root + "_muse" + ext)

        # --- phase 7: resume and escalation ---
        phase("phase 7: resume and escalation")
        reset_counts()
        resume_launches = resume_phase(run_fit, cfg0, data, result0,
                                       os.path.join(tmp, "ckpt"), neighbors)
        print("resume launches:", json.dumps(resume_launches))
        assert resume_launches["count_within"] \
            == resume_launches["region_rounds"] > 0, resume_launches
        assert resume_launches["bootstrapped_sq_radius"] > 0, resume_launches
        reset_counts()
        esc_rec, esc_res = muse_check(fixture, args.muse_max_samples,
                                      eval_batch_max=MUSE_EVAL_BATCH_MAX)
        escalated_launches = read_counts(esc_res)
        assert esc_rec["big_batch_chunks"] > 0, esc_rec
        paths.append(compare_paths(
            "MUSE escalated", lambda eager: muse_fit(
                fixture, args.muse_max_samples, run_opts=dict(eager=eager),
                eval_batch_max=MUSE_EVAL_BATCH_MAX)[0],
            neighbors, graph=(esc_res, esc_rec["wall_s"],
                              escalated_launches)))
        print(json.dumps({"paths": paths, "profiles": profiles}))
        # the escalated rounds, held on the spaxels with a star that ran
        # them (the two fits are bitwise alike until the first switch, so
        # a spaxel done before it has phase 6's logZ to the bit) and that
        # stopped at tolerance before the cap in both fits
        n = MUSE_SIDE * MUSE_SIDE
        held = (stopped_before_cap(muse_res, args.muse_max_samples, n)
                & stopped_before_cap(esc_res, args.muse_max_samples, n)
                & ~np.asarray(fixture[2]["empty"], bool)[:n]
                & (esc_res.logZ != muse_res.logZ))
        dz = np.abs(esc_res.logZ - muse_res.logZ)[held]
        bar = (3 * np.hypot(esc_res.logZerr, muse_res.logZerr) + 0.5)[held]
        within = int((dz < bar).sum())
        print(f"MUSE escalated vs phase 6: {within}/{int(held.sum())} spaxels "
              "(with a star, escalated, stopped at tolerance before the cap "
              "in both) within 3 sqrt(errA^2 + errB^2) + 0.5 (median "
              f"|dlogZ| {float(np.median(dz)) if held.any() else 0.0:.3f}, "
              f"max {float(dz.max(initial=0.0)):.3f})")
        assert held.sum() >= MUSE_MIN_HELD, int(held.sum())
        assert within >= np.ceil(MUSE_ESCALATED_BAR * held.sum()), (
            within, int(held.sum()))
        print("MUSE escalated vs phase 6:", json.dumps({
            k: [esc_rec[k], muse_rec[k]] for k in (
                "wall_s", "niter", "fill_rounds", "ndraws",
                "big_batch_chunks", "median_logZ_plus_half_yy")}
            | {"launches": [escalated_launches, muse_launches]}))

        # --- phase 8: gradient backends ---
        phase("phase 8: gradient backends")
        reset_counts()
        backends = backends_phase(data, result, fixture, muse_res)
        counts = dict(count_within=neighbors.count_within.launches,
                      bootstrapped_sq_radius=neighbors.bootstrapped_sq_radius.launches)
        # HMC, VI and refine build no region: neither kernel launches
        assert counts == dict(count_within=0, bootstrapped_sq_radius=0), counts
        print(json.dumps({"backends": backends}))

        # --- phase 9: the sharded path ---
        phase("phase 9: the sharded path")
        sharded_recs = sharded_phase(data, cfg, result, launches, wall, quad,
                                     fixture)
        print(json.dumps({"sharded": sharded_recs}))

    # --- phase 10: horns ndata=10^4 ---
    phase("phase 10: horns ndata=10^4")
    del result, result0  # about 0.4 GB of host records at 1,000
    reset_counts()
    big_launches = horns10k_phase(run_fit, cfg, gen_horns, read_counts,
                                  neighbors)

    # --- phase 11: the reference's validation protocols ---
    phase("phase 11: validation")
    validation_phase(read_counts, neighbors, muse_res, fixture[2],
                     args.muse_max_samples)

    # --- phase 12: the MUSE late state ---
    phase("phase 12: MUSE late state")
    late_launches = late_state_phase(neighbors)

    # --- phase 13: tools/muse_bench.py's cube ---
    phase("phase 13: MUSE bench cube")
    reset_counts()
    bench_launches, bench_counts = muse_bench_phase(read_counts, neighbors,
                                                    region, gen)
    timed["count_within"].extend(bench_counts)

    # --- phase 14: the MUSE seed spread's setting ---
    phase("phase 14: MUSE seed setting")
    reset_counts()
    seeds_launches = muse_seeds_phase(read_counts, neighbors)

    # --- phase 15: records ---
    phase("phase 15: records")
    print(json.dumps(dict(phase_s={k: v for k, v in phase_s.items()
                                   if k != "phase 15: records"},
                          phases_1_14_s=phase_s["phase 15: records"])))
    src = "massivedatans_tpu_torch/csrc/neighbors.cu"
    replaces = {"count_within": "massivedatans_tpu/ops/pallas_neighbors.py:69",
                "bootstrapped_sq_radius":
                    "massivedatans_tpu/ops/pallas_neighbors.py:158"}
    keys = ("ms", "plain_ms", "device_ms", "plain_device_ms", "bound_ms",
            "bound_by", "bound_share", "max_abs_err")
    records = []
    for name, recs in timed.items():
        main_rec = recs[0]  # the horns main-path shape
        records.append(dict(
            name=name, route="cuda", source=src, replaces=replaces[name],
            launches=launches[name], launches_muse=muse_launches[name],
            launches_strategies={k: v[name]
                                 for k, v in strategy_launches.items()},
            launches_resume=resume_launches[name],
            launches_horns10k=big_launches[name],
            launches_muse_escalated=escalated_launches[name],
            launches_muse_late_state=late_launches[name],
            launches_muse_bench=bench_launches[name],
            launches_muse_seeds=seeds_launches[name],
            # per rank, for each sharded fit
            launches_sharded={f"{r['backend']} world {r['world']}":
                              [c[name] for c in r["launches"]]
                              for r in sharded_recs if "launches" in r},
            region_rounds=launches["region_rounds"],
            region_rounds_muse=muse_launches["region_rounds"],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
            device_ms=main_rec["device_ms"], bound_ms=main_rec["bound_ms"],
            bound_by=main_rec["bound_by"],
            # no single PyTorch call computes either function
            library_ms=None,
            shapes={r["shape"]: {k: r[k] for k in keys} for r in recs}))
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _peak_reset():
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak_gb():
    return torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else None


def _gen(seed):
    return torch.Generator(device=DEVICE).manual_seed(seed)


def _profile_slice(fn, units):
    """Run ``fn`` (a short slice of a backend run) once to warm up, once
    timed, once under the profiler. Returns the CUDA kernels per unit
    (``units`` leapfrog steps or VI steps in the slice), the slice's wall
    and its busy share (kernel time over the unprofiled wall); None where
    the trace holds no device record."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    _sync()
    t0 = time.perf_counter()
    fn()
    _sync()
    wall = time.perf_counter() - t0
    # device records only: the host ops of a slice would be most of the
    # trace and of its processing time (the CPU rehearsal traces the host)
    act = ProfilerActivity.CUDA if DEVICE == "cuda" else ProfilerActivity.CPU
    with torch_profile(activities=[act]) as prof:
        fn()
        _sync()
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sum(e.count for e in events if e.device_type == cuda)
    if not kernels:
        print("  note: the profiler trace held no device record; kernels "
              "per step and busy share not measured")
        return dict(kernels_per_step=None, slice_wall_s=wall, busy_share=None)
    return dict(kernels_per_step=kernels / units, slice_wall_s=wall,
                busy_share=_kernel_us(events) / 1e6 / wall)


def _hmc_run(problem, run, init_u, **kw):
    """Time ``run()``, a call that runs ``run_hmc`` on ``problem`` with
    settings ``kw`` (``run_hmc``'s defaults where not given): the whole
    run, its two warmup phases (a synchronised timer around each) and the
    sampling. Returns the ``HMCResult`` and its record, with the kernels
    per leapfrog step and busy share of a 5-iteration slice."""
    from massivedatans_tpu_torch.infer import hmc

    warm = []
    phase_fn = hmc._warmup_phase

    def timed_phase(*a, **k):
        _sync()
        t0 = time.perf_counter()
        out = phase_fn(*a, **k)
        _sync()
        warm.append(time.perf_counter() - t0)
        return out

    kw = dict(dict(num_warmup=300, num_samples=300, num_leapfrog=24), **kw)
    n1 = max(2 * kw["num_warmup"] // 3, 2)
    n2 = max(kw["num_warmup"] - n1, 2)
    hmc._warmup_phase = timed_phase
    try:
        _peak_reset()
        _sync()
        t0 = time.perf_counter()
        res = run()
        _sync()
        wall = time.perf_counter() - t0
    finally:
        hmc._warmup_phase = phase_fn
    assert len(warm) == 2, warm
    grads = (n1 + n2 + kw["num_samples"]) * kw["num_leapfrog"] + 1
    rec = dict(backend="hmc", **kw, wall_s=wall, gradient_evals=grads,
               gradients_per_s=grads / wall,
               warmup_iter_ms=sum(warm) / (n1 + n2) * 1e3,
               sampling_iter_ms=(wall - sum(warm)) / max(kw["num_samples"], 1)
               * 1e3, peak_mem_GB=_peak_gb(),
               median_accept=float(res.accept_rate.median()),
               finite_logp_share=float(torch.isfinite(res.logp).float().mean()))
    # the shortest run: two iterations in each warmup phase, one sample
    short = dict(num_warmup=2, num_samples=1, num_leapfrog=kw["num_leapfrog"])
    rec.update(_profile_slice(lambda: hmc.run_hmc(
        problem, _gen(0), device=DEVICE, init_u=init_u, **short),
        5 * kw["num_leapfrog"]))
    return res, rec


def _vi_run(problem, run, init_u, **kw):
    """Time ``run()``, a call that runs ``run_vi`` on ``problem`` with
    settings ``kw``: the whole run, its fit loop and its final ELBO and
    importance weights (a synchronised timer around each). Returns the
    ``VIResult`` and its record (steps per second and the mean step from
    the fit loop alone), with the kernels per step and busy share of a
    5-step slice."""
    from massivedatans_tpu_torch.infer import run_vi, vi

    walls = {}

    def timed(name, fn):
        def call(*a, **k):
            _sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            _sync()
            walls[name] = time.perf_counter() - t0
            return out
        return call

    kw = dict(dict(steps=1500, mc_samples=8, iw_samples=256), **kw)
    fit_fn, evidence_fn = vi._fit, vi._evidence
    vi._fit, vi._evidence = timed("fit", fit_fn), timed("evidence",
                                                        evidence_fn)
    try:
        _peak_reset()
        _sync()
        t0 = time.perf_counter()
        res = run()
        _sync()
        wall = time.perf_counter() - t0
    finally:
        vi._fit, vi._evidence = fit_fn, evidence_fn
    rec = dict(backend="vi", **kw, wall_s=wall, fit_s=walls["fit"],
               evidence_s=walls["evidence"],
               steps_per_s=kw["steps"] / walls["fit"],
               step_ms=walls["fit"] / kw["steps"] * 1e3,
               peak_mem_GB=_peak_gb(),
               logZ_iw_finite=bool(torch.isfinite(res.logZ_iw).all()))
    short = dict(kw, steps=5, iw_samples=8)
    rec.update(_profile_slice(lambda: run_vi(
        problem, _gen(0), device=DEVICE, init_u=init_u, **short), 5))
    return res, rec


def _refine(problem, fit, label, **hmc_kw):
    """``run_refine`` (the function behind ``refine``) on a fit held in
    memory, one backend at a time, HMC with ``hmc_kw`` (``num_warmup``,
    ``num_samples``) where given; returns the HMC and VI results and
    their records."""
    from massivedatans_tpu_torch.cli import refine_init_u, run_refine

    init_u = refine_init_u(fit, problem.ndim)
    hmc, rec_h = _hmc_run(problem, lambda: run_refine(
        problem, fit, device=DEVICE, backend="hmc", **hmc_kw)[1], init_u,
        **hmc_kw)
    vi, rec_v = _vi_run(problem, lambda: run_refine(
        problem, fit, device=DEVICE, backend="vi")[2], init_u)
    iw = vi.logZ_iw.cpu().numpy()
    rec_v.update(iw_finite=int(np.isfinite(iw).sum()),
                 iw_nonfinite=np.nonzero(~np.isfinite(iw))[0].tolist(),
                 # over the finite ones
                 median_abs_iw_minus_ns=float(np.nanmedian(np.abs(
                     iw - fit.logZ))))
    for rec in (rec_h, rec_v):
        rec["problem"] = label
    return hmc, vi, rec_h, rec_v


def analytic_bar_counts(acc, x, elbo, iw, centers, logZ,
                        sigma=ANALYTIC_SIGMA):
    """How many datasets of the analytic oracle meet each bar of
    ``tests/test_infer.py`` (HMC accept, posterior mean and std, ELBO and
    IW evidence), from numpy arrays of either package; and the worst value
    of each."""
    dmean = np.abs(x.mean(axis=0) - centers).max(axis=1)
    dstd = np.abs(x.std(axis=0) - sigma).max(axis=1)
    counts = dict(accept_in_bar=int(((acc > 0.4) & (acc <= 1.0)).sum()),
                  mean_in_bar=int((dmean < 4.0 * sigma / np.sqrt(400) * 10)
                                  .sum()),
                  std_in_bar=int((dstd < 0.6 * sigma).sum()),
                  elbo_in_bar=int((elbo < logZ + 0.2).sum()),
                  iw_in_bar=int((np.abs(iw - logZ) < 0.25).sum()),
                  iw_over_elbo=int((iw >= elbo - 0.2).sum()))
    extremes = dict(accept_min=float(acc.min()), max_dmean=float(dmean.max()),
                    max_dstd_over_sigma=float(dstd.max() / sigma),
                    max_abs_iw_minus_logZ=float(np.abs(iw - logZ).max()))
    return counts, extremes


def muse_star_counts(iw, logZ, logZerr, empty):
    """For the MUSE refine's spaxels with a star: how many there are, how
    many have a finite ``logZ_IW`` within 3 logZerr + 0.5 of their NS
    logZ, and the median |logZ_IW - logZ_NS| over the finite ones."""
    star = ~np.asarray(empty, bool)
    d = np.abs(np.asarray(iw, np.float64) - logZ)[star]
    within = np.isfinite(d) & (d < (3 * np.asarray(logZerr) + 0.5)[star])
    return dict(star_n=int(star.sum()), star_iw_within_ns=int(within.sum()),
                star_median_abs_iw_minus_ns=float(np.nanmedian(d)))


def _hold_hmc(rec, jax_ref):
    """Hold an HMC run's record to the JAX package's median accept and
    share of finite logp, less their slacks."""
    assert rec["median_accept"] >= jax_ref["median_accept"] \
        - HMC_ACCEPT_SLACK, (rec, jax_ref)
    assert rec["finite_logp_share"] >= jax_ref["finite_logp_share"] \
        - HMC_FINITE_SLACK, (rec, jax_ref)


def backends_phase(data, horns_result, fixture, muse_result):
    """Phase 8: HMC and VI on the card for the analytic oracle at
    D = 1000, the horns refine of phase 4's fit and the MUSE refine of
    phase 6's fit, each held to its bar. Returns the runs' records."""
    from massivedatans_tpu_torch.infer import run_hmc, run_vi
    from massivedatans_tpu_torch.models.analytic import (
        make_analytic_gaussian_problem, true_logZ,
    )
    from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem
    from massivedatans_tpu_torch.muse.likelihood import make_muse_problem
    from massivedatans_tpu_torch.muse.model import load_template_grid

    sig = ANALYTIC_SIGMA
    # --- the analytic oracle: tests/test_infer.py's bars on every dataset
    centers = np.random.default_rng(3).uniform(0.3, 0.7, size=(ANALYTIC_D, 3))
    problem = make_analytic_gaussian_problem(centers, sigma=sig, device=DEVICE)
    hmc, rec_h = _hmc_run(problem, lambda: run_hmc(
        problem, _gen(0), device=DEVICE, **ANALYTIC_HMC), None, **ANALYTIC_HMC)
    acc = hmc.accept_rate.cpu().numpy()
    x = hmc.x.cpu().numpy()
    vi, rec_v = _vi_run(problem, lambda: run_vi(
        problem, _gen(0), device=DEVICE, **ANALYTIC_VI), None, **ANALYTIC_VI)
    lz = true_logZ(centers, sig)
    elbo, iw = vi.elbo.cpu().numpy(), vi.logZ_iw.cpu().numpy()
    bars, extremes = analytic_bar_counts(acc, x, elbo, iw, centers, lz)
    rec_h.update(problem=f"analytic D={ANALYTIC_D}",
                 **{k: extremes[k] for k in ("accept_min", "max_dmean",
                                             "max_dstd_over_sigma")})
    rec_v.update(problem=f"analytic D={ANALYTIC_D}",
                 max_abs_iw_minus_logZ=extremes["max_abs_iw_minus_logZ"])
    records = [rec_h, rec_v]
    print(json.dumps(rec_h))
    print(json.dumps(rec_v))
    print("analytic oracle, datasets meeting each bar of tests/test_infer.py:",
          json.dumps(bars))
    for k, v in bars.items():
        assert v >= ANALYTIC_JAX_COUNTS[k] - ANALYTIC_SLACK, (k, bars)

    # --- horns: run_refine on phase 4's fit, in memory
    problem = make_gaussline_problem(data["x"], data["y"],
                                     noise_level=data["noise_level"],
                                     device=DEVICE)
    with open(os.path.join(ROOT, "quad_logZ.json")) as fh:
        quad = np.asarray(json.load(fh)["logZ"], float)
    nq = min(len(quad), problem.ndata)
    quad = quad[:nq]
    _, vi, rec_h, rec_v = _refine(problem, horns_result,
                                  f"horns D={problem.ndata} refine")
    iw = vi.logZ_iw.cpu().numpy()
    bar = 3 * horns_result.logZerr[:nq] + 0.5
    rec_v.update(iw_quad_within=int((np.abs(iw[:nq] - quad) < bar).sum()),
                 quad_n=nq, iw_quad_bar=HORNS_IW_JAX_COUNT - HORNS_IW_SLACK)
    print(json.dumps(rec_h))
    print(json.dumps(rec_v))
    records += [rec_h, rec_v]
    _hold_hmc(rec_h, HORNS_HMC_JAX)
    assert rec_v["logZ_iw_finite"], rec_v
    assert rec_v["iw_quad_within"] >= rec_v["iw_quad_bar"], rec_v

    # --- MUSE: run_refine on phase 6's fit, in memory
    cube, tpl, truths = fixture
    md = load_template_grid(tpl, data_wl_nm=cube.wavelength_nm, zlo=0.0,
                            zhi=0.5, device=DEVICE)
    problem = make_muse_problem(md, cube.y, cube.var)
    n = problem.ndata
    _, vi, rec_h, rec_v = _refine(problem, muse_result,
                                  f"MUSE FULL spaxels={n} refine",
                                  **MUSE_REFINE_HMC)
    empty = np.asarray(truths["empty"], bool)[:n]
    yy = np.asarray(truths["yy"], np.float64)[:n]
    iw = vi.logZ_iw.cpu().numpy().astype(np.float64)
    identity = iw[empty] + yy[empty] / 2
    rec_v.update(n_empty=int(empty.sum()),
                 median_logZ_iw_plus_half_yy=float(np.median(identity)),
                 **muse_star_counts(iw, muse_result.logZ, muse_result.logZerr,
                                    empty),
                 iw_finite_bar=MUSE_IW_JAX_FINITE - MUSE_IW_SLACK,
                 star_iw_within_ns_bar=MUSE_STAR_JAX_WITHIN - MUSE_IW_SLACK)
    print(json.dumps(rec_h))
    print(json.dumps(rec_v))
    records += [rec_h, rec_v]
    _hold_hmc(rec_h, MUSE_HMC_JAX)
    # not every logZ_IW is finite in the reference either: a VI draw with
    # SFage at u = 0 (z below about -88 in float32) has a NaN gradient
    # through the SFH normalisation in both packages
    # (tests/test_torch_infer.py), which makes that spaxel's fit NaN; the
    # empty spaxels must all be finite
    assert rec_v["iw_finite"] >= rec_v["iw_finite_bar"], rec_v
    assert rec_v["star_iw_within_ns"] >= rec_v["star_iw_within_ns_bar"], rec_v
    assert empty.any() and abs(rec_v["median_logZ_iw_plus_half_yy"]) \
        <= EMPTY_IDENTITY_BAR, rec_v
    # the backends set full float32 themselves: no TF32 after them
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    return records


def horns10k_phase(run_fit, cfg, gen_horns, read_counts, neighbors):
    """Phase 10: the horns fit at the reference's headline scale, the
    first ``HORNS10K_NDATA`` spectra of ``gen_horns(HORNS10K_NDATA)`` at
    ``cfg`` (the default ``RunConfig``) on the captured path, to
    tolerance. The launch counters must be 0 when it is called. Checks the
    shapes, finite logZ, logZerr > 0, no stalled dataset, the quadrature
    bar of ``HORNS10K_ORACLE`` (>= 95 of its 100 datasets), that the group
    labels ran on their cadence (fewer refreshes than chunks, K*D being
    past 2^20) and that the first ``HORNS10K_EAGER_CHUNKS`` chunks are
    their eager run bit for bit (``compare_paths``). Prints the fit's
    record and the comparison's; returns the fit's launches."""
    data = gen_horns(HORNS10K_NDATA)

    def fit(eager=False, **run_opts):
        return run_fit(data["x"], data["y"], cfg, DEVICE,
                       noise_level=data["noise_level"], eager=eager,
                       **run_opts)

    _peak_reset()
    _sync()
    t0 = time.perf_counter()
    result = fit()
    _sync()
    wall = time.perf_counter() - t0
    launches = read_counts(result)
    st = result.stats
    D, K = HORNS10K_NDATA, cfg.nlive_points
    print(json.dumps(dict(
        fit=f"horns ndata={D} nlive={K}", wall_s=wall,
        niter=result.niterations, ndraws=result.ndraws,
        fill_rounds=st["fill_rounds"], evaluations_per_dataset=result.ndraws / D,
        member_overflow=st["member_overflow"], pile_peak=st["pile_peak"],
        chunks=st["chunks"], group_refreshes=st["group_refreshes"],
        n_groups_max=st["n_groups_max"], steps=st["steps"],
        stalled_total=int(st["stalled_mask"].sum()), launches=launches,
        **path_stats(result), graph_pool_GB=st["graph_pool_bytes"] / 1e9,
        peak_mem_GB=_peak_gb(),
        # the process's peak resident set so far (kB on Linux)
        host_peak_rss_GB=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        / 1e6, timing=st["timing"])))
    rows = result.niterations + K
    assert st["chunk_path"] == "graph", st["chunk_path"]
    assert result.u.shape == result.x.shape == (rows, D, 3), result.u.shape
    for a in (result.L, result.w, result.mask):
        assert a.shape == (rows, D), a.shape
    assert result.logZ.shape == (D,) and np.isfinite(result.logZ).all()
    assert (result.logZerr > 0).all()
    assert not st["stalled_mask"].any(), int(st["stalled_mask"].sum())
    # the labels refresh every 4th chunk once K * D > 2^20
    assert 0 < st["group_refreshes"] < st["chunks"], st
    with open(os.path.join(ROOT, HORNS10K_ORACLE)) as fh:
        oracle = json.load(fh)
    assert oracle["n_gen"] == HORNS10K_NDATA, oracle["n_gen"]
    quad = np.asarray(oracle["logZ"], float)
    nq = len(quad)
    dq = np.abs(result.logZ[:nq] - quad)
    within = int((dq < 3 * result.logZerr[:nq] + 0.5).sum())
    print(f"quadrature oracle ({HORNS10K_ORACLE}): {within}/{nq} datasets "
          f"within 3 logZerr + 0.5 (median |dlogZ| {np.median(dq):.3f}, "
          f"max {dq.max():.3f})")
    assert within >= int(np.ceil(0.95 * nq)), (within, nq)
    del result  # about 2 GB of host records
    with tempfile.TemporaryDirectory() as tmp:
        compare_paths(
            f"horns ndata={D}, first {HORNS10K_EAGER_CHUNKS} chunks",
            lambda eager: fit(eager, checkpoint_dir=os.path.join(
                tmp, "eager" if eager else "graph"),
                max_chunks=HORNS10K_EAGER_CHUNKS), neighbors)
    return launches


def muse_bench_phase(read_counts, neighbors, region, gen):
    """Phase 13: ``tools/muse_bench.py``'s cube (4,223 spaxels, nspec
    3600, the real-MUSE bad windows; ``tools/torch_muse_bench.py``'s
    ``build_bench_cube``, its SHA-256 the record's) fitted on the captured
    path at the options of ``BENCH_RECORD`` (the JAX package's CPU record,
    seed 1) capped at ``BENCH_CAP``, without the record's checkpoints.
    First each kernel is held bit for bit against its plain version at
    this fit's shapes: the count at the proposal pool (N = 8,192, M =
    1,664, ndim 5, timed; and timed at ndim 3, the horns model's) and the
    radius at M = 1,664, ndim 5. The launch
    counters must be 0 when it is called. Checks the shapes, finite logZ,
    iterations, evaluations and fill rounds within the tool's
    ``RATIO_BAR`` x the record's at the chunk that ends at the cap
    (``held_to_record``), and its first ``BENCH_EAGER_CHUNKS`` chunks bit
    for bit against their eager run (``compare_paths``).
    Prints the fit's record (per chunk too) beside the JAX package's;
    returns the fit's launches and the count kernel's record."""
    from massivedatans_tpu_torch.config import RunConfig
    from massivedatans_tpu_torch.muse.pipeline import fit_muse
    from tools import torch_muse_bench as bench
    from tools.torch_muse_validate import chunk_records

    with open(os.path.join(ROOT, BENCH_RECORD)) as fh:
        ref = json.load(fh)
    opts = dict(ref["options"], cap=BENCH_CAP)
    count_recs = [check_count_within(neighbors, gen, opts["proposal_batch"],
                                     MAIN_M, ndim, timed=True)
                  for ndim in (5, 3)]
    check_radius(neighbors, region, gen, MAIN_M, 5, NBOOT)
    neighbors.count_within.launches = 0
    neighbors.bootstrapped_sq_radius.launches = 0
    cfg = RunConfig(**bench.config_fields(opts))
    with tempfile.TemporaryDirectory() as tmp:
        cube, tpl = bench.load_bench_cube(tmp, opts["n_spaxels"],
                                          opts["nspec"])
        assert bench.cube_sha256(cube) == ref["cube_sha256"]

        def fit(eager=False, **run_opts):
            return fit_muse(cube, tpl, bench.ZLO, bench.ZHI, "FULL", cfg,
                            device=DEVICE, eager=eager, **run_opts)[0]

        _peak_reset()
        _sync()
        t0 = time.perf_counter()
        with chunk_records(group_every=bench.group_every(
                opts["nlive"], opts["n_spaxels"])) as per_chunk:
            result = fit()
        _sync()
        wall = time.perf_counter() - t0
        launches = read_counts(result)
        st = result.stats
        D, K = opts["n_spaxels"], opts["nlive"]
        held = bench.held_to_record(dict(
            niter=result.niterations, ndraws=result.ndraws,
            fill_rounds=st["fill_rounds"], options=opts,
            per_chunk=per_chunk), ref)
        print(json.dumps(dict(
            fit=f"tools/muse_bench.py's cube, {D} spaxels, nlive {K}, "
                f"cap {BENCH_CAP}", wall_s=wall, niter=result.niterations,
            ndraws=result.ndraws, fill_rounds=st["fill_rounds"],
            evals_per_s=result.ndraws / wall,
            member_overflow=st["member_overflow"], pile_peak=st["pile_peak"],
            chunks=st["chunks"], group_refreshes=st["group_refreshes"],
            n_groups_max=st["n_groups_max"], launches=launches,
            **path_stats(result), peak_mem_GB=_peak_gb(),
            timing=st["timing"], against_jax_record=held,
            per_chunk=per_chunk)))
        rows = result.niterations + K
        assert st["chunk_path"] == "graph", st["chunk_path"]
        assert result.u.shape == result.x.shape == (rows, D, 5), \
            result.u.shape
        assert result.logZ.shape == (D,) and np.isfinite(result.logZ).all()
        assert all(held["held"].values()), held["ratios"]
        del result  # about 1 GB of host records
        compare_paths(
            f"MUSE bench cube, first {BENCH_EAGER_CHUNKS} chunks",
            lambda eager: fit(eager, checkpoint_dir=os.path.join(
                tmp, "eager" if eager else "graph"),
                max_chunks=BENCH_EAGER_CHUNKS), neighbors)
    return launches, count_recs


def muse_seeds_phase(read_counts, neighbors):
    """Phase 14: the setting of ``SEEDS_RECORD`` (both packages' seeds of
    ``tools/muse_bench.py``'s cube at 100 spaxels where the fill budget
    binds), seed ``SEEDS_SEED``, on the captured path through
    ``tools/torch_muse_bench.py``'s cube and options; the launch counters
    must be 0 when it is called. Checks the cube's SHA-256, finite logZ,
    the stop at the cap, and the fit's evaluations, advances and
    evaluations per advance within the range of the record's JAX seeds
    widened by ``SEEDS_WIDEN`` each way (``advance_summary`` of its
    per-chunk records), and its first ``SEEDS_EAGER_CHUNKS`` chunks bit
    for bit against their eager run (``compare_paths``). Prints the fit's
    record beside the JAX seeds' range; returns its launches."""
    from massivedatans_tpu_torch.config import RunConfig
    from massivedatans_tpu_torch.muse.pipeline import fit_muse
    from tools import torch_muse_bench as bench
    from tools.torch_muse_validate import chunk_records

    with open(os.path.join(ROOT, SEEDS_RECORD)) as fh:
        ref = json.load(fh)
    opts = dict(bench.defaults(), **ref["setting"], seed=SEEDS_SEED)
    jax = [f for f in ref["fits"] if f["package"] == "jax"]
    ranges = {k: (min(f[k] for f in jax) / SEEDS_WIDEN,
                  max(f[k] for f in jax) * SEEDS_WIDEN) for k in SEEDS_HELD}
    cfg = RunConfig(**bench.config_fields(opts))
    with tempfile.TemporaryDirectory() as tmp:
        cube, tpl = bench.load_bench_cube(tmp, opts["n_spaxels"],
                                          opts["nspec"])
        assert bench.cube_sha256(cube) == ref["cube_sha256"]

        def fit(eager=False, **run_opts):
            return fit_muse(cube, tpl, bench.ZLO, bench.ZHI, "FULL", cfg,
                            device=DEVICE, eager=eager, **run_opts)[0]

        _sync()
        t0 = time.perf_counter()
        with chunk_records(group_every=bench.group_every(
                opts["nlive"], opts["n_spaxels"])) as per_chunk:
            result = fit()
        _sync()
        wall = time.perf_counter() - t0
        launches = read_counts(result)
        st = result.stats
        got = dict(ndraws=result.ndraws, **bench.advance_summary(
            per_chunk, per_chunk.per_spaxel, result.ndraws))
        held = {k: ranges[k][0] <= got[k] <= ranges[k][1]
                for k in SEEDS_HELD}
        print(json.dumps(dict(
            fit=f"tools/muse_bench.py's cube, {opts['n_spaxels']} spaxels, "
                f"fill budget {opts['fill_budget']}, cap {opts['cap']}, "
                f"seed {SEEDS_SEED}", wall_s=wall, niter=result.niterations,
            fill_rounds=st["fill_rounds"],
            member_overflow=st["member_overflow"], launches=launches,
            **path_stats(result), **got, jax_seeds=ref["seeds"]["jax"],
            jax_range_widened=ranges, held=held)))
        assert st["chunk_path"] == "graph", st["chunk_path"]
        assert np.isfinite(result.logZ).all()
        assert result.niterations == opts["cap"] + 1, result.niterations
        assert all(held.values()), (got, ranges)
        compare_paths(
            f"MUSE seed setting, first {SEEDS_EAGER_CHUNKS} chunks",
            lambda eager: fit(eager, checkpoint_dir=os.path.join(
                tmp, "eager" if eager else "graph"),
                max_chunks=SEEDS_EAGER_CHUNKS), neighbors)
    return launches


def validation_phase(read_counts, neighbors, muse_result, truths, muse_cap):
    """Phase 11: the reference's validation protocols on the captured path,
    through the tools that run them (``tools/torch_calib_parity.py``,
    ``tools/torch_posterior_recovery.py``): first
    ``tools/torch_muse_validate.py``'s analysis of phase 6's MUSE fit
    (capped at ``muse_cap``), with no bar; then the paired no-signal run,
    the headline no-signal run at 10^4 and the gen_simple(100) recovery,
    each held to its bars against the JAX package's records (every bar
    must apply: the stream is the record's) and each launching both
    kernels, ``count_within`` once per region round (``read_counts``).
    Prints the analysis and each run's record on lines of their own."""
    from tools import torch_calib_parity as calib
    from tools import torch_muse_validate as musev
    from tools import torch_posterior_recovery as recovery

    out = dict(logZ=muse_result.logZ, x=muse_result.x, L=muse_result.L,
               w=muse_result.w, mask=muse_result.mask)
    capped = musev.capped_mask(muse_result.mask, muse_result.niterations,
                               muse_cap)
    t0 = time.perf_counter()
    payload = musev.analyze(out, truths, capped, MUSE_NLIVE,
                            muse_result.stats)
    ex = payload["extra"]
    print(json.dumps(dict(
        analysis=f"tools/torch_muse_validate.py analyze of phase 6's fit "
                 f"(max_samples {muse_cap}), no bar",
        analysis_s=time.perf_counter() - t0, n_fit=ex["n_fit"],
        n_capped=ex["n_capped"], sbc_rank_ks=ex["sbc_rank_ks"],
        pull_coverage=ex["pull_coverage"],
        zbin_mode_accuracy=ex["zbin_mode_accuracy"],
        empty_evidence_identity=ex["empty_evidence_identity"],
        goodness_of_fit=ex["goodness_of_fit"],
        bars_at_tolerance=musev.bars(payload))))
    bars, path = {}, "graph" if DEVICE == "cuda" else "eager"
    runs = (("paired", lambda: calib.fit(DEVICE, 1000, 100, calib.PAIRED_CFG,
                                         neighbors)),
            ("headline", lambda: calib.fit(DEVICE, 10000, 10000, {},
                                           neighbors)),
            ("recovery", lambda: recovery.fit(DEVICE, 100, None, neighbors)))
    for name, run in runs:
        rec, res, *z_true = run()
        rec["launches"] = read_counts(res)
        assert rec["chunk_path"] == path, rec["chunk_path"]
        assert np.isfinite(res.logZ).all() and (res.logZerr > 0).all()
        held = (calib.paired_bars(rec, res) if name == "paired"
                else calib.headline_bars(rec) if name == "headline"
                else recovery.evaluate(rec, res, *z_true))
        assert held, f"{name}: the stream is not the JAX record's"
        bars.update(held)
        rec["bars"] = held
        print(json.dumps(rec), flush=True)
        del res
    print("validation bars:", json.dumps(bars))
    assert all(bars.values()), bars


def late_state_phase(neighbors):
    """Phase 12: the JAX MUSE run of record's late state (its checkpoint,
    iteration 7,001) loaded into the port with numpy
    (``tools/muse_rounds_from_state.py``, its spaxels stopped by the cap
    running again) on the card. Each running spaxel's live L is recomputed
    and held to a float64 witness and to the stored values at
    ``MUSE_CANCEL`` * yy (the fixture is the state's cube), and the
    decisions at its lowest live L that the card's likelihood and float64
    disagree on are counted and printed beside the JAX package's CPU
    count (``live_decisions``, no bar on the count); then
    ``LATE_BATCHES`` batches of each round kind (region, focus, column)
    and ``LATE_CHUNKS`` chunks of the engine (seed ``LATE_SEED``,
    captured, then eagerly: both must end in the same state bit for bit),
    between a reset and a read of the launch counters (both kernels must
    launch). Each kind's valid share, accepted share and radius, and the
    chunks' evaluations, fill rounds and running spaxels, are held to the
    JAX package's CPU numbers in ``LATE_RECORD``: they fail where they part
    from them by more than 4 standard errors (a chunk total's error is the
    port's spread over the record's seeds) and by more than 10 %. Prints
    the per-kind shares beside the record's and returns the counts."""
    from tools import muse_rounds_from_state as mrs

    with open(os.path.join(ROOT, LATE_RECORD)) as fh:
        ref = json.load(fh)
    state_file = os.path.join(ROOT, ref["state"])
    assert mrs.sha256_file(state_file) == ref["state_sha256"]
    raw, cap = mrs.state_arrays(os.path.dirname(state_file))
    arrays = mrs.reopen(raw)
    cfg = mrs.port_config(arrays)
    with tempfile.TemporaryDirectory() as tmp:
        cube, tpl, _ = muse_fixture(tmp)
        problem = mrs.port_problem(cube, tpl, DEVICE)
    t0 = time.perf_counter()
    live = mrs.live_check(problem, cube, arrays, MUSE_CANCEL)
    contour = mrs.live_decisions(problem, cube, arrays, MUSE_CANCEL)
    print(json.dumps(dict(late_state_live_check=live,
                          at_the_contour=contour,
                          jax_cpu_at_the_contour=ref["A"]["at_the_contour"])))
    assert live["held"] and live["spaxels"] == ref["running"], live
    assert contour["held"], contour
    state = mrs.port_labels(mrs.port_state(arrays, cap, DEVICE),
                            cfg.nlive_points)
    neighbors.count_within.launches = 0
    neighbors.bootstrapped_sq_radius.launches = 0
    kinds = mrs.port_kinds(problem, state, cfg, LATE_BATCHES)
    chunks = mrs.port_chunks(problem, arrays, cap, cfg, LATE_SEED,
                             LATE_CHUNKS, DEVICE)
    _sync()
    counts = dict(count_within=neighbors.count_within.launches,
                  bootstrapped_sq_radius=neighbors.bootstrapped_sq_radius.launches)
    wall = time.perf_counter() - t0
    eager = mrs.port_chunks(problem, arrays, cap, cfg, LATE_SEED,
                            LATE_CHUNKS, DEVICE, eager=True)
    keys = ("niter", "fill_rounds", "ndraws", "running", "member_overflow",
            "n_groups")
    bitwise = (eager[-1]["digest"] == chunks[-1]["digest"]
               and all(e[k] == c[k] for e, c in zip(eager, chunks)
                       for k in keys))
    jax_kinds = ref["B"]["jax"]
    held = {f"{kind}.{k}": not mrs.differs(jax_kinds[kind][k],
                                           kinds[kind][k])
            for kind in mrs.KINDS for k in LATE_HELD
            if jax_kinds[kind][k] is not None}
    # what the chunks added to the state's counts, against the record's
    runs, start = ref["C"]["runs"], ref["C"]["start"]
    jax_totals = mrs.chunk_totals(runs["jax"], start)
    port_totals = mrs.chunk_totals(runs["torch"], start)
    card = {k: v[0] for k, v in mrs.chunk_totals([chunks], start).items()}
    for k in ("fill_rounds", "ndraws", "running"):
        spread = float(np.std(port_totals[k], ddof=1))
        held[f"chunks.{k}"] = not mrs.differs(
            (card[k], spread), mrs.mean_se(jax_totals[k]))
    print(json.dumps(dict(
        late_state=f"{ref['state']} (iteration {ref['iteration']}, "
                   f"{ref['running']} spaxels reopened) on the card",
        kinds={kind: {k: kinds[kind][k] for k in ("valid_share",
                                                  "accepted_share",
                                                  "radius", "overflow")}
               for kind in mrs.KINDS},
        jax_cpu={kind: {k: jax_kinds[kind][k] for k in (
            "valid_share", "accepted_share", "radius", "overflow")}
            for kind in mrs.KINDS},
        chunks=chunks, added=card, jax_cpu_added={
            k: mrs.mean_se(v) for k, v in jax_totals.items()},
        eager_bitwise=bitwise, launches=counts, wall_s=wall, held=held)))
    assert counts["count_within"] > 0, counts
    assert counts["bootstrapped_sq_radius"] > 0, counts
    assert bitwise, (chunks, eager)
    assert all(held.values()), held
    return counts


def strategy_fit(run_fit, cfg, data, ndata, quad, neighbors, device=DEVICE):
    """Fit the first ``ndata`` horns spectra with ``cfg.constrainer``,
    print its record and check the path and the shapes: no region kernel
    launched, finite evidences, logZerr > 0. Returns the launch counts, how
    many of the datasets held lie within 3 logZerr + 0.5 of the quadrature
    oracle ``quad``, and how many are held: the first 100, or where
    ``cfg.max_samples`` caps the fit, those of them that stopped at
    tolerance before the cap."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    result = run_fit(data["x"], data["y"][:, :ndata], cfg, device,
                     noise_level=data["noise_level"])
    sync()
    wall = time.perf_counter() - t0
    counts = launch_counts(neighbors, result, regions=False)
    nq = min(len(quad), ndata)
    dq = np.abs(result.logZ[:nq] - quad[:nq])
    held = stopped_before_cap(result, cfg.max_samples, nq)
    within = int((dq < 3 * result.logZerr[:nq] + 0.5)[held].sum())
    rec = dict(
        fit=f"horns ndata={ndata} nlive={cfg.nlive_points} "
            f"constrainer={cfg.constrainer} max_samples={cfg.max_samples} "
            f"seed={cfg.seed}",
        wall_s=wall, niter=result.niterations, ndraws=result.ndraws,
        fill_rounds=result.stats["fill_rounds"],
        rounds_per_iter=result.stats["fill_rounds"] / max(result.niterations, 1),
        launches=counts, member_overflow=result.stats["member_overflow"],
        stalled=result.stats["stalled"], **path_stats(result),
        timing=result.stats["timing"], quad_within=within, quad_held=int(held.sum()), quad_n=nq,
        median_dlogZ_held=float(np.median(dq[held])) if held.any() else None,
        max_dlogZ_held=float(dq[held].max(initial=0.0)))
    print(json.dumps(rec))
    # the path claimed: no union-of-balls region, so neither kernel
    assert counts == dict(count_within=0, bootstrapped_sq_radius=0,
                          region_rounds=0), counts
    assert result.logZ.shape == (ndata,) and np.isfinite(result.logZ).all()
    assert (result.logZerr > 0).all()
    assert result.u.shape == (result.niterations + cfg.nlive_points, ndata, 3)
    return counts, within, int(held.sum())


def stopped_before_cap(result, cap, n):
    """Which of the first ``n`` datasets count as stopped at tolerance:
    all of them in an uncapped fit; where ``cap`` iterations cap it, those
    not stalled that stopped before the cap (it stops those still running
    one iteration past it)."""
    if not cap:
        return np.ones(n, bool)
    ran = result.mask[:result.niterations, :n].sum(axis=0)
    return (ran <= cap) & ~result.stats["stalled_mask"][:n]


def resume_phase(run_fit, cfg, data, full, ckpt_dir, neighbors):
    """Preempt the horns fit ``full`` (phase 4's at ``cfg``, lookahead 0)
    halfway through its chunks, resume it from the checkpoint with a fresh
    generator seeded alike, and check that the two legs give its result
    bit for bit, on the captured path. Returns the launch counts."""
    max_chunks = full.stats["chunks"] // 2
    legs = []
    for leg in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run_fit(data["x"], data["y"], cfg, DEVICE,
                    noise_level=data["noise_level"], checkpoint_dir=ckpt_dir,
                    checkpoint_every=10,
                    max_chunks=max_chunks if leg == 0 else None)
        torch.cuda.synchronize()
        legs.append((r, time.perf_counter() - t0))
    (part, wall0), (resumed, wall1) = legs
    nbytes = sum(os.path.getsize(os.path.join(ckpt_dir, f))
                 for f in os.listdir(ckpt_dir))
    same = {k: bool(np.array_equal(getattr(resumed, k), getattr(full, k)))
            for k in ("logZ", "logZerr", "L", "u", "x", "w", "mask")}
    print(json.dumps(dict(
        fit=f"horns ndata={data['y'].shape[1]} nlive={cfg.nlive_points} "
            f"preempted at chunk {max_chunks} of {full.stats['chunks']}, "
            "then resumed",
        wall_s=[wall0, wall1], niter=[part.niterations, resumed.niterations],
        checkpoint_bytes=nbytes, checkpoint_files=len(os.listdir(ckpt_dir)),
        checkpoint_s=[part.stats["timing"]["checkpoint_s"],
                      resumed.stats["timing"]["checkpoint_s"]],
        init_s=[part.stats["timing"]["init_s"],
                resumed.stats["timing"]["init_s"]],
        bitwise=same)))
    assert part.stats["interrupted"] and not resumed.stats["interrupted"]
    assert part.stats["chunks"] == max_chunks > 0
    assert part.stats["chunk_path"] == resumed.stats["chunk_path"] == "graph"
    assert all(same.values()), same
    assert (resumed.niterations, resumed.ndraws, resumed.stats["fill_rounds"]) \
        == (full.niterations, full.ndraws, full.stats["fill_rounds"])
    counts = {k: launch_counts(neighbors, r)["region_rounds"]
              for k, r in (("part", part), ("resumed", resumed))}
    return dict(count_within=neighbors.count_within.launches,
                bootstrapped_sq_radius=neighbors.bootstrapped_sq_radius.launches,
                region_rounds=counts["part"] + counts["resumed"])


def _sync_on(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _fit_digest(res):
    """What the bitwise bars hold of a fit: logZ, logZerr, iterations,
    evaluations, fill rounds and the L, u, w and mask records by
    SHA-256."""
    return dict(logZ=res.logZ, logZerr=res.logZerr, niter=res.niterations,
                ndraws=res.ndraws, fill_rounds=res.stats["fill_rounds"],
                **{f"sha_{k}": _sha(getattr(res, k))
                   for k in ("L", "u", "w", "mask")})


def _bitwise(a, b):
    """Key by key, whether two ``_fit_digest``s are equal bit for bit."""
    return {k: bool(np.array_equal(a[k], b[k])) for k in a}


def _sharded_fit_rank(rank, data, cfg, model_parallel=1, eager=False):
    """One rank of a sharded horns fit: counters to 0, the fit on the
    mesh (``model_parallel`` ranks on the spectral axis; ``eager``: the
    steps run eagerly), counters read. Returns the rank's record (and, on
    rank 0, the result's digest and stats)."""
    from massivedatans_tpu_torch.cli import run_fit
    from massivedatans_tpu_torch.ns import engine
    from massivedatans_tpu_torch.ops import neighbors
    from massivedatans_tpu_torch.parallel import sharded

    t0 = time.perf_counter()
    mesh = sharded.make_mesh(rank.world, model_parallel,
                             rank.mesh_device_type)
    # the first collective (a gloo group makes its connections here)
    sharded.global_any(torch.ones(1, device=rank.device),
                       sharded.data_axis(mesh)[0])
    setup_s = time.perf_counter() - t0
    steps, replayed = _count_steps(engine)
    neighbors.count_within.launches = 0
    neighbors.bootstrapped_sq_radius.launches = 0
    for k in sharded.CALLS:
        sharded.CALLS[k] = 0
    _sync_on(rank.device)
    t0 = time.perf_counter()
    res = run_fit(data["x"], data["y"], cfg, rank.device,
                  noise_level=data["noise_level"], mesh=mesh, eager=eager)
    _sync_on(rank.device)
    rec = dict(
        wall_s=time.perf_counter() - t0, setup_s=setup_s,
        calls=dict(sharded.CALLS), graph_replays=sum(replayed.values()),
        launches=dict(count_within=neighbors.count_within.launches,
                      bootstrapped_sq_radius=neighbors.bootstrapped_sq_radius.launches,
                      region_rounds=steps["region"] + steps["focus"]))
    if res is not None:  # rank 0; the other ranks return no result
        rec.update(timing=res.stats["timing"], digest=_fit_digest(res),
                   member_overflow=res.stats["member_overflow"],
                   **path_stats(res))
    return rec


def _against(got, ref, rtol, atol, scale=None):
    """``got`` against ``ref`` (``[B, D]``; dead rows -inf in both) at the
    bar ``atol + rtol |ref|``, plus ``scale[d]`` where given: the largest
    error, its largest ratio to the bar and the entries beyond it."""
    dead = torch.isneginf(ref)
    err = torch.where(dead, 0.0, (got.double() - ref.double()).abs())
    bar = atol + rtol * torch.where(dead, 0.0, ref.double().abs())
    if scale is not None:
        bar = bar + scale[None, :]
    return dict(max_abs_err=float(err.max()),
                max_err_over_bar=float((err / bar).max()),
                beyond=int((err > bar).sum()),
                dead_rows_match=bool(torch.equal(torch.isneginf(got), dead)),
                finite=bool(torch.isfinite(got[~dead]).all()))


def _muse_witness(md, cube, x):
    """The MUSE likelihood of ``x`` in float64 from the same templates,
    spectra and candidates, and its ``yy``."""
    import copy

    from massivedatans_tpu_torch.muse.likelihood import (
        muse_weights,
        scaled_loglike_batch,
    )

    f64 = dict(dtype=torch.float64, device=x.device)
    y_over_v, inv_v, yy = (torch.as_tensor(a, **f64)
                           for a in muse_weights(cube.y, cube.var))
    md64 = copy.deepcopy(md).double()
    return scaled_loglike_batch(md64, y_over_v, inv_v, yy, x.double()), yy


def _mp_likelihood_rank(rank, data, cube, tpl):
    """The gaussline and MUSE likelihoods of one fill round's candidates on
    a (data 1, model 2) mesh: gaussline against the single-device one at
    the JAX test's bar; MUSE, single-device, sharded and with TF32 on,
    against a float64 witness (``MUSE_CANCEL``)."""
    from massivedatans_tpu_torch.config import set_fp32_precision
    from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem
    from massivedatans_tpu_torch.muse.likelihood import make_muse_problem
    from massivedatans_tpu_torch.muse.model import load_template_grid
    from massivedatans_tpu_torch.parallel import sharded

    set_fp32_precision()
    mesh = sharded.make_mesh(rank.world, 2, rank.mesh_device_type)
    group = sharded.model_axis(mesh)[0]
    gen = torch.Generator(device=rank.device).manual_seed(7)
    md = load_template_grid(tpl, data_wl_nm=cube.wavelength_nm, zlo=0.0,
                            zhi=0.5, device=rank.device)
    gl = make_gaussline_problem(data["x"], data["y"], data["noise_level"],
                                device=rank.device)
    mu = make_muse_problem(md, cube.y, cube.var)
    out = {}
    for name, problem in dict(gaussline=gl, muse=mu).items():
        u = torch.rand((MP_BATCH, problem.ndim), generator=gen,
                       device=rank.device)
        x = problem.transform_batch(u)
        single = problem.loglike(x)
        got = sharded.shard_problem(problem, mesh).loglike_sharded(x, group)
        rec = dict(shape=list(got.shape),
                   dead_rows=int(torch.isneginf(single).all(1).sum()),
                   sharded_vs_single=_against(got, single, *MP_TOL[name]))
        if name == "muse":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.set_float32_matmul_precision("high")
            tf32 = problem.loglike(x)
            set_fp32_precision()
            ref, yy = _muse_witness(md, cube, x)
            rec.update(yy_max=float(yy.max()), **{
                f"{k}_vs_f64": _against(v, ref, *MP_TOL[name],
                                        MUSE_CANCEL * yy)
                for k, v in dict(single=single, sharded=got,
                                 tf32=tf32).items()},
                single_vs_f64_plain=_against(single, ref, *MP_TOL[name]))
        _sync_on(rank.device)
        out[name] = rec
    return out


def sharded_fit(world, backend, data, cfg, single, single_launches,
                single_wall, quad, model_parallel=1, eager=False):
    """The horns fit of ``data`` on a mesh of ``world`` ranks, each on a
    card (``backend``; ``model_parallel`` ranks on the spectral axis;
    ``eager``: the steps run eagerly), held against the single-device fit
    ``single`` (its launches and wall beside): bit for bit at one rank,
    the quadrature bar ``quad`` always, both kernels on every rank. The
    chunk path must be the one the groups allow: captured under NCCL
    (graph replays in every rank), eager under gloo or ``eager``. Prints
    and returns its record; ``rec["ranks"]`` holds every rank's (rank 0's
    with the result's digest), which the record printed leaves out."""
    from massivedatans_tpu_torch.parallel import spawn_ranks

    nq = len(quad)
    t0 = time.perf_counter()
    ranks = spawn_ranks(_sharded_fit_rank, world, backend, DEVICE,
                        SHARDED_TIMEOUT_S, data, cfg, model_parallel, eager)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    d0 = r0["digest"]
    dq = np.abs(d0["logZ"][:nq] - quad)
    within = int((dq < 3 * d0["logZerr"][:nq] + 0.5).sum())
    rounds, niter = d0["fill_rounds"], d0["niter"]
    rec = dict(
        fit=f"horns ndata={data['y'].shape[1]} nlive={cfg.nlive_points}",
        world=world, backend=backend, model_parallel=model_parallel,
        ranks_per_card=(-(-world // max(1, torch.cuda.device_count()))
                        if backend == "gloo" else 1),
        chunk_path=r0["chunk_path"],
        graph_replays_ranks=[r["graph_replays"] for r in ranks],
        graph_replays_per_iter=r0["graph_replays_per_iter"],
        host_syncs_per_iter=r0["host_syncs_per_iter"],
        capture_s=r0["capture_s"],
        wall_s=r0["wall_s"], wall_s_ranks=[r["wall_s"] for r in ranks],
        setup_s=r0["setup_s"], spawn_s=spawn_s,
        wall_s_single=single_wall, niter=niter,
        niter_single=single.niterations, ndraws=d0["ndraws"],
        ndraws_single=single.ndraws, fill_rounds=rounds,
        fill_rounds_single=single.stats["fill_rounds"],
        all_reduce_per_round=r0["calls"]["all_reduce"] / rounds,
        all_gather_per_round=r0["calls"]["all_gather"] / rounds,
        wall_ms_per_round=1e3 * r0["wall_s"] / rounds,
        wall_ms_per_round_single=1e3 * single_wall
        / single.stats["fill_rounds"],
        calls=r0["calls"], launches=[r["launches"] for r in ranks],
        member_overflow=r0["member_overflow"], timing=r0["timing"],
        quad_within=within, quad_held=nq)
    if world == 1:
        rec["bitwise"] = _bitwise(d0, _fit_digest(single)) | dict(
            launches=r0["launches"] == single_launches)
    else:
        dz = np.abs(d0["logZ"] - single.logZ)
        rec.update(max_abs_dlogZ_vs_single=float(dz.max()),
                   datasets_bitwise_vs_single=int((dz == 0).sum()))
    print(json.dumps({k: v for k, v in rec.items() if k != "timing"}))
    rec["ranks"] = ranks
    captured = backend == "nccl" and not eager
    assert r0["chunk_path"] == ("graph" if captured else "eager"), r0
    for r in ranks:  # every rank ran both kernels, one count per round
        assert (r["graph_replays"] > 0) == captured, r["graph_replays"]
        c = r["launches"]
        assert c["count_within"] > 0 and c["bootstrapped_sq_radius"] > 0, c
        assert c["count_within"] == c["region_rounds"], c
    assert np.isfinite(d0["logZ"]).all() and (d0["logZerr"] > 0).all()
    assert within >= int(np.ceil(0.95 * nq)), (world, backend, within)
    if world == 1:
        assert all(rec["bitwise"].values()), rec["bitwise"]
    return rec


def hold_paths(graph, eager):
    """Two ``sharded_fit`` records of one mesh, captured and eager, held
    bit for bit: the result's digest, and in every rank the kernels'
    launches and the collective calls. Prints and returns the record."""
    ranks = list(zip(graph["ranks"], eager["ranks"], strict=True))
    rec = dict(world=graph["world"], model_parallel=graph["model_parallel"],
               wall_s_graph=graph["wall_s"], wall_s_eager=eager["wall_s"],
               bitwise=_bitwise(graph["ranks"][0]["digest"],
                                eager["ranks"][0]["digest"]) | dict(
                   launches=all(g["launches"] == e["launches"]
                                for g, e in ranks),
                   calls=all(g["calls"] == e["calls"] for g, e in ranks)))
    print(json.dumps({"paths_sharded": rec}))
    assert all(rec["bitwise"].values()), rec
    return rec


def sharded_phase(data, cfg, single, single_launches, single_wall, quad,
                  fixture):
    """Phase 9 (see the module docstring). Returns the records."""
    from massivedatans_tpu_torch.parallel import spawn_ranks

    cards = torch.cuda.device_count() if DEVICE == "cuda" else 0
    runs = [(1, "nccl" if DEVICE == "cuda" else "gloo"), (2, "gloo")]
    if cards >= 2:
        runs.append((min(cards, 4), "nccl"))
    recs = [sharded_fit(world, backend, data, cfg, single, single_launches,
                        single_wall, quad) for world, backend in runs]
    for r in recs:  # every rank's own records stay out of the smoke's line
        r.pop("ranks")
    cube, tpl, _ = fixture
    t0 = time.perf_counter()
    mp = spawn_ranks(_mp_likelihood_rank, 2, "gloo", DEVICE,
                     SHARDED_TIMEOUT_S, data, cube, tpl)
    rec = dict(likelihoods="model parallel, data 1 x model 2, gloo, one card",
               batch=MP_BATCH, tolerances=MP_TOL, muse_cancel=MUSE_CANCEL,
               ranks=mp, spawn_s=time.perf_counter() - t0)
    recs.append(rec)
    print(json.dumps(rec))
    held = [r["gaussline"]["sharded_vs_single"] for r in mp] + [
        r["muse"][k] for r in mp for k in ("single_vs_f64", "sharded_vs_f64")]
    assert all(h["beyond"] == 0 and h["dead_rows_match"] and h["finite"]
               for h in held), mp
    # the bar tells a TF32 contraction from a float32 one
    assert all(r["muse"]["tf32_vs_f64"]["beyond"] > 0 for r in mp), mp
    return recs


def muse_fixture(tmp):
    """Build the MUSE fixture in ``tmp`` (``tools/torch_muse_validate.py``'s
    ``build_fixture``); returns ``(cube, templates, truths)``."""
    from tools.torch_muse_validate import build_fixture

    t0 = time.perf_counter()
    fixture = build_fixture(tmp, MUSE_SIDE, MUSE_NSPEC, MUSE_SEED, MUSE_FLUX)
    print(f"MUSE fixture built in {time.perf_counter() - t0:.2f} s")
    return fixture


def muse_fit(fixture, cap, progress=False, run_opts=None, **cfg_changes):
    """Fit the MUSE fixture (FULL, nlive 400, tolerance 0.5) capped at
    ``cap`` iterations (0: none); ``run_opts`` go to the integrator
    (checkpoint_dir, max_chunks). Returns ``(result, problem)``."""
    from massivedatans_tpu_torch.config import RunConfig
    from massivedatans_tpu_torch.muse.pipeline import fit_muse

    cube, tpl, _ = fixture
    cfg = RunConfig(nlive_points=MUSE_NLIVE, tolerance=0.5, max_samples=cap,
                    **cfg_changes)
    # progress lines (iteration, draws, it/s) go to stderr
    return fit_muse(cube, tpl, 0.0, 0.5, "FULL", cfg, device=DEVICE,
                    progress=progress, **(run_opts or {}))


def muse_check(fixture, cap, **cfg_changes):
    """Fit the MUSE fixture, print its record, check the shapes and the
    no-star identity on the empty spaxels; returns the record and the
    result."""
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, problem = muse_fit(fixture, cap, progress=True, **cfg_changes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = MUSE_SIDE * MUSE_SIDE
    truths = fixture[2]
    empty = np.asarray(truths["empty"], bool)[:n]
    yy = np.asarray(truths["yy"], np.float64)[:n]
    identity = result.logZ[empty] + yy[empty] / 2
    med = float(np.median(identity)) if empty.any() else float("nan")
    rec = dict(
        fit=f"MUSE FULL spaxels={problem.ndata} nspec={fixture[0].y.shape[0]} "
            f"nlive={MUSE_NLIVE} max_samples={cap} {cfg_changes or ''}".strip(),
        wall_s=wall, niter=result.niterations,
        ndraws=result.ndraws, fill_rounds=result.stats["fill_rounds"],
        big_batch_chunks=result.stats["big_batch_chunks"],
        chunks=result.stats["chunks"],
        member_overflow=result.stats["member_overflow"],
        stalled=result.stats["stalled"], timing=result.stats["timing"],
        peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9,
        n_empty=int(empty.sum()), median_logZ_plus_half_yy=med,
        max_abs_logZ_plus_half_yy=float(np.abs(identity).max(initial=0.0)))
    print(json.dumps(rec))
    rows = result.niterations + MUSE_NLIVE
    assert result.u.shape == (rows, n, 5), result.u.shape
    assert result.x.shape == (rows, n, 5) and result.L.shape == (rows, n)
    assert result.logZ.shape == (n,) and np.isfinite(result.logZ).all()
    assert (result.logZerr > 0).all()
    assert empty.any() and abs(med) <= EMPTY_IDENTITY_BAR, med
    return rec, result


def profile(fit, path):
    """Time a short capped fit without and with the profiler; write the
    per-kernel device-time tables and the device busy share (kernel time
    over the unprofiled wall)."""

    def run():
        fit()
        torch.cuda.synchronize()

    run()  # warm-up
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    events = _profiled(run)
    busy = _kernel_us(events) / 1e6
    cuda = torch.autograd.DeviceType.CUDA
    ours = {e.key: (e.count, e.self_device_time_total) for e in events
            if e.device_type == cuda and ("count_within" in e.key
                                          or "bootstrap_radius" in e.key)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(f"capped fit: wall {wall:.3f} s unprofiled, device kernel "
                 f"time {busy:.3f} s, busy share {busy / wall:.4f}\n")
        for k, (n, us) in ours.items():
            fh.write(f"{k}: {n} launches, {us / max(n, 1):.2f} us each\n")
        fh.write(events.table(sort_by="self_device_time_total", row_limit=40,
                              max_name_column_width=70))
        fh.write("\n")
        fh.write(events.table(sort_by="self_cpu_time_total", row_limit=40,
                              max_name_column_width=70))
    print(f"profile: capped fit wall {wall:.3f} s, device kernel time "
          f"{busy:.3f} s (busy share {busy / wall:.4f}) -> {path}")
    for k, (n, us) in ours.items():
        print(f"  {k[:60]}: {n} launches, {us / max(n, 1):.2f} us each")


if __name__ == "__main__":
    sys.exit(main())
