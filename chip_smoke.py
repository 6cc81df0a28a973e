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
- MUSE: the ``tools/muse_validate.py`` fixture (7 Z x 111 ages x 400 wl
  templates, a 10x10 model-family cube of nspec 3600, seed 11, flux
  0.1-1.0) built with the port's ``synth``, then ``fit_muse`` (the core of
  ``python -m massivedatans_tpu_torch musefit``) with the FULL model (ndim
  5), nlive 400, tolerance 0.5, capped at ``--muse-max-samples``
  iterations (default 2500, which keeps the whole script near 5 min; 0
  runs to tolerance).

Phases, each of which raises on failure:

1. require ``torch.cuda.is_available()``; print the card's name and power
   limit; turn TF32 off and assert it;
2. build the kernels with nvcc and print the build seconds;
3. compare each kernel with its plain version at the horns shapes (ndim 3)
   and the MUSE shapes (ndim 5), each also at M=16384; time both at the
   main-path shapes with CUDA events over 200 launches;
4. reset the launch counters, run the horns fit, read the counters (each
   kernel must have launched), check the result's shapes, that logZ is
   finite, and that >= 95 of the first 100 datasets lie within
   3 logZerr + 0.5 of the quadrature oracle ``quad_logZ.json``;
5. reset the counters, run the MUSE fit, read the counters (each kernel
   must have launched), check the shapes, that logZ is finite with
   logZerr > 0, and the no-star identity on the empty spaxels:
   |median(logZ + yy/2)| <= 1;
6. print one JSON line of kernel records, then the ``{"ok": true, ...}``
   line last.

Exits non-zero without a result line when there is no CUDA card or the
package is missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TIMING_LAUNCHES = 200
COUNT_SHAPE = dict(N=256, M=1664, ndim=3)   # proposal_batch/2 x member cap
RADIUS_SHAPE = dict(M=1664, ndim=3, nb=10)  # member cap x nbootstraps
COUNT_SHAPE_MUSE = dict(COUNT_SHAPE, ndim=5)    # MUSE FULL
RADIUS_SHAPE_MUSE = dict(RADIUS_SHAPE, ndim=5)
LARGE_M = 16384
MUSE_SIDE, MUSE_NSPEC, MUSE_SEED = 10, 3600, 11  # tools/muse_validate.py
MUSE_FLUX = (0.1, 1.0)
PROFILE_SAMPLES, PROFILE_SAMPLES_MUSE = 300, 2000  # the MUSE fit's costly
# rounds come late: it reaches 2,000 iterations in about 30 s on the H100
EMPTY_IDENTITY_BAR = 1.0  # |median(logZ + yy/2)| over empty spaxels
RADIUS_RTOL = 1e-5
TIE_BAND = 1e-4  # |d - r| below which a count may differ (f32 vs f64)
DEVICE = "cuda"


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
    ``n`` calls launch, from a profiler trace (host gaps excluded)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return _kernel_us(prof.key_averages()) / n / 1e3


def _kernel_us(events):
    """Summed device time of the kernel records (not of the ops that
    launched them, which would count each kernel twice)."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in events
               if e.device_type == cuda)


def _timed(rec, kernel, plain):
    """Host-clock CUDA-event time and device time per call, in turns."""
    rec["ms"] = _time_ms(kernel)
    rec["plain_ms"] = _time_ms(plain)
    rec["device_ms"] = _device_ms(kernel)
    rec["plain_device_ms"] = _device_ms(plain)
    print("  timing", json.dumps({k: rec[k] for k in (
        "ms", "plain_ms", "device_ms", "plain_device_ms")}))


def check_count_within(neighbors, gen, N, M, ndim, timed=False):
    dev = DEVICE
    members = torch.randn((M, ndim), generator=gen, device=dev)
    mask = torch.arange(M, device=dev) < (M - M // 7)  # non-divisible count
    points = 3.0 * (2.0 * torch.rand((N, ndim), generator=gen, device=dev) - 1.0)
    radius = torch.tensor(0.45, device=dev)
    got = neighbors.count_within(members, mask, points, radius)
    want = neighbors.count_within_plain(members, mask, points, radius)
    torch.cuda.synchronize()
    d = torch.cdist(points.double(), members.double())
    ties = ((d - radius.double()).abs() < TIE_BAND)[:, mask].sum(dim=1)
    diff = (got.long() - want.long()).abs()
    bad = int((diff > ties).sum())
    rec = dict(shape=f"N={N} M={M} ndim={ndim}", max_abs_err=int(diff.max()),
               mismatches_outside_tie_band=bad,
               exact_equal=bool(torch.equal(got, want)))
    print("count_within", json.dumps(rec))
    assert got.shape == (N,) and got.dtype == torch.int32
    assert bad == 0, rec
    if timed:
        _timed(rec, lambda: neighbors.count_within(members, mask, points, radius),
               lambda: neighbors.count_within_plain(members, mask, points, radius))
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
    print("bootstrapped_sq_radius", json.dumps(rec))
    assert got.shape == () and got.dtype == torch.float32
    assert np.isfinite(float(got)) and float(got) > 0, rec
    assert err <= RADIUS_RTOL * abs(float(want)), rec
    if timed:
        _timed(rec, lambda: neighbors.bootstrapped_sq_radius(w, mask, inbag),
               lambda: neighbors.bootstrapped_sq_radius_plain(w, mask, inbag))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile-out", default=None,
                    help="also profile capped horns and MUSE fits "
                         f"({PROFILE_SAMPLES} and {PROFILE_SAMPLES_MUSE} "
                         "iterations) and write the kernel tables here")
    ap.add_argument("--muse-max-samples", type=int, default=2500,
                    help="iteration cap of the MUSE fit (0: run to "
                         "tolerance)")
    args = ap.parse_args(argv)

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
    from massivedatans_tpu.config import RunConfig
    from massivedatans_tpu.datagen.generators import gen_horns
    from massivedatans_tpu_torch.cli import run_fit
    from massivedatans_tpu_torch.config import set_fp32_precision
    from massivedatans_tpu_torch.ns import region
    from massivedatans_tpu_torch.ops import _build, neighbors

    # --- phase 1: the card ---
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    set_fp32_precision()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False

    # --- phase 2: build ---
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({os.path.relpath(_build.library_path(), ROOT)})")

    # --- phase 3: kernels vs plain versions ---
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    cw = check_count_within(neighbors, gen, **COUNT_SHAPE, timed=True)
    check_count_within(neighbors, gen, **dict(COUNT_SHAPE, M=LARGE_M))
    rr = check_radius(neighbors, region, gen, **RADIUS_SHAPE, timed=True)
    check_radius(neighbors, region, gen, **dict(RADIUS_SHAPE, M=LARGE_M))
    cw5 = check_count_within(neighbors, gen, **COUNT_SHAPE_MUSE, timed=True)
    check_count_within(neighbors, gen, **dict(COUNT_SHAPE_MUSE, M=LARGE_M))
    rr5 = check_radius(neighbors, region, gen, **RADIUS_SHAPE_MUSE, timed=True)
    check_radius(neighbors, region, gen, **dict(RADIUS_SHAPE_MUSE, M=LARGE_M))

    # --- phase 4: the horns path ---
    cfg = RunConfig()
    data = gen_horns(1000)
    neighbors.count_within.launches = 0
    neighbors.bootstrapped_sq_radius.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = run_fit(data["x"], data["y"], cfg, DEVICE, noise_level=data["noise_level"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(count_within=neighbors.count_within.launches,
                    bootstrapped_sq_radius=neighbors.bootstrapped_sq_radius.launches)
    print(json.dumps(dict(
        fit=f"horns ndata={data['y'].shape[1]} nlive={cfg.nlive_points}",
        wall_s=wall, niter=result.niterations, ndraws=result.ndraws,
        fill_rounds=result.stats["fill_rounds"], launches=launches,
        member_overflow=result.stats["member_overflow"],
        timing=result.stats["timing"],
        peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9)))
    assert all(n > 0 for n in launches.values()), launches
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

    # --- phase 5: the MUSE path ---
    with tempfile.TemporaryDirectory() as tmp:
        muse_launches, muse_fit = muse_phase(neighbors, args.muse_max_samples,
                                             tmp)
        if args.profile_out:
            profile(lambda: run_fit(data["x"], data["y"], dataclasses.replace(
                cfg, max_samples=PROFILE_SAMPLES), DEVICE,
                noise_level=data["noise_level"]), args.profile_out)
            root, ext = os.path.splitext(args.profile_out)
            profile(lambda: muse_fit(PROFILE_SAMPLES_MUSE),
                    root + "_muse" + ext)

    # --- phase 6: records ---
    src = "massivedatans_tpu_torch/csrc/neighbors.cu"
    print(json.dumps({"kernels": [
        dict(name="count_within", route="cuda", source=src,
             replaces="massivedatans_tpu/ops/pallas_neighbors.py:69",
             launches=launches["count_within"], max_abs_err=cw["max_abs_err"],
             ms=cw["ms"], plain_ms=cw["plain_ms"],
             launches_muse=muse_launches["count_within"],
             max_abs_err_ndim5=cw5["max_abs_err"], ms_ndim5=cw5["ms"],
             plain_ms_ndim5=cw5["plain_ms"]),
        dict(name="bootstrapped_sq_radius", route="cuda", source=src,
             replaces="massivedatans_tpu/ops/pallas_neighbors.py:158",
             launches=launches["bootstrapped_sq_radius"],
             max_abs_err=rr["max_abs_err"], ms=rr["ms"],
             plain_ms=rr["plain_ms"],
             launches_muse=muse_launches["bootstrapped_sq_radius"],
             max_abs_err_ndim5=rr5["max_abs_err"], ms_ndim5=rr5["ms"],
             plain_ms_ndim5=rr5["plain_ms"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def muse_phase(neighbors, max_samples, tmp):
    """Build the MUSE fixture in ``tmp``, fit it with the launch counters
    reset, check the result; returns the launch counts of the fit and a
    ``fit(max_samples)`` callable for the profiler."""
    from massivedatans_tpu.config import RunConfig
    from massivedatans_tpu_torch.muse import synth
    from massivedatans_tpu_torch.muse.pipeline import fit_muse, load_muse_cube

    t0 = time.perf_counter()
    tpl = synth.make_template_files(os.path.join(tmp, "templates"))
    n = MUSE_SIDE * MUSE_SIDE
    cube_path, reg, truths_path = synth.make_model_cube(
        os.path.join(tmp, f"model_cube_{n}.fits"),
        os.path.join(tmp, f"sel_{n}.reg"), tpl,
        os.path.join(tmp, f"truths_{n}.json"), ny=MUSE_SIDE, nx=MUSE_SIDE,
        nspec=MUSE_NSPEC, seed=MUSE_SEED, flux_lo=MUSE_FLUX[0],
        flux_hi=MUSE_FLUX[1])
    # the synthetic cube has no sky residuals: no bad-window inflation
    cube = load_muse_cube(cube_path, reg, maxdata=n, bad_windows=[])
    with open(truths_path) as fh:
        truths = json.load(fh)
    fixture_s = time.perf_counter() - t0
    cfg = RunConfig(nlive_points=400, tolerance=0.5, max_samples=max_samples)

    def fit(cap):
        # progress lines (iteration, draws, it/s) go to stderr
        return fit_muse(cube, tpl, 0.0, 0.5, "FULL",
                        dataclasses.replace(cfg, max_samples=cap),
                        device=DEVICE, progress=cap == max_samples)

    neighbors.count_within.launches = 0
    neighbors.bootstrapped_sq_radius.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, problem = fit(max_samples)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(count_within=neighbors.count_within.launches,
                    bootstrapped_sq_radius=neighbors.bootstrapped_sq_radius.launches)
    empty = np.asarray(truths["empty"], bool)[:n]
    yy = np.asarray(truths["yy"], np.float64)[:n]
    identity = result.logZ[empty] + yy[empty] / 2
    med = float(np.median(identity)) if empty.any() else float("nan")
    print(json.dumps(dict(
        fit=f"MUSE FULL spaxels={problem.ndata} nspec={cube.y.shape[0]} "
            f"nlive={cfg.nlive_points} max_samples={max_samples}",
        fixture_s=fixture_s, wall_s=wall, niter=result.niterations,
        ndraws=result.ndraws, fill_rounds=result.stats["fill_rounds"],
        launches=launches, member_overflow=result.stats["member_overflow"],
        stalled=result.stats["stalled"], timing=result.stats["timing"],
        peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9,
        n_empty=int(empty.sum()), median_logZ_plus_half_yy=med,
        max_abs_logZ_plus_half_yy=float(np.abs(identity).max(initial=0.0)))))
    assert all(k > 0 for k in launches.values()), launches
    rows = result.niterations + cfg.nlive_points
    assert result.u.shape == (rows, n, 5), result.u.shape
    assert result.x.shape == (rows, n, 5) and result.L.shape == (rows, n)
    assert result.logZ.shape == (n,) and np.isfinite(result.logZ).all()
    assert (result.logZerr > 0).all()
    assert empty.any() and abs(med) <= EMPTY_IDENTITY_BAR, med
    return launches, fit


def profile(fit, path):
    """Time a short capped fit without and with the profiler; write the
    per-kernel device-time tables and the device busy share (kernel time
    over the unprofiled wall)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    def run():
        fit()
        torch.cuda.synchronize()

    run()  # warm-up
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        run()
    events = prof.key_averages()
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
