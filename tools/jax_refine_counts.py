"""The JAX package's gradient backends at the sizes of chip_smoke.py's
"gradient backends" phase, on the CPU: the reference counts that the
port's bars there rest on.

    JAX_PLATFORMS=cpu python3 tools/jax_refine_counts.py            # every part
    JAX_PLATFORMS=cpu python3 tools/jax_refine_counts.py --part analytic

- ``analytic``: the oracle of ``tests/test_infer.py`` (ndim 3, sigma 0.05,
  centres ``uniform(0.3, 0.7)`` from seed 3) at D = 1,000, with that test's
  settings: ``run_hmc(key(0), 400 / 400 / 16)`` and
  ``run_vi(key(0), steps=1200, lr=3e-2)``. Prints, for each bar of the
  test, how many of the 1,000 datasets meet it
  (``chip_smoke.analytic_bar_counts``, which the smoke's bar uses too).
- ``horns``: ``gen_horns(1000)`` fitted by the JAX package's
  ``multi_nested_integrator`` (default ``RunConfig``: MLFRIENDS, nlive 400,
  tolerance 0.5, its default key), then the JAX CLI's ``refine`` at its
  defaults: the chains seeded from one resampled posterior point per
  dataset (``cli.py:297-305``), ``run_hmc(key(0))`` 300 / 300 / 24 and
  ``run_vi(key(1))`` 1,500 steps. Prints the median accept, the share of
  finite ``logp``, the median |logZ_IW - logZ_NS| and how many of the
  first 100 datasets have ``logZ_IW`` within 3 logZerr + 0.5 of
  ``quad_logZ.json``.
- ``muse``: the MUSE fixture of ``chip_smoke.py`` (``tools/muse_validate.py``'s:
  templates of ``make_template_files``, a 10x10 model-family cube of nspec
  3600, seed 11, flux 0.1-1.0, no bad windows) fitted by the JAX package
  (FULL, nlive 400, tolerance 0.5, capped at 2,000 iterations as the smoke
  caps it), then the same ``refine`` as for horns, but with HMC cut to
  ``chip_smoke.MUSE_REFINE_HMC`` iterations as the smoke cuts it. Prints
  the same numbers and, instead of the quadrature count, the spaxels whose
  ``logZ_IW`` is not finite, how many spaxels with a star have
  ``logZ_IW`` within 3 logZerr + 0.5 of their NS logZ, and the median of
  ``logZ_IW + yy/2`` over the empty spaxels.

One JSON line per part, with its wall seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def analytic():
    import jax
    import numpy as np

    import chip_smoke as cs
    from massivedatans_tpu.infer import run_hmc, run_vi
    from massivedatans_tpu.models.analytic import (
        make_analytic_gaussian_problem, true_logZ,
    )

    centers = np.random.default_rng(3).uniform(0.3, 0.7,
                                               size=(cs.ANALYTIC_D, 3))
    problem = make_analytic_gaussian_problem(centers, sigma=cs.ANALYTIC_SIGMA)
    t0 = time.perf_counter()
    res = run_hmc(problem, jax.random.key(0), **cs.ANALYTIC_HMC)
    acc, x = np.asarray(res.accept_rate), np.asarray(res.x)
    t_hmc = time.perf_counter() - t0
    vi = run_vi(problem, jax.random.key(0), **cs.ANALYTIC_VI)
    elbo, iw = np.asarray(vi.elbo), np.asarray(vi.logZ_iw)
    counts, extremes = cs.analytic_bar_counts(
        acc, x, elbo, iw, centers, true_logZ(centers, cs.ANALYTIC_SIGMA))
    return dict(part="analytic", D=cs.ANALYTIC_D, hmc_s=t_hmc,
                vi_s=time.perf_counter() - t0 - t_hmc, **counts, **extremes)


def refine_init_u(out, ndim):
    """The JAX CLI's chain seeds (massivedatans_tpu/cli.py:297-305): one
    resampled posterior point per dataset of the fit's arrays ``out``."""
    import numpy as np

    D = out["logZ"].shape[0]
    w = (out["w"] + out["L"]).astype(np.float64)
    w[~np.isfinite(w)] = -np.inf
    rng = np.random.default_rng(0)
    init_u = np.empty((D, ndim), np.float32)
    for d in range(D):
        p = np.exp(w[:, d] - w[:, d].max())
        p /= p.sum()
        init_u[d] = out["u"][rng.choice(len(p), p=p), d, :]
    return init_u


def _refine(problem, res, **hmc_kw):
    """The JAX CLI's refine (massivedatans_tpu/cli.py:297-332) on a fit
    result, at its defaults but for HMC's ``hmc_kw``; returns HMC, VI, the
    fit's arrays and walls."""
    import jax
    import numpy as np

    from massivedatans_tpu.infer import run_hmc, run_vi

    out = dict(u=np.asarray(res.u), w=np.asarray(res.w), L=np.asarray(res.L),
               logZ=np.asarray(res.logZ), logZerr=np.asarray(res.logZerr))
    init_u = refine_init_u(out, problem.ndim)
    t1 = time.perf_counter()
    hmc = run_hmc(problem, jax.random.key(0), init_u=init_u, **hmc_kw)
    jax.block_until_ready(hmc.x)
    t2 = time.perf_counter()
    vi = run_vi(problem, jax.random.key(1), init_u=init_u)
    jax.block_until_ready(vi.logZ_iw)
    return hmc, vi, out, t2 - t1, time.perf_counter() - t2


def muse_problem(side=10, nspec=3600, seed=11):
    """The JAX package's MUSE FULL problem on the smoke's fixture, and the
    fixture's truths."""
    import tempfile

    from massivedatans_tpu.muse.likelihood import make_muse_problem
    from massivedatans_tpu.muse.model import load_template_grid
    from massivedatans_tpu.muse.pipeline import load_muse_cube
    from massivedatans_tpu.muse.synth import make_model_cube, make_template_files

    with tempfile.TemporaryDirectory() as tmp:
        tpl = make_template_files(os.path.join(tmp, "templates"))
        cube_path, reg, truths_path = make_model_cube(
            os.path.join(tmp, "cube.fits"), os.path.join(tmp, "sel.reg"), tpl,
            os.path.join(tmp, "truths.json"), ny=side, nx=side, nspec=nspec,
            seed=seed, flux_lo=0.1, flux_hi=1.0)
        cube = load_muse_cube(cube_path, reg, maxdata=side * side,
                              bad_windows=[])
        md = load_template_grid(tpl, data_wl_nm=cube.wavelength_nm, zlo=0.0,
                                zhi=0.5)
        with open(truths_path) as fh:
            truths = json.load(fh)
    return make_muse_problem(md, cube.y, cube.var), truths


def muse(cap=2000):
    import numpy as np

    import chip_smoke as cs
    from massivedatans_tpu.config import RunConfig
    from massivedatans_tpu.ns.integrator import multi_nested_integrator

    problem, truths = muse_problem()
    n = problem.ndata
    t0 = time.perf_counter()
    res = multi_nested_integrator(
        problem, RunConfig(nlive_points=400, tolerance=0.5, max_samples=cap),
        progress=False)
    fit_s = time.perf_counter() - t0
    hmc, vi, out, hmc_s, vi_s = _refine(problem, res, **cs.MUSE_REFINE_HMC)
    iw = np.asarray(vi.logZ_iw, np.float64)
    empty = np.asarray(truths["empty"], bool)[:n]
    yy = np.asarray(truths["yy"], np.float64)[:n]
    bad = np.nonzero(~np.isfinite(iw))[0]
    star = cs.muse_star_counts(iw, out["logZ"], out["logZerr"], empty)
    return dict(
        part="muse", D=n, hmc=cs.MUSE_REFINE_HMC, fit_s=fit_s, hmc_s=hmc_s,
        vi_s=vi_s,
        niter=int(res.niterations), ns_logZ_finite=bool(
            np.isfinite(out["logZ"]).all()),
        iw_finite=int(np.isfinite(iw).sum()), iw_nonfinite=bad.tolist(),
        median_accept=float(np.median(np.asarray(hmc.accept_rate))),
        finite_logp_share=float(np.isfinite(np.asarray(hmc.logp)).mean()),
        median_abs_iw_minus_ns_finite=float(np.nanmedian(
            np.abs(iw - out["logZ"]))),
        **star, n_empty=int(empty.sum()),
        median_logZ_iw_plus_half_yy=float(np.median(iw[empty] + yy[empty] / 2)))


def horns(D=1000):
    import numpy as np

    from massivedatans_tpu.config import RunConfig
    from massivedatans_tpu.datagen.generators import gen_horns
    from massivedatans_tpu.models.gaussline import make_gaussline_problem
    from massivedatans_tpu.ns.integrator import multi_nested_integrator

    data = gen_horns(D)
    problem = make_gaussline_problem(data["x"], data["y"],
                                     noise_level=data["noise_level"])
    t0 = time.perf_counter()
    res = multi_nested_integrator(problem, RunConfig(), progress=False)
    fit_s = time.perf_counter() - t0
    hmc, vi, out, hmc_s, vi_s = _refine(problem, res)
    iw = np.asarray(vi.logZ_iw)
    with open(os.path.join(ROOT, "quad_logZ.json")) as fh:
        quad = np.asarray(json.load(fh)["logZ"], float)
    nq = len(quad)
    ns_in = np.abs(out["logZ"][:nq] - quad) < 3 * out["logZerr"][:nq] + 0.5
    iw_in = np.abs(iw[:nq] - quad) < 3 * out["logZerr"][:nq] + 0.5
    return dict(
        part="horns", D=D, fit_s=fit_s, hmc_s=hmc_s, vi_s=vi_s,
        niter=int(res.niterations), ndraws=int(res.ndraws),
        ns_quad_within=int(ns_in.sum()), iw_quad_within=int(iw_in.sum()),
        quad_n=nq, iw_finite=bool(np.isfinite(iw).all()),
        median_accept=float(np.median(np.asarray(hmc.accept_rate))),
        finite_logp_share=float(np.isfinite(np.asarray(hmc.logp)).mean()),
        median_abs_iw_minus_ns=float(np.median(np.abs(iw - out["logZ"]))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=["analytic", "horns", "muse", "all"],
                    default="all")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    for part in ("analytic", "horns", "muse"):
        if args.part in (part, "all"):
            print(json.dumps(globals()[part]()), flush=True)


if __name__ == "__main__":
    main()
