"""Command-line interface of the PyTorch port.

    python -m massivedatans_tpu_torch gen horns 1000
    python -m massivedatans_tpu_torch fit data_widths_1000.hdf5 100
    python -m massivedatans_tpu_torch check <output.out8.hdf5>
    python -m massivedatans_tpu_torch musefit CUBE REGION ZLO ZHI TEMPLATES...
    python -m massivedatans_tpu_torch refine <data.hdf5> <output.out8.hdf5>
    python -m massivedatans_tpu_torch plot-evidences|plot-scaling|plot-posterior|
                                      plot-bestfit|plot-muse-posterior ...

Same arguments, environment knobs and output files as
``python -m massivedatans_tpu`` (reference ``sample.py``), plus
``--device`` (default ``cuda``) for the subcommands that compute. The data
generators, the HDF5 schema and the post-processing are this package's
copies of the JAX package's (``datagen/generators.py``, ``io/hdf5io.py``,
``postprocess.py``), so both packages read and write the same files.
``fit`` is a thin wrapper around ``run_fit`` and ``refine`` around
``run_refine``, which take arrays in memory; ``musefit`` wraps
``muse.pipeline.run_musefit``.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch

from massivedatans_tpu_torch.config import RunConfig


def run_fit(x, y, cfg: RunConfig, device, noise_level: float = 0.01,
            progress: bool = False, generator=None, **run_opts):
    """Fit the Gaussian-line model to the spectra ``y[nx, D]`` on
    ``device`` and return the ``NSResult``. ``run_opts`` go to
    ``multi_nested_integrator`` (``checkpoint_dir``, ``checkpoint_every``,
    ``max_chunks``, ``dispatch_target_s``, ``mesh``)."""
    from massivedatans_tpu_torch.config import set_fp32_precision
    from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem
    from massivedatans_tpu_torch.ns.integrator import multi_nested_integrator

    set_fp32_precision()
    problem = make_gaussline_problem(x, y, noise_level=noise_level,
                                     device=device)
    return multi_nested_integrator(problem, cfg, device=device,
                                   generator=generator, progress=progress,
                                   **run_opts)


def _resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: torch.cuda.is_available() is False (no CUDA "
            "card or no CUDA build of PyTorch); pass --device cpu to run on "
            "the CPU")
    return device


def cmd_gen(args):
    from massivedatans_tpu_torch.datagen.generators import (
        FILENAME_STEMS, GENERATORS, save_dataset,
    )

    data = GENERATORS[args.kind](args.N, seed=args.seed)
    path = args.out or FILENAME_STEMS[args.kind].format(N=args.N)
    save_dataset(data, path)
    print(f"wrote {path}: x{data['x'].shape} y{data['y'].shape}")


def _not_ported_cmd(name, item):
    def fn(args):
        raise NotImplementedError(
            f"`{name}` is not ported to massivedatans_tpu_torch yet "
            f"(ROADMAP.md queue 1, item {item})")
    return fn


def cmd_fit(args):
    from massivedatans_tpu_torch.io.hdf5io import (
        load_spectra, output_prefix, write_results,
    )

    if args.devices > 1:
        _not_ported_cmd("fit --devices > 1", "15")(args)
    device = _resolve_device(args.device)
    cfg = RunConfig.from_env(**{k: v for k, v in dict(
        nlive_points=args.nlive,
        tolerance=args.tolerance,
        max_samples=args.max_samples,
        constrainer=args.constrainer,
    ).items() if v is not None})
    x, y = load_spectra(args.data, args.ndata)
    print(f"fitting {y.shape[1]} datasets on {device}, "
          f"nlive={cfg.nlive_points}, constrainer={cfg.constrainer}",
          file=sys.stderr)
    result = run_fit(x, y, cfg, device, noise_level=args.noise_level,
                     progress=not args.quiet,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every)
    prefix = output_prefix(args.data, cfg.constrainer, cfg.nlive_points,
                           y.shape[1])
    write_results(prefix, result)
    print("logZ = %.1f +- %.1f" % (result.logZ[0], result.logZerr[0]))
    print("ndraws:", result.ndraws, "niter:", result.u.shape[0])
    print("wrote", prefix + ".hdf5")


def cmd_musefit(args):
    import os

    from massivedatans_tpu_torch.muse.pipeline import run_musefit

    if args.devices > 1 or args.model_parallel > 1:
        _not_ported_cmd("musefit --devices/--model-parallel > 1", "15")(args)
    device = _resolve_device(args.device)
    model = args.model or os.environ.get("MODEL", "FULL")
    maxdata = args.maxdata
    if maxdata is None:
        maxdata = int(os.environ.get("MAXDATA", 0))
    result, problem, cube = run_musefit(
        args.cube, args.region, args.zlo, args.zhi, args.templates,
        model=model, maxdata=maxdata,
        nlive=args.nlive or int(os.environ.get("NLIVE_POINTS", 400)),
        max_samples=args.max_samples, out_prefix=args.out,
        checkpoint_dir=args.checkpoint_dir, ages_file=args.ages_file,
        device=device,
    )
    print("logZ = %.1f +- %.1f" % (result.logZ[0], result.logZerr[0]))
    print("ndraws:", result.ndraws)


def cmd_check(args):
    """Summarize an output file (reference checkoutput.py:8-42)."""
    from massivedatans_tpu_torch.io.hdf5io import read_results

    rng = np.random.default_rng(args.seed)
    for path in args.files:
        out = read_results(path)
        print(path)
        logZ, logZerr = out["logZ"], out["logZerr"]
        print("logZ[0] = %.1f +- %.1f" % (logZ[0], logZerr[0]))
        print("ndraws:", int(out["ndraws"]))
        w = out["w"] + out["L"]
        for d in range(min(w.shape[1], args.max_datasets)):
            wd = w[:, d].astype(np.float64)
            wd[~np.isfinite(wd)] = -np.inf
            p = np.exp(wd - wd.max())
            p /= p.sum()
            i = rng.choice(len(p), size=1000, p=p)
            xs = out["x"][i, d, :]
            stats = "  ".join(
                f"p{j}={xs[:, j].mean():.3f}+-{xs[:, j].std():.3f}"
                for j in range(xs.shape[1]))
            print(f"  dataset {d}: logZ={logZ[d]:.2f}+-{logZerr[d]:.2f}  {stats}")


def _fit_arrays(out) -> dict:
    """``u, w, L, logZ, logZerr`` of a fit, from an ``NSResult`` or from
    the dict that ``read_results`` gives."""
    keys = ("u", "w", "L", "logZ", "logZerr")
    if isinstance(out, dict):
        return {k: np.asarray(out[k]) for k in keys}
    return {k: np.asarray(getattr(out, k)) for k in keys}


def refine_init_u(out, ndim: int) -> np.ndarray:
    """One resampled nested-sampling posterior point per dataset, the
    chains' starting points: the JAX CLI's code and seed
    (``massivedatans_tpu/cli.py:297-305``), so both packages pick the same
    rows of the same fit."""
    out = _fit_arrays(out)
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


def run_refine(problem, out, *, device, backend: str = "both",
               num_warmup: int = 300, num_samples: int = 300,
               vi_steps: int = 1500, max_datasets: int = 4):
    """Refine a fit of ``problem`` on ``device``: batched HMC from one
    posterior point per dataset (generator seed 0) and mean-field VI
    evidences (seed 1), as the JAX CLI's ``refine`` does, printing its
    lines. ``out`` is the fit: an ``NSResult`` or ``read_results``'s
    dict. Returns ``(init_u, hmc_result or None, vi_result or None)``."""
    from massivedatans_tpu_torch.config import set_fp32_precision
    from massivedatans_tpu_torch.infer import run_hmc, run_vi

    set_fp32_precision()
    device = torch.device(device)
    out = _fit_arrays(out)
    D = out["logZ"].shape[0]
    init_u = refine_init_u(out, problem.ndim)
    hmc = vi = None
    if backend in ("hmc", "both"):
        hmc = run_hmc(problem, torch.Generator(device=device).manual_seed(0),
                      device=device, init_u=init_u, num_warmup=num_warmup,
                      num_samples=num_samples)
        print(f"HMC: mean accept {float(hmc.accept_rate.mean()):.2f}")
        xs = hmc.x.cpu().numpy()
        for d in range(min(D, max_datasets)):
            stats = "  ".join(
                f"p{j}={xs[:, d, j].mean():.3f}+-{xs[:, d, j].std():.3f}"
                for j in range(problem.ndim))
            print(f"  dataset {d}: {stats}")
    if backend in ("vi", "both"):
        vi = run_vi(problem, torch.Generator(device=device).manual_seed(1),
                    device=device, init_u=init_u, steps=vi_steps)
        iw = vi.logZ_iw.cpu().numpy()
        dns = iw - out["logZ"]
        print(f"VI: median |logZ_IW - logZ_NS| = "
              f"{float(np.median(np.abs(dns))):.2f} "
              f"(NS MC error ~{float(np.median(out['logZerr'])):.2f})")
        for d in range(min(D, max_datasets)):
            print(f"  dataset {d}: logZ_IW={iw[d]:.2f}  "
                  f"logZ_NS={out['logZ'][d]:.2f}+-{out['logZerr'][d]:.2f}")
    return init_u, hmc, vi


def cmd_refine(args):
    from massivedatans_tpu_torch.io.hdf5io import load_spectra, read_results

    device = _resolve_device(args.device)
    out = read_results(args.output)
    D = out["logZ"].shape[0]
    if args.muse is not None:
        from massivedatans_tpu_torch.muse.likelihood import make_muse_problem
        from massivedatans_tpu_torch.muse.model import load_template_grid
        from massivedatans_tpu_torch.muse.pipeline import load_muse_cube

        region, zlo, zhi = args.muse
        cube = load_muse_cube(args.data, region, maxdata=D)
        md = load_template_grid(args.muse_templates,
                                data_wl_nm=cube.wavelength_nm,
                                zlo=float(zlo), zhi=float(zhi), device=device)
        problem = make_muse_problem(md, cube.y, cube.var)
    else:
        from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem

        x_grid, y = load_spectra(args.data, D)
        problem = make_gaussline_problem(x_grid, y,
                                         noise_level=args.noise_level,
                                         device=device)
    run_refine(problem, out, device=device, backend=args.backend,
               num_warmup=args.num_warmup, num_samples=args.num_samples,
               vi_steps=args.vi_steps, max_datasets=args.max_datasets)


def cmd_plot_evidences(args):
    from massivedatans_tpu_torch import postprocess as pp
    from massivedatans_tpu_torch.io.hdf5io import load_spectra, read_results

    _, y = load_spectra(args.data)
    out = read_results(args.output)
    B = pp.plot_evidences(out, y[:, :out["logZ"].shape[0]], path=args.out)
    print(f"median log10 B = {np.median(B):.2f}; wrote {args.out}")


def cmd_plot_posterior(args):
    from massivedatans_tpu_torch import postprocess as pp
    from massivedatans_tpu_torch.io.hdf5io import read_results

    out = read_results(args.output)
    pp.plot_posterior(out, d=args.dataset, path=args.out)
    print("wrote", args.out)


def cmd_plot_bestfit(args):
    from massivedatans_tpu_torch import postprocess as pp
    from massivedatans_tpu_torch.io.hdf5io import load_spectra, read_results
    from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem

    out = read_results(args.output)
    x, y = load_spectra(args.data, out["logZ"].shape[0])
    problem = make_gaussline_problem(x, y, noise_level=args.noise_level)
    paths = pp.plot_bestfit(out, problem, datasets=args.datasets,
                            path_prefix=args.prefix)
    print(f"wrote {len(paths)} plots -> {args.prefix}_*.pdf")


def cmd_plot_muse_posterior(args):
    from massivedatans_tpu_torch import postprocess as pp
    from massivedatans_tpu_torch.io.hdf5io import read_results

    out = read_results(args.output)
    done = pp.plot_muse_posterior(out, min_finite=args.min_finite,
                                  size=args.size, path_prefix=args.prefix)
    print(f"plotted {len(done)} datasets -> {args.prefix}_*.pdf")


def cmd_plot_scaling(args):
    from massivedatans_tpu_torch import postprocess as pp

    N, draws = pp.plot_scaling(args.stats, path=args.out)
    print("N:", list(N), "draws:", list(draws), "-> wrote", args.out)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    p = argparse.ArgumentParser(prog="massivedatans_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen", help="generate synthetic spectra")
    g.add_argument("kind", choices=["horns", "nothing", "simple", "bright",
                                    "faint", "agn", "realistic"])
    g.add_argument("N", type=int)
    g.add_argument("--seed", type=int, default=None)
    g.add_argument("--out", default=None)
    g.set_defaults(fn=cmd_gen)

    f = sub.add_parser("fit", help="run joint nested sampling (sample.py)")
    f.add_argument("data")
    f.add_argument("ndata", type=int)
    f.add_argument("--nlive", type=int, default=None)
    f.add_argument("--tolerance", type=float, default=None)
    f.add_argument("--max-samples", type=int, default=None)
    f.add_argument("--constrainer", default=None)
    f.add_argument("--noise-level", type=float, default=0.01)
    f.add_argument("--quiet", action="store_true")
    f.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    f.add_argument("--devices", type=int, default=1,
                   help="datasets sharded over several devices: not ported")
    f.add_argument("--checkpoint-dir", default=None,
                   help="persist sampler state here and resume from it")
    f.add_argument("--checkpoint-every", type=int, default=10,
                   help="chunks between state checkpoints")
    f.set_defaults(fn=cmd_fit)

    c = sub.add_parser("check", help="summarize output files (checkoutput.py)")
    c.add_argument("files", nargs="+")
    c.add_argument("--max-datasets", type=int, default=4)
    c.add_argument("--seed", type=int, default=0,
                   help="seed of the posterior resampling")
    c.set_defaults(fn=cmd_check)

    m = sub.add_parser("musefit", help="fit a MUSE datacube (musefuse.py)")
    m.add_argument("cube")
    m.add_argument("region")
    m.add_argument("zlo", type=float)
    m.add_argument("zhi", type=float)
    m.add_argument("templates", nargs="+")
    m.add_argument("--model", default=None, choices=["FULL", "ZSOL"])
    m.add_argument("--maxdata", type=int, default=None)
    m.add_argument("--nlive", type=int, default=None)
    m.add_argument("--max-samples", type=int, default=100000)
    m.add_argument("--out", default=None)
    m.add_argument("--ages-file", default=None,
                   help="text file with one template age (years) per line; "
                        "default: the reference BC03 grid (musefuse.py:190)")
    m.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    m.add_argument("--checkpoint-dir", default=None,
                   help="persist sampler state here and resume from it")
    m.add_argument("--devices", type=int, default=1,
                   help="spaxels sharded over several devices: not ported")
    m.add_argument("--model-parallel", type=int, default=1,
                   help="wavelength axis sharded over devices: not ported")
    m.set_defaults(fn=cmd_musefit)

    r = sub.add_parser(
        "refine",
        help="gradient-based refinement/cross-check of an NS run: batched "
             "per-dataset HMC posteriors and/or mean-field VI evidences")
    r.add_argument("data", help="spectra HDF5, or a FITS cube with --muse")
    r.add_argument("output", help="the fit's .out8.hdf5 (seeds the chains)")
    r.add_argument("--backend", default="both", choices=["hmc", "vi", "both"])
    r.add_argument("--num-warmup", type=int, default=300)
    r.add_argument("--num-samples", type=int, default=300)
    r.add_argument("--vi-steps", type=int, default=1500)
    r.add_argument("--noise-level", type=float, default=0.01)
    r.add_argument("--max-datasets", type=int, default=4)
    r.add_argument("--muse", nargs=3, metavar=("REGION", "ZLO", "ZHI"),
                   default=None,
                   help="treat `data` as a MUSE cube: ds9 region, zlo, zhi")
    r.add_argument("--muse-templates", nargs="+", default=None)
    r.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    r.set_defaults(fn=cmd_refine)

    pe = sub.add_parser("plot-evidences",
                        help="Bayes factors vs no-signal (plotevidences.py)")
    pe.add_argument("data")
    pe.add_argument("output")
    pe.add_argument("--out", default="plotevidences.pdf")
    pe.set_defaults(fn=cmd_plot_evidences)

    ps = sub.add_parser("plot-scaling",
                        help="evals vs N scaling (plotscaling.py)")
    ps.add_argument("stats", nargs="+")
    ps.add_argument("--out", default="scaling.pdf")
    ps.set_defaults(fn=cmd_plot_scaling)

    pp_ = sub.add_parser("plot-posterior",
                         help="marginal posteriors (plotposterior.py)")
    pp_.add_argument("output")
    pp_.add_argument("--dataset", type=int, default=0)
    pp_.add_argument("--out", default="posterior.pdf")
    pp_.set_defaults(fn=cmd_plot_posterior)

    pb = sub.add_parser(
        "plot-bestfit",
        help="best-fit model vs data per dataset (musefuse.py emits these "
             "from inside the likelihood; here post-hoc)")
    pb.add_argument("data")
    pb.add_argument("output")
    pb.add_argument("--datasets", type=int, nargs="+", default=[0])
    pb.add_argument("--noise-level", type=float, default=0.01)
    pb.add_argument("--prefix", default="bestfit")
    pb.set_defaults(fn=cmd_plot_bestfit)

    pm = sub.add_parser(
        "plot-muse-posterior",
        help="per-spaxel posterior corner plots (plotmuseposterior.py)")
    pm.add_argument("output")
    pm.add_argument("--min-finite", type=int, default=4000)
    pm.add_argument("--size", type=int, default=100000)
    pm.add_argument("--prefix", default="museposterior")
    pm.set_defaults(fn=cmd_plot_muse_posterior)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
