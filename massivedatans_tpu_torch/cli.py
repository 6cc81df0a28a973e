"""Command-line interface of the PyTorch port.

    python -m massivedatans_tpu_torch gen horns 1000
    python -m massivedatans_tpu_torch fit data_widths_1000.hdf5 100
    python -m massivedatans_tpu_torch check <output.out8.hdf5>
    python -m massivedatans_tpu_torch musefit CUBE REGION ZLO ZHI TEMPLATES...

Same arguments, environment knobs and output files as
``python -m massivedatans_tpu`` (reference ``sample.py``), plus
``--device`` (default ``cuda``). The data generators and the HDF5 schema
are this package's copies of the JAX package's (``datagen/generators.py``,
``io/hdf5io.py``), so both packages read and write the same files. ``fit`` is a thin wrapper around ``run_fit``, which takes
arrays in memory; ``musefit`` wraps ``muse.pipeline.run_musefit``.
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


# subcommands of the JAX CLI that this port does not carry yet, with the
# ROADMAP.md queue 1 item that ports each
_NOT_PORTED = {
    "refine": "13", "plot-evidences": "16",
    "plot-scaling": "16", "plot-posterior": "16", "plot-bestfit": "16",
    "plot-muse-posterior": "16",
}


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

    for name, item in _NOT_PORTED.items():
        n = sub.add_parser(name, help=f"not ported yet (ROADMAP item {item})")
        n.add_argument("rest", nargs=argparse.REMAINDER)
        n.set_defaults(fn=_not_ported_cmd(name, item))

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
