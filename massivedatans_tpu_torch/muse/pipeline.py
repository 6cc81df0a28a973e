"""MUSE datacube pipeline (reference ``musefuse.py`` driver).

Counterpart of ``massivedatans_tpu/muse/pipeline.py``. Cube loading, region
selection and noise screening are the JAX package's numpy-only
``load_muse_cube``. The fit is in two layers:

- ``fit_muse`` fits a loaded cube in memory and writes nothing, so it runs
  where h5py is not installed;
- ``run_musefit`` is the JAX package's entry point (same arguments, plus
  ``device``): load, fit, and write the reference output schema plus the
  MUSE datasets ``fiberids``, ``duration`` and ``ndata``.
"""

from __future__ import annotations

import numpy as np

from massivedatans_tpu.config import RunConfig
from massivedatans_tpu.muse.pipeline import MuseCube, load_muse_cube
from massivedatans_tpu_torch.config import set_fp32_precision
from massivedatans_tpu_torch.muse.likelihood import make_muse_problem
from massivedatans_tpu_torch.muse.model import load_template_grid
from massivedatans_tpu_torch.ns.integrator import (
    multi_nested_integrator,
    reject_unported,
)

MODELS = ("FULL", "ZSOL")


def fit_muse(cube: MuseCube, template_files, zlo: float, zhi: float,
             model: str = "FULL", cfg: RunConfig | None = None, *, device,
             ages=None, generator=None, progress: bool = False):
    """Fit every spaxel of ``cube`` jointly on ``device``; returns
    ``(result, problem)``. ``ages`` is the template age grid (years), by
    default the reference BC03 grid."""
    if model not in MODELS:
        raise ValueError(f"model {model!r}: choose one of {MODELS}")
    set_fp32_precision()
    md = load_template_grid(template_files, ages=ages,
                            data_wl_nm=cube.wavelength_nm, zlo=zlo, zhi=zhi,
                            device=device)
    problem = make_muse_problem(md, cube.y, cube.var, zsol=model == "ZSOL")
    result = multi_nested_integrator(problem, cfg or RunConfig(),
                                     device=device, generator=generator,
                                     progress=progress)
    return result, problem


def run_musefit(cube_path: str, region_path: str, zlo: float, zhi: float,
                template_files, model: str = "FULL", maxdata: int = 0,
                nlive: int = 400, tolerance: float = 0.5,
                max_samples: int = 100000, out_prefix: str | None = None,
                cfg_overrides: dict | None = None, progress: bool = True,
                checkpoint_dir: str | None = None, mesh=None,
                ages_file: str | None = None,
                max_chunks: int | None = None,
                checkpoint_every: int = 10,
                dispatch_target_s: float | None = None,
                bad_windows=None, *, device):
    """Reference musefuse.py main flow; returns ``(result, problem, cube)``.

    ``bad_windows``: wavelength windows whose noise is inflated (None = the
    real-MUSE defaults; synthetic cubes pass ``[]``). ``checkpoint_dir``,
    ``max_chunks``, ``dispatch_target_s`` and ``mesh`` are not ported yet
    and raise; ``checkpoint_every`` only applies with a checkpoint."""
    reject_unported(mesh=mesh, checkpoint_dir=checkpoint_dir,
                    max_chunks=max_chunks, dispatch_target_s=dispatch_target_s)
    cube = load_muse_cube(cube_path, region_path, maxdata=maxdata,
                          bad_windows=bad_windows)
    cfg = RunConfig.from_env(
        nlive_points=nlive, tolerance=tolerance, max_samples=max_samples,
        **(cfg_overrides or {}),
    )
    result, problem = fit_muse(
        cube, template_files, zlo, zhi, model=model, cfg=cfg, device=device,
        ages=np.loadtxt(ages_file) if ages_file else None, progress=progress)

    if out_prefix is None:
        suffix = "_zsol_" if model == "ZSOL" else "_full_"
        out_prefix = f"{cube_path}{suffix}.out_{problem.ndata}"
    import h5py

    from massivedatans_tpu.io.hdf5io import write_results

    write_results(out_prefix, result)
    # extra MUSE datasets (musefuse.py:661-663)
    with h5py.File(out_prefix + ".hdf5", "a") as f:
        f.create_dataset("fiberids", data=cube.goodids,
                         compression="gzip", shuffle=True)
        f.create_dataset("duration", data=result.duration)
        f.create_dataset("ndata", data=problem.ndata)
    return result, problem, cube
