"""MUSE datacube pipeline (reference ``musefuse.py`` driver).

Counterpart of ``massivedatans_tpu/muse/pipeline.py``. Cube loading, region
selection and noise screening (``MuseCube``, ``BAD_WINDOWS``,
``screen_noise_outliers``, ``load_muse_cube``) are copies of the JAX
package's numpy code: load a FITS cube (DATA flux + STAT variance), select
spaxels by a ds9 region, screen bad spaxels and inflate the noise in known
bad wavelength windows. The fit is in two layers:

- ``fit_muse`` fits a loaded cube in memory and writes nothing, so it runs
  where h5py is not installed;
- ``run_musefit`` is the JAX package's entry point (same arguments, plus
  ``device``): load, fit, and write the reference output schema plus the
  MUSE datasets ``fiberids``, ``duration`` and ``ndata``.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from massivedatans_tpu_torch.config import RunConfig, set_fp32_precision
from massivedatans_tpu_torch.io.hdf5io import write_results
from massivedatans_tpu_torch.muse.fitsio import fits_open, get_hdu
from massivedatans_tpu_torch.muse.likelihood import make_muse_problem
from massivedatans_tpu_torch.muse.model import load_template_grid
from massivedatans_tpu_torch.muse.regions import parse_region_mask
from massivedatans_tpu_torch.ns.integrator import (
    multi_nested_integrator,
    reject_unported,
)

log = logging.getLogger("massivedatans_tpu_torch")

MODELS = ("FULL", "ZSOL")

# wavelength windows with known sky-subtraction residuals; the noise there is
# inflated so they are effectively masked (musefuse.py:130-134)
BAD_WINDOWS = [(1600, 1670), (1730, 1780), (1950, 2000),
               (2250, 2700), (2800, 3000)]


@dataclasses.dataclass
class MuseCube:
    wavelength_nm: np.ndarray  # [nspec]
    y: np.ndarray              # [nspec, D]
    var: np.ndarray            # [nspec, D]
    goodids: np.ndarray        # [D] spaxel ids within the region selection
    mask_shape: tuple          # (ny, nx) of the field
    region_mask: np.ndarray    # [ny, nx]

    def flat_positions(self) -> np.ndarray:
        """Flat (ny*nx) field positions of the fitted spaxels, for maps."""
        return np.where(self.region_mask.ravel())[0][self.goodids]


def screen_noise_outliers(var: np.ndarray, window: int = 10,
                          nsigma: float = 5.0) -> np.ndarray:
    """Rolling-median variance screening (musefuse.py:113-129; the reference
    computes this but ships with it disabled — enable via pipeline flag)."""
    nspec = var.shape[0]
    out = var.copy()
    for j in range(nspec):
        lo, hi = max(0, j - window), min(nspec, j + window)
        seg = var[lo:hi]
        med = np.median(seg, axis=0)
        meddiff = np.median(np.abs(med[None, :] - seg), axis=0)
        bad = np.abs(var[j] - med) > nsigma * meddiff
        if bad.any():
            out[max(0, j - 3):min(nspec, j + 4), bad] += 1e10
    return out


def load_muse_cube(cube_path: str, region_path: str | None = None,
                   maxdata: int = 0, nspec_max: int = 3600,
                   screen_outliers: bool = False,
                   bad_windows=None) -> MuseCube:
    hdus = fits_open(cube_path)
    data_hdu = get_hdu(hdus, "DATA")
    stat_hdu = get_hdu(hdus, "STAT")
    y = np.asarray(data_hdu.data, np.float64)[:nspec_max]
    var = np.asarray(stat_hdu.data, np.float64)[:nspec_max]
    nspec, ny, nx = y.shape
    wavelength = (
        float(data_hdu.header.get("CD3_3", 1.25)) * np.arange(nspec)
        + float(data_hdu.header.get("CRVAL3", 4750.0))
    ) / 10.0  # Angstrom -> nm (musefuse.py:89,255)

    if region_path is not None:
        with open(region_path) as fh:
            mask = parse_region_mask(fh.read(), (ny, nx))
    else:
        mask = np.ones((ny, nx), bool)

    y = y.reshape(nspec, -1)[:, mask.ravel()]
    var = var.reshape(nspec, -1)[:, mask.ravel()]
    good = np.isfinite(var).all(axis=0)  # musefuse.py:92-95
    goodids = np.where(good)[0]
    if maxdata:
        goodids = goodids[:maxdata]
    y = y[:, goodids]
    var = var[:, goodids]
    assert (var > 0).all(), "non-positive variances in STAT"

    if screen_outliers:
        var = screen_noise_outliers(var)
    for lo, hi in (bad_windows if bad_windows is not None else BAD_WINDOWS):
        if lo < nspec:
            var[lo:min(hi, nspec)] += 1e10

    log.info("MUSE cube: %d spectral bins, %d/%d spaxels selected",
             nspec, len(goodids), mask.sum())
    return MuseCube(wavelength_nm=wavelength, y=y, var=var,
                    goodids=goodids, mask_shape=(ny, nx), region_mask=mask)


def fit_muse(cube: MuseCube, template_files, zlo: float, zhi: float,
             model: str = "FULL", cfg: RunConfig | None = None, *, device,
             ages=None, generator=None, progress: bool = False,
             **run_opts):
    """Fit every spaxel of ``cube`` jointly on ``device``; returns
    ``(result, problem)``. ``ages`` is the template age grid (years), by
    default the reference BC03 grid. ``run_opts`` go to
    ``multi_nested_integrator`` (``checkpoint_dir``, ``checkpoint_every``,
    ``max_chunks``, ``dispatch_target_s``, ``mesh``)."""
    if model not in MODELS:
        raise ValueError(f"model {model!r}: choose one of {MODELS}")
    set_fp32_precision()
    md = load_template_grid(template_files, ages=ages,
                            data_wl_nm=cube.wavelength_nm, zlo=zlo, zhi=zhi,
                            device=device)
    problem = make_muse_problem(md, cube.y, cube.var, zsol=model == "ZSOL")
    result = multi_nested_integrator(problem, cfg or RunConfig(),
                                     device=device, generator=generator,
                                     progress=progress, **run_opts)
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
    ``checkpoint_every``, ``max_chunks`` and ``dispatch_target_s`` are the
    integrator's (``multi_nested_integrator``); an interrupted fit writes
    its partial result, as the JAX package does. ``mesh`` is not ported
    yet and raises."""
    reject_unported(mesh)
    cube = load_muse_cube(cube_path, region_path, maxdata=maxdata,
                          bad_windows=bad_windows)
    cfg = RunConfig.from_env(
        nlive_points=nlive, tolerance=tolerance, max_samples=max_samples,
        **(cfg_overrides or {}),
    )
    result, problem = fit_muse(
        cube, template_files, zlo, zhi, model=model, cfg=cfg, device=device,
        ages=np.loadtxt(ages_file) if ages_file else None, progress=progress,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        max_chunks=max_chunks, dispatch_target_s=dispatch_target_s)

    if out_prefix is None:
        suffix = "_zsol_" if model == "ZSOL" else "_full_"
        out_prefix = f"{cube_path}{suffix}.out_{problem.ndata}"
    import h5py

    write_results(out_prefix, result)
    # extra MUSE datasets (musefuse.py:661-663)
    with h5py.File(out_prefix + ".hdf5", "a") as f:
        f.create_dataset("fiberids", data=cube.goodids,
                         compression="gzip", shuffle=True)
        f.create_dataset("duration", data=result.duration)
        f.create_dataset("ndata", data=problem.ndata)
    return result, problem, cube
