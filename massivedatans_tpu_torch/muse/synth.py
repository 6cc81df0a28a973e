"""Synthetic MUSE fixtures: template library, datacube and region file.

Counterpart of ``massivedatans_tpu/muse/synth.py``: the pipeline runs
end to end without proprietary data. ``make_template_files`` and
``make_synthetic_cube`` are copies of the JAX package's numpy functions
(same draws, same file bytes); ``make_model_cube`` uses this package's
``predict_batch``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from massivedatans_tpu_torch.muse.fitsio import fits_write
from massivedatans_tpu_torch.muse.model import (
    _SFTAU_GRID,
    load_template_grid,
    predict_batch,
)


def make_template_files(dirpath: str, n_ages: int = 111, n_wl: int = 400,
                        nZ: int = 7, seed: int = 0):
    """Plausible smooth SSP-like templates: blackbody-ish continua whose
    temperature falls with age, bluer for lower metallicity.

    The default ``n_ages=111`` matches the reference BC03 grid
    (``model.REFERENCE_AGES[::2]``, musefuse.py:190) so the files load
    without an explicit ages list. For other column counts an ``ages.txt``
    (geometric grid) is written alongside, to pass as ``--ages-file``.
    """
    rng = np.random.default_rng(seed)
    wl_A = np.linspace(3000.0, 9000.0, n_wl)  # Angstrom
    files = []
    os.makedirs(dirpath, exist_ok=True)
    if n_ages != 111:
        ages = np.concatenate([[0.0], np.geomspace(1e5, 2e10, n_ages - 1)])
        np.savetxt(os.path.join(dirpath, "ages.txt"), ages)
    for iz in range(nZ):
        cols = [wl_A]
        for a in range(n_ages):
            # keep the same temperature span regardless of grid length
            temp = 12000.0 * (0.97 ** (a * 24.0 / n_ages)) * (1.0 + 0.05 * iz)
            x = 1.43878e8 / (wl_A * temp)  # hc/(k lambda T), Angstrom*K
            planck = 1.0 / (wl_A ** 5 * np.expm1(np.clip(x, 1e-3, 50.0)))
            bump = 1.0 + 0.3 * np.exp(
                -0.5 * ((wl_A - 4000 - 50 * a) / 300.0) ** 2)
            cols.append(planck * bump / planck.max())
        path = os.path.join(dirpath, f"ssp_Z{iz}.txt")
        np.savetxt(path, np.column_stack(cols))
        files.append(path)
    return files


def make_model_cube(path: str, region_path: str, template_files,
                    truths_path: str, ny: int = 10, nx: int = 10,
                    nspec: int = 600, seed: int = 3, noise: float = 0.05,
                    zlo: float = 0.0, zhi: float = 0.5,
                    frac_empty: float = 0.1, cd3: float = 1.25,
                    flux_lo: float = 0.3, flux_hi: float = 3.0):
    """FITS cube whose spaxels are drawn from the fitted model family.

    Every non-empty spaxel is ``amp * predict_batch(md, theta)`` plus
    Gaussian noise, with theta = (Z, logSFtau, SFage, z, EBV) drawn from the
    fit prior and ``amp`` set so the mean observed flux hits a target drawn
    log-uniformly from [flux_lo, flux_hi]. A ``frac_empty`` fraction of the
    spaxels (and any whose model underflows to zero) carries pure noise,
    which anchors the no-star evidence identity logZ ~= -yy/2. The model
    grid is the one the fit builds (same template files, same observed
    wavelengths from CRVAL3/CD3_3); the model runs on the CPU.

    What makes parameters identifiable under the profiled amplitude is the
    total spectral span (nspec * cd3), so small-nspec fixtures should raise
    ``cd3``. Same draws, files and truths JSON as the JAX package's
    ``make_model_cube`` for the same seed; returns
    ``(path, region_path, truths_path)``.
    """
    rng = np.random.default_rng(seed)
    crval3 = 4750.0  # MUSE native sampling from 4750 A (musefuse.py:89)
    wl_nm = (crval3 + cd3 * np.arange(nspec)) / 10.0
    md = load_template_grid(template_files, data_wl_nm=wl_nm,
                            zlo=zlo, zhi=zhi)
    D = ny * nx
    empty = rng.uniform(size=D) < frac_empty
    zg = md.z_grid.numpy().astype(np.float64)
    theta = np.column_stack([
        rng.uniform(zg[0], zg[-1], D),                    # Z (log10)
        rng.uniform(_SFTAU_GRID[0], _SFTAU_GRID[-1], D),  # logSFtau
        rng.uniform(0.0, 13.0, D),                        # SFage (Gyr)
        rng.uniform(zlo, zhi, D),                         # redshift
        rng.uniform(0.0, 2.0, D),                         # EBV
    ]).astype(np.float32)
    model = predict_batch(md, torch.from_numpy(theta)).numpy()
    # the profiled amplitude is chosen post-extinction to hit a target mean
    # flux, so every spaxel has a comparable SNR; spaxels whose template
    # underflows (extreme EBV, dead SFH corner) are reclassified as empty
    mean_flux = np.abs(np.asarray(model, np.float64)).mean(axis=1)
    target = 10.0 ** rng.uniform(np.log10(flux_lo), np.log10(flux_hi), D)
    dead_model = mean_flux <= 1e-25
    empty = empty | dead_model
    amp = np.where(empty, 0.0,
                   target / np.maximum(mean_flux, 1e-300))
    spec = np.where(empty[:, None], 0.0, amp[:, None] * model)
    cube = (spec.T + rng.normal(0.0, noise, (nspec, D))).astype(np.float32)
    cube = cube.reshape(nspec, ny, nx)
    stat = np.full((nspec, ny, nx), noise ** 2, np.float32)
    fits_write(path, {"DATA": cube, "STAT": stat},
               extra_cards={"CRVAL3": crval3, "CD3_3": cd3})
    with open(region_path, "w") as fh:
        # whole-field box: every spaxel selected, in flat row-major order
        fh.write("# Region file format: DS9\nimage\n")
        fh.write(f"box({nx/2:.1f},{ny/2:.1f},{nx*2},{ny*2})\n")
    yy = np.nansum(cube.reshape(nspec, D) ** 2 / noise ** 2, axis=0)
    with open(truths_path, "w") as fh:
        json.dump({
            "params": theta.tolist(),
            "param_names": ["Z", "logSFtau", "SFage", "z", "EBV"],
            "amp": amp.tolist(),
            "empty": empty.tolist(),
            "noise": noise, "nspec": nspec, "ny": ny, "nx": nx,
            "zlo": zlo, "zhi": zhi, "seed": seed,
            "yy": yy.tolist(),
        }, fh)
    return path, region_path, truths_path


def make_synthetic_cube(path: str, region_path: str, nspec: int = 300,
                        ny: int = 8, nx: int = 8, seed: int = 1,
                        noise: float = 0.05):
    """FITS cube with DATA/STAT extensions and a circular ds9 region."""
    rng = np.random.default_rng(seed)
    crval3, cd3 = 4750.0, (9000.0 - 4750.0) / nspec
    wl = crval3 + cd3 * np.arange(nspec)
    cont = 1.0 / (wl / 6000.0) ** 2
    cube = np.zeros((nspec, ny, nx), np.float32)
    for j in range(ny):
        for i in range(nx):
            amp = rng.uniform(0.5, 2.0)
            slope = rng.uniform(-0.3, 0.3)
            spec = amp * cont * (1 + slope * (wl - 6000) / 6000)
            cube[:, j, i] = spec + rng.normal(0, noise, nspec)
    stat = np.full((nspec, ny, nx), noise ** 2, np.float32)
    # a few NaN spaxels to exercise screening (musefuse.py:92-95)
    stat[:, 0, 0] = np.nan
    fits_write(path, {"DATA": cube, "STAT": stat},
               extra_cards={"CRVAL3": crval3, "CD3_3": cd3})
    with open(region_path, "w") as fh:
        fh.write("# Region file format: DS9\nimage\n")
        fh.write(f"circle({nx/2:.1f},{ny/2:.1f},{max(nx,ny)/2:.1f})\n")
    return path, region_path
