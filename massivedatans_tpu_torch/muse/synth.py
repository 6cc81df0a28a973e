"""Synthetic MUSE fixtures: template library, datacube and region file.

``make_template_files`` and ``make_synthetic_cube`` are the JAX package's
numpy-only functions (``massivedatans_tpu/muse/synth.py``), re-exported.
``make_model_cube`` is its counterpart with this package's
``predict_batch``, so the model-family cube can be built where JAX is not
installed.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from massivedatans_tpu.muse.fitsio import fits_write
from massivedatans_tpu.muse.synth import (  # noqa: F401
    make_synthetic_cube,
    make_template_files,
)
from massivedatans_tpu_torch.muse.model import (
    _SFTAU_GRID,
    load_template_grid,
    predict_batch,
)


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
