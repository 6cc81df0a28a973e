"""MUSE stellar-population model, batch-first.

Counterpart of ``massivedatans_tpu/muse/model.py`` (reference
``musefuse.py:160-346``): a 5-parameter (Z, logSFtau, SFage, z, EBV)
delayed-exponential star-formation-history synthesis over a
metallicity/age template grid, Calzetti extinction, and a redshift
interpolation onto the instrument wavelength grid. The 4-parameter ZSOL
variant fixes Z = 0.004.

The synthesis is one float32 product ``[B, n_ages-1] @ [n_ages-1, nZ*n_wl]``
(the JAX package's ``einsum("ba,zaw->bzw")`` at HIGHEST precision, left to
XLA there and to ``torch.matmul`` here; TF32 must be off, see
``config.set_fp32_precision``), so the peak stays at ``[B, nZ, n_wl]``:
gathering ``templates[iZ]`` per candidate would make a
``[B, n_ages, n_wl]`` block. The metallicity row is then picked by an exact
gather on the Z axis, which gives the JAX one-hot sum's numbers wherever
they are finite.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# The published BC03 age grid (years), exactly as hardcoded by the reference
# (musefuse.py:190). The reference takes every second entry (``[::2]``);
# template files must carry one column per subsampled age.
REFERENCE_AGES = np.array([
    0.000E+00, 1.000E+05, 1.412E+05, 1.585E+05, 1.778E+05, 1.995E+05,
    2.239E+05, 2.512E+05, 2.818E+05, 3.162E+05, 3.548E+05, 3.981E+05,
    4.467E+05, 5.012E+05, 5.623E+05, 6.310E+05, 7.080E+05, 7.943E+05,
    8.913E+05, 1.000E+06, 1.047E+06, 1.096E+06, 1.148E+06, 1.202E+06,
    1.259E+06, 1.318E+06, 1.380E+06, 1.445E+06, 1.514E+06, 1.585E+06,
    1.660E+06, 1.738E+06, 1.820E+06, 1.906E+06, 1.995E+06, 2.089E+06,
    2.188E+06, 2.291E+06, 2.399E+06, 2.512E+06, 2.630E+06, 2.754E+06,
    2.884E+06, 3.020E+06, 3.162E+06, 3.311E+06, 3.467E+06, 3.631E+06,
    3.802E+06, 3.981E+06, 4.169E+06, 4.365E+06, 4.571E+06, 4.786E+06,
    5.012E+06, 5.248E+06, 5.495E+06, 5.754E+06, 6.026E+06, 6.310E+06,
    6.607E+06, 6.918E+06, 7.244E+06, 7.586E+06, 7.943E+06, 8.318E+06,
    8.710E+06, 9.120E+06, 9.550E+06, 1.000E+07, 1.047E+07, 1.096E+07,
    1.148E+07, 1.202E+07, 1.259E+07, 1.318E+07, 1.380E+07, 1.445E+07,
    1.514E+07, 1.585E+07, 1.660E+07, 1.738E+07, 1.820E+07, 1.906E+07,
    1.995E+07, 2.089E+07, 2.188E+07, 2.291E+07, 2.399E+07, 2.512E+07,
    2.630E+07, 2.754E+07, 2.900E+07, 3.000E+07, 3.100E+07, 3.200E+07,
    3.300E+07, 3.400E+07, 3.500E+07, 3.600E+07, 3.700E+07, 3.800E+07,
    3.900E+07, 4.000E+07, 4.250E+07, 4.500E+07, 4.750E+07, 5.000E+07,
    5.250E+07, 5.500E+07, 5.709E+07, 6.405E+07, 7.187E+07, 8.064E+07,
    9.048E+07, 1.015E+08, 1.139E+08, 1.278E+08, 1.434E+08, 1.609E+08,
    1.805E+08, 2.026E+08, 2.273E+08, 2.550E+08, 2.861E+08, 3.210E+08,
    3.602E+08, 4.042E+08, 4.535E+08, 5.088E+08, 5.709E+08, 6.405E+08,
    7.187E+08, 8.064E+08, 9.048E+08, 1.015E+09, 1.139E+09, 1.278E+09,
    1.434E+09, 1.609E+09, 1.680E+09, 1.700E+09, 1.800E+09, 1.900E+09,
    2.000E+09, 2.100E+09, 2.200E+09, 2.300E+09, 2.400E+09, 2.500E+09,
    2.600E+09, 2.750E+09, 3.000E+09, 3.250E+09, 3.500E+09, 3.750E+09,
    4.000E+09, 4.250E+09, 4.500E+09, 4.750E+09, 5.000E+09, 5.250E+09,
    5.500E+09, 5.750E+09, 6.000E+09, 6.250E+09, 6.500E+09, 6.750E+09,
    7.000E+09, 7.250E+09, 7.500E+09, 7.750E+09, 8.000E+09, 8.250E+09,
    8.500E+09, 8.750E+09, 9.000E+09, 9.250E+09, 9.500E+09, 9.750E+09,
    1.000E+10, 1.025E+10, 1.050E+10, 1.075E+10, 1.100E+10, 1.125E+10,
    1.150E+10, 1.175E+10, 1.200E+10, 1.225E+10, 1.250E+10, 1.275E+10,
    1.300E+10, 1.325E+10, 1.350E+10, 1.375E+10, 1.400E+10, 1.425E+10,
    1.450E+10, 1.475E+10, 1.500E+10, 1.525E+10, 1.550E+10, 1.575E+10,
    1.600E+10, 1.625E+10, 1.650E+10, 1.675E+10, 1.700E+10, 1.725E+10,
    1.750E+10, 1.775E+10, 1.800E+10, 1.825E+10, 1.850E+10, 1.875E+10,
    1.900E+10, 1.925E+10, 1.950E+10, 1.975E+10, 2.000E+10,
])


_Z_GRID = np.log10([0.0001, 0.0004, 0.004, 0.008, 0.02, 0.05, 0.1])
_SFTAU_GRID = np.log10(np.array([1, 4, 10, 40, 100, 400, 1000, 4000]) * 1e6)
_SFAGE_MAX = 13.0
_ZSOL_Z = float(np.log10(0.004))  # ZSOL's fixed metallicity (musefuse.py:540-543)


def calzetti_curve(wavelength_nm: np.ndarray) -> np.ndarray:
    """Calzetti (2000) attenuation k(lambda) (musefuse.py:257-266)."""
    wl = np.asarray(wavelength_nm, np.float64)
    out = np.zeros_like(wl)
    blue = wl < 630.0
    out[blue] = 2.659 * (
        -2.156 + 1.509e3 / wl[blue] - 0.198e6 / wl[blue] ** 2
        + 0.011e9 / wl[blue] ** 3
    ) + 4.05
    red = ~blue
    out[red] = 2.659 * (-1.857 + 1.040e3 / wl[red]) + 4.05
    return out


class MuseModelData(nn.Module):
    """The model's grids as float32 buffers, so ``.to(device)`` moves them.

    ``synth`` is derived from ``templates``: the age-major
    ``[n_ages - 1, nZ * n_wl]`` right-hand side of the synthesis product
    (the last age column carries no SFH weight).
    """

    def __init__(self, templates, ages, age_weight, model_wl, calzetti,
                 data_wl, z_grid, norm_index: int, zlo, zhi):
        super().__init__()
        self.register_buffer("templates", templates)    # [nZ, n_ages, n_wl]
        self.register_buffer("ages", ages)              # [n_ages] years
        self.register_buffer("age_weight", age_weight)  # [n_ages - 1]
        self.register_buffer("model_wl", model_wl)      # [n_wl] nm, uniform
        self.register_buffer("calzetti", calzetti)      # [n_wl]
        self.register_buffer("data_wl", data_wl)        # [nspec] nm
        self.register_buffer("z_grid", z_grid)          # [nZ] log10 Z
        self.register_buffer("sftau_grid", torch.as_tensor(
            _SFTAU_GRID, dtype=torch.float32, device=templates.device))
        self.register_buffer("zlo", zlo)                # scalar
        self.register_buffer("zhi", zhi)                # scalar
        self.norm_index = int(norm_index)  # normalization pixel, model grid
        nZ, n_ages, n_wl = templates.shape
        self.register_buffer("synth", templates[:, :-1, :].permute(1, 0, 2)
                             .reshape(n_ages - 1, nZ * n_wl).contiguous())


def model_data_from_numpy(templates, ages, model_wl, data_wl_nm, zlo, zhi,
                          norm_index, age_weight=None, calzetti=None,
                          z_grid=None, device="cpu") -> MuseModelData:
    """``MuseModelData`` from host arrays, each cast to float32 on
    ``device``; the derived grids default to what ``load_template_grid``
    computes from the others."""
    def f32(a):
        return torch.as_tensor(np.array(a), dtype=torch.float32,
                               device=device)

    return MuseModelData(
        templates=f32(templates),
        ages=f32(ages),
        age_weight=f32(np.diff(np.asarray(ages, np.float64))
                       if age_weight is None else age_weight),
        model_wl=f32(model_wl),
        calzetti=f32(calzetti_curve(model_wl) if calzetti is None
                     else calzetti),
        data_wl=f32(data_wl_nm),
        z_grid=f32(_Z_GRID if z_grid is None else z_grid),
        norm_index=int(norm_index),
        zlo=f32(zlo),
        zhi=f32(zhi),
    )


def load_template_grid(filenames, ages=None, data_wl_nm=None,
                       zlo=0.0, zhi=0.5, uniform_oversample: int = 2,
                       device="cpu") -> MuseModelData:
    """Build the dense model tensors from per-metallicity template files
    (reference loadtxt loop, musefuse.py:173-179: column 0 = wavelength in
    Angstrom, columns 1.. = one spectrum per age).

    The library is resampled on the host onto a UNIFORM wavelength grid of
    ``uniform_oversample`` × the native point count, so the redshift lookup
    of ``predict_batch`` is arithmetic indexing plus two gathers; a
    non-uniform grid without the resample is refused."""
    grids = []
    model_wl = None
    for fn in filenames:
        data = np.loadtxt(fn)
        model_wl = data[:, 0] / 10.0  # Angstrom -> nm (musefuse.py:255-256)
        grids.append(data[:, 1:].T)   # [n_ages, n_wl]
    templates = np.stack(grids)       # [nZ, n_ages, n_wl]
    if uniform_oversample:
        wl_u = np.linspace(model_wl[0], model_wl[-1],
                           uniform_oversample * len(model_wl))
        templates = np.stack([
            np.stack([np.interp(wl_u, model_wl, row) for row in g])
            for g in templates
        ])
        model_wl = wl_u
    else:
        dwl = np.diff(model_wl)
        if not np.allclose(dwl, dwl[0], rtol=1e-4):
            raise ValueError(
                "uniform_oversample=0 requires an already-uniform template "
                f"wavelength grid (spacing varies {dwl.min():.4g}.."
                f"{dwl.max():.4g} nm); the redshift lookup uses arithmetic "
                "uniform-grid indexing and would return wrong spectra — "
                "leave uniform_oversample>=1 for non-uniform libraries"
            )
    n_ages = templates.shape[1]
    if ages is None:
        ages = REFERENCE_AGES[::2]  # musefuse.py:190
        if n_ages != len(ages):
            raise ValueError(
                f"template files carry {n_ages} age columns but the "
                f"reference BC03 grid (musefuse.py:190, [::2]) has "
                f"{len(ages)} entries; pass ages= / --ages-file with the "
                "grid matching your template library — silently guessing "
                "ages would mis-weight the SFH synthesis"
            )
    ages = np.asarray(ages, np.float64)
    if len(ages) != n_ages:
        raise ValueError(
            f"ages grid has {len(ages)} entries but template files carry "
            f"{n_ages} age columns"
        )
    # normalize near 656nm rest frame (reference index 2050 on its grid)
    norm_index = int(np.argmin(np.abs(model_wl - 656.0)))
    return model_data_from_numpy(
        templates, ages, model_wl,
        data_wl_nm if data_wl_nm is not None else model_wl,
        zlo, zhi, norm_index, device=device)


def muse_prior_transform(md: MuseModelData, u):
    """FULL model prior (musefuse.py:490-500) on ``u[B, 5]``: Z, logSFtau,
    SFage, z, EBV."""
    zg, tg = md.z_grid, md.sftau_grid
    return torch.stack([
        u[:, 0] * (zg[-1] - zg[0]) + zg[0],
        u[:, 1] * (tg[-1] - tg[0]) + tg[0],
        u[:, 2] * _SFAGE_MAX,
        u[:, 3] * (md.zhi - md.zlo) + md.zlo,
        u[:, 4] * 2.0,
    ], dim=1)


def muse_prior_transform_zsol(md: MuseModelData, u):
    """ZSOL model prior (musefuse.py:502-510) on ``u[B, 4]``: logSFtau,
    SFage, z, EBV."""
    tg = md.sftau_grid
    return torch.stack([
        u[:, 0] * (tg[-1] - tg[0]) + tg[0],
        u[:, 1] * _SFAGE_MAX,
        u[:, 2] * (md.zhi - md.zlo) + md.zlo,
        u[:, 3] * 2.0,
    ], dim=1)


def _sfh_weights(md: MuseModelData, logSFtau, sfage):
    """[B, n_ages] delayed-exponential SFH weights (musefuse.py:237-251),
    max-normalized per candidate in log space so extreme sfage/tau corners
    do not underflow f32. At sfage = 0 every ``log_sfh`` is -inf and the
    normalization gives NaN: the ``isfinite`` guard zeroes that row."""
    SFtau = 10.0 ** logSFtau                              # [B]
    tsince = torch.clamp_min(sfage[:, None] * 1e9 - md.ages[None, :], 0.0)
    log_sfh = torch.where(
        tsince > 0.0, torch.log(torch.clamp_min(tsince, 1e-30)), -torch.inf
    ) - tsince / SFtau[:, None]
    sfh = torch.exp(log_sfh - torch.amax(log_sfh, dim=1, keepdim=True))
    return torch.where(torch.isfinite(sfh), sfh, 0.0)


def predict_batch(md: MuseModelData, x_batch, zsol: bool = False):
    """``[B, nspec]`` model spectra for a parameter batch ``x[B, ndim]``."""
    B = x_batch.shape[0]
    if zsol:
        Zp = torch.full((B,), _ZSOL_Z, dtype=torch.float32,
                        device=x_batch.device)
        logSFtau, sfage, z, EBV = x_batch.unbind(dim=1)
    else:
        Zp, logSFtau, sfage, z, EBV = x_batch.unbind(dim=1)
    nZ, n_wl = md.z_grid.shape[0], md.model_wl.shape[0]
    # metallicity bin: largest grid Z <= Z (reference iZ selection, :224)
    iZ = torch.clamp(
        torch.searchsorted(md.z_grid, Zp.contiguous(), right=True) - 1,
        0, nZ - 1)
    w = _sfh_weights(md, logSFtau, sfage)[:, :-1] * md.age_weight[None, :]
    per_z = torch.matmul(w, md.synth).view(B, nZ, n_wl)   # [B, nZ, n_wl]
    template = torch.gather(
        per_z, 1, iZ[:, None, None].expand(B, 1, n_wl)).squeeze(1)
    template = template / (1e-10 + template[:, md.norm_index][:, None])
    template = template * 10.0 ** (-2.5 * md.calzetti[None, :]
                                   * EBV[:, None])
    # redshift: sample the restframe model at data_wl / (1 + z) on the
    # uniform model grid; queries outside it clamp to the endpoint values
    q = md.data_wl[None, :] / (1.0 + z)[:, None]          # [B, nspec]
    wl0 = md.model_wl[0]
    dwl = (md.model_wl[n_wl - 1] - wl0) / (n_wl - 1)
    pos = torch.clamp((q - wl0) / dwl, 0.0, n_wl - 1.0)
    i0 = torch.clamp_max(pos.to(torch.int64), n_wl - 2)
    frac = pos - i0.to(pos.dtype)
    t0 = torch.gather(template, 1, i0)
    t1 = torch.gather(template, 1, i0 + 1)
    return t0 * (1.0 - frac) + t1 * frac


def predict_spectrum(md: MuseModelData, Z, logSFtau, sfage, z, EBV):
    """One FULL-model spectrum on the data wavelength grid
    (musefuse.py:268-346): ``predict_batch`` on one row."""
    x = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                     device=md.templates.device)
                     for v in (Z, logSFtau, sfage, z, EBV)])
    return predict_batch(md, x[None, :])[0]
