"""Scale-marginalized spectral likelihood for MUSE spaxels.

Counterpart of ``massivedatans_tpu/muse/likelihood.py`` (reference
``cmuselike.c:34-66``): per spaxel the best-fit amplitude
``s = sum(y*m/var) / sum(m^2/var)`` is profiled out, and for a batch of B
model spectra against D spaxels the chi^2 is two float32 products:

    s1[b,d] = ypred[b] . (y/var)[:, d]
    s2[b,d] = ypred^2[b] . (1/var)[:, d]
    chi2[b,d] = yy[d] - 2 s s1 + s^2 s2,  s = s1/(s2 + 1e-10)

Masked bins (NaN flux or variance) carry zero weight in the precomputed
``y/var``, ``1/var`` and ``yy``, which ``make_muse_problem`` forms in
float64 on the host before casting to float32.

f32 underflow guard: the chi^2 is invariant under a per-candidate rescaling
m -> c*m, but a high-EBV candidate's Calzetti factor drives m to ~1e-20 and
m^2 flushes to zero in f32. Every entry point therefore rescales each
candidate to max |m| = 1 first (``_unit_scale``). A candidate whose model
spectrum is all zero ("no stars", musefuse.py:363-366) scores ``-inf``; the
JAX package writes -1e100, which its float32 cast turns into -inf too.
"""

from __future__ import annotations

import numpy as np
import torch

from massivedatans_tpu_torch.models.base import Problem
from massivedatans_tpu_torch.muse.model import (
    MuseModelData,
    muse_prior_transform,
    muse_prior_transform_zsol,
    predict_batch,
)


def _unit_scale(ypred):
    """Rescale each candidate spectrum (row) to max |m| = 1. All-zero rows
    pass through unchanged (the no-stars guard catches them)."""
    norm = torch.amax(torch.abs(ypred), dim=1, keepdim=True)
    return ypred / torch.where(norm > 0.0, norm, 1.0)


def _profiled_loglike(s1, s2, yy):
    s2 = s2 + 1e-10
    s = s1 / s2
    chi2 = yy - 2.0 * s * s1 + torch.square(s) * s2
    return -0.5 * chi2


def scaled_loglike_batch(md: MuseModelData, y_over_v, inv_v, yy, x_batch,
                         zsol: bool = False):
    """``L[B, D]``: every candidate of ``x[B, ndim]`` against every spaxel."""
    ypred = predict_batch(md, x_batch, zsol=zsol)        # [B, nspec]
    dead = torch.all(ypred == 0.0, dim=1)
    ypred = _unit_scale(ypred)
    s1 = torch.matmul(ypred, y_over_v)
    s2 = torch.matmul(torch.square(ypred), inv_v)
    L = _profiled_loglike(s1, s2, yy[None, :])
    return torch.where(dead[:, None], -torch.inf, L)


def scaled_loglike_paired(md: MuseModelData, y_over_v, inv_v, yy, x,
                          zsol: bool = False):
    """``L[..., d]`` of spaxel d under its own parameter vector
    ``x[..., d, :]``; leading axes broadcast (the synthesis is row by
    row, so they are flattened into its batch and restored after)."""
    lead, ndim = x.shape[:-1], x.shape[-1]
    ypred = predict_batch(md, x.reshape(-1, ndim), zsol=zsol)  # [n*D, nspec]
    dead = torch.all(ypred == 0.0, dim=1).reshape(lead)
    ypred = _unit_scale(ypred).reshape(*lead, -1)          # [..., D, nspec]
    s1 = (ypred * y_over_v.T).sum(dim=-1)
    s2 = (torch.square(ypred) * inv_v.T).sum(dim=-1)
    return torch.where(dead, -torch.inf, _profiled_loglike(s1, s2, yy))


class MuseProblem(Problem):
    """The many-spaxel MUSE problem: FULL (ndim 5) or ZSOL (ndim 4)."""

    def __init__(self, md: MuseModelData, y_over_v, inv_v, yy,
                 zsol: bool = False, name: str = "muse"):
        super().__init__(ndim=4 if zsol else 5, ndata=yy.shape[0])
        self.md = md
        self.register_buffer("y_over_v", y_over_v)  # [nspec, D]
        self.register_buffer("inv_v", inv_v)        # [nspec, D]
        self.register_buffer("yy", yy)              # [D]
        self.zsol = zsol
        self.name = name

    def transform_batch(self, u):
        if self.zsol:
            return muse_prior_transform_zsol(self.md, u)
        return muse_prior_transform(self.md, u)

    def loglike(self, x):
        return scaled_loglike_batch(self.md, self.y_over_v, self.inv_v,
                                    self.yy, x, zsol=self.zsol)

    def loglike_paired(self, x):
        return scaled_loglike_paired(self.md, self.y_over_v, self.inv_v,
                                     self.yy, x, zsol=self.zsol)

    def predict_one(self, x):
        """One unscaled model spectrum; the best-fit amplitude against a
        spaxel is ``s1/s2`` (cmuselike.c:48-64)."""
        return predict_batch(self.md, x[None, :], zsol=self.zsol)[0]


def make_muse_problem(md: MuseModelData, y, var, zsol: bool = False,
                      name: str = "muse") -> MuseProblem:
    """The MUSE problem from ``[nspec, D]`` flux and variance arrays, on
    the device of ``md``. The weights are formed in float64 and invalid
    bins zeroed before the float32 cast (an f32 ``yy`` would lose the
    absolute accuracy chi^2 needs)."""
    y64 = np.asarray(y, np.float64)
    v64 = np.asarray(var, np.float64)
    valid = np.isfinite(y64) & np.isfinite(v64) & (v64 > 0)
    inv_v = np.where(valid, 1.0 / np.where(valid, v64, 1.0), 0.0)
    y_over_v = np.where(valid, y64 * inv_v, 0.0)
    yy = np.where(valid, y64 ** 2 * inv_v, 0.0).sum(axis=0)
    f32 = dict(dtype=torch.float32, device=md.templates.device)
    return MuseProblem(md, torch.as_tensor(y_over_v, **f32),
                       torch.as_tensor(inv_v, **f32),
                       torch.as_tensor(yy, **f32), zsol=zsol, name=name)
