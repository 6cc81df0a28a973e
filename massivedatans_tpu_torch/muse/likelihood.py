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

Under a (data, model) mesh each rank holds a wavelength slice of the
weights (``MuseProblem.shard``) and ``scaled_loglike_batch_mp`` reduces
``s1`` and ``s2`` over the model axis before the best-fit scale.
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
from massivedatans_tpu_torch.parallel.sharded import (
    all_reduce,
    dataset_block,
    model_block,
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


def scaled_loglike_batch_mp(md: MuseModelData, y_over_v, inv_v, yy, x_batch,
                            wl_block: slice, model_group, zsol: bool = False):
    """Model-parallel ``L[B, D]`` (JAX ``scaled_loglike_batch_mp``):
    ``y_over_v`` and ``inv_v`` hold the wavelength bins ``wl_block`` of
    this rank. The synthesis runs replicated and is scaled to unit max on
    the FULL spectrum, so every rank applies the same scale; each rank
    contracts its slice and ``s1``, ``s2`` are summed over
    ``model_group`` before the nonlinear best-fit scale."""
    ypred = predict_batch(md, x_batch, zsol=zsol)        # [B, nspec]
    dead = torch.all(ypred == 0.0, dim=1)
    ypred = _unit_scale(ypred)[:, wl_block]
    s12 = torch.stack([torch.matmul(ypred, y_over_v),
                       torch.matmul(torch.square(ypred), inv_v)])
    s1, s2 = all_reduce(s12, model_group)
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
        # this rank's wavelength bins and the ranks sharing them (``shard``)
        self.wl_block = slice(0, y_over_v.shape[0])
        self.n_model = 1

    def transform_batch(self, u):
        if self.zsol:
            return muse_prior_transform_zsol(self.md, u)
        return muse_prior_transform(self.md, u)

    def loglike(self, x):
        if self.n_model > 1:
            raise ValueError("this problem holds a wavelength slice: its "
                             "likelihood is loglike_sharded(x, model_group)")
        return scaled_loglike_batch(self.md, self.y_over_v, self.inv_v,
                                    self.yy, x, zsol=self.zsol)

    def loglike_sharded(self, x, model_group=None):
        if model_group is None:
            return self.loglike(x)
        return scaled_loglike_batch_mp(self.md, self.y_over_v, self.inv_v,
                                       self.yy, x, self.wl_block, model_group,
                                       zsol=self.zsol)

    def shard(self, rank_data, n_data, rank_model=0, n_model=1):
        """Spaxels in block ``rank_data`` of ``n_data``; weights in
        wavelength block ``rank_model`` of ``n_model``; ``yy`` and the
        templates stay whole."""
        b = dataset_block(self.ndata, rank_data, n_data)
        w = model_block(self.y_over_v.shape[0], rank_model, n_model)
        out = MuseProblem(self.md, self.y_over_v[w, b].contiguous(),
                          self.inv_v[w, b].contiguous(),
                          self.yy[b].contiguous(), zsol=self.zsol,
                          name=self.name)
        out.wl_block, out.n_model = w, n_model
        return out

    def loglike_paired(self, x):
        return scaled_loglike_paired(self.md, self.y_over_v, self.inv_v,
                                     self.yy, x, zsol=self.zsol)

    def predict_one(self, x):
        """One unscaled model spectrum; the best-fit amplitude against a
        spaxel is ``s1/s2`` (cmuselike.c:48-64)."""
        return predict_batch(self.md, x[None, :], zsol=self.zsol)[0]


def muse_weights(y, var):
    """``(y/var, 1/var, yy)`` of ``[nspec, D]`` flux and variance arrays,
    in float64 on the host, invalid bins (NaN, variance <= 0) zeroed."""
    y64 = np.asarray(y, np.float64)
    v64 = np.asarray(var, np.float64)
    valid = np.isfinite(y64) & np.isfinite(v64) & (v64 > 0)
    inv_v = np.where(valid, 1.0 / np.where(valid, v64, 1.0), 0.0)
    y_over_v = np.where(valid, y64 * inv_v, 0.0)
    yy = np.where(valid, y64 ** 2 * inv_v, 0.0).sum(axis=0)
    return y_over_v, inv_v, yy


def make_muse_problem(md: MuseModelData, y, var, zsol: bool = False,
                      name: str = "muse") -> MuseProblem:
    """The MUSE problem from ``[nspec, D]`` flux and variance arrays, on
    the device of ``md``. The weights are formed in float64
    (``muse_weights``) before the float32 cast (an f32 ``yy`` would lose
    the absolute accuracy chi^2 needs)."""
    y_over_v, inv_v, yy = muse_weights(y, var)
    f32 = dict(dtype=torch.float32, device=md.templates.device)
    return MuseProblem(md, torch.as_tensor(y_over_v, **f32),
                       torch.as_tensor(inv_v, **f32),
                       torch.as_tensor(yy, **f32), zsol=zsol, name=name)
