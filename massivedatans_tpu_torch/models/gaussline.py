"""Gaussian emission-line model over many spectra.

Counterpart of ``massivedatans_tpu/models/gaussline.py`` (reference
``sample.py:44-108`` and ``clike.c:34-89``). For a batch of B parameter
vectors the model curves ``ypred[B, nx]`` are computed once and scored
against all D spectra through one ``[B, nx] @ [nx, D]`` product:

    chi2[b, d] = (||ypred_b||^2 - 2 ypred_b . y_d + ||y_d||^2) / noise^2

The product is a plain float32 ``torch.matmul`` (the JAX package left it to
XLA too). It must run in full float32: chi^2 needs >= 11 mantissa bits on
its inputs and TF32 keeps 10, so callers on the card first set the
precision with ``config.set_fp32_precision``.
"""

from __future__ import annotations

import numpy as np
import torch

from massivedatans_tpu_torch.models.base import Problem


def gaussline_prior_transform(u):
    """Reference ``priortransform`` (sample.py:52-58) on ``u[B, 3]``:
    A, mu, log10(sigma)."""
    A = 10.0 ** (u[:, 0] * 2.0 - 2.0)
    mu = u[:, 1] * 400.0 + 400.0
    log_sig = u[:, 2] * 2.0
    return torch.stack([A, mu, log_sig], dim=1)


def gaussline_predict(x_grid, params):
    """Model curves ``A exp(-((mu - x)/sig)^2 / 2)`` (sample.py:64-68):
    ``params[B, 3]`` -> ``[B, nx]``."""
    A, mu, log_sig = params[:, 0:1], params[:, 1:2], params[:, 2:3]
    sig = 10.0 ** log_sig
    return A * torch.exp(-0.5 * torch.square((mu - x_grid[None, :]) / sig))


def chi2_loglike_batch(x_grid, y, ysq, noise_level, x_batch):
    """``L[B, D]`` for all datasets at once (replaces clike.c)."""
    ypred = gaussline_predict(x_grid, x_batch)            # [B, nx]
    cross = torch.matmul(ypred, y)                        # [B, D]
    ssp = torch.square(ypred).sum(dim=1)                  # [B]
    chi2 = ssp[:, None] - 2.0 * cross + ysq[None, :]
    inv_var = 1.0 / torch.square(noise_level)
    return -0.5 * chi2 * inv_var


def chi2_loglike_paired(x_grid, y, ysq, noise_level, x):
    """``L[..., d]`` of dataset d under its own parameter vector
    ``x[..., d, :]``: one curve per dataset, O(D * nx), for the gradient
    backends. The JAX package's HIGHEST-precision ``einsum("dn,nd->d")``
    is an elementwise product and a sum here, so no TF32 path exists;
    leading axes of ``x`` broadcast."""
    lead, ndim = x.shape[:-1], x.shape[-1]
    ypred = gaussline_predict(x_grid, x.reshape(-1, ndim))
    ypred = ypred.reshape(*lead, x_grid.shape[0])         # [..., D, nx]
    cross = (ypred * y.T).sum(dim=-1)                     # [..., D]
    ssp = torch.square(ypred).sum(dim=-1)
    chi2 = ssp - 2.0 * cross + ysq
    return -0.5 * chi2 / torch.square(noise_level)


class GaussLine(Problem):
    name = "gaussline"

    def __init__(self, x, y, ysq, noise_level):
        super().__init__(ndim=3, ndata=y.shape[1])
        self.register_buffer("x", x)                      # [nx]
        self.register_buffer("y", y)                      # [nx, D]
        self.register_buffer("ysq", ysq)                  # [D]
        self.register_buffer("noise_level", noise_level)  # scalar

    def transform_batch(self, u):
        return gaussline_prior_transform(u)

    def loglike(self, x):
        return chi2_loglike_batch(self.x, self.y, self.ysq, self.noise_level, x)

    def loglike_paired(self, x):
        return chi2_loglike_paired(self.x, self.y, self.ysq, self.noise_level,
                                   x)

    def predict_one(self, x):
        """The model curve of ``x[ndim]`` on the data grid
        (``gaussline_predict_one``)."""
        return gaussline_predict(self.x, x[None, :])[0]


def make_gaussline_problem(x_grid, y, noise_level=0.01, device="cpu") -> GaussLine:
    """The line-fit problem from a ``[nx]`` grid and ``[nx, D]`` spectra.

    ``ysq`` is summed on the host in float64 and then cast to float32, as
    the JAX package does (gaussline.py:114-121): an f32 sum of squares would
    lose the absolute accuracy chi^2 needs.
    """
    x64 = np.asarray(x_grid, dtype=np.float64)
    y64 = np.asarray(y, dtype=np.float64)
    f32 = dict(dtype=torch.float32, device=device)
    return GaussLine(
        x=torch.as_tensor(x64, **f32),
        y=torch.as_tensor(y64, **f32),
        ysq=torch.as_tensor((y64 ** 2).sum(axis=0), **f32),
        noise_level=torch.tensor(noise_level, **f32),
    )
