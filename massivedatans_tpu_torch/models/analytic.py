"""Analytic-evidence test problem.

Counterpart of ``massivedatans_tpu/models/analytic.py``: a spherical
Gaussian likelihood on the unit cube whose evidence has a closed form per
dataset, the sharpest end-to-end oracle of the sampler, and its two-blob
mixture, the multimodal oracle.

    L_d(theta) = -sum_i (theta_i - c_{d,i})^2 / (2 s^2)
    Z_d = prod_i s * sqrt(2*pi)/2 * [erf((1-c_i)/(s*sqrt2)) + erf(c_i/(s*sqrt2))]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from massivedatans_tpu_torch.models.base import Problem
from massivedatans_tpu_torch.parallel.sharded import dataset_block


def analytic_loglike_batch(centers, sigma, x_batch):
    # ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2, as the JAX package writes it
    cross = torch.matmul(x_batch, centers.T)              # [B, D]
    ssx = torch.square(x_batch).sum(dim=1)
    ssc = torch.square(centers).sum(dim=1)
    d2 = ssx[:, None] - 2.0 * cross + ssc[None, :]
    return -0.5 * d2 / torch.square(sigma)


def true_logZ(centers, sigma: float) -> np.ndarray:
    """Exact per-dataset log-evidence of the unit-cube-truncated Gaussian."""
    from scipy.special import erf

    c = np.asarray(centers, dtype=np.float64)
    s2 = sigma * np.sqrt(2.0)
    per_axis = (sigma * np.sqrt(2.0 * np.pi) / 2.0) * (
        erf((1.0 - c) / s2) + erf(c / s2)
    )
    return np.log(per_axis).sum(axis=1)


class AnalyticGaussian(Problem):
    name = "analytic_gaussian"

    def __init__(self, centers, sigma):
        super().__init__(ndim=centers.shape[1], ndata=centers.shape[0])
        self.register_buffer("centers", centers)  # [D, ndim]
        self.register_buffer("sigma", sigma)      # scalar

    def transform_batch(self, u):
        return u

    def loglike(self, x):
        return analytic_loglike_batch(self.centers, self.sigma, x)

    def shard(self, rank_data, n_data, rank_model=0, n_model=1):
        self.require_no_model_axis(n_model)
        b = dataset_block(self.ndata, rank_data, n_data)
        return AnalyticGaussian(self.centers[b], self.sigma)


def make_analytic_gaussian_problem(centers, sigma=0.05, device="cpu") -> AnalyticGaussian:
    f32 = dict(dtype=torch.float32, device=device)
    return AnalyticGaussian(
        centers=torch.as_tensor(np.asarray(centers, np.float64), **f32),
        sigma=torch.tensor(sigma, **f32),
    )


def _sq_dist_to(x_batch, centers):
    cross = torch.matmul(x_batch, centers.T)
    ssx = torch.square(x_batch).sum(dim=1)
    ssc = torch.square(centers).sum(dim=1)
    return ssx[:, None] - 2.0 * cross + ssc[None, :]


def bimodal_loglike_batch(centers_a, centers_b, sigma, x_batch):
    """log(0.5 N(c_a, s) + 0.5 N(c_b, s)) per dataset: the multimodal
    oracle (an equal-weight two-blob mixture with exact evidence)."""
    inv = 0.5 / torch.square(sigma)
    la = -_sq_dist_to(x_batch, centers_a) * inv
    lb = -_sq_dist_to(x_batch, centers_b) * inv
    return torch.logaddexp(la, lb) - math.log(2.0)


def true_logZ_bimodal(centers_a, centers_b, sigma: float) -> np.ndarray:
    """Exact evidence of the equal-weight truncated two-Gaussian mixture."""
    za = true_logZ(centers_a, sigma)
    zb = true_logZ(centers_b, sigma)
    return np.logaddexp(za, zb) - np.log(2.0)


class AnalyticBimodal(Problem):
    """Two Gaussian blobs per dataset with known total evidence: the
    multimodal acceptance oracle (the regime the reference's
    MultiEllipsoidal/nestle splitting exists for, elldrawer.py:36-48)."""

    name = "analytic_bimodal"

    def __init__(self, centers_a, centers_b, sigma):
        super().__init__(ndim=centers_a.shape[1], ndata=centers_a.shape[0])
        self.register_buffer("centers_a", centers_a)  # [D, ndim]
        self.register_buffer("centers_b", centers_b)  # [D, ndim]
        self.register_buffer("sigma", sigma)          # scalar

    def transform_batch(self, u):
        return u

    def loglike(self, x):
        return bimodal_loglike_batch(self.centers_a, self.centers_b,
                                     self.sigma, x)

    def shard(self, rank_data, n_data, rank_model=0, n_model=1):
        self.require_no_model_axis(n_model)
        b = dataset_block(self.ndata, rank_data, n_data)
        return AnalyticBimodal(self.centers_a[b], self.centers_b[b],
                               self.sigma)


def make_analytic_bimodal_problem(centers_a, centers_b, sigma=0.05,
                                  device="cpu") -> AnalyticBimodal:
    f32 = dict(dtype=torch.float32, device=device)
    return AnalyticBimodal(
        centers_a=torch.as_tensor(np.asarray(centers_a, np.float64), **f32),
        centers_b=torch.as_tensor(np.asarray(centers_b, np.float64), **f32),
        sigma=torch.tensor(sigma, **f32),
    )
