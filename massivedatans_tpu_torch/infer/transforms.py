"""Unconstrained <-> unit-cube bijection for the gradient backends.

Counterpart of ``massivedatans_tpu/infer/transforms.py``. The nested
sampler works on the unit cube (reference ``priortransform`` contract,
sample.py:52-58); HMC and VI run in ``z = logit(u)`` with the exact
change-of-variables correction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def z_to_u(z):
    """Sigmoid map R^n -> (0,1)^n."""
    return torch.sigmoid(z)


def u_to_z(u, eps: float = 1e-6):
    """Logit map (0,1)^n -> R^n (clipped away from the walls)."""
    u = torch.clamp(u, eps, 1.0 - eps)
    return torch.log(u) - torch.log1p(-u)


def log_abs_det_jacobian(z):
    """log|du/dz| summed over the last axis: sum_i log sigma(z) + log sigma(-z)."""
    return (F.logsigmoid(z) + F.logsigmoid(-z)).sum(dim=-1)


def make_log_posterior(problem):
    """``log_post(z[..., D, ndim]) -> [..., D]``: the per-dataset
    unnormalized posterior density in z-space. The prior is uniform on the
    cube, so the density is the paired likelihood plus the Jacobian. The
    prior transform is row by row, so the leading axes are flattened into
    its batch; the paired likelihood keeps them (row d goes with dataset
    d)."""

    def log_post(z):
        u = z_to_u(z)
        x = problem.transform_batch(u.reshape(-1, u.shape[-1])).reshape(u.shape)
        return problem.loglike_paired(x) + log_abs_det_jacobian(z)

    return log_post


def value_and_grad(log_post, z):
    """``(log_post(z), d sum(log_post(z)) / dz)``, both detached. The
    datasets are independent, so the gradient of the sum is the
    per-dataset gradient: one backward pass serves all D."""
    with torch.enable_grad():
        z = z.detach().requires_grad_(True)
        logp = log_post(z)
        (grad,) = torch.autograd.grad(logp.sum(), z)
    return logp.detach(), grad
