"""Batched mean-field variational inference over D independent datasets.

Counterpart of ``massivedatans_tpu/infer/vi.py``: a diagonal Gaussian
``q_d(z) = N(mu_d, diag(sigma_d^2))`` in logit space per dataset, all D
fitted together by Adam on the summed negative ELBO (reparameterisation
trick). optax's ``adam`` becomes ``torch.optim.Adam`` with the same
defaults (betas 0.9 / 0.999, eps 1e-8, no eps-root), which gives the same
update up to rounding.

Outputs per dataset:
- ``elbo``: the evidence lower bound from ``4 * mc_samples`` fresh draws,
- ``logZ_iw``: the K-sample importance-weighted evidence (IWAE bound;
  Burda et al. 2016), ``logsumexp_K(w) - log K``.

As in ``hmc.py``, the standard normals of each step come from a draw
source that ``run_vi`` feeds from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from massivedatans_tpu_torch.config import set_fp32_precision
from massivedatans_tpu_torch.infer import transforms

_LOG2PI = math.log(2.0 * math.pi)
# candidates z scored at once by the final ELBO and the importance weights:
# the MUSE likelihood holds a [B, nZ, n_wl] block for B candidates (4.45 GB
# at B = 25,600 on the card), so the draws go through in chunks and the
# peak no longer grows with D * iw_samples
EVAL_CANDIDATES = 8192


class VIResult(NamedTuple):
    mu: torch.Tensor          # [D, ndim] variational mean (z-space)
    sigma: torch.Tensor       # [D, ndim] variational stddev (z-space)
    elbo: torch.Tensor        # [D] final ELBO (lower-bounds logZ)
    logZ_iw: torch.Tensor     # [D] importance-weighted evidence estimate
    elbo_trace: torch.Tensor  # [steps] mean ELBO per step


def _elbo_samples(log_post, mu, log_sigma, eps):
    """``[n, D]`` ELBO integrands ``log p(z) - log q(z)`` at
    ``z = mu + sigma * eps`` for ``eps[n, D, ndim]`` (JAX ``_elbo_samples``
    with its normals passed in)."""
    z = mu[None] + torch.exp(log_sigma)[None] * eps     # [n, D, ndim]
    logp = log_post(z)                                  # [n, D]
    logq = (-0.5 * torch.square(eps) - log_sigma[None] - 0.5 * _LOG2PI).sum(-1)
    return logp - logq


def _fit(log_post, mu0, log_sigma0, draw: Callable, steps: int,
         mc_samples: int, lr: float):
    """Adam on the summed negative ELBO, on normals from ``draw(n) ->
    eps[n, D, ndim]`` called once per step with ``mc_samples``; returns
    ``mu``, ``log_sigma`` and the mean ELBO of each step."""
    mu = mu0.detach().clone().requires_grad_(True)
    log_sigma = log_sigma0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([mu, log_sigma], lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    trace = mu0.new_empty((steps,))
    with torch.enable_grad():
        for s in range(steps):
            opt.zero_grad(set_to_none=True)
            per_dataset = _elbo_samples(log_post, mu, log_sigma,
                                        draw(mc_samples)).mean(dim=0)
            (-per_dataset.sum()).backward()
            opt.step()
            trace[s] = per_dataset.detach().mean()
    return mu.detach(), log_sigma.detach(), trace


def _scored(log_post, mu, log_sigma, eps):
    """``_elbo_samples`` over ``eps[n, D, ndim]``, at most
    ``EVAL_CANDIDATES`` candidates ``z`` at a time along ``n``."""
    chunk = max(1, EVAL_CANDIDATES // mu.shape[0])
    return torch.cat([_elbo_samples(log_post, mu, log_sigma, e)
                      for e in eps.split(chunk)])


def _evidence(log_post, mu, log_sigma, draw: Callable, mc_samples: int,
              iw_samples: int):
    """The final ELBO from ``draw(4 * mc_samples)`` and the importance-
    weighted evidence from ``draw(iw_samples)``."""
    with torch.no_grad():
        elbo = _scored(log_post, mu, log_sigma,
                       draw(4 * mc_samples)).mean(dim=0)
        w = _scored(log_post, mu, log_sigma, draw(iw_samples))
        logZ_iw = torch.logsumexp(w, dim=0) - math.log(float(iw_samples))
    return elbo, logZ_iw


def generator_draws(generator: torch.Generator, D: int, ndim: int, device):
    """The draw source of ``run_vi``: standard normals from ``generator``."""
    def draw(n):
        return torch.randn((n, D, ndim), generator=generator, device=device)
    return draw


def run_vi(problem, generator: torch.Generator, *, device, init_u=None,
           steps: int = 1500, mc_samples: int = 8, iw_samples: int = 256,
           lr: float = 2e-2, draw: Optional[Callable] = None) -> VIResult:
    """Fit D batched mean-field Gaussians on ``problem`` (moved to
    ``device``); returns evidences and posteriors.

    ``init_u``: ``[D, ndim]`` unit-cube initialisation of the means (numpy
    or tensor); default the cube's centre. Every ``log_sigma`` starts at 0.
    ``generator`` lives on ``device`` and feeds every draw, unless ``draw``
    replaces it as the draw source.
    """
    set_fp32_precision()
    device = torch.device(device)
    problem = problem.to(device)
    D, ndim = problem.ndata, problem.ndim
    if init_u is None:
        mu0 = torch.zeros((D, ndim), dtype=torch.float32, device=device)
    else:
        mu0 = transforms.u_to_z(torch.as_tensor(init_u, dtype=torch.float32)
                                .to(device))
    log_sigma0 = torch.zeros((D, ndim), dtype=torch.float32, device=device)
    if draw is None:
        draw = generator_draws(generator, D, ndim, device)
    log_post = transforms.make_log_posterior(problem)
    mu, log_sigma, trace = _fit(log_post, mu0, log_sigma0, draw, steps,
                                mc_samples, lr)
    elbo, logZ_iw = _evidence(log_post, mu, log_sigma, draw, mc_samples,
                              iw_samples)
    return VIResult(mu=mu, sigma=torch.exp(log_sigma), elbo=elbo,
                    logZ_iw=logZ_iw, elbo_trace=trace)
