"""Batched Hamiltonian Monte Carlo over D independent datasets.

Counterpart of ``massivedatans_tpu/infer/hmc.py``: positions ``z[D, ndim]``
of D chains advance together, one leapfrog trajectory per iteration and a
Metropolis accept per dataset. Warmup runs dual-averaging step-size
adaptation (Hoffman & Gelman 2014, eq. 6) in two phases and fits a
diagonal mass matrix from a Welford variance of the first phase's second
half. Every constant and edge of the JAX algorithm is kept.

The JAX package runs each phase as one ``lax.scan`` program; here a Python
loop issues each iteration's operations, with no host synchronisation:
dual averaging, the Welford update and the accept are tensor operations on
the device. Each leapfrog step takes one gradient, and the gradient at the
trajectory's end is carried into the next iteration (the same ``z``, so the
same numbers as recomputing it).

Random numbers are kept apart from the arithmetic: each iteration takes its
standard normals ``[D, ndim]`` and uniforms ``[D]`` from a draw source.
``run_hmc`` feeds the source from a ``torch.Generator``; a test can feed it
the JAX package's own draws and compare whole runs.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from massivedatans_tpu_torch.config import set_fp32_precision
from massivedatans_tpu_torch.infer import transforms

# dual averaging (hmc.py:93), and the first phase's step size
GAMMA, T0, KAPPA = 0.05, 10.0, 0.75
EPS0 = 0.1


class HMCResult(NamedTuple):
    u: torch.Tensor            # [S, D, ndim] unit-cube samples
    x: torch.Tensor            # [S, D, ndim] transformed samples
    logp: torch.Tensor         # [S, D] log posterior density (z-space)
    accept_rate: torch.Tensor  # [D]
    step_size: torch.Tensor    # [D] adapted leapfrog step size
    mass: torch.Tensor         # [D, ndim] diagonal mass matrix


def _leapfrog(value_and_grad, z, p, eps, inv_mass, n_steps: int, grad=None):
    """``n_steps`` leapfrog steps of all D chains (JAX ``_leapfrog``).

    ``value_and_grad(z) -> (logp[D], grad[D, ndim])``; ``grad`` is the
    gradient at the start ``z`` when the caller holds it. Returns the end
    position and momentum, and the log density and gradient there."""
    eps_ = eps[:, None]
    if grad is None:
        _, grad = value_and_grad(z)
    logp = None
    for _ in range(n_steps):
        p_half = p + 0.5 * eps_ * grad
        z = z + eps_ * inv_mass * p_half
        logp, grad = value_and_grad(z)
        p = p_half + 0.5 * eps_ * grad
    if logp is None:
        logp, _ = value_and_grad(z)
    return z, p, logp, grad


def _kinetic(p, inv_mass):
    return 0.5 * torch.sum(torch.square(p) * inv_mass, dim=-1)


def _one_iter(value_and_grad, z, logp0, grad0, eps, inv_mass, normal,
              uniform, num_leapfrog: int):
    """One trajectory and Metropolis accept of every chain (hmc.py:69-84).
    A non-finite ``log_alpha`` (a NaN trajectory included: ``minimum``
    propagates NaN) becomes -inf and rejects."""
    p0 = normal / torch.sqrt(inv_mass)
    h0 = -logp0 + _kinetic(p0, inv_mass)
    z1, p1, logp1, grad1 = _leapfrog(value_and_grad, z, p0, eps, inv_mass,
                                     num_leapfrog, grad0)
    h1 = -logp1 + _kinetic(p1, inv_mass)
    log_alpha = torch.minimum(torch.zeros_like(h0), h0 - h1)
    log_alpha = torch.where(torch.isfinite(log_alpha), log_alpha, -torch.inf)
    accept = torch.log(uniform) < log_alpha
    z = torch.where(accept[:, None], z1, z)
    logp = torch.where(accept, logp1, logp0)
    grad = torch.where(accept[:, None], grad1, grad0)
    return z, logp, grad, accept, torch.exp(log_alpha)


def _warmup_phase(value_and_grad, state, inv_mass, eps0, n_iters: int,
                  draw, num_leapfrog: int, target_accept: float):
    """Dual averaging of the step size over ``n_iters`` iterations, and the
    Welford variance of ``z`` over the second half (hmc.py:89-125).
    ``state`` is ``(z, logp, grad)``; returns the new state, the final
    ``exp(log_eps_bar)`` and the variance ``max(m2 / n_win, 1e-6)``."""
    z, logp, grad = state
    mu_da = math.log(10.0) + torch.log(eps0)
    log_eps = torch.log(eps0)
    log_eps_bar = torch.log(eps0)
    h_bar = torch.zeros_like(eps0)
    mean, m2 = torch.zeros_like(z), torch.zeros_like(z)
    half = n_iters // 2
    for i in range(n_iters):
        normal, uniform = draw()
        z, logp, grad, _, alpha = _one_iter(
            value_and_grad, z, logp, grad, torch.exp(log_eps), inv_mass,
            normal, uniform, num_leapfrog)
        t = i + 1.0
        h_bar = (1.0 - 1.0 / (t + T0)) * h_bar + (
            (target_accept - alpha) / (t + T0))
        log_eps = mu_da - math.sqrt(t) / GAMMA * h_bar
        w = t ** (-KAPPA)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        if i >= half:  # streaming Welford variance over the second half
            n_eff = max(i - half + 1.0, 1.0)
            delta = z - mean
            mean = mean + delta / n_eff
            m2 = m2 + delta * (z - mean)
    n_win = max(n_iters - half, 2.0)
    return (z, logp, grad), torch.exp(log_eps_bar), \
        torch.clamp_min(m2 / n_win, 1e-6)


def _run(log_post, z0, draw: Callable, num_warmup: int, num_samples: int,
         num_leapfrog: int, target_accept: float):
    """The whole sampler on draws from ``draw() -> (normal[D, ndim],
    uniform[D])``, called once per iteration: first phase, second phase,
    then sampling. Returns ``(z[S, D, ndim], logp[S, D], accept_rate[D],
    step_size[D], inv_mass[D, ndim])``."""
    def vg(z):
        return transforms.value_and_grad(log_post, z)

    D = z0.shape[0]
    n1 = max(2 * num_warmup // 3, 2)
    n2 = max(num_warmup - n1, 2)
    state = (z0, *vg(z0))
    state, eps1, var = _warmup_phase(
        vg, state, torch.ones_like(z0),
        torch.full((D,), EPS0, dtype=z0.dtype, device=z0.device), n1, draw,
        num_leapfrog, target_accept)
    inv_mass = var  # inv mass = posterior variance: unit condition number
    state, eps, _ = _warmup_phase(vg, state, inv_mass, eps1, n2, draw,
                                  num_leapfrog, target_accept)

    z, logp, grad = state
    zs = z.new_empty((num_samples, *z.shape))
    logps = z.new_empty((num_samples, D))
    accepted = z.new_zeros((D,))
    for s in range(num_samples):
        normal, uniform = draw()
        z, logp, grad, acc, _ = _one_iter(vg, z, logp, grad, eps, inv_mass,
                                          normal, uniform, num_leapfrog)
        zs[s] = z
        logps[s] = logp
        accepted += acc
    return zs, logps, accepted / max(num_samples, 1), eps, inv_mass


def generator_draws(generator: torch.Generator, D: int, ndim: int, device):
    """The draw source of ``run_hmc``: standard normals and uniforms on
    ``[0, 1)`` from ``generator``."""
    def draw():
        return (torch.randn((D, ndim), generator=generator, device=device),
                torch.rand((D,), generator=generator, device=device))
    return draw


def run_hmc(problem, generator: torch.Generator, *, device,
            init_u=None, num_warmup: int = 300, num_samples: int = 300,
            num_leapfrog: int = 24, target_accept: float = 0.8,
            draw: Optional[Callable] = None) -> HMCResult:
    """Run D batched HMC chains on ``problem`` (moved to ``device``).

    ``init_u``: ``[D, ndim]`` unit-cube starting points (numpy or tensor;
    e.g. one nested-sampling posterior point per dataset); default the
    cube's centre. ``generator`` lives on ``device`` and feeds every draw,
    unless ``draw`` replaces it as the draw source.
    """
    set_fp32_precision()
    device = torch.device(device)
    problem = problem.to(device)
    D, ndim = problem.ndata, problem.ndim
    if init_u is None:
        init_u = torch.full((D, ndim), 0.5)
    z0 = transforms.u_to_z(torch.as_tensor(init_u, dtype=torch.float32)
                           .to(device))
    if draw is None:
        draw = generator_draws(generator, D, ndim, device)
    log_post = transforms.make_log_posterior(problem)
    zs, logps, rate, eps, inv_mass = _run(
        log_post, z0, draw, num_warmup, num_samples, num_leapfrog,
        target_accept)
    u = transforms.z_to_u(zs)
    with torch.no_grad():
        x = problem.transform_batch(u.reshape(-1, ndim)).reshape(u.shape)
    return HMCResult(u=u, x=x, logp=logps, accept_rate=rate, step_size=eps,
                     mass=1.0 / inv_mass)
