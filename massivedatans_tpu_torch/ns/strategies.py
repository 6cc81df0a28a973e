"""Constrained-draw strategies (reference layer L3).

Counterpart of ``massivedatans_tpu/ns/strategies.py``. The reference ships
three constrainers selected by ``CONSTRAINER`` (sample.py:131-155):
MLFriends (hiermetriclearn.py), multi-ellipsoid (elldrawer.py via nestle)
and whitened slice sampling (whitenedmcmc.py); the JAX package adds the
RadFriends/SupFriends variants and a Galilean random walk. A strategy is
the functions the engine's fill loop calls:

- ``build(members_u, member_mask, generator, prev_scale, prev_radius)`` →
  geometry (rebuilt at NS-iteration start and on refocus),
- ``init_chains(geom, generator)`` → per-fill strategy state ``sstate``,
- ``propose(geom, sstate, generator)`` → ``(cand_u[B, ndim], valid[B],
  sstate)``,
- ``observe(sstate, cand_u, chain_accept)`` → sstate (likelihood feedback:
  ``chain_accept[B]`` says which candidates beat any running dataset's
  threshold),
- ``refresh(geom, sstate, generator, chain_accept)`` → sstate (direction
  and restart updates after the feedback).

The friends family and the ellipsoids keep no state: their
``init_chains``, ``observe`` and ``refresh`` are no-ops that draw no random
numbers. None of these functions reads anything back from the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from massivedatans_tpu_torch.config import RunConfig, require_run_config
from massivedatans_tpu_torch.ns import ellipsoids as ell_lib
from massivedatans_tpu_torch.ns import region as region_lib


def _no_init_chains(geom, generator):
    return ()


def _no_observe(sstate, cand_u, chain_accept):
    return sstate


def _no_refresh(geom, sstate, generator, chain_accept):
    return sstate


@dataclasses.dataclass(frozen=True)
class Strategy:
    build: Callable    # geometry from member points
    propose: Callable  # fixed-size candidate batch
    init_chains: Callable = _no_init_chains  # per-fill strategy state
    observe: Callable = _no_observe          # likelihood feedback
    refresh: Callable = _no_refresh          # post-feedback update
    norm: str = "euclidean"  # ball norm when the geometry is a Region


def _compact(u_prop, ok, B: int):
    """Move in-geometry proposals to the front of a fixed eval batch
    (stable, as ``jnp.argsort``)."""
    take = torch.argsort((~ok).to(torch.uint8), stable=True)[:B]
    return u_prop[take], ok[take]


def _restart_points(members_u, member_mask, generator, n: int):
    """``n`` chain starts drawn uniformly from the valid members."""
    return members_u[region_lib.uniform_choice(member_mask, n, generator)]


# --------------------------------------------------------------------------
# MLFriends: metric-learned union-of-balls (hiermetriclearn.py:30-213)
# --------------------------------------------------------------------------

def make_mlfriends(cfg: RunConfig, norm: str = "euclidean",
                   metriclearner: str | None = None) -> Strategy:
    """Union-of-balls/boxes constrained draws: MLFriends by default,
    ``norm="chebyshev"`` the SupFriends box variant, ``metriclearner="none"``
    plain RadFriends (reference friends.py:8-334)."""
    learner = cfg.metriclearner if metriclearner is None else metriclearner

    def build(members_u, member_mask, generator, prev_scale, prev_radius,
              extra_u=None, extra_mask=None):
        return region_lib.build_region(
            members_u, member_mask, generator,
            nbootstraps=cfg.nbootstraps,
            metriclearner=learner,
            prev_scale=prev_scale if cfg.force_shrink else None,
            prev_radius=prev_radius if cfg.force_shrink else None,
            norm=norm,
            estimator=cfg.radius_estimator,
            extra_u=extra_u,
            extra_mask=extra_mask,
        )

    def propose(geom, sstate, generator):
        u_prop, ok = region_lib.sample_region(
            geom, generator, cfg.proposal_batch, norm=norm)
        return (*_compact(u_prop, ok, cfg.eval_batch), sstate)

    return Strategy(build, propose, norm=norm)


# --------------------------------------------------------------------------
# Multi-ellipsoid (elldrawer.py:25-102, own fit instead of nestle)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class EllGeom:
    ells: ell_lib.Ellipsoids
    members_u: torch.Tensor
    member_mask: torch.Tensor


def make_multiellipsoids(cfg: RunConfig) -> Strategy:
    def build(members_u, member_mask, generator, prev_scale, prev_radius,
              extra_u=None, extra_mask=None):
        # phantom extras are a friends-family feature (friends.py:54-59);
        # the ellipsoid fit uses live members only, as the reference does
        ells = ell_lib.fit_ellipsoids(members_u, member_mask, generator)
        return EllGeom(ells=ells, members_u=members_u, member_mask=member_mask)

    def propose(geom, sstate, generator):
        u_prop, ok = ell_lib.sample_ellipsoids(geom.ells, generator,
                                               cfg.proposal_batch)
        in_cube = torch.all((u_prop > 0.0) & (u_prop < 1.0), dim=1)
        return (*_compact(u_prop, ok & in_cube, cfg.eval_batch), sstate)

    return Strategy(build, propose)


# --------------------------------------------------------------------------
# Whitened slice sampling (whitenedmcmc.py:127-324)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SliceGeom:
    members_u: torch.Tensor    # [M, ndim] chain restart points (live points)
    member_mask: torch.Tensor  # [M]
    metric: region_lib.Metric
    chol: torch.Tensor         # [ndim, ndim] live-point covariance Cholesky
                               # (Mahalanobis directions, whitenedmcmc.py:200-215)
    axis_dirs: torch.Tensor    # [ndim, ndim] row k: unit direction of axis k
                               # in the whitened metric (iterate directions)


@dataclasses.dataclass
class SliceChains:
    u: torch.Tensor          # [C, ndim] current chain positions
    direction: torch.Tensor  # [C, ndim] unit direction (whitened space)
    lo: torch.Tensor         # [C] interval bounds along direction
    hi: torch.Tensor         # [C]
    t: torch.Tensor          # [C] last proposed offset
    steps: torch.Tensor      # [C] int32 accepted direction-steps since restart
    axis: torch.Tensor       # [C] int32 iterating coordinate index

    def replace(self, **kw) -> "SliceChains":
        return dataclasses.replace(self, **kw)


def _cube_bracket(u, direction):
    """Exact ``[lo, hi]`` of ``{t : u + t*d in (0,1)^ndim}``.

    Replaces the reference's stepping-out doubling loop
    (whitenedmcmc.py:144-174), whose inside-filter is the unit cube
    (sample.py:150-152): the bracket has a closed form on a box.
    """
    eps = 1e-12
    d = torch.where(torch.abs(direction) < eps, eps, direction)
    t0 = (0.0 - u) / d
    t1 = (1.0 - u) / d
    return (torch.minimum(t0, t1).amax(dim=1),
            torch.maximum(t0, t1).amin(dim=1))


def _live_cholesky(members_u, member_mask):
    """Cholesky factor of the masked live-point covariance
    (whitenedmcmc.py:204-206 uses numpy.cov of the live points), NaN where
    it does not exist. The 1e-10 jitter is the JAX package's; it is below
    float32 resolution at typical variances."""
    ndim = members_u.shape[1]
    mf = member_mask.to(members_u.dtype)[:, None]
    n = torch.clamp(mf.sum(), min=2.0)
    mean = (members_u * mf).sum(dim=0) / n
    centered = (members_u - mean) * mf
    cov = centered.T @ centered / (n - 1.0)
    cov = cov + 1e-10 * torch.eye(ndim, dtype=cov.dtype, device=cov.device)
    return ell_lib._cholesky_or_nan(cov)


def make_slice(cfg: RunConfig) -> Strategy:
    """Batched slice sampler: C = eval_batch parallel chains, each advanced
    one proposal per fill round; every proposal is scored against all
    datasets by the shared matmul, and proposals of chains past burn-in are
    candidates.

    ``cfg.slice_direction``: ``iterate`` cycles whitened coordinates
    (FilteredUnitIterateSlice, whitenedmcmc.py:232-249, the default),
    ``random`` draws random whitened directions (:217-230), ``mahalanobis``
    draws them through the live-point covariance Cholesky
    (FilteredMahalanobisSliceProposal, :200-215).

    As in the JAX package, a chain's proposals are candidates after
    ``5·ndim`` accepted steps of burn-in, ``refresh`` restarts it after
    ``5·ndim + 8``, and the chains start afresh at every NS iteration
    (``init_chains``).
    """
    C = cfg.eval_batch
    direction = cfg.slice_direction.lower()
    if direction not in ("iterate", "random", "mahalanobis"):
        raise ValueError(f"unknown slice_direction {direction!r}")

    def build(members_u, member_mask, generator, prev_scale, prev_radius,
              extra_u=None, extra_mask=None):
        metric = region_lib.fit_metric(members_u, member_mask,
                                       cfg.metriclearner)
        ndim = members_u.shape[1]
        axis_dirs = torch.eye(ndim, device=members_u.device) * metric.scale
        return SliceGeom(
            members_u=members_u, member_mask=member_mask, metric=metric,
            chol=_live_cholesky(members_u, member_mask),
            axis_dirs=axis_dirs / torch.linalg.vector_norm(
                axis_dirs, dim=1, keepdim=True))

    def _new_direction(geom, generator, axis):
        ndim = geom.members_u.shape[1]
        if direction == "iterate":
            # the next coordinate axis, in the whitened metric
            new_axis = (axis + 1) % ndim
            return geom.axis_dirs[new_axis.long()], new_axis
        d = torch.randn((axis.shape[0], ndim), generator=generator,
                        device=axis.device)
        if direction == "mahalanobis":
            d = d @ geom.chol.T
        else:
            d = d * geom.metric.scale[None, :]
        return d / torch.linalg.vector_norm(d, dim=1, keepdim=True), axis

    def init_chains(geom, generator):
        device = geom.members_u.device
        u0 = _restart_points(geom.members_u, geom.member_mask, generator, C)
        axis0 = torch.zeros((C,), dtype=torch.int32, device=device)
        d0, axis0 = _new_direction(geom, generator, axis0)
        lo, hi = _cube_bracket(u0, d0)
        return SliceChains(
            u=u0, direction=d0, lo=lo, hi=hi,
            t=torch.zeros((C,), dtype=torch.float32, device=device),
            steps=torch.zeros((C,), dtype=torch.int32, device=device),
            axis=axis0)

    def propose(geom, sstate, generator):
        # jax.random.uniform(minval=lo, maxval=hi): max(lo, r·(hi-lo) + lo)
        r = torch.rand(sstate.lo.shape, generator=generator,
                       device=sstate.lo.device)
        t = torch.maximum(sstate.lo, r * (sstate.hi - sstate.lo) + sstate.lo)
        cand = sstate.u + sstate.direction * t[:, None]
        cand = torch.clamp(cand, 1e-7, 1.0 - 1e-7)
        return cand, sstate.steps >= 5 * cand.shape[1], sstate.replace(t=t)

    def observe(sstate, cand_u, chain_accept):
        # slice accept/shrink (whitenedmcmc.py:176-191): on accept move the
        # chain; on reject shrink the interval toward the current point
        return sstate.replace(
            u=torch.where(chain_accept[:, None], cand_u, sstate.u),
            lo=torch.where(chain_accept | (sstate.t >= 0), sstate.lo, sstate.t),
            hi=torch.where(chain_accept | (sstate.t < 0), sstate.hi, sstate.t),
            steps=sstate.steps + chain_accept.to(torch.int32))

    def refresh(geom, sstate, generator, chain_accept):
        ndim = geom.members_u.shape[1]
        d_new, axis_new = _new_direction(geom, generator, sstate.axis)
        # a new direction after an accepted step or a collapsed interval
        collapsed = (sstate.hi - sstate.lo) < 1e-9
        new_dir = chain_accept | collapsed
        d = torch.where(new_dir[:, None], d_new, sstate.direction)
        axis = torch.where(chain_accept, axis_new, sstate.axis)
        # periodic restart from a random live point to decorrelate
        restart = sstate.steps >= (5 * ndim + 8)
        u_r = _restart_points(geom.members_u, geom.member_mask, generator, C)
        u = torch.where(restart[:, None], u_r, sstate.u)
        # a new bracket for a new direction or a new start (one bracket of
        # the updated positions: it is the old position's where no restart)
        lo_new, hi_new = _cube_bracket(u, d)
        rebracket = new_dir | restart
        return sstate.replace(
            u=u, direction=d, axis=axis,
            lo=torch.where(rebracket, lo_new, sstate.lo),
            hi=torch.where(rebracket, hi_new, sstate.hi),
            steps=torch.where(restart, 0, sstate.steps))

    return Strategy(build, propose, init_chains, observe, refresh)


# --------------------------------------------------------------------------
# Galilean / adaptive random-walk MCMC (whitenedmcmc.py:44-124)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class WalkGeom:
    members_u: torch.Tensor    # [M, ndim] chain restart points (live points)
    member_mask: torch.Tensor  # [M]
    metric: region_lib.Metric


@dataclasses.dataclass
class WalkChains:
    u: torch.Tensor        # [C, ndim] current chain positions
    v: torch.Tensor        # [C, ndim] unit velocity (whitened-metric direction)
    eps: torch.Tensor      # [C] step scale (unit-cube units)
    steps: torch.Tensor    # [C] int32 accepted steps since restart
    rejects: torch.Tensor  # [C] int32 consecutive rejections

    def replace(self, **kw) -> "WalkChains":
        return dataclasses.replace(self, **kw)


def _reflect_cube(u):
    """Fold positions back into (0,1)^ndim by mirror reflection at the walls
    (period-2 triangle wave). ``torch.remainder``, not ``torch.fmod``: the
    result takes the divisor's sign, as ``jnp.mod``."""
    r = torch.abs(torch.remainder(u, 2.0))
    r = torch.where(r > 1.0, 2.0 - r, r)
    return torch.clamp(r, 1e-7, 1.0 - 1e-7)


# Sivia-style asymmetric step adaptation (targets ~70% acceptance), as
# float32 values
_GROW = float(np.float32(np.exp(0.12)))
_SHRINK = float(np.float32(np.exp(-0.3)))


def make_galilean(cfg: RunConfig) -> Strategy:
    """Batched Galilean-style MCMC: C = eval_batch parallel chains coast with
    a persistent velocity; the first rejection reverses it (Skilling's
    gradient-free Galilean move), repeated rejection resamples it.

    Covers the reference's random-walk proposal family (``BaseProposal``
    step-scale adaptation, whitenedmcmc.py:44-96, and the DNest
    ``MultiScaleProposal``, :98-124): the per-chain ``eps`` grows on
    acceptance and shrinks on rejection. A proposal counts as accepted when
    it beats *any* running dataset's constraint (whitenedmcmc.py:305).
    As in the JAX package, a chain's proposals are candidates after
    ``2·ndim`` accepted steps of burn-in, and it restarts after
    ``2·ndim + 8``.
    """
    C = cfg.eval_batch

    def build(members_u, member_mask, generator, prev_scale, prev_radius,
              extra_u=None, extra_mask=None):
        return WalkGeom(members_u=members_u, member_mask=member_mask,
                        metric=region_lib.fit_metric(members_u, member_mask,
                                                     cfg.metriclearner))

    def _new_velocity(geom, generator):
        d = torch.randn((C, geom.members_u.shape[1]), generator=generator,
                        device=geom.members_u.device)
        d = d * geom.metric.scale[None, :]
        return d / torch.linalg.vector_norm(d, dim=1, keepdim=True)

    def init_chains(geom, generator):
        device = geom.members_u.device
        u0 = _restart_points(geom.members_u, geom.member_mask, generator, C)
        v0 = _new_velocity(geom, generator)
        # initial step ~ half the live-point cloud's metric scale
        ndim = geom.members_u.shape[1]
        # a divisor made on the device: a Python float would be multiplied
        # by its reciprocal on the card, which is not the JAX package's
        # division, and a host tensor would be a copy that synchronises
        root_ndim = torch.sqrt(torch.full((), float(ndim), device=device))
        eps0 = 0.5 * torch.linalg.vector_norm(geom.metric.scale) / root_ndim
        return WalkChains(
            u=u0, v=v0, eps=eps0.expand(C).clone(),
            steps=torch.zeros((C,), dtype=torch.int32, device=device),
            rejects=torch.zeros((C,), dtype=torch.int32, device=device))

    def propose(geom, sstate, generator):
        cand = _reflect_cube(sstate.u + sstate.eps[:, None] * sstate.v)
        return cand, sstate.steps >= 2 * cand.shape[1], sstate

    def observe(sstate, cand_u, chain_accept):
        eps = torch.clamp(
            sstate.eps * torch.where(chain_accept, _GROW, _SHRINK), 1e-6, 0.5)
        return sstate.replace(
            u=torch.where(chain_accept[:, None], cand_u, sstate.u),
            eps=eps,
            steps=sstate.steps + chain_accept.to(torch.int32),
            rejects=torch.where(chain_accept, 0, sstate.rejects + 1))

    def refresh(geom, sstate, generator, chain_accept):
        ndim = geom.members_u.shape[1]
        # Galilean move: the first rejection reverses the velocity (coast
        # back into the constraint); persistent rejection resamples it
        v_new = _new_velocity(geom, generator)
        v = torch.where((sstate.rejects >= 2)[:, None], v_new,
                        torch.where((sstate.rejects == 1)[:, None], -sstate.v,
                                    sstate.v))
        restart = sstate.steps >= (2 * ndim + 8)
        u_r = _restart_points(geom.members_u, geom.member_mask, generator, C)
        return sstate.replace(
            u=torch.where(restart[:, None], u_r, sstate.u),
            v=torch.where(restart[:, None], v_new, v),
            steps=torch.where(restart, 0, sstate.steps),
            rejects=torch.where(restart, 0, sstate.rejects))

    return Strategy(build, propose, init_chains, observe, refresh)


def make_strategy(cfg: RunConfig) -> Strategy:
    """Resolve cfg.constrainer (reference CONSTRAINER env, sample.py:131)."""
    require_run_config(cfg)
    name = cfg.constrainer.upper()
    if name == "MLFRIENDS":
        return make_mlfriends(cfg)
    if name == "RADFRIENDS":
        return make_mlfriends(cfg, norm="euclidean", metriclearner="none")
    if name == "SUPFRIENDS":
        return make_mlfriends(cfg, norm="chebyshev", metriclearner="none")
    if name == "MULTIELLIPSOIDS":
        return make_multiellipsoids(cfg)
    if name == "SLICE":
        return make_slice(cfg)
    if name in ("GALILEAN", "MCMC"):
        return make_galilean(cfg)
    raise ValueError(f"unknown constrainer {cfg.constrainer!r}")
