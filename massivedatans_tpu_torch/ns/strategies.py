"""Constrained-draw strategies (reference layer L3).

Counterpart of ``massivedatans_tpu/ns/strategies.py``. A strategy is the
two functions the engine's fill loop calls:

- ``build(members_u, member_mask, generator, prev_scale, prev_radius)`` →
  geometry (rebuilt at NS-iteration start and on refocus),
- ``propose(geom, generator)`` → ``(cand_u[B, ndim], valid[B])``.

This port carries the friends family (MLFRIENDS, RADFRIENDS, SUPFRIENDS),
which keeps no state between proposals.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from massivedatans_tpu_torch.config import RunConfig, require_run_config
from massivedatans_tpu_torch.ns import region as region_lib


@dataclasses.dataclass(frozen=True)
class Strategy:
    build: Callable    # geometry from member points
    propose: Callable  # fixed-size candidate batch
    norm: str = "euclidean"  # ball norm when the geometry is a Region


def _compact(u_prop, ok, B: int):
    """Move in-geometry proposals to the front of a fixed eval batch
    (stable, as ``jnp.argsort``)."""
    take = torch.argsort((~ok).to(torch.uint8), stable=True)[:B]
    return u_prop[take], ok[take]


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

    def propose(geom, generator):
        u_prop, ok = region_lib.sample_region(
            geom, generator, cfg.proposal_batch, norm=norm)
        return _compact(u_prop, ok, cfg.eval_batch)

    return Strategy(build, propose, norm=norm)


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
    if name in ("MULTIELLIPSOIDS", "SLICE", "GALILEAN", "MCMC"):
        raise NotImplementedError(
            f"constrainer {cfg.constrainer!r} is not ported yet "
            "(ROADMAP.md queue 1, item 9: the other strategies)")
    raise ValueError(f"unknown constrainer {cfg.constrainer!r}")
