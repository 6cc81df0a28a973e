"""The port's constrainers end to end on the CPU, at the sizes and bars of
the JAX package's own tests:

- the bimodal oracle (tests/test_multimodal.py) for MLFRIENDS,
  MULTIELLIPSOIDS and SLICE;
- the analytic Gaussian for every alternative constrainer and the
  correlated Gaussian for the random and Mahalanobis slice directions
  (tests/test_constrainers.py);
- the friends options (tests/test_friends_options.py): the phantom buffer
  and the jackknife and phantom evidences;
- a fixed-seed MLFRIENDS trajectory, unchanged by the strategy state that
  the fill loop now carries.
"""

import dataclasses

import numpy as np
import pytest
import torch

from massivedatans_tpu_torch.config import RunConfig
from massivedatans_tpu_torch.models.analytic import (
    make_analytic_bimodal_problem,
    make_analytic_gaussian_problem,
    true_logZ,
    true_logZ_bimodal,
)
from massivedatans_tpu_torch.models.base import Problem
from massivedatans_tpu_torch.ns import engine
from massivedatans_tpu_torch.ns.integrator import multi_nested_integrator

torch.set_num_threads(1)

SMALL = RunConfig(nlive_points=100, proposal_batch=256, eval_batch=64,
                  shelf_capacity=4, chunk_iters=25)


def _err(result, K):
    return result.logZerr + np.sqrt(np.maximum(result.information, 0.0) / K)


def _run(problem, cfg, seed):
    return multi_nested_integrator(problem, cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(seed),
                                   progress=False)


# --- bimodal oracle (tests/test_multimodal.py) --------------------------------

BIMODAL_SIGMA = 0.04
BIMODAL_NLIVE = 160


@pytest.mark.parametrize("constrainer", ["MLFRIENDS", "MULTIELLIPSOIDS", "SLICE"])
def test_bimodal_evidence_and_mode_populations(constrainer):
    # 4 datasets; per dataset the two modes sit in opposite corners of the
    # square, > 10 sigma apart: a region that collapses onto one mode misses
    # the evidence by ~log(2)
    rng = np.random.default_rng(7)
    D = 4
    ca = rng.uniform(0.15, 0.3, size=(D, 2))
    cb = rng.uniform(0.7, 0.85, size=(D, 2))
    cfg = dataclasses.replace(SMALL, nlive_points=BIMODAL_NLIVE, tolerance=0.5,
                              max_fill_rounds=512, constrainer=constrainer)
    result = _run(make_analytic_bimodal_problem(ca, cb, sigma=BIMODAL_SIGMA),
                  cfg, 5)
    resid = np.abs(result.logZ - true_logZ_bimodal(ca, cb, BIMODAL_SIGMA))
    err = _err(result, BIMODAL_NLIVE)
    assert (resid < 3.0 * err + 0.5).all(), (constrainer, resid, err)
    assert resid.mean() < 0.4, (constrainer, resid)

    # both modes populated: posterior mass within 5 sigma of each centre
    w = (result.w + result.L).astype(np.float64)
    for d in range(D):
        wd = np.where(result.mask[:, d], w[:, d], -np.inf)
        wd = np.exp(wd - wd.max())
        wd /= wd.sum()
        x = result.x[:, d, :].astype(np.float64)
        mass_a = wd[np.linalg.norm(x - ca[d], axis=1) < 5 * BIMODAL_SIGMA].sum()
        mass_b = wd[np.linalg.norm(x - cb[d], axis=1) < 5 * BIMODAL_SIGMA].sum()
        assert mass_a + mass_b > 0.95, (constrainer, d, mass_a, mass_b)
        assert min(mass_a, mass_b) > 0.15, (constrainer, d, mass_a, mass_b)


# --- analytic Gaussian (tests/test_constrainers.py) ------------------------------

@pytest.mark.parametrize(
    "constrainer",
    ["MULTIELLIPSOIDS", "SLICE", "GALILEAN", "RADFRIENDS", "SUPFRIENDS"])
def test_alternative_constrainer_logZ(constrainer):
    rng = np.random.default_rng(11)
    centers = rng.uniform(0.35, 0.65, size=(4, 2))
    cfg = dataclasses.replace(SMALL, max_fill_rounds=1024,
                              constrainer=constrainer)
    result = _run(make_analytic_gaussian_problem(centers, sigma=0.06), cfg, 2)
    resid = np.abs(result.logZ - true_logZ(centers, sigma=0.06))
    err = _err(result, 100)
    assert (resid < 3.5 * err + 0.8).all(), (constrainer, resid, err)
    assert result.stats["stalled"] == 0


class CorrelatedGaussian(Problem):
    """A strongly correlated Gaussian likelihood around each dataset's
    centre (an unnormalised density: its evidence is the Gaussian
    normalisation, the truncation being negligible)."""

    name = "correlated"

    def __init__(self, centers, prec):
        super().__init__(ndim=centers.shape[1], ndata=centers.shape[0])
        self.register_buffer("centers", centers)
        self.register_buffer("prec", prec)

    def transform_batch(self, u):
        return u

    def loglike(self, x):
        delta = x[:, None, :] - self.centers[None, :, :]   # [B, D, ndim]
        return -0.5 * torch.einsum("bdi,ij,bdj->bd", delta, self.prec, delta)


@pytest.mark.parametrize("direction", ["mahalanobis", "random"])
def test_slice_direction_on_correlated_gaussian(direction):
    rng = np.random.default_rng(21)
    D, ndim = 3, 2
    centers = rng.uniform(0.42, 0.58, size=(D, ndim))
    theta = np.pi / 4
    R = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    cov = R @ (np.diag([0.08, 0.008]) ** 2) @ R.T  # 10:1, rotated 45 deg
    lz_true = 0.5 * ndim * np.log(2 * np.pi) + 0.5 * np.log(np.linalg.det(cov))
    problem = CorrelatedGaussian(
        torch.tensor(centers, dtype=torch.float32),
        torch.tensor(np.linalg.inv(cov), dtype=torch.float32))
    cfg = dataclasses.replace(SMALL, max_fill_rounds=1024, constrainer="SLICE",
                              slice_direction=direction)
    result = _run(problem, cfg, 3)
    resid = np.abs(result.logZ - lz_true)
    assert (resid < 3.5 * _err(result, 100) + 0.8).all(), (direction, resid)


# --- friends options (tests/test_friends_options.py) ---------------------------

def test_phantom_buffer_holds_top_dead_points():
    rng = np.random.default_rng(5)
    centers = rng.uniform(0.4, 0.6, size=(3, 2))
    problem = make_analytic_gaussian_problem(centers, sigma=0.08)
    Q = 6
    cfg = RunConfig(nlive_points=50, proposal_batch=128, eval_batch=32,
                    shelf_capacity=4, phantom_capacity=Q)
    gen = torch.Generator().manual_seed(0)
    state = engine.init_state(problem, gen, cfg)
    state, dead, rows = engine.run_chunk(
        problem, state, cfg, cfg.resolve_member_capacity(3), 40, gen)
    assert rows == 40
    dead_L = dead.L[:rows].reshape(-1).numpy()
    expected = np.sort(dead_L[np.isfinite(dead_L)])[::-1][:Q]
    np.testing.assert_allclose(state.phantom_L.numpy(), expected, rtol=1e-6)
    idx = state.phantom_idx.numpy()
    assert (idx >= 0).all() and (idx < int(state.pile_size)).all()
    # each slot holds the pile row of a point with that likelihood for
    # some dataset
    rows_L = problem.loglike(state.pile_x[state.phantom_idx.long()]).numpy()
    assert np.isclose(rows_L, expected[:, None], rtol=1e-5).any(axis=1).all()


@pytest.mark.parametrize("kw", [
    dict(constrainer="RADFRIENDS", radius_estimator="jackknife"),
    dict(constrainer="MLFRIENDS", radius_estimator="jackknife"),
    dict(constrainer="MLFRIENDS", phantom_capacity=16),
])
def test_friends_options_logZ(kw):
    rng = np.random.default_rng(11)
    centers = rng.uniform(0.35, 0.65, size=(4, 2))
    cfg = dataclasses.replace(SMALL, **kw)
    result = _run(make_analytic_gaussian_problem(centers, sigma=0.06), cfg, 2)
    resid = np.abs(result.logZ - true_logZ(centers, sigma=0.06))
    assert (resid < 3.5 * _err(result, 100) + 0.8).all(), (kw, resid)


# --- MLFRIENDS trajectory guard --------------------------------------------------

# iterations, fill rounds and evaluations of this fit (the same numbers on
# the CPU, one thread). The chunk program's steps that are off still
# spend their random draws, so a change to its schedule
# (ns/engine.ChunkProgram.plan) moves them
GUARD = {3: (200, 53, 3492), 7: (200, 54, 3538)}


@pytest.mark.parametrize("seed", sorted(GUARD))
def test_mlfriends_trajectory_unchanged(seed):
    rng = np.random.default_rng(42)
    centers = rng.uniform(0.25, 0.75, size=(8, 2))
    cfg = dataclasses.replace(SMALL, tolerance=0.5, max_fill_rounds=512)
    result = _run(make_analytic_gaussian_problem(centers, sigma=0.05), cfg, seed)
    assert (result.niterations, result.stats["fill_rounds"],
            result.ndraws) == GUARD[seed]


# --- on the card ---------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("constrainer", ["MULTIELLIPSOIDS", "SLICE", "GALILEAN"])
@pytest.mark.parametrize("direction", ["iterate", "mahalanobis"])
def test_strategy_round_reads_nothing_back_on_the_card(constrainer, direction):
    """build, init_chains, propose, observe and refresh issue no
    device-to-host synchronisation."""
    _need_card()
    from massivedatans_tpu_torch.ns.strategies import make_strategy

    if direction != "iterate" and constrainer != "SLICE":
        pytest.skip("directions are a slice option")
    cfg = RunConfig(constrainer=constrainer, slice_direction=direction)
    s = make_strategy(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mu = 0.3 + 0.4 * torch.rand((1664, 3), generator=gen, device="cuda")
    mask = torch.arange(1664, device="cuda") < 1500
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        geom = s.build(mu, mask, gen, torch.zeros(3, device="cuda"),
                       torch.zeros((), device="cuda"))
        st = s.init_chains(geom, gen)
        for _ in range(3):
            cand, valid, st = s.propose(geom, st, gen)
            accept = cand[:, 0] < 0.5
            st = s.observe(st, cand, accept)
            st = s.refresh(geom, st, gen, accept)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cand.shape == (cfg.eval_batch, 3) and valid.shape == (cfg.eval_batch,)


@pytest.mark.cuda
@pytest.mark.parametrize("constrainer", ["MULTIELLIPSOIDS", "SLICE", "GALILEAN"])
def test_alternative_constrainer_logZ_on_the_card(constrainer):
    _need_card()
    from massivedatans_tpu_torch.ops import neighbors

    rng = np.random.default_rng(11)
    centers = rng.uniform(0.35, 0.65, size=(4, 2))
    cfg = dataclasses.replace(SMALL, max_fill_rounds=1024,
                              constrainer=constrainer)
    neighbors.count_within.launches = 0
    neighbors.bootstrapped_sq_radius.launches = 0
    result = multi_nested_integrator(
        make_analytic_gaussian_problem(centers, sigma=0.06), cfg,
        device="cuda", progress=False)
    resid = np.abs(result.logZ - true_logZ(centers, sigma=0.06))
    assert (resid < 3.5 * _err(result, 100) + 0.8).all(), (constrainer, resid)
    assert neighbors.count_within.launches == 0
    assert neighbors.bootstrapped_sq_radius.launches == 0
