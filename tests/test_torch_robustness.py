"""The JAX package's robustness bars, held on the port.

Ports of ``tests/test_overflow_stall_bias.py`` (forced member overflow,
stall flags in the result and in the HDF5 output, a healthy run without
stalls, the ``chunk_fill_budget`` truncation) and of the pile tests of
``tests/test_integrator_pipeline.py`` (the capacity transport guard,
drops at a full pile kept contained, the phantom compaction remap,
compaction invisible), at those tests' sizes, configurations and seeds:
a JAX ``jax.random.key(s)`` is the port's ``torch.Generator`` seeded
``s``. The draws differ between the packages, so the bars are the JAX
tests' own statistical and structural ones, not equality with JAX.

``test_dead_row_reconstruction_exact`` has no counterpart: the JAX
package streams only the dead rows' L and indices and replays its float32
volume ledger on the host, whereas the port's chunk report carries each
row's ``logwidth`` and ``running`` as the device computed them, so there
is no host replay to hold against the device.
"""

import dataclasses
import json

import h5py
import numpy as np
import pytest
import torch

from massivedatans_tpu_torch.config import RunConfig
from massivedatans_tpu_torch.io.hdf5io import write_results
from massivedatans_tpu_torch.models.analytic import (
    AnalyticGaussian,
    make_analytic_gaussian_problem,
    true_logZ,
)
from massivedatans_tpu_torch.ns import engine
from massivedatans_tpu_torch.ns.integrator import multi_nested_integrator

torch.set_num_threads(1)


def _run(problem, cfg, seed):
    return multi_nested_integrator(
        problem, cfg, device="cpu",
        generator=torch.Generator().manual_seed(seed), progress=False)


# --- tests/test_overflow_stall_bias.py -----------------------------------------

def _stall_problem(D=8, seed=3, sigma=0.06):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.3, 0.7, size=(D, 2))
    return make_analytic_gaussian_problem(centers, sigma=sigma), centers, sigma


class PlateauGaussian(AnalyticGaussian):
    """The analytic Gaussian capped at -2: once every live point sits on
    the cap no candidate can strictly exceed Lmin, so every fill stalls."""

    def loglike(self, x):
        return torch.clamp(super().loglike(x), max=-2.0)


def test_forced_member_overflow_evidence_unbiased():
    """:35. A member capacity (64) below nlive (100) makes every region
    build subsample; the evidences stay within Monte-Carlo error of the
    truth and of the full-capacity run."""
    problem, centers, sigma = _stall_problem()
    want = true_logZ(centers, sigma)
    base = RunConfig(
        nlive_points=100, proposal_batch=128, eval_batch=64,
        shelf_capacity=4, chunk_iters=25, max_fill_rounds=512,
        region_rebuild_draws=0, region_rebuild_every=5,
    )
    tiny = dataclasses.replace(base, member_capacity=64)
    r_tiny = _run(problem, tiny, 2)
    r_big = _run(problem, base, 2)
    assert r_tiny.stats["member_overflow"] > 10, r_tiny.stats
    assert r_big.stats["member_overflow"] == 0, r_big.stats
    for r, label in [(r_tiny, "tiny"), (r_big, "big")]:
        err = np.abs(r.logZ - want)
        tol = 3.0 * (r.logZerr + 0.2)
        assert (err < tol).all(), (label, err, tol, r.logZerr)
    diff = np.abs(r_tiny.logZ - r_big.logZ)
    joint = 3.0 * (r_tiny.logZerr + r_big.logZerr + 0.1)
    assert (diff < joint).all(), (diff, joint)


def test_stall_flags_surface_in_result_and_hdf5(tmp_path):
    """:73. On a likelihood plateau with tolerance 0 the only way out is
    the stall force-termination; every dataset is flagged in the stats,
    the ``stalled`` HDF5 dataset and the ``.stats.json``."""
    _, centers, sigma = _stall_problem(D=4)
    f32 = dict(dtype=torch.float32)
    problem = PlateauGaussian(torch.as_tensor(centers, **f32),
                              torch.tensor(sigma, **f32))
    cfg = RunConfig(
        nlive_points=40, proposal_batch=64, eval_batch=16,
        shelf_capacity=2, chunk_iters=10, max_fill_rounds=8,
        stall_limit=5, check_every=5, min_samples=0, tolerance=0.0,
    )
    result = _run(problem, cfg, 0)
    assert result.stats["stalled_mask"].shape == (4,)
    assert result.stats["stall_count"].shape == (4,)
    assert result.stats["stalled_mask"].all(), result.stats
    prefix = str(tmp_path / "out")
    write_results(prefix, result)
    with h5py.File(prefix + ".hdf5") as f:
        assert "stalled" in f
        got = np.array(f["stalled"])
    np.testing.assert_array_equal(got, result.stats["stalled_mask"])
    with open(prefix + ".stats.json") as fh:
        stats = json.load(fh)
    assert stats["n_stalled_datasets"] == int(got.sum())
    assert "interrupted" in stats


def test_healthy_run_reports_no_stalls(tmp_path):
    """:123."""
    problem, _, _ = _stall_problem(D=4)
    cfg = RunConfig(
        nlive_points=50, proposal_batch=128, eval_batch=32,
        shelf_capacity=4, chunk_iters=20, max_fill_rounds=256,
    )
    result = _run(problem, cfg, 1)
    assert not result.stats["stalled_mask"].any()
    prefix = str(tmp_path / "out")
    write_results(prefix, result)
    with open(prefix + ".stats.json") as fh:
        stats = json.load(fh)
    assert stats["n_stalled_datasets"] == 0


def test_chunk_fill_budget_truncation_unbiased():
    """:143. Three fill rounds per 25-iteration chunk: most iterations run
    on shelf stock or skip. The budget binds (more iterations), no
    truncation counts as a stall, and the evidences stay within
    Monte-Carlo error of the truth and of the unbudgeted run."""
    problem, centers, sigma = _stall_problem()
    want = true_logZ(centers, sigma)
    base = RunConfig(
        nlive_points=100, proposal_batch=128, eval_batch=64,
        shelf_capacity=4, chunk_iters=25, max_fill_rounds=512,
    )
    tight = dataclasses.replace(base, chunk_fill_budget=3)
    r_tight = _run(problem, tight, 2)
    r_free = _run(problem, base, 2)
    assert r_tight.stats["fill_rounds"] > 0
    assert r_tight.niterations > r_free.niterations
    assert not r_tight.stats["stalled_mask"].any(), r_tight.stats
    for r, label in [(r_tight, "tight"), (r_free, "free")]:
        err = np.abs(r.logZ - want)
        tol = 3.0 * (r.logZerr + 0.2)
        assert (err < tol).all(), (label, err, tol, r.logZerr)
    diff = np.abs(r_tight.logZ - r_free.logZ)
    joint = 3.0 * (r_tight.logZerr + r_free.logZerr + 0.1)
    assert (diff < joint).all(), (diff, joint)


# --- tests/test_integrator_pipeline.py -----------------------------------------

PIPE_CFG = RunConfig(
    nlive_points=50,
    proposal_batch=128,
    eval_batch=32,
    shelf_capacity=4,
    chunk_iters=20,
    max_fill_rounds=256,
)


def _pipe_problem(D=6, ndim=2, seed=21):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.3, 0.7, size=(D, ndim))
    return centers, make_analytic_gaussian_problem(centers, sigma=0.07)


def test_compaction_is_invisible():
    """:46. A 1024-row pile compacts repeatedly mid-run; the dead-point
    stream and the evidences are those of an uncompacted run."""
    _, problem = _pipe_problem()
    big = _run(problem, dataclasses.replace(PIPE_CFG, pile_capacity=1 << 16), 4)
    small = _run(problem, dataclasses.replace(PIPE_CFG, pile_capacity=1024), 4)
    assert small.stats["pile_peak"] <= 1024
    np.testing.assert_array_equal(big.L, small.L)
    np.testing.assert_array_equal(big.u, small.u)
    np.testing.assert_allclose(big.logZ, small.logZ, rtol=0, atol=1e-6)
    assert big.ndraws == small.ndraws


def test_pile_capacity_transport_guard():
    """:70. Capacities at or above 2^24 are refused with sizing guidance;
    the largest bucket below it is accepted."""
    cfg = dataclasses.replace(PIPE_CFG, pile_capacity=(1 << 24))
    with pytest.raises(ValueError, match="2\\^24"):
        cfg.resolve_pile_capacity(100)
    cap = dataclasses.replace(
        PIPE_CFG, pile_capacity=(1 << 24) - 1024).resolve_pile_capacity(100)
    assert cap == (1 << 24) - 1024


def test_pile_capacity_hit_drops_are_contained():
    """:84. At a full pile accepted candidates are dropped into the sink
    row: the size clamps at capacity, no shelf or live point points past
    it, the stall force-termination retires every dataset and the chunk
    ends early with finite state."""
    _, problem = _pipe_problem(D=6, seed=24)
    cfg = dataclasses.replace(
        PIPE_CFG, pile_capacity=1024, tolerance=0.0, chunk_iters=900,
        region_rebuild_every=25,
    )
    P = cfg.resolve_pile_capacity(problem.ndata)
    assert P == 1024
    mc = cfg.resolve_member_capacity(problem.ndata)
    gen = torch.Generator().manual_seed(9)
    st = engine.init_state(problem, gen, cfg)
    st2, _, rows = engine.run_chunk(problem, st, cfg, mc, cfg.chunk_iters,
                                    gen)
    assert int(st2.pile_size) == P
    assert 0 < int(st2.iteration) < cfg.chunk_iters
    assert rows == int(st2.iteration)
    assert not st2.running.any()
    limit = engine.resolve_stall_limit(cfg)
    assert int(st2.stall_count.max()) > limit
    assert int(st2.shelves.idx.max()) < P and int(st2.live_idx.max()) < P
    assert torch.isfinite(st2.live_L).all()
    assert torch.isfinite(st2.logZ).all()


def test_phantom_compaction_remap():
    """:118. Phantom pile rows survive the compaction remap: a 1024-row
    pile with phantom_capacity 16 reproduces the big-pile run."""
    _, problem = _pipe_problem(D=6, seed=25)
    base = dataclasses.replace(PIPE_CFG, phantom_capacity=16)
    big = _run(problem, dataclasses.replace(base, pile_capacity=1 << 16), 4)
    small = _run(problem, dataclasses.replace(base, pile_capacity=1024), 4)
    assert small.stats["pile_peak"] <= 1024
    np.testing.assert_array_equal(big.L, small.L)
    np.testing.assert_allclose(big.logZ, small.logZ, rtol=0, atol=1e-6)
    assert big.ndraws == small.ndraws
