"""Eval-batch escalation (``cfg.eval_batch_max``) and the adaptive fill
budget (``dispatch_target_s``) of the port's integrator.

The bar of the JAX package's tests/test_eval_batch_escalation.py: the
integrator switches to the larger batch when a chunk needs more than 2.5
fill rounds per iteration, the switch shows in ``stats``, and the
evidences stay within ``3·(logZerr + 0.2)`` of the analytic truth either
way. SLICE sizes its chains from the eval batch when it is built, so it
catches an escalated chunk that runs the small batch's strategy.
"""

import numpy as np
import pytest
import torch

from massivedatans_tpu_torch.config import RunConfig
from massivedatans_tpu_torch.models.analytic import (
    make_analytic_gaussian_problem,
    true_logZ,
)
from massivedatans_tpu_torch.ns import engine
from massivedatans_tpu_torch.ns.integrator import (
    escalated_config,
    multi_nested_integrator,
)

torch.set_num_threads(1)

BASE = dict(nlive_points=100, proposal_batch=32, eval_batch=8,
            shelf_capacity=4, chunk_iters=25, max_fill_rounds=512)


def _problem():
    # tight, well-separated modes: late-run region acceptance collapses,
    # so a tiny base batch needs many fill rounds per iteration
    rng = np.random.default_rng(5)
    centers = rng.uniform(0.2, 0.8, size=(8, 2))
    return (make_analytic_gaussian_problem(centers, sigma=0.01),
            true_logZ(centers, sigma=0.01))


def _fit(cfg, **kw):
    problem, want = _problem()
    r = multi_nested_integrator(problem, cfg, device="cpu",
                                generator=torch.Generator().manual_seed(3),
                                progress=False, **kw)
    err = np.abs(r.logZ - want)
    tol = 3.0 * (r.logZerr + 0.2)
    assert (err < tol).all(), (err, tol)
    return r


@pytest.mark.parametrize("constrainer", ["MLFRIENDS", "SLICE"])
def test_escalation_engages_and_keeps_evidences(constrainer, monkeypatch):
    batches = []  # the eval batch each chunk ran at, and its strategy's
    start = engine.ChunkRunner.start

    def spy(self, state, cfg, *a, **k):
        batches.append(cfg.eval_batch)
        return start(self, state, cfg, *a, **k)

    monkeypatch.setattr(engine.ChunkRunner, "start", spy)
    r = _fit(RunConfig(eval_batch_max=64, constrainer=constrainer, **BASE))
    assert r.stats["big_batch_chunks"] > 0, r.stats
    assert batches.count(64) == r.stats["big_batch_chunks"]
    assert set(batches) == {8, 64} and batches[0] == 8

    batches.clear()
    r_off = _fit(RunConfig(constrainer=constrainer, **BASE))
    assert r_off.stats["big_batch_chunks"] == 0
    assert set(batches) == {8}


def test_escalated_config_scales_the_proposal_pools():
    cfg = RunConfig(eval_batch_max=64, column_proposal_batch=48, **BASE)
    big = escalated_config(cfg)
    assert (big.eval_batch, big.proposal_batch, big.column_proposal_batch) \
        == (64, 256, 384)
    assert escalated_config(RunConfig(eval_batch_max=64, **BASE)) \
        .column_proposal_batch == 0  # 0 still means "proposal_batch"


@pytest.mark.parametrize("constrainer", ["MLFRIENDS", "SLICE"])
def test_tiny_dispatch_target_keeps_the_budget_at_its_floor(constrainer):
    r = _fit(RunConfig(constrainer=constrainer, **BASE), dispatch_target_s=1e-6)
    assert r.stats["fill_budget_last"] == 256
    assert r.stats["big_batch_chunks"] == 0


def test_dispatch_budget_growth_is_damped_and_capped(tmp_path):
    """A huge target: from 512 rounds the budget grows 1.5x per measured
    chunk (the first chunk of a call is not measured) up to its ceiling."""
    problem, _ = _problem()
    r = multi_nested_integrator(
        problem, RunConfig(**BASE), device="cpu", progress=False,
        dispatch_target_s=1e3, checkpoint_dir=str(tmp_path), max_chunks=3)
    assert r.stats["fill_budget_last"] == int(int(512 * 1.5) * 1.5)
    r = _fit(RunConfig(chunk_fill_budget=600, **BASE), dispatch_target_s=1e3)
    assert r.stats["fill_budget_last"] == 600
    assert _fit(RunConfig(**BASE)).stats["fill_budget_last"] is None
