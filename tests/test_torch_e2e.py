"""The port's whole slice on the CPU: integrator to kernels.

The acceptance standard is the JAX package's own (tests/test_engine_e2e.py):
evidences within Monte-Carlo error of the analytic truth and of the horns
quadrature oracle (quad_logZ.json), plus agreement with the JAX integrator
run on the same inputs.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import pytest
import torch

from massivedatans_tpu.config import RunConfig as JaxRunConfig
from massivedatans_tpu.models import analytic as jax_analytic
from massivedatans_tpu.ns.integrator import multi_nested_integrator as jax_integrator
from massivedatans_tpu_torch.cli import run_fit
from massivedatans_tpu_torch.config import RunConfig
from massivedatans_tpu_torch.datagen.generators import gen_horns
from massivedatans_tpu_torch.models.analytic import (
    make_analytic_gaussian_problem,
    true_logZ,
)
from massivedatans_tpu_torch.ns.integrator import multi_nested_integrator

torch.set_num_threads(1)

SMALL = RunConfig(
    nlive_points=100,
    proposal_batch=256,
    eval_batch=64,
    shelf_capacity=4,
    chunk_iters=25,
    tolerance=0.5,
    max_fill_rounds=512,
)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _err(result, K):
    return result.logZerr + np.sqrt(np.maximum(result.information, 0.0) / K)


@pytest.fixture(scope="module")
def analytic_runs():
    rng = np.random.default_rng(42)
    centers = rng.uniform(0.25, 0.75, size=(8, 2))
    port = multi_nested_integrator(
        make_analytic_gaussian_problem(centers, sigma=0.05), SMALL,
        device="cpu", generator=torch.Generator().manual_seed(3),
        progress=False)
    ref = jax_integrator(
        jax_analytic.make_analytic_gaussian_problem(centers, sigma=0.05),
        JaxRunConfig(**dataclasses.asdict(SMALL)), key=jax.random.key(3),
        progress=False)
    return centers, port, ref


def test_analytic_logZ_within_mc_error(analytic_runs):
    centers, result, _ = analytic_runs
    resid = np.abs(result.logZ - true_logZ(centers, sigma=0.05))
    err = _err(result, SMALL.nlive_points)
    assert (resid < 3.0 * err + 0.6).all(), (resid, err)
    assert resid.mean() < 0.45, resid


def test_analytic_logZ_agrees_with_jax_integrator(analytic_runs):
    _, port, ref = analytic_runs
    K = SMALL.nlive_points
    bound = 3.0 * np.sqrt(_err(port, K) ** 2 + _err(ref, K) ** 2) + 0.5
    assert (np.abs(port.logZ - ref.logZ) < bound).all(), (port.logZ, ref.logZ)


def test_result_schema(analytic_runs):
    _, result, _ = analytic_runs
    n = result.u.shape[0]
    assert n == result.niterations + SMALL.nlive_points
    assert result.u.shape == (n, 8, 2) and result.x.shape == (n, 8, 2)
    assert result.L.shape == (n, 8) and result.w.shape == (n, 8)
    assert result.mask.shape == (n, 8)
    assert result.mask[-SMALL.nlive_points:].all()  # tail rows: live points
    assert np.isfinite(result.logZ).all() and (result.logZerr > 0).all()
    assert result.ndraws > 0 and result.stats["stalled"] == 0
    # analytic problem: the prior transform is the identity
    assert np.array_equal(result.u, result.x)


def test_max_samples_is_immediate():
    rng = np.random.default_rng(11)
    centers = rng.uniform(0.3, 0.7, size=(4, 2))
    result = multi_nested_integrator(
        make_analytic_gaussian_problem(centers, sigma=0.05), SMALL,
        device="cpu", generator=torch.Generator().manual_seed(2),
        progress=False, max_samples=30)
    assert 30 <= result.niterations <= 31, result.niterations
    assert np.isfinite(result.logZ).all() and (result.logZerr > 0).all()
    assert (np.abs(result.logZ - true_logZ(centers, 0.05)) < 25).all()


def test_horns_first_spectra_match_quadrature():
    """The first spectra of gen_horns(1000) against the committed
    quadrature oracle, through the same run_fit the CLI and chip_smoke.py
    call."""
    data = gen_horns(1000)
    D = 4
    result = run_fit(data["x"], data["y"][:, :D], RunConfig(nlive_points=100),
                     "cpu", noise_level=data["noise_level"])
    with open(os.path.join(ROOT, "quad_logZ.json")) as fh:
        quad = np.asarray(json.load(fh)["logZ"], float)[:D]
    dq = np.abs(result.logZ - quad)
    assert (dq < 3 * result.logZerr + 0.5).all(), (dq, result.logZerr)
    assert result.u.shape == (result.niterations + 100, D, 3)


@pytest.mark.parametrize("constrainer", ["MLFRIENDS", "SUPFRIENDS"])
def test_decoupled_datasets_with_column_rounds(monkeypatch, constrainer):
    """Separated tight blobs with small batches, so fills take several
    rounds and the per-column proposals (engine._column_proposals) run
    inside the fill loop; evidences stay unbiased (the bar of the JAX
    package's test_decoupled_datasets_logZ_with_column_focus)."""
    from massivedatans_tpu_torch.ns import engine

    calls = []
    column_proposals = engine._column_proposals
    monkeypatch.setattr(engine, "_column_proposals",
                        lambda *a, **k: calls.append(1) or column_proposals(*a, **k))
    rng = np.random.default_rng(9)
    gx, gy = np.meshgrid(np.linspace(0.15, 0.85, 4), np.linspace(0.2, 0.8, 3))
    centers = np.stack([gx.ravel(), gy.ravel()], axis=1)
    centers += rng.uniform(-0.02, 0.02, size=centers.shape)
    cfg = dataclasses.replace(SMALL, constrainer=constrainer, eval_batch=16,
                              proposal_batch=64, column_focus_groups=4,
                              column_focus_fallback_rounds=1)
    result = multi_nested_integrator(
        make_analytic_gaussian_problem(centers, sigma=0.015), cfg,
        device="cpu", generator=torch.Generator().manual_seed(5),
        progress=False)
    assert len(calls) > 0
    resid = np.abs(result.logZ - true_logZ(centers, sigma=0.015))
    err = _err(result, SMALL.nlive_points)
    assert (resid < 3.5 * err + 0.8).all(), (resid, err)
    assert result.stats["stalled"] == 0


def test_unported_options_raise(tmp_path):
    """A mesh that is not a torch.distributed DeviceMesh is refused (the
    mesh path: tests/test_torch_parallel.py); checkpointing, eval-batch
    escalation and the adaptive fill budget run."""
    problem = make_analytic_gaussian_problem(np.full((2, 2), 0.5))
    with pytest.raises(TypeError, match="DeviceMesh"):
        multi_nested_integrator(problem, SMALL, device="cpu", mesh=object())
    cfg = dataclasses.replace(SMALL, max_samples=60,
                              eval_batch_max=4 * SMALL.eval_batch)
    result = multi_nested_integrator(
        problem, cfg, device="cpu", progress=False, dispatch_target_s=1.0,
        checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=1)
    assert np.isfinite(result.logZ).all()
    assert os.path.exists(tmp_path / "ckpt" / "state.npz")
    assert result.stats["fill_budget_last"] is not None


def test_port_modules_import_no_jax_modules():
    """The port imports nothing of the JAX package and nothing of JAX, and
    turns a JAX package RunConfig away."""
    pkg = os.path.join(ROOT, "massivedatans_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                src = fh.read()
            assert "import jax" not in src and "from jax" not in src, f
            for line in src.splitlines():
                words = line.split()
                if len(words) >= 2 and words[0] in ("from", "import"):
                    top = words[1].split(".")[0]
                    assert top not in ("massivedatans_tpu", "jax"), (f, line)
    problem = make_analytic_gaussian_problem(np.full((2, 2), 0.5))
    with pytest.raises(TypeError, match="asdict"):
        multi_nested_integrator(problem, JaxRunConfig(), device="cpu")
