"""The port at the reference's headline scale, held at small sizes on the
CPU: the quadrature oracle of the 10^4 horns stream, the scaling tool
(``tools/torch_scaling_bench.py``) and the group-label cadence that runs
only at large K*D (``config.group_refresh_chunks``)."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from massivedatans_tpu_torch.config import RunConfig
from massivedatans_tpu_torch.datagen.generators import gen_horns
from massivedatans_tpu_torch.models.analytic import (
    make_analytic_gaussian_problem,
    true_logZ,
)
from massivedatans_tpu_torch.ns import engine, integrator
from test_quadrature_oracle import quadrature_logZ

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(ROOT, "quad_logZ_horns10000.json")
SMALL = RunConfig(
    nlive_points=100,
    proposal_batch=256,
    eval_batch=64,
    shelf_capacity=4,
    chunk_iters=25,
    tolerance=0.5,
    max_fill_rounds=512,
)
# rounding of the oracle's entries (4 decimals) on each side, and the
# float64 summation order of a different column subset
RECOMPUTE_TOL = 2e-4


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_horns10000_oracle_recomputes_on_the_coarse_grid():
    """The committed oracle covers the first 100 datasets of
    gen_horns(10000); three of them (the first and the two least
    converged) recomputed on the coarse grid agree with the fine values
    within the file's own convergence record."""
    with open(ORACLE) as fh:
        oracle = json.load(fh)
    assert oracle["n_gen"] == 10000 and oracle["ndata"] == 100
    assert len(oracle["logZ"]) == len(oracle["conv_abs_diff"]) == 100
    assert oracle["grid"] == [160, 3000, 160]
    assert oracle["grid_coarse"] == [96, 1600, 96]
    fine = np.asarray(oracle["logZ"])
    conv = np.asarray(oracle["conv_abs_diff"])
    assert np.isfinite(fine).all()
    assert abs(conv.max() - oracle["conv_max_abs_diff"]) <= 1e-4
    picks = np.unique(np.concatenate([[0], np.argsort(conv)[-2:]]))
    data = gen_horns(10000)
    n_a, n_mu, n_sig = oracle["grid_coarse"]
    coarse = quadrature_logZ(np.asarray(data["x"], float),
                             np.asarray(data["y"], float)[:, picks],
                             float(data["noise_level"]), n_a=n_a, n_mu=n_mu,
                             n_sig=n_sig)
    assert (np.abs(coarse - fine[picks]) <= conv[picks] + RECOMPUTE_TOL).all(), (
        coarse, fine[picks], conv[picks])


def test_scaling_tool_writes_the_reference_stats(tmp_path):
    """The scaling tool at N in {2, 4}, nlive 50, on the CPU: every key of
    the JAX tool's stats files, the port's own keys, and plot_scaling reads
    the files."""
    from massivedatans_tpu_torch.postprocess import plot_scaling

    tool = _load_tool("torch_scaling_bench")
    out = tmp_path / "scaling"
    assert tool.main(["--device", "cpu", "--ns", "2", "4", "--nlive", "50",
                      "--out", str(out)]) == 0
    with open(os.path.join(ROOT, "scaling_out", "scaling_10.stats.json")) as fh:
        ref_keys = set(json.load(fh))
    files = [str(out / f"scaling_{n}.stats.json") for n in (2, 4)]
    for n, fn in zip((2, 4), files):
        with open(fn) as fh:
            stats = json.load(fh)
        assert ref_keys <= set(stats), ref_keys - set(stats)
        assert stats["ndata"] == n and stats["stalled_total"] == 0
        assert stats["chunk_path"] == "eager" and "groups_s" in stats["timing"]
        assert 0 < stats["group_refreshes"] <= stats["chunks"]
        assert stats["n_groups_max"] >= 1 and stats["steps"]["region"] > 0
        assert set(stats["launches"]) == {"count_within",
                                          "bootstrapped_sq_radius"}
    Ns, draws = plot_scaling(files, path=str(tmp_path / "again.pdf"))
    assert list(Ns) == [2, 4] and (draws > 0).all()
    assert (out / "scaling.pdf").exists()


def test_scaling_tool_bars():
    """The tool's bars: 9 of 10 at N = 10, 95 of 100 above."""
    tool = _load_tool("torch_scaling_bench")
    quad = np.zeros(100)
    err = np.ones(100)
    for n, need in ((10, 9), (100, 95), (4, 3)):
        z = np.zeros(n)
        assert tool.quad_within(z, err[:n], quad) == (n, need)
        z[:n - need] = 10.0  # outside the bar
        assert tool.quad_within(z, err[:n], quad) == (need, need)
    assert tool.exponent([100, 1000, 10000], [1e5, 1e6, 1e7]) == pytest.approx(1.0)


@pytest.mark.parametrize("pile_capacity, lookahead", [(0, 1), (3000, 2)])
def test_label_cadence_refreshes_every_third_chunk(monkeypatch, pile_capacity,
                                                   lookahead):
    """``group_refresh_chunks=3``: only chunks 0, 3, 6, ... carry the live
    points in their report and refresh the group labels; every chunk
    starts from the labels and group count the last refresh set (a chunk
    without labels changes neither), also where the pile is compacted
    after draining a lookahead of 2; the evidence bar of
    test_decoupled_datasets_with_column_rounds holds."""
    events, finished = [], [0]
    finish = engine.ChunkRunner.finish

    def counted_finish(self):
        finished[0] += 1
        return finish(self)

    gather = integrator.sharded.all_gather_rows

    def recorded_gather(x, group, dim=0):
        if dim == 1:  # the report's live points: a refresh chunk
            events.append(("gathered", finished[0] - 1))
        return gather(x, group, dim)

    labels_fn = integrator.subsets_lib.component_labels

    def recorded_labels(*a, **k):
        labels, n = labels_fn(*a, **k)
        events.append(("labels", np.maximum(labels, 0), max(int(n), 1)))
        return labels, n

    start = engine.ChunkProgram.start

    def recorded_start(self, state, *a, **k):
        events.append(("start", state.group_id.numpy().copy(), state.n_groups))
        return start(self, state, *a, **k)

    compact = integrator.compact_pile
    compactions = []

    def counted_compact(*a, **k):
        compactions.append(1)
        return compact(*a, **k)

    monkeypatch.setattr(engine.ChunkRunner, "finish", counted_finish)
    monkeypatch.setattr(integrator.sharded, "all_gather_rows", recorded_gather)
    monkeypatch.setattr(integrator.subsets_lib, "component_labels",
                        recorded_labels)
    monkeypatch.setattr(engine.ChunkProgram, "start", recorded_start)
    monkeypatch.setattr(integrator, "compact_pile", counted_compact)

    rng = np.random.default_rng(9)
    gx, gy = np.meshgrid(np.linspace(0.15, 0.85, 4), np.linspace(0.2, 0.8, 3))
    centers = np.stack([gx.ravel(), gy.ravel()], axis=1)
    centers += rng.uniform(-0.02, 0.02, size=centers.shape)
    cfg = dataclasses.replace(SMALL, group_refresh_chunks=3,
                              pile_capacity=pile_capacity,
                              pipeline_lookahead=lookahead)
    result = integrator.multi_nested_integrator(
        make_analytic_gaussian_problem(centers, sigma=0.015), cfg,
        device="cpu", generator=torch.Generator().manual_seed(5),
        progress=False)
    chunks = result.stats["chunks"]
    gathered = [e[1] for e in events if e[0] == "gathered"]
    assert gathered == list(range(0, chunks, 3)), (gathered, chunks)
    refreshes = sum(e[0] == "labels" for e in events)
    assert refreshes == result.stats["group_refreshes"]
    assert len(gathered) - 1 <= refreshes <= len(gathered) < chunks
    # the labels separate the blobs late in the run
    assert result.stats["n_groups_max"] > 1
    assert max(e[2] for e in events if e[0] == "labels") \
        == result.stats["n_groups_max"]
    last = (np.zeros(len(centers), np.int32), 1)
    for e in events:
        if e[0] == "labels":
            last = e[1:]
        elif e[0] == "start":
            assert np.array_equal(e[1], last[0]) and e[2] == last[1]
    assert bool(compactions) == (pile_capacity > 0)
    resid = np.abs(result.logZ - true_logZ(centers, sigma=0.015))
    err = result.logZerr + np.sqrt(np.maximum(result.information, 0.0)
                                   / SMALL.nlive_points)
    assert (resid < 3.5 * err + 0.8).all(), (resid, err)
    assert result.stats["stalled"] == 0


def test_label_cadence_under_a_mesh_matches_one_device():
    """Four gloo ranks with ``group_refresh_chunks=3``: the live points
    are all-gathered on the refresh chunks only, every rank takes the same
    labels, and the run walks the single-device trajectory (column
    proposals off, as across data ranks), refreshes included."""
    from massivedatans_tpu_torch.parallel.launch import run_sharded

    rng = np.random.default_rng(9)
    gx, gy = np.meshgrid(np.linspace(0.15, 0.85, 4), np.linspace(0.2, 0.8, 3))
    centers = np.stack([gx.ravel(), gy.ravel()], axis=1)
    centers += rng.uniform(-0.02, 0.02, size=centers.shape)
    problem = make_analytic_gaussian_problem(centers, sigma=0.015)
    cfg = dataclasses.replace(SMALL, nlive_points=50, group_refresh_chunks=3,
                              use_column_focus=False, seed=2)
    single = integrator.multi_nested_integrator(problem, cfg, device="cpu",
                                                progress=False)
    mesh = run_sharded(problem, cfg, 4, "gloo", "cpu", timeout_s=120)
    for res in (single, mesh):
        assert 0 < res.stats["group_refreshes"] < res.stats["chunks"]
    assert mesh.stats["group_refreshes"] == single.stats["group_refreshes"]
    assert mesh.stats["n_groups_max"] == single.stats["n_groups_max"] > 1
    assert mesh.niterations == single.niterations
    np.testing.assert_allclose(mesh.logZ, single.logZ, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mesh.L, single.L, rtol=1e-5, atol=1e-5)
