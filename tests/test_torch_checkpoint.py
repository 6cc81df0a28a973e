"""Checkpoint and resume of the port (``io/checkpoint.py``).

The bars of the JAX package's tests/test_checkpoint.py and
tests/test_checkpoint_midrun.py, on the same analytic problems and
``RunConfig``: a run preempted mid-flight and resumed is bit for bit the
uninterrupted run (at ``pipeline_lookahead=0``, the JAX package's
contract, set here as in its tests/test_checkpoint_midrun.py:27), a
checkpoint of a finished run resumes straight to the same result, and
checkpoints the port cannot resume exactly (the JAX package's, another
format version, another nlive, a generator on the other device type) are
refused by name.
"""

import dataclasses
import json
import logging
import os

import h5py
import jax
import numpy as np
import pytest
import torch

from massivedatans_tpu.config import RunConfig as JaxRunConfig
from massivedatans_tpu.models import analytic as jax_analytic
from massivedatans_tpu.ns.integrator import multi_nested_integrator as jax_integrator
from massivedatans_tpu_torch import cli
from massivedatans_tpu_torch.config import RunConfig
from massivedatans_tpu_torch.io import checkpoint as ckpt
from massivedatans_tpu_torch.models.analytic import make_analytic_gaussian_problem
from massivedatans_tpu_torch.ns.integrator import multi_nested_integrator

torch.set_num_threads(1)

CFG = RunConfig(
    nlive_points=60,
    proposal_batch=128,
    eval_batch=32,
    shelf_capacity=4,
    chunk_iters=20,
    max_fill_rounds=256,
    pipeline_lookahead=0,  # bit-identity contract (integrator docstring)
)
# keep every dataset running well past the preemption
MIDRUN = dataclasses.replace(CFG, min_samples=120)
FIELDS = ("logZ", "logZerr", "L", "u", "x", "w", "mask")


def _problem(seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.35, 0.65, size=(6, 2))
    return make_analytic_gaussian_problem(centers, sigma=0.07)


def _run(problem, cfg, **kw):
    return multi_nested_integrator(
        problem, cfg, device="cpu", generator=torch.Generator().manual_seed(4),
        progress=False, **kw)


def _assert_same(got, want):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.niterations == want.niterations
    assert got.ndraws == want.ndraws
    assert got.stats["fill_rounds"] == want.stats["fill_rounds"]


@pytest.fixture(scope="module")
def midrun_full():
    return _run(_problem(11), MIDRUN)


def test_preempt_midrun_resume_bitidentical(tmp_path, midrun_full):
    full = midrun_full
    assert full.niterations > 3 * CFG.chunk_iters + 20  # 3 chunks = mid-run
    d = str(tmp_path / "ck")
    partial = _run(_problem(11), MIDRUN, checkpoint_dir=d, checkpoint_every=1,
                   max_chunks=3)
    assert partial.stats["interrupted"]
    assert partial.niterations == 3 * CFG.chunk_iters < full.niterations
    # the format on disk: tagged, fields by name, only the used pile prefix
    with np.load(os.path.join(d, "state.npz")) as data:
        assert str(data["format"]) == ckpt.FORMAT
        assert int(data["format_version"]) == ckpt.FORMAT_VERSION
        assert data["pile_u"].shape[0] == int(data["pile_size"])
        assert data["shelves.idx"].dtype == np.int32
        assert data["ndraws"].dtype == np.int64
        assert str(data["generator.device"]) == "cpu"
    assert ckpt.load_meta(d)["chunk_index"] == 3
    assert len(ckpt.load_chunks(d)) == 3

    resumed = _run(_problem(11), MIDRUN, checkpoint_dir=d, checkpoint_every=1)
    assert not resumed.stats["interrupted"]
    _assert_same(resumed, full)


def test_preempt_resume_preempt_again(tmp_path, midrun_full):
    """Two preemptions in sequence (rolling preemptible workers), at a
    checkpoint cadence that is not a divisor of the preemption points."""
    d = str(tmp_path / "ck")
    p1 = _run(_problem(11), MIDRUN, checkpoint_dir=d, checkpoint_every=3,
              max_chunks=2)
    assert p1.stats["interrupted"]
    p2 = _run(_problem(11), MIDRUN, checkpoint_dir=d, checkpoint_every=3,
              max_chunks=4)
    assert p2.stats["interrupted"]
    assert p2.niterations == 4 * CFG.chunk_iters
    final = _run(_problem(11), MIDRUN, checkpoint_dir=d, checkpoint_every=3)
    _assert_same(final, midrun_full)


def test_state_file_commits_the_checkpoint(tmp_path, midrun_full):
    """A worker killed after ``state.npz`` went in place and before its
    copies ``host.npz`` and ``meta.json`` did: the resume reads the chunk
    index, running mask and group count committed with the state, not the
    older copies, and ends on the uninterrupted run."""
    d = str(tmp_path / "ck")
    _run(_problem(11), MIDRUN, checkpoint_dir=d, checkpoint_every=1,
         max_chunks=2)
    stale = {}
    for name in ("host.npz", "meta.json"):
        with open(os.path.join(d, name), "rb") as fh:
            stale[name] = fh.read()
    _run(_problem(11), MIDRUN, checkpoint_dir=d, checkpoint_every=1,
         max_chunks=4)
    for name, raw in stale.items():
        with open(os.path.join(d, name), "wb") as fh:
            fh.write(raw)
    with open(os.path.join(d, "meta.json")) as fh:
        assert json.load(fh)["chunk_index"] == 2
    assert ckpt.load_meta(d)["chunk_index"] == 4
    resumed = _run(_problem(11), MIDRUN, checkpoint_dir=d)
    _assert_same(resumed, midrun_full)


def test_preempt_at_every_chunk_across_pile_compaction(tmp_path, caplog):
    """A small pile is compacted mid-run; a worker preempted after every
    chunk, compaction included, still ends on the uninterrupted run."""
    cfg = dataclasses.replace(MIDRUN, pile_capacity=400)
    full = _run(_problem(11), cfg)
    d = str(tmp_path / "ck")
    with caplog.at_level(logging.INFO, logger="massivedatans_tpu_torch"):
        for n in range(1, 100):
            r = _run(_problem(11), cfg, checkpoint_dir=d, max_chunks=n)
            if not r.stats["interrupted"]:
                break
    assert any("pile compaction" in m for m in caplog.messages)
    assert r.stats["chunks"] == n
    _assert_same(r, full)


@pytest.mark.parametrize("constrainer", ["MULTIELLIPSOIDS", "SLICE"])
def test_stateful_strategies_resume_bitwise(tmp_path, constrainer):
    cfg = dataclasses.replace(MIDRUN, constrainer=constrainer)
    full = _run(_problem(11), cfg)
    d = str(tmp_path / "ck")
    partial = _run(_problem(11), cfg, checkpoint_dir=d, max_chunks=3)
    assert partial.stats["interrupted"]
    _assert_same(_run(_problem(11), cfg, checkpoint_dir=d), full)


def test_preempt_resume_under_mesh(tmp_path):
    """tests/test_checkpoint_midrun.py::test_preempt_resume_under_mesh: a
    run on a 2-rank dataset mesh, preempted after 3 chunks and resumed, is
    the uninterrupted sharded run bit for bit (rank 0 writes the gathered
    state; every rank loads and re-shards it)."""
    from massivedatans_tpu_torch.parallel.launch import run_sharded

    def sharded(**kw):
        return run_sharded(_problem(11), dataclasses.replace(MIDRUN, seed=4),
                           2, "gloo", "cpu", timeout_s=120, **kw)

    full = sharded()
    ck = str(tmp_path / "ckm")
    partial = sharded(checkpoint_dir=ck, checkpoint_every=1, max_chunks=3)
    assert partial.stats["interrupted"]
    assert ckpt.load_meta(ck)["ndata"] == 6  # the whole state, gathered
    resumed = sharded(checkpoint_dir=ck, checkpoint_every=1)
    np.testing.assert_array_equal(resumed.logZ, full.logZ)
    np.testing.assert_array_equal(resumed.L, full.L)
    assert resumed.niterations == full.niterations
    # the sharded run walks the single-device trajectory (no column
    # proposals on either side), to f32 rounding of the likelihood
    single = _run(_problem(11), dataclasses.replace(MIDRUN,
                                                    use_column_focus=False))
    assert full.niterations == single.niterations
    np.testing.assert_allclose(full.logZ, single.logZ, rtol=1e-5, atol=1e-5)


def test_max_samples_checkpoint_resumes_to_the_same_result(tmp_path):
    """The JAX package's round-1 bar: a run stopped by max_samples
    terminated every dataset, so its resume is the already-complete
    branch and returns the same result at once."""
    d = str(tmp_path / "ck")
    partial = _run(_problem(9), CFG, checkpoint_dir=d, checkpoint_every=1,
                   max_samples=60)
    assert partial.niterations <= 80 and not partial.stats["interrupted"]
    resumed = _run(_problem(9), CFG, checkpoint_dir=d, checkpoint_every=1)
    _assert_same(resumed, partial)
    assert resumed.stats["chunks"] == partial.stats["chunks"]


def test_checkpointed_run_equals_the_plain_run(tmp_path):
    full = _run(_problem(9), CFG)
    d = str(tmp_path / "ck2")
    _assert_same(_run(_problem(9), CFG, checkpoint_dir=d, checkpoint_every=2),
                 full)
    resumed = _run(_problem(9), CFG, checkpoint_dir=d)
    _assert_same(resumed, full)
    assert resumed.u.shape == full.u.shape


def test_max_chunks_requires_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _run(_problem(11), MIDRUN, max_chunks=2)


@pytest.fixture
def port_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    _run(_problem(11), MIDRUN, checkpoint_dir=d, max_chunks=2)
    return d


def _edit_state(path, **arrays):
    state = os.path.join(path, "state.npz")
    with np.load(state) as data:
        saved = dict(data)
    saved.update(arrays)
    np.savez(state, **saved)


def test_jax_package_checkpoint_is_refused(tmp_path):
    d = str(tmp_path / "jax_ck")
    rng = np.random.default_rng(11)
    centers = rng.uniform(0.35, 0.65, size=(6, 2))
    jax_integrator(jax_analytic.make_analytic_gaussian_problem(centers, 0.07),
                   JaxRunConfig(**dataclasses.asdict(MIDRUN)),
                   key=jax.random.key(4), progress=False, checkpoint_dir=d,
                   max_chunks=1)
    assert ckpt.has_checkpoint(d)
    with pytest.raises(ValueError, match="JAX package"):
        _run(_problem(11), MIDRUN, checkpoint_dir=d)


def test_wrong_format_version_is_refused(port_checkpoint):
    _edit_state(port_checkpoint, format_version=np.int64(99))
    with pytest.raises(ValueError, match="v99"):
        _run(_problem(11), MIDRUN, checkpoint_dir=port_checkpoint)


def test_other_nlive_is_refused(port_checkpoint):
    cfg = dataclasses.replace(MIDRUN, nlive_points=50)
    with pytest.raises(ValueError, match="live_idx.*other run parameters"):
        _run(_problem(11), cfg, checkpoint_dir=port_checkpoint)


def test_generator_on_the_other_device_type_is_refused(port_checkpoint):
    _edit_state(port_checkpoint, **{"generator.device": np.array("cuda")})
    with pytest.raises(ValueError, match="cuda generator.*on cpu"):
        _run(_problem(11), MIDRUN, checkpoint_dir=port_checkpoint)


def _hdf5(path):
    with h5py.File(path) as f:
        return {k: f[k][()] for k in f.keys() if k != "duration"}


def _assert_same_files(got, want):
    got, want = _hdf5(got), _hdf5(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture
def tiny_cube(tmp_path, monkeypatch):
    from massivedatans_tpu_torch.muse import synth

    monkeypatch.chdir(tmp_path)
    tpl = synth.make_template_files("tpl", n_wl=100)
    synth.make_model_cube("cube.fits", "sel.reg", tpl, "truths.json",
                          ny=2, nx=3, nspec=80, cd3=50.0)
    return tpl


def test_run_musefit_preempt_resume_writes_the_uninterrupted_output(tiny_cube):
    from massivedatans_tpu_torch.muse.pipeline import run_musefit

    kw = dict(nlive=30, max_samples=80, progress=False, device="cpu",
              cfg_overrides=dict(chunk_iters=20))
    full, _, _ = run_musefit("cube.fits", "sel.reg", 0.0, 0.5, tiny_cube,
                             out_prefix="full", **kw)
    partial, _, _ = run_musefit("cube.fits", "sel.reg", 0.0, 0.5, tiny_cube,
                                out_prefix="piece", checkpoint_dir="ck",
                                max_chunks=2, checkpoint_every=1, **kw)
    assert partial.stats["interrupted"] and os.path.exists("piece.hdf5")
    resumed, _, _ = run_musefit("cube.fits", "sel.reg", 0.0, 0.5, tiny_cube,
                                out_prefix="piece", checkpoint_dir="ck", **kw)
    assert not resumed.stats["interrupted"]
    assert resumed.niterations == full.niterations > 2 * 20
    _assert_same_files("piece.hdf5", "full.hdf5")


def test_cli_fit_checkpoint_dir_resumes_to_the_same_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cli.main(["gen", "horns", "32"])
    fit = ["fit", "data_widths_32.hdf5", "3", "--nlive", "40", "--max-samples",
           "150", "--device", "cpu", "--quiet", "--checkpoint-dir", "ck",
           "--checkpoint-every", "2"]
    out = "data_widths_32.hdf5_MLFRIENDS_nlive40_3.out8.hdf5"
    cli.main(fit)
    assert ckpt.has_checkpoint("ck")
    meta = ckpt.load_meta("ck")
    assert meta["nlive"] == 40 and meta["ndata"] == 3
    os.rename(out, "first.hdf5")
    cli.main(fit)  # the checkpoint is of a finished run
    _assert_same_files(out, "first.hdf5")
    with open(out[:-len(".hdf5")] + ".stats.json") as fh:
        assert json.load(fh)["interrupted"] == 0
