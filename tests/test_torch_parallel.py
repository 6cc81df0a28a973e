"""Dataset-sharded execution of the port (``parallel/``), on the CPU with gloo.

Ports of tests/test_parallel.py at its sizes, seeds and bars, plus the
deterministic parts held against the JAX package under ``shard_map`` on
its 8 virtual CPU devices (tests/conftest.py). Every multi-rank case runs
in processes started by ``parallel.launch.spawn_ranks``; each collective
there runs under ``TIMEOUT_S``, so a rank that drifts out of step fails
its test instead of hanging it. The rank functions below import nothing
of JAX: the ranks import this module to find them, so JAX is imported
only inside the tests, in this process.
"""

import dataclasses

import numpy as np
import pytest
import torch

from massivedatans_tpu_torch.config import RunConfig
from massivedatans_tpu_torch.models.analytic import (
    make_analytic_gaussian_problem,
    true_logZ,
)
from massivedatans_tpu_torch.models.base import Problem
from massivedatans_tpu_torch.ns import engine
from massivedatans_tpu_torch.ns.integrator import multi_nested_integrator
from massivedatans_tpu_torch.parallel import sharded
from massivedatans_tpu_torch.parallel.launch import run_sharded, spawn_ranks

torch.set_num_threads(1)

TIMEOUT_S = 120
CFG = RunConfig(
    nlive_points=50,
    proposal_batch=128,
    eval_batch=32,
    shelf_capacity=4,
    chunk_iters=10,
    max_fill_rounds=256,
)
# the sharded path makes no column proposals (they read one rank's empty
# datasets); full runs held to the single-device trajectory leave them off
# on both sides
NO_COLS = dataclasses.replace(CFG, use_column_focus=False)
W = 4  # ranks of the collective checks


def _spawn(fn, world, *args):
    return spawn_ranks(fn, world, "gloo", "cpu", TIMEOUT_S, *args)


def _centers(D=16, ndim=2, seed=0):
    return np.random.default_rng(seed).uniform(0.3, 0.7, size=(D, ndim))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# --- (a) the collectives, against the JAX package's -----------------------------

def _collective_inputs():
    rng = np.random.default_rng(8)
    K, D, Q = 12, 16, 6
    any_cases = np.zeros((3, D), bool)
    any_cases[1, 13] = True             # one dataset of the last rank
    any_cases[2] = rng.random(D) < 0.3
    return dict(
        any_cases=any_cases,
        rows=rng.random((W, 24)) < 0.15,                      # [rank, B]
        dead_L=rng.normal(-10.0, 3.0, D).astype(np.float32),
        dead_i=rng.permutation(1000)[:D].astype(np.int32),
        phantom_L=np.sort(rng.normal(-8.0, 1.0, Q)).astype(np.float32)[::-1].copy(),
        phantom_i=rng.permutation(1000)[:Q].astype(np.int32) + 1000,
        live_idx=rng.integers(0, 400, size=(K, D)).astype(np.int32),
        col_mask=rng.random(D) < 0.7,
        a=np.int64(2 * 123457 + 1),
    )


def _collectives_rank(rank, inp, capacities):
    torch.set_num_threads(1)
    mesh = sharded.make_mesh(rank.world)
    group, r, n = sharded.data_axis(mesh)
    block = sharded.dataset_block(inp["live_idx"].shape[1], r, n)
    t = torch.from_numpy
    out = dict(
        any=[bool(sharded.global_any(t(c[block]), group))
             for c in inp["any_cases"]],
        or_rows=sharded.global_or_rows(t(inp["rows"][r]), group).numpy(),
        max=int(sharded.global_max(torch.tensor(r * 3 % 5), group)),
    )
    cand_L = sharded.all_gather_rows(t(inp["dead_L"][block]), group)
    cand_i = sharded.all_gather_rows(t(inp["dead_i"][block]), group)
    Q = len(inp["phantom_L"])
    top_L, sel = torch.topk(torch.cat([t(inp["phantom_L"]), cand_L]), Q)
    out.update(cand_L=cand_L.numpy(), cand_i=cand_i.numpy(),
               top_L=top_L.numpy(),
               top_i=torch.cat([t(inp["phantom_i"]), cand_i])[sel].numpy())
    a = torch.tensor(inp["a"])
    out["members"] = [
        [v.numpy() for v in engine.unique_members(
            t(inp["live_idx"][:, block]), t(inp["col_mask"][block]), cap, a,
            group)]
        for cap in capacities]
    return out


@pytest.fixture(scope="module")
def collectives():
    inp = _collective_inputs()
    n_unique = len(np.unique(inp["live_idx"][:, inp["col_mask"]]))
    # no overflow; overflow on every rank's local set; overflow only of the
    # gathered union
    caps = (512, 16, n_unique - 3)
    return inp, caps, _spawn(_collectives_rank, W, inp, caps)


def _jax_mesh(shape=(W,), names=("data",)):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                names)


def _shard_map(fn, in_specs, out_specs, *args):
    import jax

    return jax.jit(jax.shard_map(fn, mesh=_jax_mesh(), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))(*args)


def test_global_any_and_or_rows_match_jax(collectives):
    from jax.sharding import PartitionSpec as P

    from massivedatans_tpu.ns import engine as jax_engine

    inp, _, outs = collectives
    want_any = [bool(_shard_map(lambda x: jax_engine._global_any(x, "data"),
                                P("data"), P(), c)) for c in inp["any_cases"]]
    assert want_any == [False, True, bool(inp["any_cases"][2].any())]
    want_rows = np.asarray(_shard_map(
        lambda x: jax_engine._global_or_rows(x, "data"), P("data"), P(),
        inp["rows"].reshape(-1)))
    for out in outs:
        assert out["any"] == want_any
        np.testing.assert_array_equal(out["or_rows"], want_rows)
        assert out["max"] == max(r * 3 % 5 for r in range(W))


def test_phantom_gather_matches_jax(collectives):
    """engine.py:786-795 of the JAX package: all-gather the dead
    candidates, then top-Q of the phantom buffer and them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    inp, _, outs = collectives

    def merge(L, i):
        cand_L = jax.lax.all_gather(L, "data").reshape(-1)
        cand_i = jax.lax.all_gather(i, "data").reshape(-1)
        top_L, sel = jax.lax.top_k(
            jnp.concatenate([jnp.asarray(inp["phantom_L"]), cand_L]),
            len(inp["phantom_L"]))
        all_i = jnp.concatenate([jnp.asarray(inp["phantom_i"]), cand_i])
        return cand_L, cand_i, top_L, all_i[sel]

    want = [np.asarray(v) for v in _shard_map(
        merge, (P("data"), P("data")), (P(), P(), P(), P()),
        inp["dead_L"], inp["dead_i"])]
    for out in outs:
        for k, w in zip(("cand_L", "cand_i", "top_L", "top_i"), want):
            np.testing.assert_array_equal(out[k], w, err_msg=k)


def test_unique_members_under_mesh_matches_jax_and_single_device(collectives):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from massivedatans_tpu.ns import engine as jax_engine

    inp, caps, outs = collectives
    a = torch.tensor(inp["a"])
    for c, cap in enumerate(caps):
        single = [v.numpy() for v in engine.unique_members(
            torch.from_numpy(inp["live_idx"]), torch.from_numpy(inp["col_mask"]),
            cap, a)]
        for out in outs:
            for got, want in zip(out["members"][c], single):
                np.testing.assert_array_equal(got, want)
        if c == 0:  # no overflow: the JAX package's set, whatever its hash
            assert int(single[2]) == 0
            key = jax.random.key(0)
            want = _shard_map(
                lambda li, cm: jax_engine.unique_members(li, cm, cap, key,
                                                         "data"),
                (P(None, "data"), P("data")), (P(), P(), P()),
                jnp.asarray(inp["live_idx"]), jnp.asarray(inp["col_mask"]))
            for got, w in zip(outs[0]["members"][c], want):
                np.testing.assert_array_equal(got, np.asarray(w))
        else:
            assert int(single[2]) == 1 and int(single[1].sum()) == cap


# --- (b) a sharded chunk against the single-device chunk ------------------------

def _chunk_rank(rank, centers, cfg, seed):
    torch.set_num_threads(1)
    mesh = sharded.make_mesh(rank.world)
    group = sharded.data_axis(mesh)[0]
    problem = make_analytic_gaussian_problem(centers, sigma=0.08)
    gen = _gen(seed)
    state = engine.init_state(problem, gen, cfg)
    state = sharded.shard_state(state, mesh)
    problem = sharded.shard_problem(problem, mesh)
    state, dead, rows = engine.run_chunk(
        problem, state, cfg, cfg.resolve_member_capacity(len(centers)), 10,
        gen, group=group)
    full = sharded.gather_state(state, mesh)
    dead = {f: sharded.all_gather_rows(getattr(dead, f), group, dim=1).numpy()
            for f in ("idx", "L", "logwidth", "running")}
    return None if full is None else (_state_arrays(full), dead, rows)


def _state_arrays(state):
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "shelves":
            out.update({f"shelves.{g.name}": getattr(v, g.name).numpy()
                        for g in dataclasses.fields(v)})
        else:
            out[f.name] = v.numpy() if torch.is_tensor(v) else v
    return out


@pytest.fixture(scope="module")
def single_chunk():
    centers = _centers()
    problem = make_analytic_gaussian_problem(centers, sigma=0.08)
    gen = _gen(0)
    state = engine.init_state(problem, gen, CFG)
    state, dead, rows = engine.run_chunk(
        problem, state, CFG, CFG.resolve_member_capacity(16), 10, gen)
    return centers, _state_arrays(state), {
        f: getattr(dead, f).numpy()
        for f in ("idx", "L", "logwidth", "running")}, rows


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_chunk_matches_single_device(single_chunk, world):
    """tests/test_parallel.py::test_sharded_chunk_matches_single_device: the
    pile is replicated and the proposals identical, so after one chunk the
    live points and evidences agree; at one rank, bit for bit."""
    centers, s_single, d_single, rows = single_chunk
    s_shard, d_shard, rows_shard = _spawn(_chunk_rank, world, centers, CFG,
                                          0)[0]
    assert rows_shard == rows
    np.testing.assert_allclose(d_shard["L"], d_single["L"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s_shard["logZ"], s_single["logZ"], rtol=1e-4,
                               atol=1e-4)
    assert int(s_shard["pile_size"]) == int(s_single["pile_size"])
    np.testing.assert_array_equal(s_shard["live_idx"], s_single["live_idx"])
    if world == 1:
        for k, v in s_single.items():
            np.testing.assert_array_equal(s_shard[k], v, err_msg=k)
        for k, v in d_single.items():
            np.testing.assert_array_equal(d_shard[k], v, err_msg=k)


# --- (c)-(e) the model axis: a (data=2, model=2) mesh ----------------------------

MP_B = 32


def _mp_rank(rank, horns, muse_in, x_horns, chunk_in):
    from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem
    from massivedatans_tpu_torch.muse.likelihood import make_muse_problem
    from massivedatans_tpu_torch.muse.model import load_template_grid

    torch.set_num_threads(1)
    mesh = sharded.make_mesh(rank.world, model_parallel=2)
    group = sharded.data_axis(mesh)[0]
    model_group = sharded.model_axis(mesh)[0]
    out = dict(model_axis=sharded.mesh_model_axis(mesh),
               data_axis_size=sharded.data_axis(mesh)[2])
    # (c) gaussline
    problem = make_gaussline_problem(horns["x"], horns["y"],
                                     horns["noise_level"])
    local = sharded.shard_problem(problem, mesh)
    L = local.loglike_sharded(torch.from_numpy(x_horns), model_group)
    out["gaussline"] = sharded.all_gather_rows(L, group, dim=1).numpy()
    # (d) MUSE
    md = load_template_grid(muse_in["tpl"], zlo=0.0, zhi=0.5)
    mp = make_muse_problem(md, muse_in["y"], muse_in["var"])
    local = sharded.shard_problem(mp, mesh)
    L = local.loglike_sharded(torch.from_numpy(muse_in["x"]), model_group)
    out["muse"] = sharded.all_gather_rows(L, group, dim=1).numpy()
    # (e) a chunk
    problem = make_gaussline_problem(chunk_in["x"], chunk_in["y"],
                                     chunk_in["noise_level"])
    gen = _gen(0)
    state = sharded.shard_state(engine.init_state(problem, gen, CFG), mesh)
    state, _, _ = engine.run_chunk(
        sharded.shard_problem(problem, mesh), state, CFG,
        CFG.resolve_member_capacity(problem.ndata), 10, gen, group=group,
        model_group=model_group)
    full = sharded.gather_state(state, mesh)
    if full is not None:
        out["chunk"] = dict(iteration=int(full.iteration),
                            logZ=full.logZ.numpy())
    return out


@pytest.fixture(scope="module")
def model_parallel(tmp_path_factory):
    from massivedatans_tpu_torch.datagen.generators import gen_horns
    from massivedatans_tpu_torch.models.gaussline import (
        gaussline_prior_transform,
    )
    from massivedatans_tpu_torch.muse import synth
    from massivedatans_tpu_torch.muse.model import (
        load_template_grid,
        muse_prior_transform,
    )

    horns = gen_horns(16, seed=5)
    u = np.random.default_rng(2).uniform(size=(MP_B, 3)).astype(np.float32)
    x_horns = gaussline_prior_transform(torch.from_numpy(u)).numpy()
    # tests/test_muse.py::test_model_parallel_likelihood_matches's inputs
    tpl = synth.make_template_files(str(tmp_path_factory.mktemp("tpl")),
                                    n_wl=400)
    rng = np.random.default_rng(4)
    md = load_template_grid(tpl, zlo=0.0, zhi=0.5)
    nspec = int(md.data_wl.shape[0])
    y = rng.normal(1.0, 0.1, size=(nspec, 8))
    var = np.full((nspec, 8), 0.01)
    y[30:60, 2] = np.nan
    var[30:60, 2] = np.nan
    u5 = rng.uniform(size=(8, 5)).astype(np.float32)
    u5[0, 2] = 0.0  # sfage = 0: a dead row
    x_muse = muse_prior_transform(md, torch.from_numpy(u5)).numpy()
    muse_in = dict(tpl=tpl, y=y, var=var, x=x_muse)
    chunk_in = gen_horns(16, seed=7)
    out = _spawn(_mp_rank, 4, horns, muse_in, x_horns, chunk_in)[0]
    return horns, x_horns, muse_in, chunk_in, out


def test_gaussline_model_parallel_likelihood_matches(model_parallel):
    """tests/test_parallel.py::test_model_parallel_likelihood_matches: the
    reduced partial contractions give the single-device likelihood and the
    JAX package's ``chi2_loglike_batch_mp`` on a (2, 2) mesh."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from massivedatans_tpu.models.gaussline import (
        make_gaussline_problem as jax_problem,
    )
    from massivedatans_tpu.parallel.sharded import (
        MODEL_AXIS, problem_pspecs, shard_problem,
    )
    from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem

    horns, x_horns, _, _, out = model_parallel
    assert out["model_axis"] == sharded.MODEL_AXIS == MODEL_AXIS
    assert out["data_axis_size"] == 2
    single = make_gaussline_problem(horns["x"], horns["y"],
                                    horns["noise_level"])
    want = single.loglike(torch.from_numpy(x_horns)).numpy()
    np.testing.assert_allclose(out["gaussline"], want, rtol=2e-5, atol=2e-4)

    import jax

    jp = jax_problem(horns["x"], horns["y"], horns["noise_level"])
    mesh = _jax_mesh((2, 2), ("data", MODEL_AXIS))
    specs = problem_pspecs(jp, mesh)
    jp_sh = shard_problem(jp, mesh)
    got_jax = jax.jit(jax.shard_map(
        lambda pr, x: pr.loglike_sharded(x, MODEL_AXIS), mesh=mesh,
        in_specs=(specs, P()), out_specs=P(None, "data"),
        check_vma=False))(jp_sh, jnp.asarray(x_horns))
    np.testing.assert_allclose(out["gaussline"], np.asarray(got_jax),
                               rtol=2e-5, atol=2e-4)


def test_muse_model_parallel_likelihood_matches(model_parallel):
    """tests/test_muse.py's model-parallel MUSE likelihood bar, on the same
    synthetic templates and spaxels: against the port's single-device
    likelihood and the JAX package's ``scaled_loglike_batch_mp``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from massivedatans_tpu.muse.likelihood import (
        make_muse_problem as jax_muse_problem,
    )
    from massivedatans_tpu.muse.model import (
        load_template_grid as jax_load_grid,
    )
    from massivedatans_tpu.parallel.sharded import (
        MODEL_AXIS, problem_pspecs, shard_problem,
    )
    from massivedatans_tpu_torch.muse.likelihood import make_muse_problem
    from massivedatans_tpu_torch.muse.model import load_template_grid

    _, _, muse_in, _, out = model_parallel
    md = load_template_grid(muse_in["tpl"], zlo=0.0, zhi=0.5)
    single = make_muse_problem(md, muse_in["y"], muse_in["var"])
    want = single.loglike(torch.from_numpy(muse_in["x"])).numpy()
    got = out["muse"]
    assert np.isneginf(want[0]).all() and np.isneginf(got[0]).all()
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4, atol=1e-3)

    jp = jax_muse_problem(jax_load_grid(muse_in["tpl"], zlo=0.0, zhi=0.5),
                          muse_in["y"], muse_in["var"])
    mesh = _jax_mesh((2, 2), ("data", MODEL_AXIS))
    specs = problem_pspecs(jp, mesh)
    jp_sh = shard_problem(jp, mesh)
    got_jax = np.asarray(jax.jit(jax.shard_map(
        lambda pr, x: pr.loglike_sharded(x, MODEL_AXIS), mesh=mesh,
        in_specs=(specs, P()), out_specs=P(None, "data"),
        check_vma=False))(jp_sh, jnp.asarray(muse_in["x"])))
    # the dead row: -inf here, -1e100 in the JAX package
    assert (got_jax[0] <= -1e30).all()
    np.testing.assert_allclose(got[1:], got_jax[1:], rtol=1e-4, atol=1e-3)


def test_model_parallel_chunk_runs(model_parallel):
    """tests/test_parallel.py::test_model_parallel_chunk_runs: a chunk on a
    (data, model) mesh tracks the single-device trajectory."""
    from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem

    _, _, _, chunk_in, out = model_parallel
    problem = make_gaussline_problem(chunk_in["x"], chunk_in["y"],
                                     chunk_in["noise_level"])
    gen = _gen(0)
    state, _, _ = engine.run_chunk(
        problem, engine.init_state(problem, gen, CFG), CFG,
        CFG.resolve_member_capacity(problem.ndata), 10, gen)
    assert out["chunk"]["iteration"] == int(state.iteration)
    np.testing.assert_allclose(out["chunk"]["logZ"], state.logZ.numpy(),
                               rtol=1e-3, atol=0.05)


# --- (f) uneven termination ------------------------------------------------------

class WideNarrowGaussian(Problem):
    """Analytic Gaussians with one width per dataset: the last ranks'
    datasets are wide and terminate many chunks before the first's."""

    name = "wide_narrow_gaussian"

    def __init__(self, centers, sigma):
        super().__init__(ndim=centers.shape[1], ndata=centers.shape[0])
        self.register_buffer("centers", centers)  # [D, ndim]
        self.register_buffer("sigma", sigma)      # [D]

    def transform_batch(self, u):
        return u

    def loglike(self, x):
        d2 = torch.square(x[:, None, :] - self.centers[None]).sum(dim=-1)
        return -0.5 * d2 / torch.square(self.sigma)[None, :]

    def shard(self, rank_data, n_data, rank_model=0, n_model=1):
        self.require_no_model_axis(n_model)
        b = sharded.dataset_block(self.ndata, rank_data, n_data)
        return WideNarrowGaussian(self.centers[b], self.sigma[b])


def _wide_narrow(D=8):
    centers = _centers(D, seed=9)
    sigma = np.where(np.arange(D) < D // 2, 0.03, 0.25)
    return centers, sigma, WideNarrowGaussian(
        torch.as_tensor(centers, dtype=torch.float32),
        torch.as_tensor(sigma, dtype=torch.float32))


def test_uneven_termination_ends_and_matches_single_device():
    centers, sigma, problem = _wide_narrow()
    cfg = dataclasses.replace(NO_COLS, chunk_iters=20, seed=2)
    single = multi_nested_integrator(problem, cfg, device="cpu",
                                     progress=False)
    sharded_run = run_sharded(problem, cfg, 2, "gloo", "cpu",
                              timeout_s=TIMEOUT_S)
    # the wide half stops well before the narrow half
    stop = [np.flatnonzero(single.mask[:single.niterations, d]).max()
            for d in range(8)]
    assert max(stop[4:]) + 2 * cfg.chunk_iters < min(stop[:4]), stop
    assert sharded_run.niterations == single.niterations
    np.testing.assert_allclose(sharded_run.logZ, single.logZ, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(sharded_run.L, single.L, rtol=1e-5, atol=1e-5)
    err = single.logZerr + np.sqrt(np.maximum(single.information, 0.0) / 50)
    truth = np.concatenate([true_logZ(centers[:4], 0.03),
                            true_logZ(centers[4:], 0.25)])
    assert (np.abs(sharded_run.logZ - truth) < 3 * err + 0.8).all()


# --- (g) full runs against the analytic evidence ---------------------------------

def test_sharded_full_run_logZ():
    """tests/test_parallel.py::test_sharded_full_run_logZ (D=16, seed 3),
    on 4 ranks."""
    centers = _centers(seed=3)
    problem = make_analytic_gaussian_problem(centers, sigma=0.08)
    result = run_sharded(problem, dataclasses.replace(CFG, seed=1), 4, "gloo",
                         "cpu", timeout_s=TIMEOUT_S)
    err = result.logZerr + np.sqrt(np.maximum(result.information, 0.0) / 50)
    assert (np.abs(result.logZ - true_logZ(centers, sigma=0.08))
            < 3 * err + 0.8).all()


@pytest.mark.slow
def test_sharded_full_run_logZ_D512():
    """tests/test_parallel.py::test_sharded_full_run_logZ_D512 on 4 ranks
    (128 datasets each), with its bars."""
    centers = _centers(512, seed=11)
    problem = make_analytic_gaussian_problem(centers, sigma=0.08)
    cfg = RunConfig(nlive_points=50, proposal_batch=256, eval_batch=64,
                    shelf_capacity=4, chunk_iters=25, max_fill_rounds=512,
                    seed=4)
    result = run_sharded(problem, cfg, 4, "gloo", "cpu", timeout_s=TIMEOUT_S)
    lz_true = true_logZ(centers, sigma=0.08)
    err = result.logZerr + np.sqrt(np.maximum(result.information, 0.0) / 50)
    resid = np.abs(result.logZ - lz_true)
    assert (resid < 3 * err + 0.8).all(), (resid.max(), np.argmax(resid))
    assert np.abs(np.median(result.logZ - lz_true)) < 0.45


# --- where the result is collected -----------------------------------------------

def _collect_rank(rank, model_parallel, horns):
    from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem

    torch.set_num_threads(1)
    mesh = sharded.make_mesh(rank.world, model_parallel)
    problem = make_gaussline_problem(horns["x"], horns["y"],
                                     horns["noise_level"])
    result = multi_nested_integrator(
        problem, dataclasses.replace(NO_COLS, nlive_points=20),
        device="cpu", max_samples=30, progress=False, mesh=mesh)
    return None if result is None else (result.logZ, result.L.shape)


@pytest.mark.parametrize("world,model_parallel", [(2, 1), (4, 2)])
def test_result_is_gathered_to_rank_zero_only(world, model_parallel):
    """Rank 0 returns every dataset in order; the other ranks hold no
    copy of the result and return None."""
    from massivedatans_tpu_torch.datagen.generators import gen_horns

    horns = gen_horns(8, seed=3)
    out = _spawn(_collect_rank, world, model_parallel, horns)
    assert all(r is None for r in out[1:])
    logZ, shape = out[0]
    assert logZ.shape == (8,) and np.isfinite(logZ).all()
    assert shape[1] == 8


# --- requests the mesh cannot serve ----------------------------------------------

def _indivisible_rank(rank):
    mesh = sharded.make_mesh(rank.world)
    problem = make_analytic_gaussian_problem(_centers(5))
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        multi_nested_integrator(problem, CFG, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        sharded.make_mesh(rank.world, model_parallel=3)
    with pytest.raises(ValueError, match="no model-parallel layout"):
        sharded.shard_problem(make_analytic_gaussian_problem(_centers(4)),
                              sharded.make_mesh(rank.world, model_parallel=2))
    return True


def test_bad_requests_raise():
    with pytest.raises(TypeError, match="DeviceMesh"):
        multi_nested_integrator(make_analytic_gaussian_problem(_centers(4)),
                                CFG, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="nccl needs device_type='cuda'"):
        spawn_ranks(_indivisible_rank, 2, "nccl", "cpu")
    assert _spawn(_indivisible_rank, 2) == [True, True]


# --- on the card (skip here) -------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_world1_nccl_fit_equals_single_device_fit_on_the_card():
    _need_card()
    from massivedatans_tpu_torch.cli import run_fit
    from massivedatans_tpu_torch.datagen.generators import gen_horns
    from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem

    d = gen_horns(64)
    cfg = RunConfig(nlive_points=100)
    single = run_fit(d["x"], d["y"], cfg, "cuda", noise_level=d["noise_level"])
    world1 = run_sharded(make_gaussline_problem(d["x"], d["y"],
                                                d["noise_level"]),
                         cfg, 1, "nccl", "cuda", timeout_s=TIMEOUT_S)
    for k in ("logZ", "logZerr", "L", "u", "w", "mask"):
        np.testing.assert_array_equal(getattr(world1, k), getattr(single, k))
    assert world1.niterations == single.niterations
    assert world1.ndraws == single.ndraws


def _card_mp_rank(rank, x_horns):
    from massivedatans_tpu_torch.config import set_fp32_precision
    from massivedatans_tpu_torch.datagen.generators import gen_horns
    from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem

    set_fp32_precision()
    mesh = sharded.make_mesh(rank.world, 2, rank.mesh_device_type)
    h = gen_horns(16, seed=5)
    problem = make_gaussline_problem(h["x"], h["y"], h["noise_level"],
                                     device=rank.device)
    local = sharded.shard_problem(problem, mesh)
    x = torch.from_numpy(x_horns).to(rank.device)
    return (local.loglike_sharded(x, sharded.model_axis(mesh)[0]).cpu().numpy(),
            problem.loglike(x).cpu().numpy())


@pytest.mark.cuda
def test_model_parallel_likelihood_on_one_card():
    """Two ranks on one card (gloo, staged through the host)."""
    _need_card()
    u = np.random.default_rng(2).uniform(size=(MP_B, 3)).astype(np.float32)
    from massivedatans_tpu_torch.models.gaussline import (
        gaussline_prior_transform,
    )

    x = gaussline_prior_transform(torch.from_numpy(u)).numpy()
    for got, want in spawn_ranks(_card_mp_rank, 2, "gloo", "cuda",
                                 TIMEOUT_S, x):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
