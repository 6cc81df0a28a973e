"""The port's queues and engine against the JAX package.

Shelves, member dedup, the remainder integral and the termination check are
deterministic and are held bitwise or to float32 tolerances on the same
numpy inputs. One whole ``ns_iteration`` is held against JAX on a state
whose shelves are already filled, so that no random fill round runs.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from massivedatans_tpu.config import RunConfig
from massivedatans_tpu.models.analytic import make_analytic_gaussian_problem
from massivedatans_tpu.ns import engine as jax_engine
from massivedatans_tpu.ns import shelves as jax_shelves
from massivedatans_tpu_torch.config import RunConfig as PortRunConfig
from massivedatans_tpu_torch.convert import problem_from_numpy, state_from_numpy
from massivedatans_tpu_torch.ns import engine, shelves
from massivedatans_tpu_torch.ns.integrator import compact_pile, fetch

torch.set_num_threads(1)

RTOL = 2e-6  # XLA vs torch transcendentals (exp, log1p, logaddexp) in f32


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(t, a):
    assert np.array_equal(t.numpy(), np.asarray(a)), (t, a)


def _same_shelves(t, j):
    _same(t.idx, j.idx)
    _same(t.L, j.L)
    _same(t.count, j.count)


def _pair_shelves(idx, L, count):
    return (shelves.Shelves(idx=_t(idx), L=_t(L), count=_t(count)),
            jax_shelves.Shelves(idx=jnp.asarray(idx), L=jnp.asarray(L),
                                count=jnp.asarray(count)))


def test_insertion_thresholds_bitwise():
    rng = np.random.default_rng(0)
    K, S, D = 20, 6, 30
    live_L = rng.normal(size=(K, D)).astype(np.float32)
    counts = rng.integers(0, S + 1, size=D).astype(np.int32)
    L = np.full((S, D), -np.inf, np.float32)
    for d in range(D):
        L[:counts[d], d] = rng.normal(size=counts[d])
    idx = np.full((S, D), -1, np.int32)
    ts, js = _pair_shelves(idx, L, counts)
    t_bot = shelves.live_bottom(_t(live_L), S)
    j_bot = jax_shelves.live_bottom(jnp.asarray(live_L), S)
    _same(t_bot, j_bot)
    _same(shelves.insertion_thresholds(t_bot, ts),
          jax_shelves.insertion_thresholds(j_bot, js))


def test_append_clean_pop_bitwise():
    S, D, B = 4, 5, 6
    ts = shelves.init_shelves(S, D, "cpu")
    js = jax_shelves.init_shelves(S, D)
    cand_idx = np.arange(100, 100 + B, dtype=np.int32)
    cand_L = np.arange(B * D, dtype=np.float32).reshape(B, D)
    accept = np.zeros((B, D), bool)
    accept[[0, 2, 4], 0] = True
    accept[1, 1] = True
    accept[:, 2] = True  # overflow: B > S
    ts = shelves.append_batch(ts, _t(cand_idx), _t(cand_L), _t(accept))
    js = jax_shelves.append_batch(js, jnp.asarray(cand_idx), jnp.asarray(cand_L),
                                  jnp.asarray(accept))
    _same_shelves(ts, js)
    assert list(ts.count.numpy()) == [3, 1, S, 0, 0]
    Lmins = np.array([5.0, -1e30, 10.0, 0.0, 0.0], np.float32)
    ts = shelves.clean(ts, _t(Lmins))
    js = jax_shelves.clean(js, jnp.asarray(Lmins))
    _same_shelves(ts, js)
    active = np.array([True, True, False, True, True])
    t_head, t_L, ts = shelves.pop(ts, _t(active))
    j_head, j_L, js = jax_shelves.pop(js, jnp.asarray(active))
    _same(t_head, j_head)
    _same(t_L, j_L)
    _same_shelves(ts, js)


def test_append_respects_capacity_bitwise():
    rng = np.random.default_rng(1)
    S, D, B = 3, 8, 10
    accept = rng.random((B, D)) < 0.5
    cand_L = rng.normal(size=(B, D)).astype(np.float32)
    cand_idx = np.arange(B, dtype=np.int32)
    ts = shelves.append_batch(shelves.init_shelves(S, D, "cpu"), _t(cand_idx),
                              _t(cand_L), _t(accept))
    js = jax_shelves.append_batch(jax_shelves.init_shelves(S, D),
                                  jnp.asarray(cand_idx), jnp.asarray(cand_L),
                                  jnp.asarray(accept))
    _same_shelves(ts, js)


def test_unique_members_bitwise_without_overflow():
    rng = np.random.default_rng(2)
    K, D, cap = 40, 25, 512
    live_idx = rng.integers(0, 300, size=(K, D)).astype(np.int32)
    col_mask = rng.random(D) < 0.6
    got = engine.unique_members(_t(live_idx), _t(col_mask), cap,
                                torch.Generator().manual_seed(0))
    want = jax_engine.unique_members(jnp.asarray(live_idx),
                                     jnp.asarray(col_mask), cap,
                                     jax.random.key(0))
    for g, w in zip(got, want):
        _same(g, w)
    n = len(np.unique(live_idx[:, col_mask]))
    assert int(got[1].sum()) == n and int(got[2]) == 0


def test_unique_members_overflow_keeps_random_subset():
    rng = np.random.default_rng(3)
    live_idx = rng.integers(0, 5000, size=(50, 40)).astype(np.int32)
    universe = set(np.unique(live_idx).tolist())
    cap = 256
    kept = []
    for seed in range(2):
        idx, mask, ovf = engine.unique_members(
            _t(live_idx), torch.ones(40, dtype=torch.bool), cap,
            torch.Generator().manual_seed(seed))
        vals = idx.numpy()[mask.numpy()]
        assert int(ovf) == 1 and len(vals) == cap
        assert np.all(np.diff(vals) > 0) and set(vals.tolist()) <= universe
        kept.append(set(vals.tolist()))
    assert kept[0] != kept[1]  # the subset depends on the draw


def _ledger_inputs(seed=4, K=50, D=12):
    rng = np.random.default_rng(seed)
    live_L = rng.normal(-20.0, 4.0, size=(K, D)).astype(np.float32)
    logZ = rng.normal(-25.0, 2.0, size=D).astype(np.float32)
    logZ[0] = -np.inf  # nothing integrated yet
    H = rng.uniform(0.0, 5.0, size=D).astype(np.float32)
    logwidth = rng.uniform(-6.0, -3.0, size=D).astype(np.float32)
    return live_L, logZ, H, logwidth, live_L.max(axis=0)


def test_remainder_core_matches_jax():
    args = _ledger_inputs()
    K = args[0].shape[0]
    want = jax_engine.remainder_core(*map(jnp.asarray, args), K)
    got = engine.remainder_core(*map(_t, args), K)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


@pytest.fixture(scope="module")
def jax_setup():
    rng = np.random.default_rng(5)
    D, ndim = 10, 2
    centers = rng.uniform(0.3, 0.7, size=(D, ndim))
    cfg = RunConfig(nlive_points=60, proposal_batch=128, eval_batch=32,
                    shelf_capacity=4, chunk_iters=10, pile_capacity=4096)
    problem = make_analytic_gaussian_problem(centers, sigma=0.05)
    state = jax_engine.init_state(problem, jax.random.key(1), cfg)
    return centers, cfg, problem, state


def _port(cfg):
    """The port's RunConfig with the fields of a JAX package RunConfig."""
    return PortRunConfig(**dataclasses.asdict(cfg))


def _state_fields(st):
    fields = {k: np.asarray(v) for k, v in st._asdict().items()
              if k not in ("key", "shelves")}
    fields["shelves"] = {k: np.asarray(v) for k, v in st.shelves._asdict().items()}
    return fields


@pytest.mark.parametrize("mode", ["tolerance", "max_samples"])
def test_device_termination_matches_jax(jax_setup, mode):
    _, cfg, _, st = jax_setup
    live_L, logZ, H, logwidth, Lmax = _ledger_inputs(K=60, D=10)
    st = st._replace(live_L=jnp.asarray(live_L), logZ=jnp.asarray(logZ),
                     H=jnp.asarray(H), logwidth=jnp.asarray(logwidth),
                     Lmax=jnp.asarray(Lmax), iteration=jnp.int32(50))
    totalZerr = np.asarray(jax_engine.remainder_core(
        st.live_L, st.logZ, st.H, st.logwidth, st.Lmax, 60)[3])
    if mode == "tolerance":  # half the datasets pass the check
        cfg = dataclasses.replace(cfg, tolerance=float(np.median(totalZerr)))
    else:
        cfg = dataclasses.replace(cfg, max_samples=40)
    want = jax_engine.device_termination(st, cfg, 60)
    got = engine.device_termination(state_from_numpy(_state_fields(st)),
                                    _port(cfg), 60)
    _same(got.running, want.running)
    _same(got.term_iter, want.term_iter)
    assert 0 < int(want.running.sum()) < 10 or mode == "max_samples"
    np.testing.assert_allclose(got.rem_logZ.numpy(), np.asarray(want.rem_logZ),
                               rtol=RTOL)
    np.testing.assert_allclose(got.rem_logZerr.numpy(),
                               np.asarray(want.rem_logZerr), rtol=RTOL)


def _prefilled_state(jax_setup, start_iter):
    """A JAX state in which every running dataset already has shelf entries
    above its Lmin (the datasets' own centres), so the fill loop runs no
    round in either package and the iteration is deterministic."""
    centers, cfg, problem, st = jax_setup
    K, D = cfg.nlive_points, centers.shape[0]
    c = jnp.asarray(centers, jnp.float32)
    Lc = np.asarray(problem.loglike(c))        # [D, D]
    pile_u = st.pile_u.at[K:K + D].set(c).at[K + D:K + 2 * D].set(c * 0.99 + 0.005)
    pile_x = st.pile_x.at[K:K + D].set(c).at[K + D:K + 2 * D].set(c * 0.99 + 0.005)
    L2 = np.asarray(problem.loglike(c * 0.99 + 0.005))
    S = cfg.shelf_capacity
    idx = np.full((S, D), -1, np.int32)
    L = np.full((S, D), -np.inf, np.float32)
    count = np.zeros(D, np.int32)
    running = np.ones(D, bool)
    running[[3, 7]] = False  # finished datasets keep their state
    for d in range(D):
        if running[d]:
            idx[0, d], L[0, d] = K + d, Lc[d, d]
            count[d] = 1
            if d % 2 == 0:
                idx[1, d], L[1, d] = K + D + d, L2[d, d]
                count[d] = 2
    return st._replace(
        pile_u=pile_u, pile_x=pile_x, pile_size=jnp.int32(K + 2 * D),
        shelves=jax_shelves.Shelves(idx=jnp.asarray(idx), L=jnp.asarray(L),
                                    count=jnp.asarray(count)),
        running=jnp.asarray(running), iteration=jnp.int32(start_iter),
    ), dataclasses.replace(cfg, tolerance=1e9)


@pytest.mark.parametrize("start_iter", [0, 49])
def test_ns_iteration_deterministic_step_matches_jax(jax_setup, start_iter):
    st, cfg = _prefilled_state(jax_setup, start_iter)
    problem = jax_setup[2]
    member_capacity = cfg.resolve_member_capacity(problem.ndata)
    (want, _, _), wdead = jax_engine.ns_iteration(problem, st, cfg,
                                                  member_capacity)
    tp = problem_from_numpy({k: np.asarray(v) for k, v in
                             problem.data.__dict__.items()}, "analytic_gaussian")
    (got, _, _), gdead = engine.ns_iteration(
        tp, state_from_numpy(_state_fields(st)), _port(cfg), member_capacity,
        torch.Generator().manual_seed(0))
    assert int(got.fill_rounds) == int(want.fill_rounds) == 0
    for name in ("live_idx", "live_L", "running", "term_iter", "iteration",
                 "stall_count", "pile_size", "Lmax"):
        _same(getattr(got, name), getattr(want, name))
    _same_shelves(got.shelves, want.shelves)
    _same(gdead.idx, wdead.idx)
    _same(gdead.L, wdead.L)
    _same(gdead.running, wdead.running)
    for name in ("logZ", "H", "logwidth", "logVolremaining", "last_logwidth",
                 "rem_logZ", "rem_logZerr"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=RTOL, err_msg=name)
    if start_iter == 49:  # the check at iteration 50 terminated everything
        assert not got.running.any()


def test_column_proposals_fill_only_empty_columns(jax_setup):
    _, cfg, problem, st = jax_setup
    K, D = cfg.nlive_points, problem.ndata
    rng = np.random.default_rng(6)
    pile_u = torch.from_numpy(rng.uniform(size=(500, 2)).astype(np.float32))
    live_idx = torch.from_numpy(rng.integers(0, 500, size=(K, D)).astype(np.int32))
    empty = torch.zeros(D, dtype=torch.bool)
    empty[[1, 4]] = True
    u, ok, cols = engine._column_proposals(pile_u, live_idx, empty,
                                           torch.Generator().manual_seed(1), 256)
    assert u.shape == (256, 2) and ok.shape == (256,) and cols.shape == (256,)
    assert set(cols.tolist()) <= {1, 4}
    assert int(ok.sum()) > 0
    assert ((u[ok] > 0) & (u[ok] < 1)).all()
    _, ok_none, _ = engine._column_proposals(
        pile_u, live_idx, torch.zeros(D, dtype=torch.bool),
        torch.Generator().manual_seed(1), 64)
    assert not ok_none.any()


def test_compact_pile_keeps_referenced_points(jax_setup):
    tp = problem_from_numpy({k: np.asarray(v) for k, v in
                             jax_setup[2].data.__dict__.items()},
                            "analytic_gaussian")
    cfg = dataclasses.replace(_port(jax_setup[1]), pile_capacity=2048)
    st = engine.init_state(tp, torch.Generator().manual_seed(2), cfg)
    # move the live points to scattered pile rows
    K, D = st.live_idx.shape
    rows = torch.randperm(1024, generator=torch.Generator().manual_seed(3))[:K]
    st.pile_u[rows] = st.pile_u[:K].clone()
    st = st.replace(live_idx=rows[:, None].expand(K, D).to(torch.int32).contiguous(),
                    pile_size=torch.tensor(1024, dtype=torch.int32))
    before = st.pile_u[st.live_idx.long()].clone()
    out = compact_pile(st)
    assert int(out.pile_size) == K
    assert torch.equal(out.pile_u[out.live_idx.long()], before)


def test_fetch_roundtrips_dtypes():
    ts = [torch.tensor([1, -1], dtype=torch.int32),
          torch.tensor([0.1, -np.inf], dtype=torch.float32),
          torch.tensor([True, False]), torch.tensor(2 ** 40, dtype=torch.int64)]
    for t, a in zip(ts, fetch(ts)):
        assert a.dtype == t.numpy().dtype
        assert np.array_equal(a, t.numpy())
