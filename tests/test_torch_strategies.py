"""The port's stateful strategies, ellipsoids and bimodal oracle against
the JAX package.

Deterministic parts are fed the same numpy inputs in both packages and are
held bitwise or to float32 tolerances: the k-means start members are the
JAX draw, fed to both; the slice and walk updates get the same chain
states. Random draws differ between the packages' generators, so the
random parts are held by their invariants (unit directions, points inside
the union).
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from massivedatans_tpu.config import RunConfig as JaxRunConfig
from massivedatans_tpu.models import analytic as jax_analytic
from massivedatans_tpu.ns import ellipsoids as jax_ell
from massivedatans_tpu.ns import strategies as jax_strategies
from massivedatans_tpu_torch.config import RunConfig
from massivedatans_tpu_torch.models import analytic
from massivedatans_tpu_torch.ns import ellipsoids as ell
from massivedatans_tpu_torch.ns import strategies

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 16  # chains (eval_batch) in the unit tests


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(t, a):
    assert np.array_equal(t.numpy(), np.asarray(a)), (t, a)


def _close(t, a, rtol=1e-6, atol=0.0, name=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=rtol, atol=atol,
                               err_msg=name)


def _blobs(ndim, seed=0, n=60, pad=8):
    """Two separated blobs, plus padded rows of junk that the mask hides."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0.25, 0.03, size=(n, ndim))
    b = rng.normal(0.75, 0.05, size=(n, ndim))
    w = np.vstack([a, b, np.full((pad, ndim), 7.0)]).astype(np.float32)
    mask = np.arange(len(w)) < 2 * n
    return w, mask


def _jax_init(mask, key, E=4):
    """The k-means start members that the JAX fit draws from ``key``."""
    return np.asarray(jax.random.categorical(
        key, jnp.where(jnp.asarray(mask), 0.0, -1e30), shape=(E,)))


# --- ellipsoids ------------------------------------------------------------

@pytest.mark.parametrize("ndim", [2, 5])
def test_kmeans_assignments_match_jax(ndim):
    w, mask = _blobs(ndim)
    key = jax.random.key(3)
    want = jax_ell._kmeans_assign(jnp.asarray(w), jnp.asarray(mask), key, 4)
    got = ell._kmeans_assign(_t(w), _t(mask), None, 4,
                             init_idx=_t(_jax_init(mask, key)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ndim", [2, 5])
def test_fit_ellipsoids_matches_jax(ndim):
    w, mask = _blobs(ndim, seed=ndim)
    key = jax.random.key(0)
    want = jax_ell.fit_ellipsoids(jnp.asarray(w), jnp.asarray(mask), key,
                                  n_ellipsoids=ell.N_ELLIPSOIDS,
                                  enlarge=ell.ENLARGE)
    got = ell.fit_ellipsoids(_t(w), _t(mask), None,
                             init_idx=_t(_jax_init(mask, key)))
    _same(got.valid, want.valid)
    for name in ("mean", "cov_chol", "inv_chol", "log_vol"):
        _close(getattr(got, name), getattr(want, name), rtol=1e-4, atol=1e-6,
               name=name)
    # every member lies in at least one ellipsoid
    assert (ell.count_containing(got, _t(w[mask])) >= 1).all()


def _to_port(ells):
    return ell.Ellipsoids(**{f.name: _t(getattr(ells, f.name))
                             for f in dataclasses.fields(ell.Ellipsoids)})


@pytest.mark.parametrize("ndim", [2, 5])
def test_count_containing_matches_jax(ndim):
    w, mask = _blobs(ndim, seed=10 + ndim)
    ells = jax_ell.fit_ellipsoids(jnp.asarray(w), jnp.asarray(mask),
                                  jax.random.key(1), n_ellipsoids=4)
    rng = np.random.default_rng(ndim)
    pts = np.vstack([rng.uniform(size=(400, ndim)), w[mask]]).astype(np.float32)
    want = np.asarray(jax_ell.count_containing(ells, jnp.asarray(pts)))
    got = ell.count_containing(_to_port(ells), _t(pts)).numpy()
    assert got.dtype == np.int32
    # Mahalanobis^2 in float64: points on a boundary may go either way
    mean = np.asarray(ells.mean, np.float64)
    inv = np.asarray(ells.inv_chol, np.float64)
    z = np.einsum("eij,enj->eni", inv, pts[None] - mean[:, None])
    m2 = np.square(z).sum(axis=2)
    clear = (np.abs(m2 - 1.0) > 1e-4).all(axis=0)
    assert clear.sum() > 0.9 * len(pts)
    np.testing.assert_array_equal(got[clear], want[clear])
    assert want.max() >= 1 and want.min() == 0


@pytest.mark.parametrize("ndim", [2, 3, 5])
def test_sample_ellipsoids_stays_in_union(ndim):
    rng = np.random.default_rng(1)
    w = rng.uniform(0.3, 0.7, size=(100, ndim)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    ells = ell.fit_ellipsoids(_t(w), torch.ones(100, dtype=torch.bool), gen)
    u, ok = ell.sample_ellipsoids(ells, gen, 512)
    assert u.shape == (512, ndim) and ok.dtype == torch.bool
    assert int(ok.sum()) > 50
    assert (ell.count_containing(ells, u[ok]) >= 1).all()


def test_failed_cholesky_is_nan_not_an_error():
    a = torch.tensor([[[1.0, 0.0], [0.0, 1.0]], [[1.0, 2.0], [2.0, 1.0]]])
    chol = ell._cholesky_or_nan(a)
    assert torch.equal(chol[0], torch.eye(2))
    assert torch.isnan(chol[1]).all()


# --- slice sampling --------------------------------------------------------

def _directions(rng, n, ndim):
    d = rng.normal(size=(n, ndim)).astype(np.float32)
    d[::5, 0] = 0.0      # a zero component (the eps guard)
    d[1::7, -1] = 3e-13  # a tiny one
    return d


def test_cube_bracket_bitwise():
    rng = np.random.default_rng(2)
    u = rng.uniform(size=(200, 3)).astype(np.float32)
    d = _directions(rng, 200, 3)
    for g, w in zip(strategies._cube_bracket(_t(u), _t(d)),
                    jax_strategies._cube_bracket(jnp.asarray(u), jnp.asarray(d))):
        _same(g, w)


def _chains(seed, ndim=3, n=C):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.2, 0.8, size=(n, ndim)).astype(np.float32)
    d = _directions(rng, n, ndim)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lo = -rng.uniform(0.0, 0.3, size=n).astype(np.float32)
    hi = rng.uniform(0.0, 0.3, size=n).astype(np.float32)
    hi[::4] = lo[::4] + 1e-10  # collapsed intervals
    t = rng.uniform(-0.3, 0.3, size=n).astype(np.float32)
    t[3] = 0.0
    return dict(u=u, direction=d, lo=lo, hi=hi, t=t,
                steps=rng.integers(0, 5 * ndim + 8, size=n).astype(np.int32),
                axis=rng.integers(0, ndim, size=n).astype(np.int32))


def _pair_slice(fields):
    return (strategies.SliceChains(**{k: _t(v) for k, v in fields.items()}),
            jax_strategies.SliceChains(**{k: jnp.asarray(v)
                                          for k, v in fields.items()}))


def _same_fields(got, want, names):
    for name in names:
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name


def test_slice_observe_bitwise():
    fields = _chains(4)
    rng = np.random.default_rng(5)
    cand = rng.uniform(size=fields["u"].shape).astype(np.float32)
    accept = rng.uniform(size=C) < 0.5
    cfg = RunConfig(eval_batch=C, constrainer="SLICE")
    ts, js = _pair_slice(fields)
    got = strategies.make_slice(cfg).observe(ts, _t(cand), _t(accept))
    want = jax_strategies.make_slice(
        JaxRunConfig(**dataclasses.asdict(cfg))).observe(
        js, jnp.asarray(cand), jnp.asarray(accept))
    _same_fields(got, want, ("u", "direction", "lo", "hi", "t", "steps", "axis"))
    assert got.steps.dtype == torch.int32


def _members(seed, ndim=3, M=64):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.3, 0.6, size=(M, ndim)).astype(np.float32)
    u[:, 0] = 0.45 + 0.2 * (u[:, 0] - 0.45)  # unequal axes
    mask = np.arange(M) < M - 5
    return u, mask


def _geoms(strategy_t, strategy_j, seed=6, ndim=3):
    mu, mask = _members(seed, ndim)
    zs = np.zeros(ndim, np.float32)
    tg = strategy_t.build(_t(mu), _t(mask), torch.Generator().manual_seed(0),
                          _t(zs), torch.tensor(0.0))
    jg = strategy_j.build(jnp.asarray(mu), jnp.asarray(mask), jax.random.key(0),
                          jnp.asarray(zs), jnp.float32(0.0))
    return tg, jg


def test_slice_build_matches_jax():
    cfg = RunConfig(eval_batch=C, constrainer="SLICE")
    tg, jg = _geoms(strategies.make_slice(cfg), jax_strategies.make_slice(
        JaxRunConfig(**dataclasses.asdict(cfg))))
    _same(tg.metric.scale, jg.metric.scale)
    _close(tg.metric.mean, jg.metric.mean, rtol=1e-6)
    _close(tg.chol, jg.chol, rtol=1e-5, atol=1e-7)


def test_slice_refresh_iterate_matches_jax():
    """Iterate directions draw nothing; no chain is due for a restart, so
    the update is deterministic in both packages."""
    cfg = RunConfig(eval_batch=C, constrainer="SLICE", slice_direction="iterate")
    ts_, js_ = (strategies.make_slice(cfg),
                jax_strategies.make_slice(JaxRunConfig(**dataclasses.asdict(cfg))))
    tg, jg = _geoms(ts_, js_)
    fields = _chains(7)
    accept = np.random.default_rng(8).uniform(size=C) < 0.5
    ts, js = _pair_slice(fields)
    got = ts_.refresh(tg, ts, torch.Generator().manual_seed(1), _t(accept))
    want = js_.refresh(jg, js, jax.random.key(1), jnp.asarray(accept))
    _same_fields(got, want, ("u", "steps", "axis", "t"))
    for name in ("direction", "lo", "hi"):
        _close(getattr(got, name), getattr(want, name), rtol=1e-6, atol=1e-7,
               name=name)
    collapsed = fields["hi"] - fields["lo"] < 1e-9
    assert (accept | collapsed).any() and not (accept | collapsed).all()


@pytest.mark.parametrize("direction", ["random", "mahalanobis", "iterate"])
def test_slice_directions_have_unit_norm(direction):
    cfg = RunConfig(eval_batch=C, constrainer="SLICE", slice_direction=direction)
    s = strategies.make_slice(cfg)
    mu, mask = _members(9)
    gen = torch.Generator().manual_seed(2)
    geom = s.build(_t(mu), _t(mask), gen, None, None)
    st = s.init_chains(geom, gen)
    for _ in range(3):
        np.testing.assert_allclose(
            torch.linalg.vector_norm(st.direction, dim=1).numpy(), 1.0,
            rtol=1e-6)
        cand, valid, st = s.propose(geom, st, gen)
        assert cand.shape == (C, 3) and not valid.any()  # burn-in
        assert ((cand > 0) & (cand < 1)).all()
        st = s.observe(st, cand, torch.ones(C, dtype=torch.bool))
        st = s.refresh(geom, st, gen, torch.ones(C, dtype=torch.bool))
    assert (st.steps == 3).all()
    # chains start at valid members
    st0 = s.init_chains(geom, gen)
    rows = (st0.u[:, None, :] == _t(mu)[None, :, :]).all(dim=2)
    assert (rows & _t(mask)[None, :]).any(dim=1).all()


# --- Galilean walk ---------------------------------------------------------

def test_reflect_cube_bitwise():
    rng = np.random.default_rng(10)
    u = np.concatenate([rng.uniform(-3.0, 3.0, size=500),
                        [-2.0, -1.0, -1e-9, 0.0, 1.0, 2.0, 2.5, 4.0]])
    u = u.astype(np.float32).reshape(-1, 2)
    _same(strategies._reflect_cube(_t(u)),
          jax_strategies._reflect_cube(jnp.asarray(u)))
    assert (u < 0).any() and (u > 2).any()


def _walk(seed, ndim=3, n=C):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, ndim)).astype(np.float32)
    return dict(
        u=rng.uniform(0.2, 0.8, size=(n, ndim)).astype(np.float32),
        v=v / np.linalg.norm(v, axis=1, keepdims=True),
        eps=np.concatenate([[1e-6, 0.5, 0.45], rng.uniform(1e-5, 0.3, n - 3)]
                           ).astype(np.float32),
        steps=rng.integers(0, 2 * ndim + 8, size=n).astype(np.int32),
        rejects=(np.arange(n) % 3).astype(np.int32))


def _pair_walk(fields):
    return (strategies.WalkChains(**{k: _t(v) for k, v in fields.items()}),
            jax_strategies.WalkChains(**{k: jnp.asarray(v)
                                         for k, v in fields.items()}))


def test_galilean_observe_bitwise():
    fields = _walk(11)
    rng = np.random.default_rng(12)
    cand = rng.uniform(size=fields["u"].shape).astype(np.float32)
    accept = rng.uniform(size=C) < 0.5
    cfg = RunConfig(eval_batch=C, constrainer="GALILEAN")
    tw, jw = _pair_walk(fields)
    got = strategies.make_galilean(cfg).observe(tw, _t(cand), _t(accept))
    want = jax_strategies.make_galilean(
        JaxRunConfig(**dataclasses.asdict(cfg))).observe(
        jw, jnp.asarray(cand), jnp.asarray(accept))
    _same_fields(got, want, ("u", "v", "eps", "steps", "rejects"))


def test_galilean_refresh_matches_jax():
    """Rejects in {0, 1, 2} and no restart: chains with fewer than two
    rejections keep or reverse their velocity, as in JAX; the others draw a
    new one (a different draw in each package), of unit metric norm."""
    cfg = RunConfig(eval_batch=C, constrainer="GALILEAN")
    tw_, jw_ = (strategies.make_galilean(cfg), jax_strategies.make_galilean(
        JaxRunConfig(**dataclasses.asdict(cfg))))
    tg, jg = _geoms(tw_, jw_, seed=13)
    fields = _walk(14)
    accept = np.random.default_rng(15).uniform(size=C) < 0.5
    tw, jw = _pair_walk(fields)
    got = tw_.refresh(tg, tw, torch.Generator().manual_seed(1), _t(accept))
    want = jw_.refresh(jg, jw, jax.random.key(1), jnp.asarray(accept))
    _same_fields(got, want, ("u", "eps", "steps", "rejects"))
    kept = fields["rejects"] < 2
    _close(got.v[kept], np.asarray(want.v)[kept], rtol=1e-6)
    np.testing.assert_array_equal(got.v[fields["rejects"] == 1].numpy(),
                                  -fields["v"][fields["rejects"] == 1])
    new_v = got.v[~kept]
    np.testing.assert_allclose(torch.linalg.vector_norm(new_v, dim=1).numpy(),
                               1.0, rtol=1e-6)


def test_galilean_init_and_restart():
    cfg = RunConfig(eval_batch=C, constrainer="GALILEAN")
    s = strategies.make_galilean(cfg)
    mu, mask = _members(16)
    gen = torch.Generator().manual_seed(3)
    geom = s.build(_t(mu), _t(mask), gen, None, None)
    st = s.init_chains(geom, gen)
    eps0 = 0.5 * np.linalg.norm(geom.metric.scale.numpy()) / np.sqrt(3.0)
    np.testing.assert_allclose(st.eps.numpy(), eps0, rtol=1e-6)
    # the initial step is the JAX package's to the bit (a true division)
    jw_ = jax_strategies.make_galilean(JaxRunConfig(**dataclasses.asdict(cfg)))
    jg = jw_.build(jnp.asarray(mu), jnp.asarray(mask), jax.random.key(0),
                   None, None)
    _same(st.eps, jw_.init_chains(jg, jax.random.key(1)).eps)
    assert st.eps.shape == (C,) and st.steps.dtype == torch.int32
    st = st.replace(steps=torch.full((C,), 2 * 3 + 8, dtype=torch.int32))
    st = s.refresh(geom, st, gen, torch.zeros(C, dtype=torch.bool))
    assert (st.steps == 0).all() and (st.rejects == 0).all()
    rows = (st.u[:, None, :] == _t(mu)[None, :, :]).all(dim=2)
    assert (rows & _t(mask)[None, :]).any(dim=1).all()


# --- strategy protocol ------------------------------------------------------

@pytest.mark.parametrize("name", ["MLFRIENDS", "RADFRIENDS", "SUPFRIENDS",
                                  "MULTIELLIPSOIDS"])
def test_stateless_strategies_draw_nothing_between_proposals(name):
    """init_chains, observe and refresh are no-ops that leave the
    generator untouched, so a friends trajectory is what it was before
    the protocol carried state."""
    s = strategies.make_strategy(RunConfig(constrainer=name, eval_batch=C))
    mu, mask = _members(17)
    gen = torch.Generator().manual_seed(4)
    geom = s.build(_t(mu), _t(mask), gen, torch.zeros(3), torch.tensor(0.0))
    before = gen.get_state()
    st = s.init_chains(geom, gen)
    assert st == ()
    accept = torch.ones(C, dtype=torch.bool)
    assert s.refresh(geom, s.observe(st, torch.zeros(C, 3), accept), gen,
                     accept) == ()
    assert torch.equal(gen.get_state(), before)
    cand, valid, st2 = s.propose(geom, st, gen)
    assert cand.shape == (C, 3) and valid.shape == (C,) and st2 == ()


@pytest.mark.parametrize("name, kind", [
    ("MLFRIENDS", "Region"), ("RADFRIENDS", "Region"), ("SUPFRIENDS", "Region"),
    ("MULTIELLIPSOIDS", "EllGeom"), ("SLICE", "SliceGeom"),
    ("GALILEAN", "WalkGeom"), ("mcmc", "WalkGeom")])
def test_make_strategy_resolves_every_name(name, kind):
    s = strategies.make_strategy(RunConfig(constrainer=name, eval_batch=C))
    mu, mask = _members(18)
    geom = s.build(_t(mu), _t(mask), torch.Generator().manual_seed(0),
                   torch.zeros(3), torch.tensor(0.0))
    assert type(geom).__name__ == kind


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="slice_direction"):
        strategies.make_slice(RunConfig(slice_direction="bogus"))
    with pytest.raises(ValueError, match="slice_direction"):
        strategies.make_strategy(RunConfig(constrainer="SLICE",
                                           slice_direction="diagonal"))
    with pytest.raises(ValueError, match="constrainer"):
        strategies.make_strategy(RunConfig(constrainer="NESTLE"))
    strategies.make_strategy(RunConfig(constrainer="SLICE",
                                       slice_direction="Mahalanobis"))


def test_feedback_functions_read_nothing_back():
    """observe, refresh and the ellipsoid fit run inside the fill loop: no
    host read of a device tensor, and no raising Cholesky."""
    for mod in ("strategies.py", "ellipsoids.py"):
        with open(os.path.join(ROOT, "massivedatans_tpu_torch", "ns", mod)) as fh:
            src = fh.read()
        for bad in (".item(", ".cpu(", ".tolist(", ".numpy(", "bool(",
                    "linalg.cholesky("):
            assert bad not in src, (mod, bad)


# --- bimodal oracle ----------------------------------------------------------

def test_bimodal_loglike_matches_jax():
    rng = np.random.default_rng(19)
    D, ndim = 6, 3
    ca = rng.uniform(0.15, 0.3, size=(D, ndim))
    cb = rng.uniform(0.7, 0.85, size=(D, ndim))
    x = rng.uniform(size=(200, ndim)).astype(np.float32)
    jp = jax_analytic.make_analytic_bimodal_problem(ca, cb, sigma=0.04)
    tp = analytic.make_analytic_bimodal_problem(ca, cb, sigma=0.04)
    want = np.asarray(jp.loglike(jnp.asarray(x)))
    got = tp.loglike(tp.transform_batch(_t(x))).numpy()
    assert got.shape == (200, D) and got.dtype == np.float32
    assert (np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want))).all()
    np.testing.assert_allclose(analytic.true_logZ_bimodal(ca, cb, 0.04),
                               jax_analytic.true_logZ_bimodal(ca, cb, 0.04),
                               rtol=1e-12)
    from massivedatans_tpu_torch.convert import problem_from_numpy

    conv = problem_from_numpy({k: np.asarray(v) for k, v in
                               jp.data.__dict__.items()}, "analytic_bimodal")
    assert torch.equal(conv.loglike(_t(x)), tp.loglike(_t(x)))
