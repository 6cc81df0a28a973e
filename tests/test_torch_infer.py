"""The port's gradient backends (``infer/``) against the JAX package's.

Both packages get the same inputs, made from seeds with numpy (the
problems from the same arrays), on the CPU. The deterministic parts are
held to float32 tolerances: the bijection, the paired likelihoods, the
gradients of the log posterior, the leapfrog integrator and the ELBO
integrand. The random parts are held twice: on the JAX package's own
draws (its key schedule replayed here and fed to the port's loops, so
whole runs can be compared), and by the distributional bars of
``tests/test_infer.py`` on the port's own generator.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from massivedatans_tpu.datagen.generators import gen_horns
from massivedatans_tpu.infer import hmc as jax_hmc
from massivedatans_tpu.infer import transforms as jax_tf
from massivedatans_tpu.infer import vi as jax_vi
from massivedatans_tpu.models.analytic import (
    make_analytic_gaussian_problem as jax_analytic,
)
from massivedatans_tpu.models.gaussline import make_gaussline_problem as jax_gaussline
from massivedatans_tpu.muse import likelihood as jax_lik
from massivedatans_tpu.muse import model as jax_model
from massivedatans_tpu.muse import synth as jax_synth
from massivedatans_tpu_torch.infer import hmc, transforms, vi
from massivedatans_tpu_torch.infer import run_hmc, run_vi
from massivedatans_tpu_torch.models.analytic import (
    make_analytic_gaussian_problem,
    true_logZ,
)
from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem
from massivedatans_tpu_torch.muse import likelihood, model

torch.set_num_threads(1)

SIGMA = 0.05
NSPEC, CD3 = 300, 15.0          # the MUSE data grid of tests/test_torch_muse.py
WL_NM = (4750.0 + CD3 * np.arange(NSPEC)) / 10.0


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _centers(D=6, ndim=3, seed=3):
    return np.random.default_rng(seed).uniform(0.3, 0.7, size=(D, ndim))


def _analytic(D=6):
    c = _centers(D)
    return (jax_analytic(c, sigma=SIGMA),
            make_analytic_gaussian_problem(c, sigma=SIGMA), c)


def _horns(D=8, seed=None):
    data = gen_horns(D) if seed is None else gen_horns(D, seed=seed)
    args = (data["x"], data["y"], data["noise_level"])
    return jax_gaussline(*args), make_gaussline_problem(*args)


@pytest.fixture(scope="module")
def muse_pair(tmp_path_factory):
    """The MUSE FULL problem of both packages on the template grid and
    data grid of ``tests/test_torch_muse.py``."""
    tpl = jax_synth.make_template_files(str(tmp_path_factory.mktemp("tpl")),
                                        n_wl=400)
    jmd = jax_model.load_template_grid(tpl, data_wl_nm=WL_NM)
    tmd = model.load_template_grid(tpl, data_wl_nm=WL_NM)
    rng = np.random.default_rng(7)
    D = 6
    y = rng.normal(1.0, 0.1, size=(NSPEC, D))
    var = np.full((NSPEC, D), 0.01)
    y[50:80, 3] = np.nan  # masked bins, as in tests/test_torch_muse.py
    var[100:140, 5] = np.nan
    return (jax_lik.make_muse_problem(jmd, y, var),
            likelihood.make_muse_problem(tmd, y, var))


# --- 1. transforms ----------------------------------------------------------------

def test_transforms_match_jax():
    rng = np.random.default_rng(0)
    u = rng.uniform(0.0, 1.0, (32, 4)).astype(np.float32)
    u[0, :2] = (0.0, 1.0)  # both clips
    z = np.asarray(jax_tf.u_to_z(jnp.asarray(u)))
    got_z = transforms.u_to_z(_t(u)).numpy()
    np.testing.assert_allclose(got_z, z, atol=1e-6, rtol=1e-6)
    zz = rng.normal(0.0, 3.0, (32, 4)).astype(np.float32)
    np.testing.assert_allclose(transforms.z_to_u(_t(zz)).numpy(),
                               np.asarray(jax_tf.z_to_u(jnp.asarray(zz))),
                               atol=1e-6)
    np.testing.assert_allclose(
        transforms.log_abs_det_jacobian(_t(zz)).numpy(),
        np.asarray(jax_tf.log_abs_det_jacobian(jnp.asarray(zz))), atol=1e-6,
        rtol=1e-6)


def test_logit_bijection_roundtrip():
    """The bars of tests/test_infer.py::test_logit_bijection_roundtrip."""
    u = np.random.default_rng(0).uniform(0.01, 0.99, (32, 4)).astype(np.float32)
    z = transforms.u_to_z(_t(u))
    np.testing.assert_allclose(transforms.z_to_u(z).numpy(), u, atol=1e-5)
    expect = np.log(u * (1 - u)).sum(axis=-1)
    np.testing.assert_allclose(transforms.log_abs_det_jacobian(z).numpy(),
                               expect, rtol=1e-4)


# --- 2. paired likelihoods ----------------------------------------------------------

def _with_sample_axis(problem, x):
    """The paired likelihood of ``x[n, D, ndim]`` in one call, and in n."""
    one = problem.loglike_paired(x)
    each = torch.stack([problem.loglike_paired(xi) for xi in x])
    return one.numpy(), each.numpy()


def test_paired_fallback_matches_jax_and_diagonal():
    jp, tp, c = _analytic()
    x = (c + 0.01).astype(np.float32)
    got = tp.loglike_paired(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jp.loglike_paired(jnp.asarray(x))),
                               rtol=1e-5)
    np.testing.assert_allclose(got, np.diagonal(tp.loglike(_t(x)).numpy()),
                               rtol=1e-5)
    xs = _t(c[None] + np.random.default_rng(1).normal(0, 0.05, (3, *c.shape)))
    one, each = _with_sample_axis(tp, xs)
    assert one.shape == (3, 6)
    np.testing.assert_array_equal(one, each)


def test_gaussline_paired_matches_jax_and_batch_diagonal():
    """The bars of tests/test_infer.py::test_gaussline_paired_matches_batch_diagonal."""
    jp, tp = _horns(8)
    u = np.random.default_rng(1).uniform(0.1, 0.9, (8, 3)).astype(np.float32)
    x = tp.transform_batch(_t(u))
    got = tp.loglike_paired(x).numpy()
    want = np.asarray(jp.loglike_paired(jp.transform_batch(jnp.asarray(u))))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.05)
    np.testing.assert_allclose(got, np.diagonal(tp.loglike(x).numpy()),
                               rtol=1e-4, atol=0.05)
    us = np.random.default_rng(2).uniform(0.1, 0.9, (4, 8, 3)).astype(np.float32)
    one, each = _with_sample_axis(tp, tp.transform_batch(
        _t(us).reshape(-1, 3)).reshape(4, 8, 3))
    assert one.shape == (4, 8)
    np.testing.assert_allclose(one, each, rtol=1e-6)
    assert tp.predict_one(x[2]).shape == (tp.x.shape[0],)


def test_muse_paired_matches_jax(muse_pair):
    jp, tp = muse_pair
    u = np.random.default_rng(3).uniform(0.05, 0.95, (6, 5)).astype(np.float32)
    u[2, 2] = 0.0  # sfage = 0: a dead row, -inf in both
    x = tp.transform_batch(_t(u))
    got = tp.loglike_paired(x).numpy().astype(np.float64)
    want = np.asarray(jp.loglike_paired(jp.transform_batch(jnp.asarray(u))),
                      np.float64)
    assert np.isneginf(got[2]) and np.isneginf(want[2])
    live = ~np.isneginf(want)
    yy = tp.yy.numpy().astype(np.float64)
    # the bar of tests/test_torch_muse.py: chi2 = yy - s1^2/s2 cancels
    assert (np.abs(got[live] - want[live])
            <= 2e-5 * (np.abs(want) + yy)[live]).all()
    us = np.random.default_rng(4).uniform(0.05, 0.95, (3, 6, 5)).astype(np.float32)
    one, each = _with_sample_axis(tp, tp.transform_batch(
        _t(us).reshape(-1, 5)).reshape(3, 6, 5))
    assert one.shape == (3, 6) and np.isfinite(one).all()
    np.testing.assert_allclose(one, each, rtol=1e-6)


def test_problem_without_curve_predicts_none():
    _, tp, c = _analytic()
    assert tp.predict_one(_t(c[0])) is None


# --- 3. gradients against jax.grad --------------------------------------------------

def _grads(jp, tp, z):
    jlp = jax_tf.make_log_posterior(jp)
    want = np.asarray(jax.grad(lambda zz: jlp(zz).sum())(jnp.asarray(z)))
    lp, got = transforms.value_and_grad(transforms.make_log_posterior(tp), _t(z))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp(jnp.asarray(z))),
                               rtol=1e-4, atol=1e-3)
    return got.numpy(), want


def _assert_grad_close(got, want):
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)  # the same NaN pattern
    scale = np.nanmax(np.abs(np.where(nan, np.nan, want)), axis=1,
                      keepdims=True)
    scale = np.nan_to_num(scale)
    bad = ~nan & (np.abs(got - want) > 1e-3 * np.abs(want) + 1e-3 * scale)
    assert not bad.any(), (got[bad], want[bad])


def test_gradient_matches_jax_analytic():
    jp, tp, c = _analytic()
    z = np.array(jax_tf.u_to_z(jnp.asarray(c + 0.02, jnp.float32)))
    z[1, 0] = np.asarray(jax_tf.u_to_z(jnp.float32(0.0)))  # u at the clip
    got, want = _grads(jp, tp, z)
    assert np.isfinite(want).all()
    _assert_grad_close(got, want)


def test_gradient_matches_jax_horns():
    jp, tp = _horns(8)
    z = np.random.default_rng(5).normal(0.0, 1.5, (8, 3)).astype(np.float32)
    z[3, 1] = np.asarray(jax_tf.u_to_z(jnp.float32(1.0)))  # u at the clip
    got, want = _grads(jp, tp, z)
    assert np.isfinite(want).all()
    _assert_grad_close(got, want)


def test_gradient_matches_jax_muse(muse_pair):
    jp, tp = muse_pair
    z = np.random.default_rng(6).normal(0.0, 1.0, (6, 5)).astype(np.float32)
    z[1, 4] = 12.0     # EBV at 2: deep extinction, alive (unit scale)
    z[1, 0] = -12.0    # at the bluest metallicity
    z[2, 2] = -110.0   # sigmoid gives u = 0: sfage = 0, a dead candidate
    z[4, 3] = np.asarray(jax_tf.u_to_z(jnp.float32(0.0)))  # u at the clip
    got, want = _grads(jp, tp, z)
    # the dead row: -inf log posterior; NaN gradient through the SFH
    # normalisation in both packages (exp of -inf - -inf), which HMC's
    # isfinite guard rejects
    assert np.isnan(want[2]).any()
    assert np.isfinite(np.delete(want, 2, axis=0)).all()
    _assert_grad_close(got, want)


# --- 4. step functions against JAX's own ----------------------------------------------

@pytest.mark.parametrize("kind, rtol", [("analytic", 1e-4), ("horns", 1e-3)])
@pytest.mark.parametrize("n_steps", [8, 24])
def test_leapfrog_and_kinetic_match_jax(kind, rtol, n_steps):
    if kind == "analytic":
        jp, tp, c = _analytic()
        z = np.array(jax_tf.u_to_z(jnp.asarray(c + 0.01, jnp.float32)))
        eps = np.full(6, 0.05, np.float32)
    else:
        jp, tp = _horns(8)
        z = np.random.default_rng(8).normal(0.0, 0.5, (8, 3)).astype(np.float32)
        eps = np.full(8, 0.002, np.float32)
    rng = np.random.default_rng(9)
    p = rng.normal(size=z.shape).astype(np.float32)
    inv_mass = rng.uniform(0.5, 1.5, z.shape).astype(np.float32)
    jlp = jax_tf.make_log_posterior(jp)
    jz, jpm = jax_hmc._leapfrog(jax.grad(lambda zz: jlp(zz).sum()),
                                jnp.asarray(z), jnp.asarray(p),
                                jnp.asarray(eps), jnp.asarray(inv_mass), n_steps)
    lp = transforms.make_log_posterior(tp)
    tz, tpm, tlogp, _ = hmc._leapfrog(
        lambda zz: transforms.value_and_grad(lp, zz), _t(z), _t(p), _t(eps),
        _t(inv_mass), n_steps)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=rtol, atol=rtol)
    np.testing.assert_allclose(tpm.numpy(), np.asarray(jpm), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(jpm)).max())
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlp(jz)), rtol=rtol)
    np.testing.assert_allclose(hmc._kinetic(tpm, _t(inv_mass)).numpy(),
                               np.asarray(jax_hmc._kinetic(jpm, inv_mass)),
                               rtol=rtol)


@pytest.mark.parametrize("kind", ["analytic", "horns"])
def test_elbo_integrand_matches_jax(kind):
    if kind == "analytic":
        jp, tp, c = _analytic()
        mu = np.array(jax_tf.u_to_z(jnp.asarray(c, jnp.float32)))
        log_sigma = np.full(mu.shape, -3.0, np.float32)
    else:
        jp, tp = _horns(8)
        mu = np.random.default_rng(10).normal(0, 0.5, (8, 3)).astype(np.float32)
        log_sigma = np.full(mu.shape, -4.0, np.float32)
    key = jax.random.key(4)
    want = np.asarray(jax_vi._elbo_samples(
        jax_tf.make_log_posterior(jp), jnp.asarray(mu), jnp.asarray(log_sigma),
        key, 16))
    eps = np.asarray(jax.random.normal(key, (16, *mu.shape)))
    got = vi._elbo_samples(transforms.make_log_posterior(tp), _t(mu),
                           _t(log_sigma), _t(eps)).numpy()
    assert got.shape == (16, mu.shape[0])
    np.testing.assert_allclose(got, want, rtol=1e-5)


# --- 5. whole runs on JAX's draws ---------------------------------------------------

def _jax_hmc_draws(key, D, ndim, num_warmup, num_samples):
    """The normals and uniforms of JAX's ``run_hmc``, in its order
    (hmc.py:72-73,81,97,127,140,145)."""
    key, k_w1, k_w2 = jax.random.split(key, 3)
    n1 = max(2 * num_warmup // 3, 2)
    n2 = max(num_warmup - n1, 2)
    key, k_samp = jax.random.split(key)
    draws = []
    for k, n in ((k_w1, n1), (k_w2, n2), (k_samp, num_samples)):
        for _ in range(n):
            k, k_it = jax.random.split(k)
            k_mom, k_acc = jax.random.split(k_it)
            draws.append((_t(jax.random.normal(k_mom, (D, ndim))),
                          _t(jax.random.uniform(k_acc, (D,)))))
    return draws


def _port_hmc(tp, draws, **kw):
    queue = iter(draws)
    res = run_hmc(tp, None, device="cpu", draw=lambda: next(queue), **kw)
    assert next(queue, None) is None  # every draw used, in order
    return res


def _assert_hmc_close(got, want, slack=None):
    """Equal accepts; ``u``, ``x``, ``logp``, ``step_size`` and ``mass``
    at ``atol 1e-4`` / ``rtol 1e-3``, plus, per dataset (the chains are
    independent), ``slack`` times the run's own float32 sensitivity."""
    np.testing.assert_array_equal(got.accept_rate.numpy(),
                                  np.asarray(want.accept_rate))
    for name in ("u", "x", "logp", "step_size", "mass"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        bound = 1e-4 + 1e-3 * np.abs(w)
        if slack is not None:
            bound = bound + slack[name]
        assert (np.abs(g - w) <= bound).all(), (name, np.abs(g - w).max())


def test_hmc_short_run_on_jax_draws_matches_jax():
    """Four warmup iterations and one sample: the chains are still well
    conditioned, so the bare float32 bars hold."""
    jp, tp, _ = _analytic()
    kw = dict(num_warmup=3, num_samples=1, num_leapfrog=8)
    want = jax_hmc.run_hmc(jp, jax.random.key(0), **kw)
    got = _port_hmc(tp, _jax_hmc_draws(jax.random.key(0), 6, 3, 3, 1), **kw)
    _assert_hmc_close(got, want)


# the port's 12/6/8 run below in float64 against the same run in float32
# moves u (and x) by 2.8e-3, logp by 0.111, step_size by 4.8e-3 and mass
# by 0.381 at most (test_hmc_run_float32_rounding_is_as_recorded): the
# run's own float32 rounding, which caps the slack
F64_VS_F32 = dict(u=2.9e-3, x=2.9e-3, logp=0.12, step_size=5e-3, mass=0.39)
SLACK_CEILING = 4.0
HMC_12_6_8 = dict(num_warmup=12, num_samples=6, num_leapfrog=8)


def test_hmc_run_float32_rounding_is_as_recorded(monkeypatch):
    """The origin of ``F64_VS_F32``: the 12/6/8 run on JAX's draws, in
    float64 (problem, draws and start) against float32."""
    _, tp, _ = _analytic()
    draws = _jax_hmc_draws(jax.random.key(0), 6, 3, 12, 6)
    f32 = _port_hmc(tp, draws, **HMC_12_6_8)
    u_to_z = transforms.u_to_z
    monkeypatch.setattr(transforms, "u_to_z",
                        lambda u, eps=1e-6: u_to_z(u, eps).double())
    f64 = _port_hmc(tp.double(), [(n.double(), u.double()) for n, u in draws],
                    **HMC_12_6_8)
    assert f64.u.dtype == torch.float64
    for name, recorded in F64_VS_F32.items():
        d = (getattr(f64, name) - getattr(f32, name)).abs().max().item()
        assert 0.5 * recorded <= d <= recorded, (name, d)


def test_hmc_run_on_jax_draws_matches_jax():
    """num_warmup=12, num_samples=6, num_leapfrog=8: dual averaging drives
    the step sizes to 0.6-10, where a leapfrog trajectory amplifies
    rounding, so the run is ill-conditioned in float32: moving every
    normal by one ulp moves ``u`` by about 2e-3 and the mass by about
    2 %. The port is held to JAX at the float32 bars plus three times that
    sensitivity, measured here per dataset; the accepts must be equal.
    The slack may not exceed ``SLACK_CEILING`` times the run's float32
    rounding (``F64_VS_F32``; the one-ulp sensitivity is at most 1.1 times
    it), so a fault that made the run more sensitive cannot widen its own
    bar."""
    jp, tp, _ = _analytic()
    kw = HMC_12_6_8
    want = jax_hmc.run_hmc(jp, jax.random.key(0), **kw)
    draws = _jax_hmc_draws(jax.random.key(0), 6, 3, 12, 6)
    got = _port_hmc(tp, draws, **kw)
    nudged = _port_hmc(tp, [(torch.nextafter(n, torch.full_like(n, 1e9)), u)
                            for n, u in draws], **kw)
    slack = {}
    for name in ("u", "x", "logp", "step_size", "mass"):
        d = (getattr(nudged, name) - getattr(got, name)).abs().numpy()
        axis = {"u": (0, 2), "x": (0, 2), "logp": 0}.get(name)
        per_dataset = d.max(axis=axis) if axis is not None else d
        if name == "mass":
            per_dataset = d.max(axis=1, keepdims=True)
        slack[name] = 3.0 * (per_dataset[:, None] if name in ("u", "x")
                             else per_dataset)
        assert slack[name].max() <= SLACK_CEILING * F64_VS_F32[name], (
            name, slack[name].max())
    _assert_hmc_close(got, want, slack)


@pytest.mark.parametrize("eval_candidates", [vi.EVAL_CANDIDATES, 30])
def test_vi_run_on_jax_draws_matches_jax(monkeypatch, eval_candidates):
    """At 30 candidates a pass, the final ELBO and the importance weights
    are scored 5 draws at a time."""
    monkeypatch.setattr(vi, "EVAL_CANDIDATES", eval_candidates)
    jp, tp, _ = _analytic()
    kw = dict(steps=20, mc_samples=8, iw_samples=256, lr=2e-2)
    want = jax_vi.run_vi(jp, jax.random.key(1), **kw)
    key, k_fit, k_final, k_iw = jax.random.split(jax.random.key(1), 4)
    eps = []
    k = k_fit
    for _ in range(20):
        k, kk = jax.random.split(k)
        eps.append(jax.random.normal(kk, (8, 6, 3)))
    eps += [jax.random.normal(k_final, (32, 6, 3)),
            jax.random.normal(k_iw, (256, 6, 3))]
    queue = iter(eps)

    def draw(n):
        e = next(queue)
        assert e.shape[0] == n
        return _t(e)

    got = run_vi(tp, None, device="cpu", draw=draw, **kw)
    assert next(queue, None) is None
    for name in ("mu", "sigma", "elbo", "logZ_iw", "elbo_trace"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, err_msg=name)


# --- 6. distributional bars on the port's own generator ---------------------------------

def test_hmc_recovers_posterior_moments():
    """tests/test_infer.py::test_hmc_recovers_posterior_moments, its
    problem, settings and bars, on the port."""
    _, tp, centers = _analytic()
    res = run_hmc(tp, torch.Generator().manual_seed(0), device="cpu",
                  num_warmup=400, num_samples=400, num_leapfrog=16)
    acc = res.accept_rate.numpy()
    assert (acc > 0.4).all() and (acc <= 1.0).all(), acc
    mean = res.x.mean(dim=0).numpy()
    std = res.x.std(dim=0, correction=0).numpy()
    assert np.abs(mean - centers).max() < 4.0 * SIGMA / np.sqrt(400) * 10
    assert np.abs(std - SIGMA).max() < 0.6 * SIGMA
    assert res.u.shape == (400, 6, 3) and res.logp.shape == (400, 6)
    assert torch.isfinite(res.logp).all()


def test_vi_evidence_matches_analytic():
    """tests/test_infer.py::test_vi_evidence_matches_analytic on the port."""
    _, tp, centers = _analytic()
    res = run_vi(tp, torch.Generator().manual_seed(0), device="cpu",
                 steps=1200, lr=3e-2)
    lz = true_logZ(centers, SIGMA)
    elbo = res.elbo.numpy()
    iw = res.logZ_iw.numpy()
    assert (elbo < lz + 0.2).all(), (elbo, lz)
    assert np.abs(iw - lz).max() < 0.25, (iw, lz)
    assert (iw >= elbo - 0.2).all()
    assert res.elbo_trace.shape == (1200,)

