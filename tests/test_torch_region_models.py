"""The port's problem layer and region geometry against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
deterministic functions are held to stated float32 tolerances, the region
sampler by the uniformity test of ``tests/test_region.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from massivedatans_tpu.datagen.generators import gen_horns
from massivedatans_tpu.models import analytic as jax_analytic
from massivedatans_tpu.models import gaussline as jax_gaussline
from massivedatans_tpu.ns import region as jax_region
from massivedatans_tpu_torch.convert import problem_from_numpy
from massivedatans_tpu_torch.models import analytic, gaussline
from massivedatans_tpu_torch.ns import region

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _numpy_data(data):
    return {k: np.asarray(v) for k, v in vars(data).items()}


def test_gaussline_loglike_matches_jax():
    data = gen_horns(64)
    jp = jax_gaussline.make_gaussline_problem(data["x"], data["y"][:, :16],
                                              data["noise_level"])
    tp = problem_from_numpy(_numpy_data(jp.data), "gaussline")
    rng = np.random.default_rng(0)
    u = rng.uniform(size=(96, 3)).astype(np.float32)
    x = np.array(jp.transform_batch(jnp.asarray(u)))
    L_jax = np.asarray(jp.loglike(jnp.asarray(x)), np.float64)
    L_t = tp.loglike(torch.from_numpy(x)).numpy().astype(np.float64)
    # f32 rounding bound of the shared expansion ssp - 2 ypred.y + ysq:
    # the magnitudes each term is rounded against, in f64
    ypred = np.asarray(jax.vmap(
        lambda p: jax_gaussline.gaussline_predict(jp.data.x, p))(x), np.float64)
    y = np.asarray(jp.data.y, np.float64)
    mag = ((ypred ** 2).sum(1)[:, None] + 2.0 * np.abs(ypred) @ np.abs(y)
           + (y ** 2).sum(0)[None, :])
    bound = 8 * EPS32 * mag / (2 * float(data["noise_level"]) ** 2)
    assert np.all(np.abs(L_t - L_jax) <= bound), np.max(np.abs(L_t - L_jax) / bound)


def test_gaussline_prior_transform_matches_jax():
    u = np.random.default_rng(1).uniform(size=(200, 3)).astype(np.float32)
    want = np.asarray(jax.vmap(jax_gaussline.gaussline_prior_transform)(
        jnp.asarray(u)))
    got = gaussline.gaussline_prior_transform(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


def test_make_gaussline_problem_sums_ysq_in_float64():
    data = gen_horns(64)
    tp = gaussline.make_gaussline_problem(data["x"], data["y"][:, :8])
    jp = jax_gaussline.make_gaussline_problem(data["x"], data["y"][:, :8])
    assert np.array_equal(tp.ysq.numpy(), np.asarray(jp.data.ysq))


def test_analytic_loglike_matches_jax():
    rng = np.random.default_rng(2)
    centers = rng.uniform(0.25, 0.75, size=(12, 3))
    jp = jax_analytic.make_analytic_gaussian_problem(centers, sigma=0.05)
    tp = analytic.make_analytic_gaussian_problem(centers, sigma=0.05)
    x = rng.uniform(size=(64, 3)).astype(np.float32)
    L_jax = np.asarray(jp.loglike(jnp.asarray(x)), np.float64)
    L_t = tp.loglike(tp.transform_batch(torch.from_numpy(x))).numpy()
    c = np.asarray(jp.data.centers, np.float64)
    x64 = x.astype(np.float64)
    mag = ((x64 ** 2).sum(1)[:, None] + 2 * np.abs(x64) @ np.abs(c).T
           + (c ** 2).sum(1)[None, :])
    bound = 8 * EPS32 * mag / (2 * 0.05 ** 2)
    assert np.all(np.abs(L_t - L_jax) <= bound)
    np.testing.assert_allclose(analytic.true_logZ(centers, 0.05),
                               jax_analytic.true_logZ(centers, 0.05), rtol=0)


@pytest.mark.parametrize("kind", ["truncatedscaling", "simplescaling", "none"])
def test_fit_metric_matches_jax(kind):
    rng = np.random.default_rng(3)
    u = (rng.normal(size=(200, 3)) * np.array([1.0, 0.1, 0.013])).astype(np.float32)
    mask = np.arange(200) < 170
    want = jax_region.fit_metric(jnp.asarray(u), jnp.asarray(mask), kind)
    got = region.fit_metric(torch.from_numpy(u), torch.from_numpy(mask), kind)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-5)
    if kind == "truncatedscaling":  # exact powers of two on both sides
        assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("shrink, phantoms", [(False, False), (True, True)])
def test_build_region_matches_jax_with_shared_bags(monkeypatch, shrink, phantoms):
    """Fed the same in-bag rounds, both packages build the same region."""
    rng = np.random.default_rng(4)
    M, ndim, nb = 160, 3, 10
    u = rng.normal(0.5, 0.1, size=(M, ndim)).astype(np.float32)
    mask = np.arange(M) < 140
    key = jax.random.key(5)
    inbag = np.asarray(jax_region.bootstrap_inbag_rounds(jnp.asarray(mask),
                                                          key, nb))
    monkeypatch.setattr(region, "bootstrap_inbag_rounds",
                        lambda m, g, n: torch.from_numpy(inbag.copy()))
    kw_j, kw_t = {}, {}
    if shrink:
        first = jax_region.build_region(jnp.asarray(u), jnp.asarray(mask), key,
                                        nbootstraps=nb)
        small = np.float32(float(first.radius) * 0.8)
        kw_j = dict(prev_scale=first.metric.scale, prev_radius=jnp.float32(small))
        kw_t = dict(prev_scale=torch.from_numpy(np.array(first.metric.scale)),
                    prev_radius=torch.tensor(small))
    if phantoms:
        extra = rng.normal(0.5, 0.2, size=(4, ndim)).astype(np.float32)
        emask = np.array([True, True, False, True])
        kw_j.update(extra_u=jnp.asarray(extra), extra_mask=jnp.asarray(emask))
        kw_t.update(extra_u=torch.from_numpy(extra),
                    extra_mask=torch.from_numpy(emask))
    want = jax_region.build_region(jnp.asarray(u), jnp.asarray(mask), key,
                                   nbootstraps=nb, **kw_j)
    got = region.build_region(torch.from_numpy(u), torch.from_numpy(mask),
                              None, nbootstraps=nb, **kw_t)
    assert np.array_equal(got.member_mask.numpy(), np.asarray(want.member_mask))
    assert int(got.n_members) == int(want.n_members)
    assert np.array_equal(got.metric.scale.numpy(), np.asarray(want.metric.scale))
    for name in ("members_w", "radius", "lo", "hi"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-5, atol=1e-6, err_msg=name)
    if shrink:
        assert float(got.radius) <= float(kw_t["prev_radius"]) + 1e-7


def test_bootstrap_inbag_rounds_draw_n_from_valid():
    g = torch.Generator().manual_seed(0)
    mask = torch.zeros(300, dtype=torch.bool)
    mask[::3] = True  # valid members need not be a prefix
    inbag = region.bootstrap_inbag_rounds(mask, g, 10)
    assert inbag.shape == (10, 300)
    assert not inbag[:, ~mask].any()
    frac = inbag[:, mask].float().mean()  # 1 - 1/e of n draws from n
    assert abs(float(frac) - (1 - np.exp(-1))) < 0.03


def test_sample_region_uniform_in_union():
    """Accepted samples are uniform on (union of balls ∩ cube): occupancy
    of two disjoint equal-volume balls (tests/test_region.py:119-148)."""
    members = np.array([[0.3, 0.3], [0.7, 0.7]], np.float32)
    g = torch.Generator().manual_seed(1)
    reg = region.build_region(torch.from_numpy(members),
                              torch.ones(2, dtype=torch.bool), g,
                              nbootstraps=3, metriclearner="none")
    reg.radius = torch.tensor(0.1)
    reg.lo = torch.tensor([0.2, 0.2])
    reg.hi = torch.tensor([0.8, 0.8])
    total, counts = 0, np.zeros(2)
    for _ in range(40):
        u, ok = region.sample_region(reg, g, 512)
        u = u[ok].numpy()
        d0 = np.linalg.norm(u - members[0], axis=1)
        d1 = np.linalg.norm(u - members[1], axis=1)
        assert ((d0 < 0.1) | (d1 < 0.1)).all()
        counts += [(d0 < 0.1).sum(), (d1 < 0.1).sum()]
        total += len(u)
    assert total > 2000
    p = counts[0] / total
    assert abs(p - 0.5) < 5 * 0.5 / np.sqrt(total), (p, total)


def test_count_within_chebyshev_matches_jax():
    rng = np.random.default_rng(7)
    members = rng.uniform(size=(50, 3)).astype(np.float32)
    pts = rng.uniform(-0.2, 1.2, size=(200, 3)).astype(np.float32)
    mask = np.ones(50, bool)
    jreg = jax_region.build_region(jnp.asarray(members), jnp.asarray(mask),
                                   jax.random.key(0), nbootstraps=5,
                                   metriclearner="none", norm="chebyshev")
    treg = region.build_region(torch.from_numpy(members),
                               torch.from_numpy(mask), None, nbootstraps=5,
                               metriclearner="none", norm="chebyshev",
                               estimator="jackknife")
    treg.radius = torch.tensor(float(jreg.radius))
    want = np.asarray(jax_region.count_within(jreg, jnp.asarray(pts),
                                              norm="chebyshev"))
    got = region.count_within(treg, torch.from_numpy(pts), norm="chebyshev")
    assert np.array_equal(got.numpy(), want)
