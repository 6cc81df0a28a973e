"""The port's copy of the post-processing layer (``postprocess.py``).

The nine tests of ``tests/test_postprocess.py`` on the port's module, and
the functions that return numbers held against the JAX package's on the
same inputs (to ``rtol 1e-12``: both are the same numpy code). The best-fit
plots read the port's problems.
"""

import json

import numpy as np
import pytest
import torch

from massivedatans_tpu import postprocess as jax_pp
from massivedatans_tpu_torch import postprocess as pp

torch.set_num_threads(1)


def _fake_out(niter=50, D=4, ndim=3, seed=0):
    """The fit dict of tests/test_postprocess.py."""
    rng = np.random.default_rng(seed)
    return dict(
        logZ=rng.normal(-100, 5, D),
        logZerr=np.abs(rng.normal(0.3, 0.05, D)),
        u=rng.uniform(size=(niter, D, ndim)).astype(np.float32),
        x=rng.uniform(size=(niter, D, ndim)).astype(np.float32),
        L=rng.normal(-50, 3, size=(niter, D)).astype(np.float32),
        w=-np.linspace(0, 5, niter)[:, None].repeat(D, 1).astype(np.float32),
        mask=np.ones((niter, D), bool),
        ndraws=1234,
    )


# --- the nine tests of tests/test_postprocess.py ------------------------------

def test_posterior_weights_normalized():
    out = _fake_out()
    p = pp.posterior_weights(out, 0)
    assert np.isclose(p.sum(), 1.0)
    assert (p >= 0).all()
    xs = pp.posterior_samples(out, 1, size=200)
    assert xs.shape == (200, 3)


def test_posterior_weights_ignore_inactive_rows():
    out = _fake_out()
    out["L"][10, 0] = -np.inf
    out["w"][11, 0] = -np.inf
    p = pp.posterior_weights(out, 0)
    assert p[10] == 0 and p[11] == 0


def test_bayes_factors_and_plot(tmp_path):
    out = _fake_out()
    y = np.random.default_rng(1).normal(0, 0.01, size=(200, 4))
    B = pp.plot_evidences(out, y, path=str(tmp_path / "ev.pdf"))
    assert B.shape == (4,)
    assert (tmp_path / "ev.pdf").exists()


def test_plot_scaling(tmp_path):
    files = []
    for N, nd in [(10, 1000), (100, 3000), (1000, 10000)]:
        fn = tmp_path / f"s{N}.json"
        fn.write_text(json.dumps(dict(ndata=N, ndraws=nd, duration=1.0)))
        files.append(str(fn))
    N, draws = pp.plot_scaling(files, path=str(tmp_path / "sc.pdf"))
    assert list(N) == [10, 100, 1000]
    assert (tmp_path / "sc.pdf").exists()


def test_muse_maps(tmp_path):
    out = _fake_out(D=4)
    flat_positions = np.array([0, 3, 7, 12])
    maps = pp.muse_maps(out, flat_positions, (4, 4),
                        path_prefix=str(tmp_path / "m"))
    assert maps["logZ"].shape == (4, 4)
    assert np.isfinite(maps["logZ"].ravel()[flat_positions]).all()
    assert np.isnan(maps["logZ"].ravel()[1])
    assert (tmp_path / "m_logZ.pdf").exists()


def test_plot_corner(tmp_path):
    s = np.random.default_rng(2).normal(size=(500, 3))
    pp.plot_corner(s, labels=["a", "b", "c"], path=str(tmp_path / "corner.pdf"))
    assert (tmp_path / "corner.pdf").exists()


def test_plot_muse_posterior(tmp_path):
    out = _fake_out(niter=64, D=3, ndim=5, seed=3)
    done = pp.plot_muse_posterior(
        out, min_finite=10, size=2000, path_prefix=str(tmp_path / "mp"),
        transforms={2: np.abs}, rng=np.random.default_rng(0))
    assert done == [0, 1, 2]
    assert (tmp_path / "mp_1.pdf").exists()
    assert (tmp_path / "mp_3.pdf").exists()
    assert pp.plot_muse_posterior(
        out, min_finite=10_000, path_prefix=str(tmp_path / "skip")) == []


def test_region_demo_plots(tmp_path):
    """The demos build their regions with the port's ns/region.py."""
    outs = pp.plot_region_demo(path_prefix=str(tmp_path / "pc"),
                               nlive=50, nlevels=2, npoints=3000)
    assert (tmp_path / "pc.pdf").exists()
    assert len(outs) >= 1
    outs2 = pp.plot_joint_region_demo(path_prefix=str(tmp_path / "pj"),
                                      nlive=50, nlevels=2, npoints=3000)
    assert len(outs2) >= 1


def test_plot_bestfit_gaussline(tmp_path):
    from massivedatans_tpu_torch.datagen.generators import gen_horns
    from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem

    data = gen_horns(8, seed=9)
    problem = make_gaussline_problem(data["x"], data["y"], data["noise_level"])
    out = _fake_out(niter=32, D=8, ndim=3, seed=4)
    paths = pp.plot_bestfit(out, problem, datasets=[0, 3],
                            path_prefix=str(tmp_path / "bf"))
    assert len(paths) == 2
    assert (tmp_path / "bf_3.pdf").exists()


# --- numbers against the JAX package ---------------------------------------------

def test_numbers_match_jax(tmp_path):
    out = _fake_out(niter=80, D=5, seed=6)
    out["L"][3, 1] = -np.inf
    y = np.random.default_rng(7).normal(0, 0.01, size=(120, 5))
    for d in range(5):
        np.testing.assert_allclose(pp.posterior_weights(out, d),
                                   jax_pp.posterior_weights(out, d),
                                   rtol=1e-12, atol=0)
        np.testing.assert_array_equal(
            pp.posterior_samples(out, d, size=300, rng=np.random.default_rng(d)),
            jax_pp.posterior_samples(out, d, size=300,
                                     rng=np.random.default_rng(d)))
    np.testing.assert_allclose(pp.analytic_nosignal_logZ(y, 0.02),
                               jax_pp.analytic_nosignal_logZ(y, 0.02),
                               rtol=1e-12)
    np.testing.assert_allclose(pp.bayes_factors(out, y),
                               jax_pp.bayes_factors(out, y), rtol=1e-12)
    # the line position of recovered_redshifts is parameter 1, in nm
    out["x"][:, :, 1] = 400.0 + 400.0 * out["x"][:, :, 1]
    out["x"][:, 2, 1] = 500.0 + 0.1 * out["x"][:, 2, 1]  # one constrained line
    zs, mask = pp.recovered_redshifts(out, std_cut=50.0)
    jzs, jmask = jax_pp.recovered_redshifts(out, std_cut=50.0)
    np.testing.assert_array_equal(mask, jmask)
    assert mask.any()
    np.testing.assert_allclose(zs, jzs, rtol=1e-12)
    positions = np.array([0, 3, 7, 12, 15])
    maps = pp.muse_maps(out, positions, (4, 4),
                        path_prefix=str(tmp_path / "p"))
    jmaps = jax_pp.muse_maps(out, positions, (4, 4),
                             path_prefix=str(tmp_path / "j"))
    assert maps.keys() == jmaps.keys()
    for k in maps:
        np.testing.assert_allclose(maps[k], jmaps[k], rtol=1e-12,
                                   equal_nan=True, err_msg=k)


def test_plot_bestfit_reads_the_port_problem(tmp_path):
    """The curve drawn is the port's ``GaussLine.predict_one`` of the
    highest-likelihood sample; a problem without a curve plots nothing,
    as in the JAX package."""
    from massivedatans_tpu_torch.datagen.generators import gen_horns
    from massivedatans_tpu_torch.models.analytic import make_analytic_gaussian_problem
    from massivedatans_tpu_torch.models.gaussline import (
        gaussline_predict, make_gaussline_problem,
    )

    data = gen_horns(6, seed=2)
    problem = make_gaussline_problem(data["x"], data["y"], data["noise_level"])
    out = _fake_out(niter=20, D=6, ndim=3, seed=8)
    out["x"][:, :, 1] = 400.0 + 400.0 * out["x"][:, :, 1]
    i, xbest = pp._best_sample(out, 4)
    assert i == int(np.argmax(out["L"][:, 4]))
    curve = pp._predict(problem, xbest)
    want = gaussline_predict(problem.x, torch.from_numpy(xbest[None]))[0]
    np.testing.assert_array_equal(curve, want.numpy())
    assert curve.shape == (data["x"].shape[0],)
    assert pp.plot_bestfit(out, problem, datasets=[4],
                           path_prefix=str(tmp_path / "g")) == \
        [str(tmp_path / "g_4.pdf")]
    analytic = make_analytic_gaussian_problem(np.full((6, 3), 0.5))
    assert pp.plot_bestfit(out, analytic, path_prefix=str(tmp_path / "a")) == []


def test_plot_muse_bestfit_on_the_port_problem(tmp_path):
    from massivedatans_tpu_torch.muse import likelihood, model, synth

    tpl = synth.make_template_files(str(tmp_path / "tpl"), n_wl=100)
    wl = (4750.0 + 40.0 * np.arange(80)) / 10.0
    md = model.load_template_grid(tpl, data_wl_nm=wl)
    rng = np.random.default_rng(3)
    y = rng.normal(1.0, 0.1, size=(80, 3))
    var = np.full((80, 3), 0.01)
    var[10:20, 1] = np.nan
    problem = likelihood.make_muse_problem(md, y, var)
    u = rng.uniform(0.1, 0.9, size=(30, 3, 5)).astype(np.float32)
    x = problem.transform_batch(torch.from_numpy(u.reshape(-1, 5)))
    out = dict(logZ=np.zeros(3), L=rng.normal(-50, 3, (30, 3)).astype(np.float32),
               x=x.numpy().reshape(30, 3, 5))
    paths = pp.plot_muse_bestfit(out, problem, path_prefix=str(tmp_path / "mb"))
    assert paths == [str(tmp_path / f"mb_{d}.pdf") for d in range(3)]
    assert all((tmp_path / f"mb_{d}.pdf").exists() for d in range(3))


@pytest.mark.parametrize("key", [0, 3])
def test_demo_region_mask_holds_its_live_points(key):
    """Every live point lies in its own ball, so the region the demo builds
    covers it; far from the points the grid is outside."""
    pts = np.random.default_rng(key).normal(2.0, 0.5, size=(60, 2))
    grid = np.concatenate([pts, [[40.0, 40.0], [-30.0, 5.0]]])
    inside = pp._demo_region_mask(pts, grid, key=key)
    assert inside.dtype == bool and inside.shape == (62,)
    assert inside[:60].all() and not inside[60:].any()
