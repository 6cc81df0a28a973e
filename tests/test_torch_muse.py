"""The port's MUSE slice against the JAX package, on the CPU.

The template library is ``synth.make_template_files(n_wl=400)`` (7
metallicities x 111 ages); the data grid has nspec 300 bins with the bin
width raised to 15 A so the span stays wide (``synth.py:96-98``). Inputs
are made with numpy from fixed seeds and handed to both packages. Float32
tolerances are stated per test.
"""

import json
import os
import subprocess
import sys

import h5py
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from massivedatans_tpu.muse import likelihood as jax_lik
from massivedatans_tpu.muse import model as jax_model
from massivedatans_tpu.muse import synth as jax_synth
from massivedatans_tpu.muse.fitsio import fits_open, get_hdu
from massivedatans_tpu_torch.convert import problem_from_numpy
from massivedatans_tpu_torch.muse import likelihood, model, synth
from massivedatans_tpu_torch.muse.pipeline import fit_muse, run_musefit

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NSPEC, CD3 = 300, 15.0
WL_NM = (4750.0 + CD3 * np.arange(NSPEC)) / 10.0
# row-relative bound on a model spectrum: f32 sums over 110 ages taken in
# another order, then the norm pixel, extinction and interpolation
MODEL_RTOL = 1e-5
# |dL| <= LIKE_RTOL * (|L| + yy): chi2 = yy - s1^2/s2 cancels down from yy
LIKE_RTOL = 2e-5
# the reference output schema plus the MUSE datasets (musefuse.py:661-663)
SCHEMA = {"logZ", "logZerr", "u", "x", "L", "w", "mask", "ndraws", "stalled",
          "fiberids", "duration", "ndata"}
FIT_OVERRIDES = dict(proposal_batch=128, eval_batch=32)


@pytest.fixture(scope="module")
def tpl_files(tmp_path_factory):
    return jax_synth.make_template_files(str(tmp_path_factory.mktemp("tpl")),
                                         n_wl=400)


@pytest.fixture(scope="module")
def mds(tpl_files):
    """The same model grid in both packages."""
    return (jax_model.load_template_grid(tpl_files, data_wl_nm=WL_NM),
            model.load_template_grid(tpl_files, data_wl_nm=WL_NM))


def _jax_prior(jmd, u, zsol):
    prior = (jax_model.muse_prior_transform_zsol if zsol
             else jax_model.muse_prior_transform)
    return np.array(jax.vmap(lambda uu: prior(jmd, uu))(jnp.asarray(u)))


def _corner_params(jmd, zsol, n=48, seed=0):
    """Unit-cube draws and their parameters, with the corners: sfage = 0
    (dead row), z = zhi, EBV = 2 and (FULL) Z on every grid edge."""
    ndim = 4 if zsol else 5
    u = np.random.default_rng(seed).uniform(size=(n, ndim)).astype(np.float32)
    o = 0 if zsol else 1  # column offset of (logSFtau, SFage, z, EBV)
    u[0, o + 1] = 0.0
    u[1:4, o + 2] = 1.0
    u[4:7, o + 3] = 1.0
    x = _jax_prior(jmd, u, zsol)
    if not zsol:
        x[7:14, 0] = np.asarray(jmd.z_grid)  # every grid edge, exactly
    return u, x


@pytest.mark.parametrize("zsol", [False, True])
def test_prior_transform_matches_jax(mds, zsol):
    jmd, tmd = mds
    u, _ = _corner_params(jmd, zsol)
    got = (model.muse_prior_transform_zsol if zsol
           else model.muse_prior_transform)(tmd, torch.from_numpy(u)).numpy()
    # the same f32 affine maps; at most one rounding apart
    np.testing.assert_allclose(got, _jax_prior(jmd, u, zsol),
                               rtol=2 * np.finfo(np.float32).eps, atol=1e-7)


@pytest.mark.parametrize("zsol", [False, True])
def test_predict_batch_matches_jax(mds, zsol):
    jmd, tmd = mds
    _, x = _corner_params(jmd, zsol)
    want = np.asarray(jax_model.predict_batch(jmd, jnp.asarray(x), zsol=zsol))
    got = model.predict_batch(tmd, torch.from_numpy(x.copy()), zsol=zsol).numpy()
    assert got.shape == (len(x), NSPEC) and np.isfinite(got).all()
    # sfage = 0: every SFH weight is zero, so is the whole row, in both
    assert not got[0].any() and not want[0].any()
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= MODEL_RTOL * scale).all(), \
        (np.abs(got - want) / np.maximum(scale, 1e-30)).max()


def test_predict_spectrum_matches_jax(mds):
    jmd, tmd = mds
    _, x = _corner_params(jmd, False, seed=4)
    for row in x[1::8]:
        want = np.asarray(jax_model.predict_spectrum(
            jmd, *(jnp.float32(v) for v in row)))
        got = model.predict_spectrum(tmd, *row).numpy()
        assert np.abs(got - want).max() <= MODEL_RTOL * np.abs(want).max()


def test_metallicity_gather_equals_one_hot_sum(mds):
    """The port picks the Z row with a gather; the JAX package multiplies
    by a one-hot and sums. On finite rows the two are the same numbers."""
    jmd, tmd = mds
    _, x = _corner_params(jmd, False)
    xt = torch.from_numpy(x)
    B, nZ, n_wl = len(x), tmd.z_grid.shape[0], tmd.model_wl.shape[0]
    w = model._sfh_weights(tmd, xt[:, 1], xt[:, 2])[:, :-1] * tmd.age_weight
    per_z = torch.matmul(w, tmd.synth).view(B, nZ, n_wl)
    iZ = torch.clamp(torch.searchsorted(tmd.z_grid, xt[:, 0].contiguous(),
                                        right=True) - 1, 0, nZ - 1)
    gathered = torch.gather(per_z, 1, iZ[:, None, None].expand(B, 1, n_wl))
    one_hot = torch.nn.functional.one_hot(iZ, nZ).to(torch.float32)
    summed = (per_z * one_hot[:, :, None]).sum(dim=1)
    assert torch.isfinite(per_z).all()
    assert torch.equal(gathered[:, 0], summed)
    # Z on grid edge k selects row k, as searchsorted(side="right") - 1
    assert iZ[7:14].tolist() == list(range(nZ))


def _noisy_data(seed, D=12):
    rng = np.random.default_rng(seed)
    y = rng.normal(1.0, 0.1, size=(NSPEC, D))
    var = np.full((NSPEC, D), 0.01)
    # NaN blocks as in tests/test_muse.py:85-87
    y[50:80, 3] = np.nan
    var[50:80, 3] = np.nan
    var[100:140, 5] = np.nan
    return y, var


def _like_params(jmd, seed=1, B=24):
    u = np.random.default_rng(seed).uniform(size=(B, 5)).astype(np.float32)
    u[0, 2] = 0.0   # dead: sfage = 0
    u[1, 4] = 1.0   # EBV = 2 at the bluest Z: deep extinction
    u[1, 0] = 0.0
    return _jax_prior(jmd, u, False)


def _assert_like_close(got, want, yy):
    dead = np.isneginf(want)
    assert (np.isneginf(got) == dead).all()
    got, want = got[~dead], np.broadcast_to(want, dead.shape)[~dead]
    assert np.isfinite(got).all()
    bound = LIKE_RTOL * (np.abs(want) + np.broadcast_to(yy, dead.shape)[~dead])
    assert (np.abs(got - want) <= bound).all(), (np.abs(got - want) / bound).max()


def test_scaled_loglike_batch_matches_jax(mds):
    jmd, tmd = mds
    y, var = _noisy_data(1)
    jp = jax_lik.make_muse_problem(jmd, y, var)
    tp = likelihood.make_muse_problem(tmd, y, var)
    x = _like_params(jmd)
    want = np.asarray(jp.loglike(jnp.asarray(x)), np.float64)
    got = tp.loglike(torch.from_numpy(x)).numpy().astype(np.float64)
    # the dead candidate is -inf in both (JAX's -1e100 overflows in f32)
    assert np.isneginf(want[0]).all() and np.isneginf(got[0]).all()
    # the underflow guard keeps the deep-extinction candidate alive
    assert np.isfinite(got[1]).all()
    _assert_like_close(got, want, np.asarray(jp.data.yy, np.float64))
    # yy and the weights are formed in f64 and zeroed on masked bins
    np.testing.assert_array_equal(tp.yy.numpy(), np.asarray(jp.data.yy))
    np.testing.assert_array_equal(tp.inv_v.numpy(), np.asarray(jp.data.inv_v))
    assert tp.y_over_v[50:80, 3].eq(0).all() and tp.inv_v[100:140, 5].eq(0).all()


def test_full_width_likelihood_at_the_contour(tmp_path):
    """nspec 3600 at yy of order 10^7: the full-size fixture and the JAX
    MUSE run of record's late state (``tools/muse_rounds_from_state.py``).
    Both packages' ``scaled_loglike_batch`` of each running spaxel's live
    points is held to a float64 witness at ``MUSE_CANCEL`` * yy on every
    spaxel (the bar ``LIKE_RTOL`` * (|L| + yy) above is about 200 nats
    there), and the decisions ``L > t`` at the thresholds drawn from each
    spaxel's lowest live L that the two packages (and each and float64)
    disagree on are counted and held within 10 % of the count in
    ``muse_state_rounds.json``."""
    sys.path.insert(0, ROOT)
    from chip_smoke import MUSE_CANCEL
    from tools import muse_rounds_from_state as mrs
    from tools.torch_muse_validate import build_fixture

    with open(os.path.join(ROOT, "muse_state_rounds.json")) as fh:
        want = json.load(fh)["A"]["at_the_contour"]
    raw, _ = mrs.state_arrays(mrs.STATE_DIR)
    arrays = mrs.reopen(raw)
    cube, tpl, _ = build_fixture(str(tmp_path))
    jproblem = mrs.jax_setup(cube, tpl, mrs.STATE_DIR, arrays)[0]
    got = mrs.live_decisions(mrs.port_problem(cube, tpl), cube, arrays,
                             MUSE_CANCEL, jproblem)
    yy = np.asarray(jproblem.data.yy)[arrays["running"]]
    assert yy.max() > 1e7 and got["spaxels"] == want["spaxels"] == 30
    assert got["held"], got
    for k, n in want["decisions_differ"].items():
        assert abs(got["decisions_differ"][k] - n) <= 0.1 * n, (k, got)


def test_loglike_paired_is_the_diagonal(mds):
    _, tmd = mds
    D = 8
    y, var = _noisy_data(5, D=D)
    tp = likelihood.make_muse_problem(tmd, y, var)
    u = torch.from_numpy(np.random.default_rng(5).uniform(
        0.05, 0.95, (D, 5)).astype(np.float32))
    u[2, 2] = 0.0  # a dead row: -inf in both
    x = tp.transform_batch(u)
    paired = tp.loglike_paired(x).numpy()
    full = np.diagonal(tp.loglike(x).numpy())
    assert np.isneginf(paired[2]) and np.isneginf(full[2])
    # one product against the same weights, summed in another order
    np.testing.assert_allclose(paired, full, rtol=1e-5)
    assert tp.predict_one(x[3]).shape == (NSPEC,)


@pytest.mark.parametrize("zsol", [False, True])
def test_problem_from_numpy_scores_like_jax(mds, zsol):
    jmd, _ = mds
    y, var = _noisy_data(2)
    jp = jax_lik.make_muse_problem(jmd, y, var, zsol=zsol)
    arrays = {k: np.asarray(v) for k, v in vars(jp.data.md).items()}
    arrays.update(y_over_v=np.asarray(jp.data.y_over_v),
                  inv_v=np.asarray(jp.data.inv_v), yy=np.asarray(jp.data.yy))
    tp = problem_from_numpy(arrays, "muse_zsol" if zsol else "muse")
    assert (tp.ndim, tp.ndata, tp.zsol) == (jp.ndim, jp.ndata, zsol)
    u, _ = _corner_params(jmd, zsol, seed=3)
    xj = np.array(jp.transform_batch(jnp.asarray(u)))
    xt = tp.transform_batch(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=2 * np.finfo(np.float32).eps,
                               atol=1e-7)
    want = np.asarray(jp.loglike(jnp.asarray(xj)), np.float64)
    got = tp.loglike(torch.from_numpy(xj)).numpy().astype(np.float64)
    _assert_like_close(got, want, arrays["yy"].astype(np.float64))


def test_load_template_grid_refuses_bad_grids(tmp_path, tpl_files):
    files = synth.make_template_files(str(tmp_path / "t24"), n_ages=24)
    with pytest.raises(ValueError, match="age columns"):
        model.load_template_grid(files)
    ages = np.loadtxt(str(tmp_path / "t24" / "ages.txt"))
    assert model.load_template_grid(files, ages=ages).ages.shape == (24,)
    with pytest.raises(ValueError, match="age columns"):
        model.load_template_grid(files, ages=ages[:-1])
    # a non-uniform wavelength column without the uniform resample
    bent = []
    for i, f in enumerate(tpl_files[:2]):
        data = np.loadtxt(f)
        data[:, 0] = np.geomspace(3000.0, 9000.0, len(data))
        bent.append(str(tmp_path / f"bent{i}.txt"))
        np.savetxt(bent[-1], data)
    with pytest.raises(ValueError, match="uniform"):
        model.load_template_grid(bent, uniform_oversample=0)
    md = model.load_template_grid(tpl_files[:2], uniform_oversample=0)
    assert md.model_wl.shape == (400,)


def test_make_model_cube_matches_jax(tmp_path, tpl_files):
    outs = {}
    for name, mod in (("jax", jax_synth), ("torch", synth)):
        d = tmp_path / name
        d.mkdir()
        mod.make_model_cube(str(d / "c.fits"), str(d / "s.reg"), tpl_files,
                            str(d / "t.json"), ny=3, nx=4, nspec=120, seed=7,
                            cd3=30.0)
        with open(d / "t.json") as fh:
            truths = json.load(fh)
        cube = get_hdu(fits_open(str(d / "c.fits")), "DATA").data
        outs[name] = (cube, truths, (d / "s.reg").read_text())
    (cj, tj, rj), (ct, tt, rt) = outs["jax"], outs["torch"]
    assert rj == rt and tj["empty"] == tt["empty"]
    assert tj["params"] == tt["params"]
    # amplitude and flux carry the model's f32 row error (MODEL_RTOL)
    np.testing.assert_allclose(tt["amp"], tj["amp"], rtol=MODEL_RTOL)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=MODEL_RTOL * np.abs(cj).max())
    np.testing.assert_allclose(tt["yy"], tj["yy"], rtol=1e-5)


@pytest.fixture(scope="module")
def small_fits(tmp_path_factory, tpl_files):
    """One 16-spaxel model-family cube, fitted by both packages."""
    from massivedatans_tpu.muse.pipeline import run_musefit as jax_run_musefit

    d = tmp_path_factory.mktemp("fit")
    cube, reg, truths = synth.make_model_cube(
        str(d / "c.fits"), str(d / "s.reg"), tpl_files, str(d / "t.json"),
        ny=4, nx=4, nspec=NSPEC, seed=5, cd3=CD3, flux_lo=0.05, flux_hi=0.3)
    kw = dict(nlive=60, max_samples=0, progress=False, bad_windows=[],
              cfg_overrides=FIT_OVERRIDES)
    port = run_musefit(cube, reg, 0.0, 0.5, tpl_files,
                       out_prefix=str(d / "port"), device="cpu", **kw)[0]
    ref = jax_run_musefit(cube, reg, 0.0, 0.5, tpl_files,
                          out_prefix=str(d / "jax"), **kw)[0]
    with open(truths) as fh:
        return port, ref, json.load(fh), str(d / "port.hdf5")


def test_run_musefit_writes_the_schema(small_fits):
    port, _, _, path = small_fits
    with h5py.File(path) as f:
        assert set(f.keys()) == SCHEMA
        assert f["u"].shape[1:] == (16, 5) and f["logZ"].shape == (16,)
        np.testing.assert_array_equal(f["fiberids"][()], np.arange(16))
        assert int(f["ndata"][()]) == 16 and float(f["duration"][()]) > 0


def test_run_musefit_logZ_matches_jax_and_empty_identity(small_fits):
    port, ref, truths, _ = small_fits
    assert np.isfinite(port.logZ).all() and (port.logZerr > 0).all()
    tol = 3.0 * np.hypot(port.logZerr, ref.logZerr) + 1.0
    agree = np.abs(port.logZ - ref.logZ) <= tol
    assert agree.sum() >= int(np.ceil(0.9 * len(agree))), \
        (port.logZ, ref.logZ, tol)
    # no-star identity: the evidence of pure noise is ~ -yy/2
    empty = np.asarray(truths["empty"], bool)
    yy = np.asarray(truths["yy"], np.float64)
    assert empty.any()
    assert abs(np.median(port.logZ[empty] + yy[empty] / 2)) <= 1.0


def test_run_musefit_unported_options_raise(tmp_path):
    """A mesh that is not a torch.distributed DeviceMesh is refused before
    the cube is read (the mesh path: tests/test_torch_cli.py and
    tests/test_torch_parallel.py)."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_musefit("missing.fits", None, 0.0, 0.5, [], device="cpu",
                    mesh=object())


def test_fit_muse_in_fresh_process_imports_no_jax():
    code = (
        "import sys, tempfile, numpy as np\n"
        "from massivedatans_tpu_torch.config import RunConfig\n"
        "from massivedatans_tpu_torch.muse import synth\n"
        "from massivedatans_tpu_torch.muse.pipeline import fit_muse, load_muse_cube\n"
        "d = tempfile.mkdtemp()\n"
        "tpl = synth.make_template_files(d + '/tpl', n_wl=100)\n"
        "c, r, t = synth.make_model_cube(d + '/c.fits', d + '/s.reg', tpl, "
        "d + '/t.json', ny=2, nx=2, nspec=80, cd3=50.0)\n"
        "cube = load_muse_cube(c, r, bad_windows=[])\n"
        "res, prob = fit_muse(cube, tpl, 0.0, 0.5, 'ZSOL', "
        "RunConfig(nlive_points=30, max_samples=60), device='cpu')\n"
        "assert np.isfinite(res.logZ).all() and prob.ndim == 4, res.logZ\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'massivedatans_tpu' not in sys.modules, sorted(sys.modules)\n"
        "print('ok', res.niterations)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
