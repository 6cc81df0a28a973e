"""The port stands alone: it imports nothing of the JAX package or of JAX,
and its own copies of the JAX package's numpy modules give what the
originals give (same configs, arrays, files and labels)."""

import ast
import dataclasses
import filecmp
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from massivedatans_tpu import config as jax_config
from massivedatans_tpu.datagen import generators as jax_generators
from massivedatans_tpu.io import hdf5io as jax_hdf5io
from massivedatans_tpu.muse import fitsio as jax_fitsio
from massivedatans_tpu.muse import pipeline as jax_pipeline
from massivedatans_tpu.muse import regions as jax_regions
from massivedatans_tpu.muse import synth as jax_synth
from massivedatans_tpu.ns import subsets as jax_subsets
from massivedatans_tpu.utils import progress as jax_progress
from massivedatans_tpu_torch import config
from massivedatans_tpu_torch.datagen import generators
from massivedatans_tpu_torch.io import hdf5io
from massivedatans_tpu_torch.muse import fitsio, pipeline, regions, synth
from massivedatans_tpu_torch.ns import subsets
from massivedatans_tpu_torch.utils import progress

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "massivedatans_tpu_torch")
FORBIDDEN = ("massivedatans_tpu", "jax", "jaxlib")


# --- no import of the JAX package or of JAX ---------------------------------

def test_every_port_module_imports_in_a_fresh_process_without_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import massivedatans_tpu_torch as p\n"
        # __main__ runs the CLI when imported; the AST scan below covers it
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')\n"
        "         if not m.name.endswith('.__main__')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok") and int(proc.stdout.split()[1]) > 20


def test_infer_and_postprocess_import_without_jax_or_matplotlib():
    """The gradient backends and the post-processing copy import in a
    fresh process where matplotlib cannot be imported (as on the card's
    machine); the numbers still come, the plots say what is missing."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None  # import matplotlib -> ImportError\n"
        "import numpy as np, torch\n"
        "from massivedatans_tpu_torch import postprocess as pp\n"
        "from massivedatans_tpu_torch.infer import run_hmc, run_vi\n"
        "from massivedatans_tpu_torch.models.analytic import "
        "make_analytic_gaussian_problem\n"
        "out = dict(w=np.zeros((5, 2), np.float32), L=np.arange(10.0, "
        "dtype=np.float32).reshape(5, 2))\n"
        "assert abs(pp.posterior_weights(out, 1).sum() - 1) < 1e-12\n"
        "try:\n"
        "    pp.plot_corner(np.zeros((4, 2)))\n"
        "    raise SystemExit('plotted without matplotlib')\n"
        "except ImportError:\n"
        "    pass\n"
        "p = make_analytic_gaussian_problem(np.full((2, 3), 0.5))\n"
        "r = run_vi(p, torch.Generator().manual_seed(0), device='cpu', "
        "steps=3, iw_samples=4)\n"
        "assert torch.isfinite(r.logZ_iw).all()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_the_jax_package_or_jax_anywhere(path):
    """Every import statement, lazy ones inside functions included."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, node.lineno, name)


# --- RunConfig ---------------------------------------------------------------

def test_run_config_fields_and_defaults_match():
    assert dataclasses.asdict(config.RunConfig()) == \
        dataclasses.asdict(jax_config.RunConfig())
    assert [f.name for f in dataclasses.fields(config.RunConfig)] == \
        [f.name for f in dataclasses.fields(jax_config.RunConfig)]


@pytest.mark.parametrize("env, overrides", [
    ({}, {}),
    ({"NLIVE_POINTS": "123", "SUPERSET_DRAWS": "7", "MAXSAMPLES": "900",
      "MINSAMPLES": "5", "CONSTRAINER": "RADFRIENDS",
      "SLICE_DIRECTION": "random", "RADIUS_ESTIMATOR": "jackknife",
      "PHANTOM_POINTS": "3", "USE_GRAPH": "0", "MDT_EVAL_BATCH": "64",
      "MDT_EVAL_BATCH_MAX": "256", "MDT_REBUILD_DRAWS": "0"}, {}),
    ({"NLIVE_POINTS": "77"}, {"tolerance": 0.1, "nlive_points": 50}),
])
def test_run_config_from_env_matches(monkeypatch, env, overrides):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = config.RunConfig.from_env(**overrides)
    want = jax_config.RunConfig.from_env(**overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for ndata in (1, 16, 17, 5000):
        assert got.resolve_member_capacity(ndata) == \
            want.resolve_member_capacity(ndata)
        assert got.resolve_pile_capacity(ndata) == \
            want.resolve_pile_capacity(ndata)


def test_run_config_validation_matches():
    for kw in (dict(phantom_capacity=2, force_shrink=False),
               dict(radius_estimator="median")):
        with pytest.raises(ValueError):
            jax_config.RunConfig(**kw)
        with pytest.raises(ValueError):
            config.RunConfig(**kw)


def test_a_jax_package_run_config_is_turned_away():
    from massivedatans_tpu_torch.ns.strategies import make_strategy

    with pytest.raises(TypeError, match="asdict"):
        make_strategy(jax_config.RunConfig())
    cfg = config.RunConfig(**dataclasses.asdict(jax_config.RunConfig()))
    assert config.require_run_config(cfg) is cfg


# --- data generators -----------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(jax_generators.GENERATORS))
@pytest.mark.parametrize("seed", [None, 4])
def test_generators_bitwise_equal(kind, seed):
    got = generators.GENERATORS[kind](40, seed=seed)
    want = jax_generators.GENERATORS[kind](40, seed=seed)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
    assert generators.FILENAME_STEMS == jax_generators.FILENAME_STEMS


# --- HDF5 schema -------------------------------------------------------------------

def _result(seed):
    rng = np.random.default_rng(seed)
    n, D = 30, 4
    return types.SimpleNamespace(
        logZ=rng.normal(size=D), logZerr=rng.uniform(0.1, 0.3, D),
        u=rng.uniform(size=(n, D, 3)).astype(np.float32),
        x=rng.uniform(size=(n, D, 3)).astype(np.float32),
        L=rng.normal(size=(n, D)).astype(np.float32),
        w=rng.normal(size=(n, D)).astype(np.float32),
        mask=rng.uniform(size=(n, D)) < 0.8, ndraws=1234, duration=1.5,
        stats=dict(stalled=0, member_overflow=2, pile_peak=99,
                   interrupted=False,
                   stalled_mask=np.array([False, True, False, False])))


@pytest.mark.parametrize("writer, reader", [
    (hdf5io, jax_hdf5io), (jax_hdf5io, hdf5io)], ids=["port->jax", "jax->port"])
def test_results_files_read_across_packages(tmp_path, writer, reader):
    pytest.importorskip("h5py")
    result = _result(1)
    prefix = writer.output_prefix(str(tmp_path / "d.hdf5"), "MLFRIENDS", 50, 4)
    assert prefix == reader.output_prefix(str(tmp_path / "d.hdf5"),
                                          "MLFRIENDS", 50, 4)
    writer.write_results(prefix, result)
    out = reader.read_results(prefix)
    for k in ("logZ", "logZerr", "u", "x", "L", "w", "mask"):
        np.testing.assert_array_equal(out[k], getattr(result, k), err_msg=k)
    assert int(out["ndraws"]) == 1234
    with open(prefix + ".stats.json") as fh:
        stats = fh.read()
    assert '"n_stalled_datasets": 1' in stats


def test_load_spectra_matches(tmp_path):
    pytest.importorskip("h5py")
    path = str(tmp_path / "h.hdf5")
    generators.save_dataset(generators.gen_horns(12), path)
    for ndata in (0, 5):
        for a, b in zip(hdf5io.load_spectra(path, ndata),
                        jax_hdf5io.load_spectra(path, ndata)):
            np.testing.assert_array_equal(a, b)


# --- subset decomposition -------------------------------------------------------

def _live_idx(seed):
    """Datasets in blocks that share pile indices within a block only."""
    rng = np.random.default_rng(seed)
    K, D = 12, 40
    block = rng.integers(0, 6, size=D)
    live = block[None, :] * 1000 + rng.integers(0, 40, size=(K, D))
    return live.astype(np.int32), rng.uniform(size=D) < 0.8


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_component_labels_match(monkeypatch, native, seed):
    if native:
        assert subsets._load_native() is not None, "no host C++ compiler"
    else:
        monkeypatch.setattr(subsets, "_load_native", lambda: None)
    live, selected = _live_idx(seed)
    for sel, nlive in ((None, None), (selected, None), (selected, 3)):
        got = subsets.component_labels(live, sel, nlive)
        want = jax_subsets.component_labels(live, sel, nlive)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert subsets.component_labels(live)[1] > 1


def test_native_union_find_is_built_into_the_port():
    lib = subsets._load_native()
    assert lib is not None
    assert os.path.dirname(lib._name) == os.path.join(PKG, "_build")


def test_shelf_sparkline_matches():
    counts = np.arange(100) % 17
    for width in (8, 64, 200):
        assert progress.shelf_sparkline(counts, 16, width) == \
            jax_progress.shelf_sparkline(counts, 16, width)


# --- MUSE files ------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(n_wl=60), dict(n_wl=40, n_ages=12, nZ=2)])
def test_template_files_identical(tmp_path, kw):
    got = synth.make_template_files(str(tmp_path / "port"), **kw)
    want = jax_synth.make_template_files(str(tmp_path / "jax"), **kw)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    names = [os.path.basename(p) for p in got]
    if "n_ages" in kw:
        names.append("ages.txt")
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "port", tmp_path / "jax", names, shallow=False)
    assert match == names and not mismatch and not errors


def test_synthetic_cube_identical(tmp_path):
    synth.make_synthetic_cube(str(tmp_path / "p.fits"), str(tmp_path / "p.reg"),
                              nspec=50, ny=5, nx=4, seed=3)
    jax_synth.make_synthetic_cube(str(tmp_path / "j.fits"),
                                  str(tmp_path / "j.reg"), nspec=50, ny=5,
                                  nx=4, seed=3)
    assert filecmp.cmp(tmp_path / "p.fits", tmp_path / "j.fits", shallow=False)
    assert filecmp.cmp(tmp_path / "p.reg", tmp_path / "j.reg", shallow=False)


@pytest.mark.parametrize("screen, bad_windows", [
    (False, None), (True, []), (False, [(5, 9), (40, 60)])])
def test_load_muse_cube_matches(tmp_path, screen, bad_windows):
    cube_path, reg = synth.make_synthetic_cube(
        str(tmp_path / "c.fits"), str(tmp_path / "c.reg"), nspec=60, ny=6,
        nx=5, seed=2)
    kw = dict(maxdata=12, screen_outliers=screen, bad_windows=bad_windows)
    got = pipeline.load_muse_cube(cube_path, reg, **kw)
    want = jax_pipeline.load_muse_cube(cube_path, reg, **kw)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)
    np.testing.assert_array_equal(got.flat_positions(), want.flat_positions())
    assert pipeline.BAD_WINDOWS == jax_pipeline.BAD_WINDOWS


def test_fits_reader_matches(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"DATA": rng.normal(size=(3, 4, 5)), "STAT": rng.uniform(size=(3, 4, 5))}
    fitsio.fits_write(str(tmp_path / "p.fits"), arrays, {"CD3_3": 2.5})
    jax_fitsio.fits_write(str(tmp_path / "j.fits"), arrays, {"CD3_3": 2.5})
    assert filecmp.cmp(tmp_path / "p.fits", tmp_path / "j.fits", shallow=False)
    got = fitsio.fits_open(str(tmp_path / "p.fits"))
    want = jax_fitsio.fits_open(str(tmp_path / "p.fits"))
    for name in ("DATA", "STAT"):
        a, b = fitsio.get_hdu(got, name), jax_fitsio.get_hdu(want, name)
        assert a.header == b.header
        np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("text", [
    "image\ncircle(4,4,3)\n",
    "# comment\nimage\nbox(3,5,4,2,30)\n-circle(3,5,1)\n",
    "ellipse(5,4,3,2,15)\npolygon(1,1,8,2,5,7)\n",
])
def test_region_masks_match(text):
    np.testing.assert_array_equal(regions.parse_region_mask(text, (9, 8)),
                                  jax_regions.parse_region_mask(text, (9, 8)))
