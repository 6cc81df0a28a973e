"""CLI surface of the port: gen -> fit -> check -> refine -> plot-*,
musefit, the device switch, and a fresh process that runs the port
without importing JAX."""

import json
import os
import subprocess
import sys
import types

import h5py
import numpy as np
import pytest
import torch

from massivedatans_tpu_torch import cli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference output schema (massivedatans_tpu/io/hdf5io.py:85), plus the
# per-dataset truncation flag write_results adds
SCHEMA = {"logZ", "logZerr", "u", "x", "L", "w", "mask", "ndraws", "stalled"}


def test_gen_fit_check_roundtrip(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cli.main(["gen", "horns", "64"])
    assert os.path.exists("data_widths_64.hdf5")
    cli.main(["fit", "data_widths_64.hdf5", "4", "--nlive", "50",
              "--device", "cpu", "--quiet"])
    out = "data_widths_64.hdf5_MLFRIENDS_nlive50_4.out8.hdf5"
    assert os.path.exists(out)
    assert os.path.exists("data_widths_64.hdf5_MLFRIENDS_nlive50_4.out8.stats.json")
    with h5py.File(out) as f:
        assert set(f.keys()) == SCHEMA
        assert f["u"].shape[1:] == (4, 3) and f["logZ"].shape == (4,)
    cli.main(["check", out, "--max-datasets", "2"])
    text = capsys.readouterr().out
    assert "logZ[0]" in text and "dataset 1:" in text


def test_fit_with_slice_constrainer_writes_reference_schema(tmp_path,
                                                            monkeypatch):
    """CONSTRAINER picks the strategy, as for the JAX CLI, and names the
    output file."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CONSTRAINER", "SLICE")
    cli.main(["gen", "horns", "32"])
    cli.main(["fit", "data_widths_32.hdf5", "3", "--nlive", "40",
              "--max-samples", "150", "--device", "cpu", "--quiet"])
    out = "data_widths_32.hdf5_SLICE_nlive40_3.out8.hdf5"
    with h5py.File(out) as f:
        assert set(f.keys()) == SCHEMA
        assert f["u"].shape[1:] == (3, 3) and f["logZ"].shape == (3,)
        assert f["mask"].shape[0] == f["u"].shape[0]
        assert (f["logZerr"][()] > 0).all()


def test_default_cuda_device_without_card_exits(tmp_path, monkeypatch):
    """--device defaults to cuda; with no card the fit stops with a message
    instead of running on the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cli.main(["gen", "horns", "16"])
    with pytest.raises(SystemExit) as exc:
        cli.main(["fit", "data_widths_16.hdf5", "2", "--nlive", "20"])
    assert exc.value.code not in (0, None)
    assert "cuda" in str(exc.value.code) and "--device cpu" in str(exc.value.code)
    assert not any(p.endswith(".out8.hdf5") for p in os.listdir("."))


def test_unported_subcommands_raise(tmp_path):
    """Only the multi-device options (ROADMAP item 15) are refused."""
    with pytest.raises(NotImplementedError, match="item 15"):
        cli.main(["fit", "d.hdf5", "2", "--device", "cpu", "--devices", "2"])


def test_gen_fit_check_refine_plot_roundtrip(tmp_path, monkeypatch, capsys):
    """tests/test_cli.py::test_gen_fit_check_refine_roundtrip on the port,
    with its sizes and asserted lines, then every plot-* subcommand."""
    monkeypatch.chdir(tmp_path)
    cli.main(["gen", "horns", "50", "--out", "d.hdf5"])
    monkeypatch.setenv("NLIVE_POINTS", "50")
    monkeypatch.setenv("MAXSAMPLES", "250")
    cli.main(["fit", "d.hdf5", "4", "--device", "cpu", "--quiet"])
    out_file = "d.hdf5_MLFRIENDS_nlive50_4.out8.hdf5"
    assert os.path.exists(out_file)
    cli.main(["check", out_file, "--max-datasets", "2"])
    text = capsys.readouterr().out
    assert "logZ[0]" in text and "dataset 1:" in text

    cli.main(["refine", "d.hdf5", out_file, "--device", "cpu",
              "--num-warmup", "40", "--num-samples", "40",
              "--vi-steps", "60", "--max-datasets", "2"])
    text = capsys.readouterr().out
    assert "HMC: mean accept" in text
    assert "VI: median |logZ_IW - logZ_NS|" in text
    assert "  dataset 1: p0=" in text and "  dataset 1: logZ_IW=" in text
    assert "dataset 2:" not in text

    cli.main(["plot-posterior", out_file, "--out", "post.pdf"])
    cli.main(["plot-muse-posterior", out_file, "--min-finite", "10",
              "--size", "500", "--prefix", "mp"])
    cli.main(["plot-evidences", "d.hdf5", out_file, "--out", "ev.pdf"])
    cli.main(["plot-bestfit", "d.hdf5", out_file, "--datasets", "0", "3",
              "--prefix", "bf"])
    with open("d.hdf5_MLFRIENDS_nlive50_4.out8.stats.json") as fh:
        stats = json.load(fh)
    with open("s2.json", "w") as fh:
        json.dump(dict(stats, ndata=40, ndraws=3 * stats["ndraws"]), fh)
    cli.main(["plot-scaling", "d.hdf5_MLFRIENDS_nlive50_4.out8.stats.json",
              "s2.json", "--out", "sc.pdf"])
    for path in ("post.pdf", "mp_1.pdf", "mp_4.pdf", "ev.pdf", "bf_0.pdf",
                 "bf_3.pdf", "sc.pdf"):
        assert os.path.getsize(path) > 0, path
    text = capsys.readouterr().out
    assert "median log10 B = " in text and "wrote 2 plots" in text
    assert "plotted 4 datasets" in text and "-> wrote sc.pdf" in text


def test_refine_picks_the_jax_cli_rows(tmp_path, monkeypatch):
    """``refine_init_u`` picks, from a fixed fit file, the rows that the
    JAX CLI's ``refine`` picks (``massivedatans_tpu/cli.py:297-305``, run
    on the same files with its HMC stubbed to catch them), bit for bit."""
    import massivedatans_tpu.infer as jax_infer
    from massivedatans_tpu import cli as jax_cli
    from massivedatans_tpu_torch.datagen.generators import gen_horns, save_dataset
    from massivedatans_tpu_torch.io.hdf5io import read_results, write_results

    monkeypatch.chdir(tmp_path)
    save_dataset(gen_horns(20), "d.hdf5")
    rng = np.random.default_rng(11)
    n, D, ndim = 60, 5, 3
    L = rng.normal(-50, 3, size=(n, D)).astype(np.float32)
    L[7, 2] = -np.inf  # an inactive row
    result = types.SimpleNamespace(
        logZ=rng.normal(size=D), logZerr=rng.uniform(0.1, 0.3, D),
        u=rng.uniform(size=(n, D, ndim)).astype(np.float32),
        x=rng.uniform(size=(n, D, ndim)).astype(np.float32), L=L,
        w=-np.linspace(0, 6, n)[:, None].repeat(D, 1).astype(np.float32),
        mask=np.ones((n, D), bool), ndraws=99, duration=1.0, stats={})
    write_results("f", result)

    caught = {}

    class Caught(Exception):
        pass

    def stub(problem, key, init_u=None, **kw):
        caught["init_u"] = np.asarray(init_u)
        raise Caught

    monkeypatch.setattr(jax_infer, "run_hmc", stub)
    with pytest.raises(Caught):
        jax_cli.main(["refine", "d.hdf5", "f.hdf5", "--backend", "hmc"])
    want = caught["init_u"]
    got = cli.refine_init_u(read_results("f.hdf5"), ndim)
    assert got.dtype == want.dtype == np.float32 and got.shape == (D, ndim)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cli.refine_init_u(result, ndim), want)


def test_refine_default_cuda_device_without_card_exits(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        cli.main(["refine", "d.hdf5", "out.hdf5"])
    assert "--device cpu" in str(exc.value.code)


@pytest.fixture
def tiny_cube(tmp_path, monkeypatch):
    from massivedatans_tpu_torch.muse import synth

    monkeypatch.chdir(tmp_path)
    tpl = synth.make_template_files("tpl", n_wl=100)
    synth.make_model_cube("cube.fits", "sel.reg", tpl, "truths.json",
                          ny=2, nx=3, nspec=80, cd3=50.0)
    return tpl


def test_musefit_roundtrip(tiny_cube, capsys):
    cli.main(["musefit", "cube.fits", "sel.reg", "0", "0.5", *tiny_cube,
              "--device", "cpu", "--nlive", "30", "--max-samples", "80"])
    out = "cube.fits_full_.out_6.hdf5"
    with h5py.File(out) as f:
        assert set(f.keys()) == SCHEMA | {"fiberids", "duration", "ndata"}
        assert f["u"].shape[1:] == (6, 5) and f["logZ"].shape == (6,)
        assert int(f["ndata"][()]) == 6 and len(f["fiberids"]) == 6
    assert "logZ = " in capsys.readouterr().out


@pytest.mark.parametrize("flags, item", [
    (["--devices", "2"], "15"),
    (["--model-parallel", "2"], "15"),
])
def test_musefit_unported_options_raise(tiny_cube, flags, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        cli.main(["musefit", "cube.fits", "sel.reg", "0", "0.5", *tiny_cube,
                  "--device", "cpu", *flags])
    assert not any(p.endswith(".hdf5") for p in os.listdir("."))


def test_run_fit_in_fresh_process_imports_no_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "from massivedatans_tpu_torch.config import RunConfig\n"
        "from massivedatans_tpu_torch.datagen.generators import gen_horns\n"
        "from massivedatans_tpu_torch.cli import run_fit\n"
        "d = gen_horns(16)\n"
        "r = run_fit(d['x'], d['y'][:, :2], RunConfig(nlive_points=30, "
        "max_samples=60), 'cpu')\n"
        "assert np.isfinite(r.logZ).all(), r.logZ\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "pkg = sorted(m for m in sys.modules if m.split('.')[0] == 'massivedatans_tpu')\n"
        "assert not pkg, pkg\n"
        "print('ok', r.niterations)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
