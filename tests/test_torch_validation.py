"""The reference's validation protocols on the port, at small sizes on the
CPU: the counterparts of the JAX package's slow end-to-end oracles
(``tests/test_engine_e2e.py``: the no-signal Bayes factors and the horns
line-position recovery), the statistics of the three validation tools
held against the JAX tools' arithmetic on the same inputs, each tool end
to end with ``--device cpu``, and the JAX package's records that the
tools read (``tools/jax_validation_records.py``, the JAX MUSE run's
checkpoint) checked against the port's generators."""

import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from massivedatans_tpu_torch.cli import run_fit
from massivedatans_tpu_torch.config import RunConfig
from massivedatans_tpu_torch.datagen.generators import (
    gen_horns,
    gen_nothing,
    gen_simple,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# tests/test_engine_e2e.py's SMALL
SMALL = RunConfig(
    nlive_points=100,
    proposal_batch=256,
    eval_batch=64,
    shelf_capacity=4,
    chunk_iters=25,
    tolerance=0.5,
    max_fill_rounds=512,
)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_nothing_suite_bayes_factors():
    """tests/test_engine_e2e.py::test_nothing_suite_bayes_factors on the
    port: the line model on pure noise stays within a few nats of the
    analytic no-signal evidence, its median B (nats) in (-4.2, -1.2)
    around the reference's -2.71 on the same data."""
    data = gen_nothing(16)
    logZ0 = np.sum(-0.5 * (data["y"] / 0.01) ** 2, axis=0)
    result = run_fit(data["x"], data["y"], SMALL, "cpu",
                     noise_level=data["noise_level"], generator=_gen(5))
    B = result.logZ - logZ0
    assert np.isfinite(B).all()
    assert (B > -8.0).all() and (B < 4.0).all(), B
    assert -4.2 < np.median(B) < -1.2, B


def test_horns_posterior_recovers_line_position():
    """tests/test_engine_e2e.py::test_horns_posterior_recovers_line_position
    on the port: the posterior mean of mu lies on the injected line for the
    first 12 spectra of gen_horns(200) with a narrow-line SNR above 6."""
    data = gen_horns(200)
    snr = data["height_narrow"] / data["noise_level"]
    bright = np.where(snr > 6)[0][:12]
    assert len(bright) >= 4, len(bright)
    result = run_fit(data["x"], data["y"][:, bright], SMALL, "cpu",
                     noise_level=data["noise_level"], generator=_gen(7))
    w = result.w + result.L
    errs = []
    for d in range(len(bright)):
        wd = w[:, d].astype(np.float64)
        wd[~np.isfinite(wd)] = -np.inf
        p = np.exp(wd - wd.max())
        p /= p.sum()
        mu_mean = (p * result.x[:, d, 1]).sum()
        mu_sd = np.sqrt((p * (result.x[:, d, 1] - mu_mean) ** 2).sum())
        errs.append((mu_mean - data["mean_narrow"][bright[d]])
                    / max(mu_sd, 0.05))
    errs = np.array(errs)
    assert np.abs(errs).max() < 6.0, errs
    assert np.abs(errs).mean() < 2.5, errs


# --- the records the tools read ---------------------------------------


@pytest.mark.parametrize("name, gen, n_gen, ndata", [
    ("calib_jax_nothing100.json", gen_nothing, 1000, 100),
    ("calib_jax_nothing10000.json", gen_nothing, 10000, 10000),
    ("recovery_jax_simple100.json", gen_simple, 100, 100),
])
def test_record_digest_is_the_port_generators_stream(name, gen, n_gen, ndata):
    """Each JAX record's input digest is that of the port's generator
    stream, recomputed here."""
    calib = _load_tool("torch_calib_parity")
    with open(os.path.join(ROOT, name)) as fh:
        rec = json.load(fh)
    data = gen(n_gen)
    y = np.asarray(data["y"])[:, :ndata]
    digest = calib.stream_sha256(data["x"], y)
    assert rec["input_sha256"] == digest
    assert rec["platform"] == "cpu" and rec["n_gen"] == n_gen
    if "keys" in rec:
        assert set(rec["keys"]) == {"1", "2"}
        for k in rec["keys"].values():
            assert len(k["constrained"]) == len(k["z_mean"]) \
                == len(k["z_sigma"]) > 0
            assert k["wall_s"] > 0
        assert 0 < rec["key2_vs_key1"]["share"] <= 1
    else:
        assert rec["ndata"] == ndata and rec["wall_s"] > 0
        if ndata <= 1000:
            assert len(rec["logZ"]) == len(rec["logZerr"]) == ndata


def test_muse_rounds_record_is_the_port_fixture(tmp_path):
    """The CPU record of ``tools/jax_muse_rounds.py`` fitted the port's
    MUSE fixture at its size, and holds a fit of each package for every
    option set and seed, with ratios and rates that follow from its
    counts."""
    tool = _load_tool("torch_muse_validate")
    rounds = _load_tool("jax_muse_rounds")
    with open(os.path.join(ROOT, "muse_rounds_cpu.json")) as fh:
        rec = json.load(fh)
    packages, options = ("jax", "torch"), rounds.OPTION_SETS
    cube, _, _ = tool.build_fixture(str(tmp_path), rec["side"], rec["nspec"])
    assert rec["cube_sha256"] == rounds.cube_sha256(cube)
    fits = {(f["package"], f["options"], f["seed"]): f for f in rec["fits"]}
    assert set(fits) == {(p, o, s) for p in packages for o in options
                         for s in rec["seeds"]}
    for (p, o, s), f in fits.items():
        assert f["evals_per_round"] == pytest.approx(
            f["ndraws"] / f["fill_rounds"])
        assert len(f["termination_iters"]) == rec["side"] ** 2
        if o == "budget":
            assert f["niter"] <= rec["cap"] + 1
            assert f["running_at_cap"] == sum(
                t > rec["cap"] for t in f["termination_iters"])
        if p == "torch":
            ratio = rec["port_over_jax"][f"{o} seed {s}"]
            assert ratio["ndraws"] == pytest.approx(
                f["ndraws"] / fits["jax", o, s]["ndraws"])


def test_jax_muse_run_counts_read_from_its_checkpoint():
    """The leaves that ``tools/torch_muse_validate.py`` reads from the JAX
    run's checkpoint are the EngineState fields it names (their flattened
    order), and their values are the run's recorded stats: the run
    stopped one iteration past a 7,000-iteration cap with 30 spaxels
    still running."""
    from massivedatans_tpu.ns.engine import EngineState
    from massivedatans_tpu.ns.shelves import Shelves

    tool = _load_tool("torch_muse_validate")
    index, i = {}, 0
    for field in EngineState._fields:
        index[field] = i
        i += len(Shelves._fields) if field == "shelves" else 1
    for name, leaf in tool.JAX_LEAVES.items():
        assert index[name] == leaf, name
    jax = tool.jax_run_counts()
    with open(os.path.join(ROOT, "MUSE_VALIDATION.json")) as fh:
        rec = json.load(fh)["extra"]
    assert jax["ndraws"] == rec["ndraws"] == rec["stats"]["ndraws"]
    assert jax["niter"] + 400 == rec["niter"]
    assert jax["niter"] == 7001 and (jax["term_iter"] == 7001).sum() == 30
    assert (jax["term_iter"] > 0).all()  # every spaxel stopped
    assert jax["fill_rounds"] / 140 == pytest.approx(
        jax["rounds_per_chunk"])


# --- the statistics against the JAX tools' arithmetic ----------------------


def test_calib_statistics_match_the_jax_tool():
    """log10 B is ``tools/calib_parity.py``'s arithmetic and the JAX
    package's ``postprocess.bayes_factors``; the paired count is the
    3-sigma rule."""
    from massivedatans_tpu import postprocess as jpost

    calib = _load_tool("torch_calib_parity")
    data = gen_nothing(50)
    rng = np.random.default_rng(3)
    logZ0 = (-0.5 * (data["y"] / data["noise_level"]) ** 2).sum(axis=0)
    logZ = logZ0 + rng.normal(-3.0, 1.0, 50)
    B = calib.log10_bayes(logZ, data["y"], data["noise_level"])
    assert np.array_equal(B, (logZ - logZ0) / np.log(10.0))
    np.testing.assert_allclose(
        B, jpost.bayes_factors(dict(logZ=logZ), data["y"],
                               data["noise_level"]), rtol=1e-12)
    st = calib.calib_stats(B)
    assert st == dict(median_log10B=float(np.median(B)),
                      max_log10B=float(B.max()),
                      frac_positive=float((B > 0).mean()))
    err = np.full(50, 0.2)
    ref = logZ + np.where(np.arange(50) < 10, 2.0, 0.5)  # 10 beyond 3 sigma
    assert calib.paired_within(logZ, err, ref, err) == 40


def _fake_line_result(rng, D=12, rows=300):
    """A result-like object whose posteriors over mu are narrow for most
    datasets and flat for some (unconstrained)."""
    x = rng.uniform(0.0, 1.0, (rows, D, 3)).astype(np.float32)
    centre = rng.uniform(450.0, 700.0, D)
    width = np.where(np.arange(D) % 4 == 3, 400.0, 5.0)
    x[:, :, 1] = (centre + width * rng.standard_normal((rows, D))).astype(
        np.float32)
    L = rng.normal(0.0, 1.0, (rows, D)).astype(np.float32)
    w = np.full((rows, D), -np.log(rows), np.float32)
    return types.SimpleNamespace(logZ=np.zeros(D), x=x, L=L, w=w), \
        (centre / 440.0 - 1.0) + rng.normal(0, 0.005, D)


def test_recovery_statistics_match_the_jax_tool():
    """The port tool's recovery statistics are the JAX tool's arithmetic
    through the JAX package's postprocess, on the same result; the bars
    follow the record's numbers."""
    from massivedatans_tpu import postprocess as jax_postprocess

    tool = _load_tool("torch_posterior_recovery")
    rng = np.random.default_rng(5)
    res, z_true = _fake_line_result(rng)
    ours = tool.recovery_stats(res, z_true)
    assert ours == tool.recovery_stats(res, z_true, jax_postprocess)
    assert 0 < len(ours["constrained"]) < 12
    other = dict(ours, z_mean=list(np.asarray(ours["z_mean"]) + 1.0))
    assert tool.agreement(ours, ours) == dict(
        share=1.0, n_both=len(ours["constrained"]), n_differ=0)
    assert tool.agreement(ours, other)["share"] == 0.0
    jax = dict(keys={"1": ours}, key2_vs_key1=dict(share=1.0))
    agree, held = tool.recovery_bars(ours, jax)
    assert all(held.values()) and agree["share"] == 1.0
    worse = dict(ours, ks_stat=ours["ks_stat"] + 0.06,
                 median_abs_z_err=ours["median_abs_z_err"] * 1.6,
                 constrained=ours["constrained"][3:],
                 z_mean=list(np.asarray(ours["z_mean"][3:]) + 1.0),
                 z_sigma=ours["z_sigma"][3:])
    assert not any(tool.recovery_bars(worse, jax)[1].values())


@pytest.fixture(scope="module")
def tiny_muse_fit(tmp_path_factory):
    """The tiny model-family cube (3x3, nspec 100, 100-wavelength
    templates, faint) fitted to tolerance at nlive 50 on the CPU."""
    from massivedatans_tpu_torch.muse.pipeline import fit_muse

    tool = _load_tool("torch_muse_validate")
    tmp = tmp_path_factory.mktemp("muse")
    cube, tpl, truths = tool.build_fixture(str(tmp), side=3, nspec=100,
                                           flux=(0.05, 0.3), n_wl=100)
    result, _ = fit_muse(cube, tpl, 0.0, 0.5, "FULL",
                         RunConfig(nlive_points=50, tolerance=0.5),
                         device="cpu", generator=_gen(1))
    return tmp, truths, result


def test_muse_analysis_is_the_jax_tools_but_for_the_capped_class(
        tiny_muse_fit, monkeypatch):
    """The JAX tool's ``analyze``, its NLIVE patched to the fit's, reading
    the tiny fit written by the port's hdf5io, gives the port tool's
    in-memory analysis exactly with the JAX tool's capped class; the
    port's class (no cap: nothing capped) differs from it only on the
    spaxels that stopped at the last iteration, which the JAX tool
    files as capped."""
    from massivedatans_tpu_torch.io.hdf5io import write_results

    tmp, truths, result = tiny_muse_fit
    tool = _load_tool("torch_muse_validate")
    monkeypatch.setattr(sys, "argv", ["muse_validate.py"])  # read at import
    jtool = _load_tool("muse_validate")
    monkeypatch.setattr(jtool, "NLIVE", 50)
    prefix = str(tmp / "fit")
    write_results(prefix, result)
    truths_path = str(tmp / "truths_9.json")
    theirs = jtool.analyze(prefix, truths_path, {}, 0.0)
    out = dict(logZ=result.logZ, x=result.x, L=result.L, w=result.w,
               mask=result.mask)
    n = result.niterations
    capped = tool.capped_mask(result.mask, n, 0)
    assert not capped.any()
    jax_capped = result.mask[n - 1].astype(bool)  # muse_validate.py:116
    ran = tool.termination_iters(result.mask, n)
    assert np.array_equal(jax_capped, ran == n)
    assert np.array_equal(tool.capped_mask(result.mask, n, n - 1), ran == n)
    assert tool.analyze(out, truths, jax_capped, 50) == theirs
    ours = tool.analyze(out, truths, capped, 50)
    empty = np.asarray(truths["empty"], bool)
    assert ours["extra"]["n_capped"] == 0
    assert theirs["extra"]["n_capped"] == int((jax_capped & ~empty).sum())
    same = ("sbc_rank_ks", "pull_coverage", "zbin_mode_accuracy",
            "zbin_mode_within1", "empty_evidence_identity",
            "goodness_of_fit", "n_fit")
    assert {k: ours["extra"][k] for k in same} == {
        k: theirs["extra"][k] for k in same}
    held = tool.bars(ours)
    assert set(held) == {"identity", "chi2_dof", "chi2_z_below_5",
                         "coverage_3sigma_z", "coverage_3sigma_EBV"}
    assert held["identity"]


def test_muse_bars_and_late_run():
    """The MUSE bars at the JAX run's own numbers hold, and each fails
    past its limit; ``late_run`` differences the pieces' counts."""
    tool = _load_tool("torch_muse_validate")
    with open(os.path.join(ROOT, "MUSE_VALIDATION.json")) as fh:
        jax = json.load(fh)
    assert all(tool.bars(jax).values())
    bad = json.loads(json.dumps(jax))
    ex = bad["extra"]
    ex["empty_evidence_identity"]["median_logZ_plus_half_yy"] = 1.2
    ex["goodness_of_fit"].update(median_chi2_over_dof=1.03,
                                 frac_chi2_z_below_5=0.9)
    ex["pull_coverage"]["z"]["frac_within_3sigma"] = 0.7
    ex["pull_coverage"]["EBV"] = {"n_constrained": 2}
    assert not any(tool.bars(bad).values())
    rows = tool.late_run([dict(niter=100, fill_rounds=50, ndraws=640,
                               running=5),
                          dict(niter=150, fill_rounds=250, ndraws=3200,
                               running=2)], eval_batch=128)
    assert rows[1] == dict(iterations=[100, 150], running=2,
                           rounds_per_iter=4.0, evals_per_round=12.8,
                           valid_share=0.1)


# --- each tool end to end on the CPU -----------------------------------


def test_calib_tool_end_to_end(tmp_path, capsys):
    """Both runs at a tiny size: statistics and launches reported, no bar
    (the streams are not the records')."""
    tool = _load_tool("torch_calib_parity")
    out = tmp_path / "calib.json"
    assert tool.main(["--device", "cpu", "--n-gen", "20", "--ndata", "6",
                      "--headline-n", "8", "--nlive", "50",
                      "--out", str(out)]) == 0
    with open(out) as fh:
        rec = json.load(fh)
    assert rec["bars"] == {} and rec["card"] is None
    for name, nd in (("paired", 6), ("headline", 8)):
        r = rec["runs"][name]
        assert r["ndata"] == nd and r["chunk_path"] == "eager"
        assert r["rows"] == r["niter"] + 50 and r["ndraws"] > 0
        assert r["max_log10B"] >= r["median_log10B"]
        assert set(r["launches"]) == {"count_within",
                                      "bootstrapped_sq_radius"}
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["bars"] == {}


def test_calib_bars_apply_to_the_record_stream(monkeypatch):
    """On the record's stream the paired bars are all four; each fails
    when its number is moved past its limit."""
    tool = _load_tool("torch_calib_parity")
    with open(os.path.join(ROOT, tool.PAIRED_RECORD)) as fh:
        jax = json.load(fh)
    res = types.SimpleNamespace(logZ=np.asarray(jax["logZ"]),
                                logZerr=np.asarray(jax["logZerr"]))
    rec = dict(input_sha256=jax["input_sha256"], config=tool.PAIRED_CFG,
               ndata=100, median_log10B=jax["median_log10B"],
               max_log10B=jax["max_log10B"])
    held = tool.paired_bars(rec, res)
    assert len(held) == 4 and all(held.values()) and rec["paired_within"] == 100
    rec.update(median_log10B=jax["median_log10B"] + 0.2, max_log10B=0.1)
    res.logZ = res.logZ + np.where(np.arange(100) < 6, 5.0, 0.0)
    assert not any(tool.paired_bars(rec, res).values())
    assert tool.paired_bars(dict(rec, input_sha256="0"), res) == {}
    with open(os.path.join(ROOT, tool.HEADLINE_RECORD)) as fh:
        big = json.load(fh)
    head = dict(input_sha256=big["input_sha256"], config={}, rows=2700,
                ndraws=33675, median_log10B=big["median_log10B"])
    assert all(tool.headline_bars(dict(head)).values())
    assert not any(tool.headline_bars(dict(
        head, rows=6000, ndraws=10000,
        median_log10B=big["median_log10B"] - 0.2)).values())


def test_recovery_tool_end_to_end(tmp_path):
    """gen_simple at a tiny size and nlive, capped: the statistics
    reported, no bar (the stream is not the record's)."""
    tool = _load_tool("torch_posterior_recovery")
    out = tmp_path / "rec.json"
    assert tool.main(["--device", "cpu", "--n", "4", "--nlive", "30",
                      "--max-samples", "300", "--out", str(out)]) == 0
    with open(out) as fh:
        rec = json.load(fh)
    assert rec["bars"] == {} and rec["n"] == 4
    assert 0 < rec["n_constrained"] <= 4 and rec["chunk_path"] == "eager"
    assert 0 <= rec["ks_stat"] <= 1 and rec["median_abs_z_err"] >= 0


def test_muse_tool_end_to_end_in_pieces(tmp_path, capsys):
    """The MUSE tool on the tiny cube, capped, in two pieces through its
    checkpoint: exit 75, then the analysis of the finished fit with the
    counts beside the JAX run's and a late-run row per piece."""
    tool = _load_tool("torch_muse_validate")
    ck, out = tmp_path / "ck", tmp_path / "v.json"
    argv = ["--device", "cpu", "--side", "3", "--nspec", "100", "--n-wl",
            "100", "--nlive", "50", "--flux", "0.05", "0.3",
            "--max-samples", "120", "--checkpoint-dir", str(ck),
            "--max-chunks", "1", "--out", str(out)]
    assert tool.main(argv) == tool.INTERRUPTED
    assert not out.exists()
    rc = tool.main(argv[:-4] + ["--max-chunks", "5", "--out", str(out)])
    assert rc in (0, 1)
    with open(out) as fh:
        rec = json.load(fh)["extra"]
    assert [p["chunks"][0] for p in rec["pieces"]] == [0, 1]
    assert rec["pieces"][0]["chunks"][1] == 1
    assert len(rec["late_run"]) == 2 and rec["niter"] == 121
    assert rec["terminated_by"] == "max_samples_cap" and rec["n_capped"] >= 1
    assert rec["termination_iter_quantiles"]["100"] == 121
    assert rec["jax_run"]["niter"] == 7001 and rec["at_jax_stop"] is None
    assert set(rec["bars"]) == {"identity", "chi2_dof", "chi2_z_below_5",
                                "coverage_3sigma_z", "coverage_3sigma_EBV"}
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["extra"]["niter"] == 121

