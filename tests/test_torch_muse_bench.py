"""``tools/torch_muse_bench.py`` (the port's ``tools/muse_bench.py``) on
the CPU: its cube against the JAX package's, the tool at a tiny size with
a resume, and both packages' counts at ``tools/muse_bench.py``'s options
on a small cube (``tools/jax_muse_rounds.py --cube bench``).
"""

import json
import math
import os
import re
import sys

import numpy as np
import pytest
import torch

from massivedatans_tpu.muse import likelihood as jax_lik
from massivedatans_tpu.muse import pipeline as jax_pipeline
from massivedatans_tpu.muse import synth as jax_synth
from massivedatans_tpu.muse.fitsio import fits_open, get_hdu
from massivedatans_tpu_torch.muse import likelihood, pipeline, synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools import jax_muse_rounds  # noqa: E402
from tools import torch_muse_bench as bench  # noqa: E402
from tools.torch_muse_validate import ChunkRows  # noqa: E402

torch.set_num_threads(1)

# the tool's line: tools/muse_bench.py's fields and its .stats.json's,
# and the port's own
FIELDS = ("metric", "ndraws", "niter", "stalled", "member_overflow",
          "pile_peak", "wall_s", "evals_per_s", "fill_rounds",
          "group_refreshes", "n_groups_max", "labels_s", "tail_s",
          "peak_mem_GB", "launches", "options", "cube_sha256", "per_chunk",
          "legs", "jax_run", "paper", "bars", "advances",
          "evals_per_advance", "budget_bound_chunks",
          "first_budget_bound_chunk", "mean_budget", "advance_quantiles")
OPTIONS = ("n_spaxels", "nspec", "nlive", "cap", "eval_batch",
           "proposal_batch", "fill_budget", "chunk_iters", "lookahead",
           "fallback_rounds", "dispatch_target", "checkpoint_every", "seed")
CHUNK_FIELDS = ("chunk", "niter", "ndraws", "fill_rounds", "running",
                "member_overflow", "wall_s", "n_groups", "advances",
                "advances_total", "rounds", "budget", "budget_bound",
                "round_steps")
TINY = ["--device", "cpu", "--n-spaxels", "20", "--nspec", "64", "--nlive",
        "50", "--cap", "100"]


def test_bench_side_is_muse_bench_s():
    assert bench.bench_side(4223) == 77
    assert bench.bench_side(100) == 13 and bench.bench_side(1000) == 38


@pytest.mark.parametrize("side,nspec,maxdata", [(77, 32, 4223),
                                                (9, 3600, 50)])
def test_cube_and_selection_match_jax(tmp_path, side, nspec, maxdata):
    """Both packages' ``make_synthetic_cube`` and ``make_template_files``
    write the same arrays, and both ``load_muse_cube(maxdata,
    bad_windows=None)`` select the same spaxels in the same order with the
    same flux, variance (the real-MUSE bad windows inflated at nspec
    3600) and likelihood weights."""
    cubes = {}
    for name, mod, pipe in (("jax", jax_synth, jax_pipeline),
                            ("torch", synth, pipeline)):
        d = tmp_path / name
        d.mkdir()
        cube, reg = str(d / "c.fits"), str(d / "s.reg")
        mod.make_synthetic_cube(cube, reg, nspec=nspec, ny=side, nx=side,
                                seed=1)
        tpl = mod.make_template_files(str(d / "tpl"), n_wl=1200)
        hdus = fits_open(cube)
        cubes[name] = dict(
            data=get_hdu(hdus, "DATA").data, stat=get_hdu(hdus, "STAT").data,
            region=(d / "s.reg").read_text(),
            tpl=[np.loadtxt(f) for f in tpl],
            loaded=pipe.load_muse_cube(cube, reg, maxdata=maxdata,
                                       bad_windows=None))
    j, t = cubes["jax"], cubes["torch"]
    np.testing.assert_array_equal(t["data"], j["data"])
    np.testing.assert_array_equal(t["stat"], j["stat"])
    assert t["region"] == j["region"]
    assert len(t["tpl"]) == len(j["tpl"]) == 7
    for a, b in zip(t["tpl"], j["tpl"]):
        np.testing.assert_array_equal(a, b)
    lj, lt = j["loaded"], t["loaded"]
    assert lt.y.shape[1] == maxdata
    np.testing.assert_array_equal(lt.goodids, lj.goodids)
    np.testing.assert_array_equal(lt.y, lj.y)
    np.testing.assert_array_equal(lt.var, lj.var)
    np.testing.assert_array_equal(lt.wavelength_nm, lj.wavelength_nm)
    assert (lt.var.max() > 1e9) == (nspec > pipeline.BAD_WINDOWS[0][0])
    port_w = likelihood.muse_weights(lt.y, lt.var)
    md = type("md", (), {})()  # make_muse_problem reads no template here
    jax_data = jax_lik.make_muse_problem(md, lj.y, lj.var).data
    for a, b in zip(port_w, (jax_data.y_over_v, jax_data.inv_v,
                             jax_data.yy)):
        np.testing.assert_array_equal(a.astype(np.float32), np.asarray(b))
    assert bench.cube_sha256(lt) == bench.cube_sha256(lj)


def test_tool_prints_every_field_and_option(capsys):
    assert bench.main(TINY + ["--eager-chunks", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    missing = [k for k in FIELDS if k not in line]
    assert not missing, missing
    assert sorted(line["options"]) == sorted(OPTIONS)
    assert line["options"]["proposal_batch"] == 8192
    assert line["options"]["fallback_rounds"] == 2
    assert line["niter"] == 101 and line["running_at_cap"] == 20
    assert line["chunk_path"] == "eager" and line["device"] == "cpu"
    assert line["per_chunk"] and all(
        sorted(r) == sorted(CHUNK_FIELDS) for r in line["per_chunk"])
    assert line["jax_run"] is None and line["paper"] is None
    # 20 spaxels advance once an iteration until the cap's iteration
    assert line["advances"] == sum(r["advances"] for r in line["per_chunk"])
    assert line["evals_per_advance"] == line["ndraws"] / line["advances"]
    assert sorted(line["advance_quantiles"]) == sorted(bench.QUANTILES)
    assert line["advance_quantiles"]["max"] <= line["niter"]
    # the wall-clock budget is on (it starts at 512 rounds) and never binds
    assert line["mean_budget"] >= 1 and line["budget_bound_chunks"] == 0
    assert line["first_budget_bound_chunk"] is None
    # the eager check ran its chunk twice (both eager here) and held
    check = line["eager_check"]
    assert check["chunks"] == 1 and check["held"], check
    assert check["bitwise"]["sha_L"] and check["bitwise"]["launches"]
    assert all(line["bars"].values()), line["bars"]
    assert len(line["cube_sha256"]) == 64
    # the JAX run's counts and the paper's figure, at 4,223 spaxels
    jax = bench.jax_counts(4223)
    assert jax["ndraws"] == 14901603 and jax["niter"] == 100401


def test_resume_sums_the_legs(tmp_path, capsys):
    """A run cut by ``--max-chunks`` (exit 75) resumes from its checkpoint;
    the finished line's wall is the sum of its legs' walls and its
    records per chunk follow on."""
    ck = str(tmp_path / "ck")
    args = TINY + ["--chunk-iters", "20", "--checkpoint-every", "1",
                   "--checkpoint-dir", ck]
    assert bench.main(args + ["--max-chunks", "2"]) == bench.INTERRUPTED
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["interrupted"] and first["chunks"] == 2
    assert bench.main(args) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(line["legs"]) == 2
    assert line["legs"][0]["chunks"] == [0, 2]
    assert line["wall_s"] == pytest.approx(
        sum(leg["wall_s"] for leg in line["legs"]))
    assert line["wall_s"] > line["legs"][1]["wall_s"]
    chunks = [r["chunk"] for r in line["per_chunk"]]
    assert chunks == list(range(1, len(chunks) + 1))
    assert line["niter"] == 101 and line["chunks"] == len(chunks)
    # labels on every chunk's report here (K D <= 2^20), each in its row
    assert all(r["n_groups"] is not None for r in line["per_chunk"]
               if r["running"] > 0)
    # the advances so far run on across the legs
    totals = np.cumsum([r["advances"] for r in line["per_chunk"]])
    assert [r["advances_total"] for r in line["per_chunk"]] == \
        totals.tolist()
    assert line["advances"] == totals[-1]


def test_resume_refuses_another_run(tmp_path, capsys):
    """A checkpoint directory resumes only the run that made it: other
    options, or a checkpoint that this tool did not start, are refused
    before any chunk runs."""
    ck = str(tmp_path / "ck")
    args = TINY + ["--chunk-iters", "20", "--checkpoint-every", "1",
                   "--checkpoint-dir", ck]
    assert bench.main(args + ["--max-chunks", "1"]) == bench.INTERRUPTED
    capsys.readouterr()
    with pytest.raises(SystemExit, match="other options"):
        bench.main(args + ["--seed", "2"])
    with open(os.path.join(ck, bench.LEGS)) as fh:
        assert len(fh.readlines()) == 1
    os.remove(os.path.join(ck, bench.RUN))
    with pytest.raises(SystemExit, match="another run"):
        bench.main(args)


def test_group_counts_find_their_chunks_under_a_cadence(tmp_path):
    """At a label cadence, each group count sits in the row of the chunk
    whose report made it (``chunk_records(first_chunk, group_every)``),
    in a resumed fit too."""
    from massivedatans_tpu_torch.config import RunConfig
    from massivedatans_tpu_torch.muse.pipeline import fit_muse
    from massivedatans_tpu_torch.ns import subsets
    from tools.torch_muse_validate import chunk_records

    cube_path, reg, tpl = bench.build_bench_cube(str(tmp_path), 12, 64)
    cube = pipeline.load_muse_cube(cube_path, reg, maxdata=12)
    cfg = RunConfig(nlive_points=30, max_samples=200, chunk_iters=20,
                    pipeline_lookahead=2, group_refresh_chunks=3)
    made = []
    labels = subsets.component_labels

    def spy(*a, **kw):
        out = labels(*a, **kw)
        made.append(int(out[1]))
        return out

    ck = str(tmp_path / "ck")
    subsets.component_labels = spy
    try:
        fit_muse(cube, tpl, 0.0, 0.3, cfg=cfg, device="cpu",
                 checkpoint_dir=ck, max_chunks=4)
        n_first = len(made)
        with chunk_records(first_chunk=4, group_every=3) as rows:
            fit_muse(cube, tpl, 0.0, 0.3, cfg=cfg, device="cpu",
                     checkpoint_dir=ck)
    finally:
        subsets.component_labels = labels
    got = [(r["chunk"], r["n_groups"]) for r in rows
           if r["n_groups"] is not None]
    # chunks dispatched at 6, 9, ... (0-based): rows 7, 10, ...
    assert [c for c, _ in got] == list(range(7, 7 + 3 * len(got), 3))
    assert [g for _, g in got] == made[n_first:]
    assert rows[0]["chunk"] == 5


def test_both_packages_count_alike_at_muse_bench_options(tmp_path):
    """``tools/jax_muse_rounds.py --cube bench`` on a small cube at
    ``tools/muse_bench.py``'s options (pool 8,192, column pool the same,
    column rounds after 2 unfilled rounds, chunks of 400, lookahead 2,
    checkpoints every 2 chunks, no wall-clock budget): iterations,
    evaluations and fill rounds of the port within [0.5, 2] x the JAX
    package's."""
    out = str(tmp_path / "rec.json")
    assert jax_muse_rounds.main([
        "--cube", "bench", "--n-spaxels", "16", "--nspec", "64", "--nlive",
        "50", "--cap", "300", "--seeds", "1", "--out", out]) == 0
    with open(out) as fh:
        rec = json.load(fh)
    assert rec["cube"] == "bench" and rec["n_spaxels"] == 16
    assert rec["options"]["dispatch_target"] == 0.0
    assert rec["options"]["proposal_batch"] == 8192
    fits = {f["package"]: f for f in rec["fits"]}
    assert fits["jax"]["column_proposal_batch"] == 8192
    assert fits["jax"]["column_focus_fallback_rounds"] == 2
    ratios = rec["port_over_jax"]["bench seed 1"]
    assert all(0.5 <= v <= 2.0 for v in ratios.values()), ratios
    assert fits["jax"]["fill_rounds"] > 10, fits["jax"]
    # the record is what the tool holds a run against
    line = dict(options=dict(seed=1), per_chunk=fits["torch"]["per_chunk"],
                **{k: fits["torch"][k] for k in ("niter", "ndraws",
                                                 "fill_rounds")})
    held = bench.held_to_record(line, rec)
    assert held["jax_seed"] == 1 and all(held["held"].values())
    assert held["per_chunk"]


def test_a_shorter_fit_is_held_at_its_cap_chunk():
    """A fit capped below the JAX record's cap is held against the
    record's chunk that ends at the fit's cap, not the record's totals
    (the fit's own last chunk, its one iteration past the cap, is not
    compared)."""
    def row(chunk, niter, ndraws, rounds):
        return dict(chunk=chunk, niter=niter, ndraws=ndraws,
                    fill_rounds=rounds)

    record = dict(cap=1200, fits=[dict(
        seed=1, niter=1201, ndraws=90000, fill_rounds=9000,
        per_chunk=[row(1, 400, 3000, 30), row(2, 800, 6000, 60),
                   row(3, 1200, 80000, 8000), row(4, 1201, 90000, 9000)])])
    line = dict(options=dict(seed=1, cap=800), niter=801, ndraws=7000,
                fill_rounds=80, per_chunk=[row(1, 400, 3300, 33),
                                           row(2, 800, 6600, 66),
                                           row(3, 801, 7000, 80)])
    held = bench.held_to_record(line, record)
    assert held["at_niter"] == 800
    assert held["jax"] == dict(niter=800, ndraws=6000, fill_rounds=60)
    assert held["port"] == dict(niter=800, ndraws=6600, fill_rounds=66)
    assert held["ratios"] == dict(niter=1.0, ndraws=1.1, fill_rounds=1.1)
    assert all(held["held"].values())
    # at the record's own cap the totals are compared
    full = dict(line, options=dict(seed=1, cap=1200), niter=1201,
                ndraws=200000, fill_rounds=9000)
    held = bench.held_to_record(full, record)
    assert held["ratios"]["ndraws"] == 200000 / 90000
    assert not held["held"]["ndraws"] and held["held"]["fill_rounds"]


BUDGET_CUBE = dict(n_spaxels=16, nspec=600, nlive=50, cap=400,
                   fill_budget=20, dispatch_target=0.0)


@pytest.fixture(scope="module")
def budget_cube(tmp_path_factory):
    """A tiny bench cube (16 spaxels, nspec 600) at nlive 50 with a fill
    budget of 20 rounds a chunk, which binds: ``(cube, tpl, fields)``,
    ``fields`` both packages' ``RunConfig`` fields."""
    tmp = str(tmp_path_factory.mktemp("budget"))
    cube, tpl = bench.load_bench_cube(tmp, BUDGET_CUBE["n_spaxels"],
                                      BUDGET_CUBE["nspec"])
    opts = dict(bench.defaults(), **BUDGET_CUBE)
    return cube, tpl, bench.config_fields(opts)


def _fit_recorded(package, cube, tpl, fields):
    """One fit of ``package`` with its per-chunk records: ``(result,
    rows)``."""
    if package == "jax":
        from massivedatans_tpu.config import RunConfig as JaxRunConfig
        from massivedatans_tpu.muse.model import load_template_grid
        from massivedatans_tpu.ns.integrator import multi_nested_integrator

        md = load_template_grid(tpl, data_wl_nm=cube.wavelength_nm,
                                zlo=bench.ZLO, zhi=bench.ZHI)
        problem = jax_lik.make_muse_problem(md, cube.y, cube.var)
        with jax_muse_rounds.jax_chunk_records(
                fill_budget=fields["chunk_fill_budget"]) as rows:
            res = multi_nested_integrator(problem, JaxRunConfig(**fields),
                                          progress=False)
        return res, rows
    from massivedatans_tpu_torch.config import RunConfig
    from tools.torch_muse_validate import chunk_records

    with chunk_records() as rows:
        res, _ = pipeline.fit_muse(cube, tpl, bench.ZLO, bench.ZHI, "FULL",
                                   RunConfig(**fields), device="cpu")
    return res, rows


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_hooks_count_advances_where_the_budget_binds(
        budget_cube, package, capsys, monkeypatch):
    """Each package's per-chunk hook counts a chunk's advances as its dead
    rows with ``idx >= 0``: in total and per spaxel they are the
    ``NSResult``'s dead rows of finite L (a row that did not advance holds
    L = -inf), the integrator's own ``MDT_DEBUG_TIMING`` line prints the
    same count for each chunk, and a chunk that used its whole budget of
    20 rounds advanced fewer spaxels than its iterations x running."""
    cube, tpl, fields = budget_cube
    monkeypatch.setenv("MDT_DEBUG_TIMING", "1")
    res, rows = _fit_recorded(package, cube, tpl, fields)
    err = capsys.readouterr().err
    dead = np.asarray(res.L)[:res.niterations] > -np.inf
    assert sum(r["advances"] for r in rows) == int(dead.sum())
    np.testing.assert_array_equal(rows.per_spaxel, dead.sum(axis=0))
    printed = {int(c): int(a) for c, a in re.findall(
        r"^chunk (\d+): .* adv=(\d+)/\d+$", err, re.M)}
    assert printed and all(rows[c - 1]["advances"] == a
                           for c, a in printed.items()), (printed, rows)
    bound = [r for r in rows if r["budget_bound"]]
    assert bound and all(r["rounds"] >= 20 and r["budget"] == 20
                         for r in bound)
    prev = {r["chunk"]: r for r in rows}
    assert any(r["advances"] < (r["niter"] - prev.get(
        r["chunk"] - 1, dict(niter=0))["niter"]) * BUDGET_CUBE["n_spaxels"]
        for r in bound)
    summary = bench.advance_summary(rows, rows.per_spaxel, res.ndraws)
    assert summary["advances"] == int(dead.sum())
    assert summary["first_budget_bound_chunk"] == bound[0]["chunk"]
    assert summary["budget_bound_chunks"] == len(bound)
    assert summary["advance_quantiles"]["min"] == dead.sum(axis=0).min()
    assert summary["advance_quantiles"]["max"] == dead.sum(axis=0).max()
    if package == "torch":
        kinds = [r["round_steps"] for r in rows]
        assert sum(k["region"] for k in kinds) > 0
        assert all(set(k) == {"region", "focus", "column"} for k in kinds)


def test_chunk_rows_count_each_field_once():
    """``ChunkRows.add`` sets a chunk's rounds, budget and
    ``budget_bound`` once, when its row is made, with no advances yet;
    ``add_advances`` adds the dead rows with ``idx >= 0`` to the last row
    and to each spaxel's count; ``advance_summary`` and ``with_totals``
    leave the rows they are given as they were."""
    rows = ChunkRows()
    rows.add(dict(chunk=1, ndraws=10, fill_rounds=3), 4)
    assert rows[-1] == dict(chunk=1, ndraws=10, fill_rounds=3, rounds=3,
                            budget=4, advances=0, budget_bound=False)
    rows.add_advances(np.array([[0, -1], [2, 1]]))
    rows.add(dict(chunk=2, ndraws=30, fill_rounds=7), 4)
    rows.add_advances(np.array([[-1, 0]]))
    rows.add_advances(np.zeros((0, 2), np.int32))
    assert [r["rounds"] for r in rows] == [3, 4]
    assert [r["budget_bound"] for r in rows] == [False, True]
    assert [r["advances"] for r in rows] == [3, 1]
    assert rows.per_spaxel.tolist() == [2, 2]
    before = json.dumps(rows)
    summary = bench.advance_summary(rows, rows.per_spaxel, 30)
    totals = bench.with_totals(rows)
    assert json.dumps(rows) == before
    assert summary["advances"] == 4 and summary["evals_per_advance"] == 7.5
    assert summary["first_budget_bound_chunk"] == 2
    assert summary["budget_bound_chunks"] == 1
    assert [r["advances_total"] for r in totals] == [3, 4]
    # a record written before the advances were counted gets no totals
    assert bench.with_totals([dict(chunk=1)]) == [dict(chunk=1)]


def test_port_debug_line_is_off_by_default(budget_cube, capsys,
                                           monkeypatch):
    """Without ``MDT_DEBUG_TIMING`` the port's integrator prints no chunk
    line; with it, one per chunk, numbered in order."""
    from massivedatans_tpu_torch.config import RunConfig

    cube, tpl, fields = budget_cube
    fields = dict(fields, max_samples=120, chunk_iters=40)
    monkeypatch.delenv("MDT_DEBUG_TIMING", raising=False)
    res, _ = pipeline.fit_muse(cube, tpl, bench.ZLO, bench.ZHI, "FULL",
                               RunConfig(**fields), device="cpu")
    assert "adv=" not in capsys.readouterr().err
    monkeypatch.setenv("MDT_DEBUG_TIMING", "1")
    again, _ = pipeline.fit_muse(cube, tpl, bench.ZLO, bench.ZHI, "FULL",
                                 RunConfig(**fields), device="cpu")
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("chunk ")]
    assert [int(ln.split()[1][:-1]) for ln in lines] == list(
        range(1, res.stats["chunks"] + 1))
    np.testing.assert_array_equal(again.logZ, res.logZ)


def test_held_to_seeds_known_answers():
    """``held_to_seeds`` on hand-made samples: equal samples hold (ratio 1,
    p 1); a sample shifted 3 x fails on both bars (exact p = 2 / C(10,
    5)); one whose median lies
    within [0.5, 2] x but whose seeds all lie above the other's fails on
    the U test; a fit with no budget-bound chunk
    counts its onset as the chunk after its last."""
    def fits(values, **kw):
        return [dict(ndraws=v, advances=10 * v, evals_per_advance=0.1,
                     budget_bound_chunks=1, first_budget_bound_chunk=3,
                     **kw) for v in values]

    same = bench.held_to_seeds(fits([1, 2, 3, 4, 5]), fits([1, 2, 3, 4, 5]))
    assert same["ndraws"]["ratio"] == 1.0 and same["ndraws"]["p"] == 1.0
    assert all(v["held"] for v in same.values())
    shifted = bench.held_to_seeds(fits([7, 8, 9, 10, 11]),
                                  fits([1, 2, 3, 4, 5]), keys=("ndraws",))
    assert shifted["ndraws"]["ratio"] == 3.0
    assert shifted["ndraws"]["p"] == pytest.approx(2 / 252)  # exact
    assert not shifted["ndraws"]["held"]
    above = bench.held_to_seeds(fits(range(20, 30)), fits(range(10, 20)),
                                keys=("ndraws",))["ndraws"]
    assert above["ratio"] == pytest.approx(24.5 / 14.5)
    # ten seeds a side: the normal approximation with continuity
    # correction, z = (100 - 50 - 0.5) / sqrt(10 * 10 * 21 / 12)
    z = 49.5 / math.sqrt(10 * 10 * 21 / 12)
    assert above["p"] == pytest.approx(math.erfc(z / math.sqrt(2)))
    assert not above["held"]
    late = [dict(f, first_budget_bound_chunk=None, budget_bound_chunks=0,
                 per_chunk=[dict(chunk=11)]) for f in fits([1])]
    onset = bench.held_to_seeds(late, fits([1]),
                                keys=("first_budget_bound_chunk",))
    assert onset["first_budget_bound_chunk"]["port_median"] == 12.0
    # records without advances: the statistic is absent, not held
    old = [dict(ndraws=v) for v in (1, 2)]
    assert bench.held_to_seeds(old, old)["advances"] is None


def test_an_old_record_loads_without_the_progress_fields():
    """A record written before the advances were counted
    (``muse_bench_4223_jax.json``) still holds a line in
    ``held_to_record``: its progress reads as absent (None) and the bars
    are those of the counts alone; ``advance_summary`` of its rows is
    None throughout."""
    with open(os.path.join(ROOT, "muse_bench_4223_jax.json")) as fh:
        record = json.load(fh)
    ref = record["fits"][0]
    rows = [dict(r, advances=400 * 4223, advances_total=400 * 4223 * i,
                 rounds=1, budget=8192, budget_bound=False)
            for i, r in enumerate(ref["per_chunk"][:7], 1)]
    line = dict(options=dict(seed=1, cap=2800), per_chunk=rows,
                niter=2801, ndraws=rows[-1]["ndraws"],
                fill_rounds=rows[-1]["fill_rounds"])
    held = bench.held_to_record(line, record)
    assert held["at_niter"] == 2800 and all(held["held"].values())
    progress = held["progress"]
    assert progress["jax"] == dict(advances=None, evals_per_advance=None)
    assert progress["port"]["advances"] == 400 * 4223 * 7
    assert progress["ratios"] == dict(advances=None, evals_per_advance=None)
    assert set(held["held"]) == {"niter", "ndraws", "fill_rounds"}
    assert all(v is None for v in bench.advance_summary(
        ref["per_chunk"], None, ref["ndraws"]).values())


def test_seed_spread_gathers_holds_and_repeats(tmp_path, capsys):
    """``tools/muse_seed_spread.py`` gathers both tools' records of one
    setting, holds the port's seeds against the JAX package's with
    ``held_to_seeds``, prints a table per package, compares each fit with
    an earlier record of its package and seed (an older JAX record's
    overflows read from its last chunk), and refuses a fit of another
    setting or cube."""
    from tools import muse_seed_spread as spread

    opts = dict(bench.defaults(), n_spaxels=16, cap=800, fill_budget=20,
                dispatch_target=0.0)
    rows = [dict(chunk=1, niter=400, ndraws=100, fill_rounds=20,
                 member_overflow=1, advances=6000, budget_bound=True)]

    def fit(seed, ndraws, **kw):
        return dict(seed=seed, niter=801, ndraws=ndraws, advances=12000,
                    evals_per_advance=ndraws / 12000, fill_rounds=40,
                    member_overflow=seed, budget_bound_chunks=1,
                    first_budget_bound_chunk=1, mean_budget=20,
                    advance_quantiles=dict.fromkeys(bench.QUANTILES, 750.0),
                    running_at_cap=16, wall_s=1.0, per_chunk=rows, **kw)

    def write(name, obj):
        path = tmp_path / name
        path.write_text(json.dumps(obj))
        return str(path)

    jax = write("j.json", dict(cube="bench", options=opts, cube_sha256="a",
                               fits=[dict(fit(s, 1000 * s), package="jax")
                                     for s in (1, 2, 3)]))
    port = [write(f"p{s}.json", dict(fit(s, 1100 * s), options=dict(
        opts, seed=s), cube_sha256="a", card="card")) for s in (1, 2, 3)]
    old = write("old.json", dict(cube="bench", options=opts, cube_sha256="a",
                                 fits=[dict(fit(1, 1000), package="jax",
                                            member_overflow=None)]))
    out = str(tmp_path / "s.json")
    assert spread.main(["--jax", jax, "--port", *port, "--previous", old,
                        "--out", out]) == 0
    printed = capsys.readouterr().out
    assert printed.count("| seed | E | A | E/A |") == 2
    with open(out) as fh:
        rec = json.load(fh)
    assert rec["seeds"] == dict(jax=[1, 2, 3], torch=[1, 2, 3])
    assert rec["held_to_seeds"]["ndraws"]["ratio"] == pytest.approx(1.1)
    assert all(v["held"] for v in rec["held_to_seeds"].values())
    (rep,) = rec["repeats"]
    assert rep["package"] == "jax" and rep["equal"]
    assert rec["card"] == ["card"] and len(rec["fits"]) == 6
    other = write("p9.json", dict(fit(9, 9), options=dict(opts, seed=9,
                                                          cap=1200),
                                  cube_sha256="a"))
    with pytest.raises(SystemExit, match="other options"):
        spread.main(["--jax", jax, "--port", other, "--out", out])
    cube = write("p8.json", dict(fit(8, 9), options=dict(opts, seed=8),
                                 cube_sha256="b"))
    with pytest.raises(SystemExit, match="another cube"):
        spread.main(["--jax", jax, "--port", cube, "--out", out])

