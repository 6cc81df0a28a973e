"""``tools/torch_muse_bench.py`` (the port's ``tools/muse_bench.py``) on
the CPU: its cube against the JAX package's, the tool at a tiny size with
a resume, and both packages' counts at ``tools/muse_bench.py``'s options
on a small cube (``tools/jax_muse_rounds.py --cube bench``).
"""

import json
import os
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

torch.set_num_threads(1)

# the tool's line: tools/muse_bench.py's fields and its .stats.json's,
# and the port's own
FIELDS = ("metric", "ndraws", "niter", "stalled", "member_overflow",
          "pile_peak", "wall_s", "evals_per_s", "fill_rounds",
          "group_refreshes", "n_groups_max", "labels_s", "tail_s",
          "peak_mem_GB", "launches", "options", "cube_sha256", "per_chunk",
          "legs", "jax_run", "paper", "bars")
OPTIONS = ("n_spaxels", "nspec", "nlive", "cap", "eval_batch",
           "proposal_batch", "fill_budget", "chunk_iters", "lookahead",
           "fallback_rounds", "dispatch_target", "checkpoint_every", "seed")
CHUNK_FIELDS = ("chunk", "niter", "ndraws", "fill_rounds", "running",
                "member_overflow", "wall_s", "n_groups")
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
