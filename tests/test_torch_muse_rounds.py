"""``tools/muse_rounds_from_state.py`` on the CPU: its leaf map, a small
late state loaded into both packages, the live L recomputed, one batch of
each round kind, and its statistics on fixed inputs.

The late state is made here by the JAX package: a 4x4 model-family cube
(``build_fixture``, nspec 300, 100 template wavelengths) fitted at nlive
50 with a 150-iteration cap, its checkpoint kept, so that the state's
spaxels stopped by the cap are reopened as in the run of record's.
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from massivedatans_tpu.config import RunConfig as JaxRunConfig
from massivedatans_tpu.io import checkpoint as jax_ckpt
from massivedatans_tpu.muse.likelihood import make_muse_problem
from massivedatans_tpu.muse.model import load_template_grid
from massivedatans_tpu.ns import engine as jax_engine
from massivedatans_tpu.ns.integrator import multi_nested_integrator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import MUSE_CANCEL  # noqa: E402
from tools import muse_rounds_from_state as mrs  # noqa: E402
from tools.torch_muse_validate import build_fixture  # noqa: E402

torch.set_num_threads(1)

SIDE, NSPEC, N_WL, NLIVE, CAP = 4, 300, 100, 50, 150


@pytest.fixture(scope="module")
def late(tmp_path_factory):
    """The fixture, both problems and the JAX fit's capped state:
    ``(cube, tpl, state_dir, jax_problem)``."""
    tmp = str(tmp_path_factory.mktemp("late"))
    cube, tpl, _ = build_fixture(tmp, SIDE, NSPEC, n_wl=N_WL)
    md = load_template_grid(tpl, data_wl_nm=cube.wavelength_nm, zlo=0.0,
                            zhi=0.5)
    problem = make_muse_problem(md, cube.y, cube.var)
    ck = os.path.join(tmp, "ck")
    multi_nested_integrator(problem, JaxRunConfig(
        nlive_points=NLIVE, max_samples=CAP, chunk_fill_budget=319, seed=3),
        progress=False, checkpoint_dir=ck)
    return cube, tpl, ck, problem


def _path_name(path):
    return ".".join(p.name for p in path)


def test_leaf_names_follow_the_jax_flatten_order(late, tmp_path):
    """``LEAF_NAMES`` is the JAX package's flatten order, and
    ``state_arrays`` reads each saved leaf back under its own field's
    name, shape and dtype."""
    _, _, _, problem = late
    template = jax_engine.init_state(problem, jax.random.key(0),
                                     JaxRunConfig(nlive_points=NLIVE))
    leaves = jax.tree_util.tree_flatten_with_path(template)[0]
    assert tuple(_path_name(p) for p, _ in leaves) == mrs.LEAF_NAMES
    jax_ckpt.save_state(str(tmp_path), template, dict(running=np.ones(1)),
                        dict(chunk_index=0))
    arrays, cap = mrs.state_arrays(str(tmp_path))
    assert cap == template.pile_u.shape[0]
    for path, leaf in leaves:
        name = _path_name(path)
        want = (np.asarray(jax.random.key_data(leaf)) if name == "key"
                else np.asarray(leaf))
        got = arrays[name]
        if name in ("pile_u", "pile_x"):  # saved as a used prefix
            want = want[:len(got)]
        assert got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_late_state_loads_into_both_packages(late):
    """The capped state reopens its capped spaxels, and the port's state
    and the JAX package's hold the same fields."""
    cube, tpl, ck, _ = late
    raw, cap = mrs.state_arrays(ck)
    assert not raw["running"].any()  # the cap stopped every spaxel
    arrays = mrs.reopen(raw)
    capped = raw["term_iter"] == raw["iteration"]
    assert capped.any()
    np.testing.assert_array_equal(arrays["running"], capped)
    assert (arrays["term_iter"][capped] == -1).all()
    port = mrs.port_state(arrays, cap)
    _, _, jstate = mrs.jax_setup(cube, tpl, ck, arrays)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        name = _path_name(path)
        if name == "key":
            continue
        obj = port
        for part in name.split("."):
            obj = getattr(obj, part)
        got = np.asarray(obj.cpu() if torch.is_tensor(obj) else obj)
        want = np.asarray(leaf)
        if name in ("pile_u", "pile_x"):  # the port's sink row
            assert got.shape[0] == want.shape[0] + 1
            got = got[:-1]
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=name)


def test_live_L_recomputes_to_the_bar(late):
    """Both packages' likelihoods give the state's live L back within
    ``MUSE_CANCEL`` * yy, and agree with float64 there."""
    cube, tpl, ck, jproblem = late
    raw, _ = mrs.state_arrays(ck)
    rec = mrs.live_check(mrs.port_problem(cube, tpl), cube, mrs.reopen(raw),
                         MUSE_CANCEL, jproblem)
    assert rec["spaxels"] > 0
    assert rec["held"], rec


@pytest.mark.parametrize("kind", mrs.KINDS)
def test_round_kinds_run_in_both_packages(late, kind):
    """A few batches of each round kind from the late state, in both
    packages: counts within the eval batch, a radius for the region kinds
    only."""
    cube, tpl, ck, _ = late
    raw, cap = mrs.state_arrays(ck)
    arrays = mrs.reopen(raw)
    cfg = mrs.port_config(arrays)
    pstate = mrs.port_labels(mrs.port_state(arrays, cap), cfg.nlive_points)
    jproblem, jcfg, jstate = mrs.jax_setup(cube, tpl, ck, arrays)
    jstate = mrs.jax_labels(jstate, cfg.nlive_points)
    for out in (mrs.port_kinds(mrs.port_problem(cube, tpl), pstate, cfg, 3,
                               kinds=(kind,)),
                mrs.jax_kinds(jproblem, jcfg, jstate, 3, kinds=(kind,))):
        rec = out[kind]
        assert rec["batches"] == 3
        assert 0.0 <= rec["valid_share"][0] <= 1.0
        assert 0.0 <= rec["accepted_per_batch"][0] <= cfg.eval_batch
        assert (rec["radius"] is None) == (kind == "column")


def test_statistics_known_answers():
    m, se = mrs.mean_se([1.0, 2.0, 3.0])
    assert m == 2.0 and se == pytest.approx(1.0 / math.sqrt(3.0))
    assert mrs.mean_se([4.0]) == (4.0, 0.0)
    # ratio of sums, linearised error: residuals a - r v = (0, -0.5, 0.5)
    r, se = mrs.ratio_se([1, 2, 3], [2, 5, 5])
    assert r == 0.5
    assert se == pytest.approx(math.sqrt(0.5 / 6) / 4)
    assert all(math.isnan(v) for v in mrs.ratio_se([0, 0], [0, 0]))
    # both the 4 se and the 10 % bar must be passed
    assert mrs.differs((1.0, 0.01), (1.2, 0.01))
    assert not mrs.differs((1.0, 0.1), (1.2, 0.1))  # within 4 se
    assert not mrs.differs((1.0, 0.0001), (1.05, 0.0001))  # within 10 %
    assert mrs.differs((float("nan"), 0.0), (1.0, 0.0))
    batches = [dict(valid=v, accepted=a, radius=r, overflow=o, eval_batch=4)
               for v, a, r, o in ((2, 1, 0.5, 0), (4, 1, 0.7, 1))]
    s = mrs.summarize(batches)
    assert s["valid_share"] == (0.75, pytest.approx(0.25))
    assert s["accepted_share"][0] == pytest.approx(1 / 3)
    assert s["radius"] == (pytest.approx(0.6), pytest.approx(0.1))
    assert s["overflow"] == (0.5, pytest.approx(0.5))
    cols = mrs.summarize([dict(b, radius=None, overflow=None)
                          for b in batches])
    assert cols["radius"] is None and cols["overflow"] is None
    assert mrs.compare_kinds({"k": s}, {"k": s}) == {"k": dict.fromkeys(
        ("valid_share", "accepted_share", "radius", "overflow"), False)}
    runs = [[dict(niter=10, fill_rounds=f, ndraws=n, running=1)]
            for f, n in ((100, 1000), (110, 1100))]
    start = dict(niter=5, fill_rounds=90, ndraws=900)
    assert mrs.chunk_totals(runs, start) == dict(
        niter=[5, 5], fill_rounds=[10, 20], ndraws=[100, 200], running=[1, 1])
    tot = mrs.compare_totals(runs, runs, start)
    assert tot["fill_rounds"]["jax"] == (15.0, pytest.approx(5.0))
    assert not any(v["differs"] for v in tot.values())
    more = [[dict(r[0], ndraws=r[0]["ndraws"] + 500)] for r in runs]
    assert mrs.compare_totals(runs, more, start)["ndraws"]["differs"]


def test_chunk_records_follow_the_fits(late, tmp_path):
    """The per-chunk records of both packages' fits (``chunk_records``,
    ``jax_chunk_records``) end at each fit's own counts, and the JAX
    states kept every 10 chunks load like the checkpoint's own."""
    from massivedatans_tpu_torch.config import RunConfig
    from massivedatans_tpu_torch.muse.pipeline import fit_muse
    from tools.jax_muse_rounds import jax_chunk_records
    from tools.torch_muse_validate import chunk_records

    cube, tpl, _, problem = late
    kw = dict(nlive_points=30, max_samples=120, chunk_iters=10,
              chunk_fill_budget=319)
    with chunk_records() as port_rows:
        port, _ = fit_muse(cube, tpl, 0.0, 0.5, "FULL", RunConfig(**kw),
                           device="cpu")
    ck = str(tmp_path / "ck")
    with jax_chunk_records(ck) as jax_rows:
        jax_res = multi_nested_integrator(problem, JaxRunConfig(**kw),
                                          progress=False, checkpoint_dir=ck)
    assert len(port_rows) == port.stats["chunks"]
    for rows, res in ((port_rows, port), (jax_rows, jax_res)):
        assert len(rows) > 10
        assert [r["chunk"] for r in rows] == list(range(1, len(rows) + 1))
        last = rows[-1]
        assert (last["niter"], last["ndraws"], last["fill_rounds"]) == (
            res.niterations, res.ndraws, res.stats["fill_rounds"])
        assert last["running"] == 0 and rows[0]["n_groups"] >= 1
    kept = os.path.join(ck, "chunk_00010")
    arrays, _ = mrs.state_arrays(kept)
    assert int(arrays["iteration"]) == jax_rows[9]["niter"]
    assert int(arrays["ndraws"]) == jax_rows[9]["ndraws"]


def test_the_card_side_imports_no_jax():
    """What ``chip_smoke.py`` phase 12 calls (the state read with numpy,
    reopened and loaded into the port) imports neither JAX nor the JAX
    package: the card's machine has neither."""
    code = (
        "import sys\n"
        "from tools import muse_rounds_from_state as m\n"
        "raw, cap = m.state_arrays(m.STATE_DIR)\n"
        "a = m.reopen(raw)\n"
        "st = m.port_labels(m.port_state(a, cap), 400)\n"
        "assert int(st.running.sum()) == 30 and st.n_groups >= 1\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'massivedatans_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_state_tool_takes_the_bench_cube(tmp_path):
    """``--cube bench``: a state kept by ``tools/jax_muse_rounds.py --cube
    bench`` loads on ``tools/torch_muse_bench.py``'s cube (z up to 0.3,
    the real-MUSE bad windows), its live L recomputes to the bar in both
    packages, and (A) and (B) run at the bench options."""
    from tools import jax_muse_rounds

    ck, out = str(tmp_path / "ck"), str(tmp_path / "s.json")
    assert jax_muse_rounds.main([
        "--cube", "bench", "--n-spaxels", "12", "--nspec", "64", "--nlive",
        "40", "--cap", "120", "--seeds", "1", "--packages", "jax",
        "--checkpoint-dir", ck, "--out", str(tmp_path / "r.json")]) == 0
    assert mrs.main([
        "--cube", "bench", "--n-spaxels", "12", "--nspec", "64", "--state",
        os.path.join(ck, "bench_seed1"), "--batches", "2", "--candidates",
        "64", "--seeds", "1", "--parts", "A", "B", "--out", out]) == 0
    with open(out) as fh:
        rec = json.load(fh)
    assert rec["cube"] == "bench" and rec["n_spaxels"] == 12
    assert rec["reopened"] and rec["running"] > 0
    assert rec["live_check"]["held"], rec["live_check"]
    opts = rec["options"]
    assert opts["proposal_batch"] == opts["column_proposal_batch"] == 8192
    assert opts["column_focus_fallback_rounds"] == 2
    assert set(rec["B"]["jax"]) == set(rec["B"]["torch"]) == set(mrs.KINDS)


def test_state_tool_runs_each_package_alone_and_combines(tmp_path):
    """(C) one package at a time (``--packages``: the JAX package on the
    CPU, the port where its card is), then ``--combine``: the seeds both
    ran, each package's chunks as its own run made them, the totals
    compared; a record of another state is refused."""
    from tools import jax_muse_rounds

    ck = str(tmp_path / "ck")
    assert jax_muse_rounds.main([
        "--cube", "bench", "--n-spaxels", "12", "--nspec", "64", "--nlive",
        "40", "--cap", "120", "--seeds", "1", "--packages", "jax",
        "--checkpoint-dir", ck, "--out", str(tmp_path / "r.json")]) == 0
    common = ["--cube", "bench", "--n-spaxels", "12", "--nspec", "64",
              "--state", os.path.join(ck, "bench_seed1"), "--parts", "C",
              "--chunks", "1", "--live-spaxels", "4"]
    outs = {p: str(tmp_path / f"{p}.json") for p in ("jax", "torch")}
    assert mrs.main(common + ["--packages", "jax", "--seeds", "2",
                              "--out", outs["jax"]]) == 0
    assert mrs.main(common + ["--packages", "torch", "--seeds", "2",
                              "--out", outs["torch"]]) == 0
    recs = {}
    for p, path in outs.items():
        with open(path) as fh:
            recs[p] = json.load(fh)
        assert list(recs[p]["C"]["runs"]) == [p]
    assert "live_check" in recs["jax"] and "live_check" not in recs["torch"]
    assert recs["jax"]["state_sha256"] == recs["torch"]["state_sha256"]

    def record(name, rec):
        with open(tmp_path / name, "w") as fh:
            json.dump(rec, fh)
        return str(tmp_path / name)

    # a second record of the port's on a seed that the JAX package lacks,
    # of more chunks: the seeds both ran, the chunks all ran
    (run,) = recs["torch"]["C"]["runs"]["torch"]
    extra = record("torch3.json", dict(recs["torch"], C=dict(
        recs["torch"]["C"], seeds=[3], chunks=2,
        runs=dict(torch=[run + run]))))
    comb = mrs.combine([outs["jax"], outs["torch"], extra],
                       str(tmp_path / "c.json"))
    assert comb["C"]["seeds"] == [2] and comb["C"]["chunks"] == 1
    for p in outs:
        assert comb["C"]["runs"][p] == recs[p]["C"]["runs"][p]
    assert set(comb["C"]["totals"]) == set(mrs.TOTALS)
    assert comb["state_sha256"] == recs["jax"]["state_sha256"]
    # each package's chunk advanced some of the 12 spaxels, at most one
    # per iteration each, and the seeds are held to each other
    for p in outs:
        last = comb["C"]["runs"][p][0][-1]
        added = last["niter"] - comb["C"]["start"]["niter"]
        assert 0 < last["advances"] <= added * 12
    assert set(comb["C"]["held_to_seeds"]) == {
        "ndraws", "advances", "evals_per_advance"}
    assert comb["C"]["held_to_seeds"]["advances"]["n_port"] == 1
    other = record("other.json", dict(recs["torch"], state_sha256="0" * 64))
    with pytest.raises(SystemExit, match="state_sha256"):
        mrs.combine([outs["jax"], other], str(tmp_path / "x.json"))


def test_seed_totals_add_evaluations_per_advance():
    """``seed_totals``: what each seed's chunks added, one dict per seed,
    with its evaluations per advance; runs recorded before the advances
    were counted give the counts alone, and ``combine``'s
    ``held_to_seeds`` then finds no advances to hold."""
    from tools.torch_muse_bench import held_to_seeds

    start = dict(niter=5, fill_rounds=90, ndraws=900)
    runs = [[dict(niter=10, fill_rounds=100, ndraws=1000 + 100 * i,
                  running=1, advances=50)] for i in range(3)]
    fits = mrs.seed_totals(runs, start)
    assert [f["ndraws"] for f in fits] == [100, 200, 300]
    assert [f["evals_per_advance"] for f in fits] == [2.0, 4.0, 6.0]
    old = [[{k: v for k, v in r[0].items() if k != "advances"}]
           for r in runs]
    assert all("evals_per_advance" not in f
               for f in mrs.seed_totals(old, start))
    held = held_to_seeds(mrs.seed_totals(old, start), fits,
                         keys=("ndraws", "advances", "evals_per_advance"))
    assert held["advances"] is None and held["ndraws"]["held"]
