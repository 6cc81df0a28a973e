"""``tools/muse_tpu_budget.py``: the fixed-budget sweep's search, its record
and verdict on synthetic fits, the TPU runs of ``results/``, and a rehearsal
of the sweep on the CPU at two fixed budgets with one fit run again.
"""

import argparse
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools import muse_tpu_budget as mtb  # noqa: E402


def tpu_run(ndraws, overflow=10000, pile=100000, niter=100401):
    return dict(file="x", ndraws=ndraws, niter=niter, stalled=0,
                member_overflow=overflow, pile_peak=pile)


TPU = {100: [tpu_run(18e6, 15000, 126000), tpu_run(15.6e6, 15000, 46000),
             tpu_run(19.3e6, 5500, 64000)],
       1000: [tpu_run(18e6, 18500, 97000)],
       4223: [tpu_run(15e6, 18700, 172000)]}


def fit(d, b, seed, ndraws, niter=100001, overflow=12000, pile=120000):
    return dict(n_spaxels=d, fill_budget=b, seed=seed, ndraws=ndraws,
                niter=niter, member_overflow=overflow, pile_peak=pile,
                stalled=0, running_at_cap=d, fill_rounds=240 * b,
                advances=10 * b, peak_mem_GB=0.5, card="card")


def grid(spec, drop=()):
    """Fits of seed 1 and the search's stage-2 seeds from {(d, b): dict of
    medians}, spread +-10 % (seed 1 at the median), less those in
    ``drop``."""
    out = []
    spreads = (1.0, 0.9, 1.1, 0.95, 1.05)
    for (d, b), med in spec.items():
        seeds = (1,) + mtb.STAGE2_SEEDS.get(d, mtb.STAGE2_SEEDS_DEFAULT)
        for seed, f in zip(seeds, spreads):
            if (d, b, seed) in drop:
                continue
            out.append(fit(d, b, seed, **{k: v * f if k != "niter" else v
                                          for k, v in med.items()}))
    return out


# evaluations below every TPU run's, within [0.5, 2] x and below, within
# and above, far above
LOW, MATCH, MATCH_HI, HIGH = (dict(ndraws=e) for e in (5e6, 16e6, 20e6,
                                                       50e6))
# seed 1 brackets the TPU run's evaluations at every D
A = {(100, 1024): MATCH, (100, 2048): MATCH_HI, (1000, 1024): MATCH,
     (1000, 2048): HIGH, (4223, 512): LOW, (4223, 1024): MATCH}
CASES = {
    # every D matched, budgets not growing with D: the TPU run's budget
    "A": (A, (), {100: [1024, 2048], 1000: [1024], 4223: [1024]},
          {100: 2048, 1000: 1024, 4223: 1024}),
    # the same with one stage-2 fit not run: open, (A) so far
    "A-open": (A, ((4223, 1024, 3),),
               {100: [1024, 2048], 1000: [1024], 4223: [1024]},
               {100: 2048, 1000: 1024, 4223: 1024}),
    # no budget meets the bars anywhere: the pile parts everywhere
    "B": ({(d, b): dict(e, pile=2e6) for d in (100, 1000, 4223)
           for b, e in ((1024, LOW), (2048, MATCH_HI))}, (),
          {100: [], 1000: [], 4223: []}, None),
    # 1,000 spaxels short of the cap at its only matching budget
    "C": ({(100, 1024): MATCH, (100, 2048): MATCH_HI,
           (1000, 1024): dict(MATCH_HI, niter=61050), (1000, 512): LOW,
           (4223, 512): LOW, (4223, 1024): MATCH}, (),
          {100: [1024, 2048], 1000: [], 4223: [1024]}, None),
    # a match at each D, but the budget grows with D: refused
    "C-grows": ({(100, 512): MATCH, (100, 1024): HIGH, (1000, 1024): MATCH,
                 (1000, 2048): HIGH, (4223, 2048): MATCH, (4223, 1024): LOW},
                (), {100: [512], 1000: [1024], 4223: [2048]}, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_verdict_labels_each_outcome(case):
    spec, drop, b_star, choice = CASES[case]
    rec = mtb.record(grid(spec, drop), TPU)
    v = rec["verdict"]
    assert v["outcome"] == ("open" if drop else case[0])
    assert v["outcome_so_far"] == case[0]
    assert rec["not_run"] == [mtb.fit_name(k) for k in drop]
    assert v["pending"] == len(drop)
    assert v["b_star"] == b_star
    assert v["consistent"] == choice
    assert v["grows_with_d"] == (case == "C-grows")
    json.dumps(rec)  # the record is JSON as it stands
    if case == "B":
        # the bar that fails at every budget is named at each D
        assert all(p["failed_at_every_budget"] == ["pile_peak"]
                   for p in v["parts"].values())
    if case == "C":
        assert v["parts"] == {1000: dict(nearest_budget=1024,
                                         failed=["iterations"],
                                         failed_at_every_budget=[])}
    if case == "A":
        by = rec["by_spaxels"][4223][1024]
        assert by["seeds"] == [1, 2, 3]
        assert by["ndraws"] == dict(min=16e6 * 0.9, median=16e6,
                                    max=16e6 * 1.1)
        assert by["ratios"]["ndraws"]["median"] == pytest.approx(16 / 15)
        assert rec["by_spaxels"][100][2048]["seeds"] == [1, 2, 3, 4, 5]


def test_seed_1_alone_leaves_the_verdict_open():
    """Seed 1 at two budgets at each D, no stage-2 seed: every bar met so
    far, and the search wants the stage-2 seeds at the bracket."""
    rec = mtb.record([f for f in grid(A) if f["seed"] == 1], TPU)
    assert rec["verdict"]["outcome"] == "open"
    assert rec["verdict"]["outcome_so_far"] == "A"
    assert rec["not_run"][:4] == ["D100_B1024_s2.json", "D100_B1024_s3.json",
                                  "D100_B1024_s4.json", "D100_B1024_s5.json"]
    assert len(rec["not_run"]) == 8 + 4 + 4


@pytest.mark.parametrize("d,median,held", [
    # 100 spaxels: overflows and pile within the three runs' range widened 2x
    (100, dict(ndraws=9.1e6, niter=100001, member_overflow=2750,
               pile_peak=23000), dict(evaluations=True, iterations=True,
                                      member_overflow=True, pile_peak=True)),
    (100, dict(ndraws=8.9e6, niter=89999, member_overflow=2700,
               pile_peak=253000), dict(evaluations=False, iterations=False,
                                       member_overflow=False,
                                       pile_peak=False)),
    # one run: within [0.5, 2] x it
    (1000, dict(ndraws=36e6, niter=90000, member_overflow=9250,
                pile_peak=194000), dict(evaluations=True, iterations=True,
                                        member_overflow=True,
                                        pile_peak=True)),
    (1000, dict(ndraws=36.1e6, niter=100001, member_overflow=9240,
                pile_peak=194100), dict(evaluations=False, iterations=True,
                                        member_overflow=False,
                                        pile_peak=False)),
])
def test_bars_known_answers(d, median, held):
    got = mtb.bars(median, TPU[d])
    assert got == dict(held, met=all(held.values()))


@pytest.mark.parametrize("es,target,nxt,stage2", [
    ({}, 18e6, 1024, None),
    ({1024: 9e6}, 18e6, 2048, [1024]),
    ({1024: 30e6}, 18e6, 512, [1024]),
    ({1024: 9e6, 2048: 20e6}, 18e6, None, [1024, 2048]),
    ({1024: 30e6, 512: 20e6, 256: 19e6}, 18e6, None, [256]),  # the floor
    ({1024: 1e6, 2048: 2e6, 4096: 4e6, 8192: 8e6}, 18e6, None, [8192]),
])
def test_search_steps_by_two_towards_the_tpu_run(es, target, nxt, stage2):
    assert mtb.next_stage1(es, target) == nxt
    if stage2 is not None:
        assert mtb.stage2_budgets(es, target) == stage2


def test_wanted_runs_seed_1_then_the_bracket_seeds():
    tpu = {d: TPU[d] for d in (100, 4223)}
    done = {(100, 1024, 1): 9e6, (4223, 1024, 1): 20e6}
    assert mtb.wanted(done, tpu, (100, 4223)) == [(100, 2048, 1),
                                                  (4223, 512, 1)]
    done.update({(100, 2048, 1): 20e6, (4223, 512, 1): 9e6,
                 (100, 1024, 2): 9e6})
    want = mtb.wanted(done, tpu, (100, 4223))
    assert want == [(100, 1024, 3), (100, 1024, 4), (100, 1024, 5)] + [
        (100, 2048, s) for s in (2, 3, 4, 5)] + [
        (4223, b, s) for b in (512, 1024) for s in (2, 3)]


def test_consistent_choice_takes_budgets_that_do_not_grow():
    assert mtb.consistent_choice({100: [1024, 2048], 1000: [1024, 4096],
                                  4223: [512, 8192]}) == {
        100: 2048, 1000: 1024, 4223: 512}
    assert mtb.consistent_choice({100: [512], 1000: [1024]}) is None


def test_tpu_runs_are_read_from_results():
    runs = mtb.tpu_runs()
    assert sorted(runs) == [100, 1000, 4223]
    assert [r["file"] for r in runs[100]] == [
        "results/muse_100_completed.stats.json",
        "results/muse_100_fresh.stats.json",
        "results/muse_100_oneattempt.stats.json"]
    assert [r["ndraws"] for r in runs[100]] == [18316206, 15632412, 19295200]
    assert [r["pile_peak"] for r in runs[100]] == [126274, 46367, 64587]
    assert runs[1000] == [dict(
        file="results/muse_1000.stats.json", ndraws=18251460, niter=100401,
        stalled=2, member_overflow=18529, pile_peak=97419)]
    assert runs[4223][0]["ndraws"] == 14901603
    assert runs[4223][0]["member_overflow"] == 18671


BENCH_ARGS = "--bench-args=--nspec 64 --nlive 50 --chunk-iters 50"


def test_rehearsal_two_budgets_and_a_repeat(tmp_path, capsys):
    """The sweep on the CPU at two fixed budgets, one fit after the other,
    then the smaller again in a later call: the same counts twice, in
    total and per chunk; the larger budget runs more rounds; the record
    and verdict are made from the fits."""
    out = tmp_path / "sweep"
    assert mtb.main(["sweep", "--device", "cpu", "--out-dir", str(out),
                     "--only", "16:2:1", "16:16:1", "--cap", "200",
                     BENCH_ARGS]) == 0
    status = json.loads((out / "status.json").read_text())
    assert status["killed"] is None and status["queue"] == []
    assert [(d["name"], d["rc"]) for d in status["done"]] == [
        ("D16_B2_s1.json", 0), ("D16_B16_s1.json", 0)]
    fits = mtb.load_fits([str(out / "fits")])
    assert [(f["fill_budget"], f["dispatch_target"], f["rc"])
            for f in fits] == [(2, 0.0, 0), (16, 0.0, 0)]
    small, big = fits
    assert small["fill_rounds"] < big["fill_rounds"]
    assert small["ndraws"] < big["ndraws"]
    rec = mtb.record(fits, {16: [tpu_run(small["ndraws"], 1, 1, 201)]})
    assert sorted(rec["by_spaxels"][16]) == [2, 16]
    assert rec["verdict"]["b_star"] == {16: []}  # 201 iterations < 90,000
    assert rec["verdict"]["outcome_so_far"] == "B"
    # a later call: the listed fit that the first call made counts as
    # done, the other runs again
    later = tmp_path / "later"
    assert mtb.main(["sweep", "--device", "cpu", "--out-dir", str(later),
                     "--have", str(out / "fits"), "--only", "16:16:1",
                     "16:2:2", "--cap", "200", BENCH_ARGS]) == 0
    assert sorted(os.listdir(later / "fits")) == ["D16_B2_s2.json"]
    again = tmp_path / "again"
    assert mtb.main(["sweep", "--device", "cpu", "--out-dir", str(again),
                     "--only", "16:2:1", "--cap", "200", BENCH_ARGS]) == 0
    a, b = (json.loads((d / "fits" / "D16_B2_s1.json").read_text())
            for d in (out, again))
    for k in ("niter", "ndraws", "fill_rounds", "member_overflow",
              "pile_peak", "stalled", "advances", "running_at_cap"):
        assert a[k] == b[k], k
    keys = ("niter", "ndraws", "fill_rounds", "member_overflow", "advances",
            "running")
    assert [[r.get(k) for k in keys] for r in a["per_chunk"]] == [
        [r.get(k) for k in keys] for r in b["per_chunk"]]


def test_stop_after_starts_no_fit(tmp_path):
    out = tmp_path / "sweep"
    assert mtb.main(["sweep", "--device", "cpu", "--out-dir", str(out),
                     "--only", "16:2:1", "--stop-after", "0",
                     BENCH_ARGS]) == 0
    status = json.loads((out / "status.json").read_text())
    assert status["done"] == [] and status["queue"] == ["D16_B2_s1.json"]


def test_only_lists_the_fits_and_predictions_grow_with_the_budget():
    """``--only``'s fits, else the search's: seed 1 at the starting budget
    at each D."""
    args = argparse.Namespace(
        only=["100:512:1", "4223:1024:2"])
    todo = mtb.plan(args, None)
    assert todo({}) == [(100, 512, 1), (4223, 1024, 2)]
    assert todo({(100, 512, 1): 1.0}) == [(4223, 1024, 2)]
    assert mtb.plan(argparse.Namespace(only=[]),
                    TPU)({}) == [(100, 1024, 1), (1000, 1024, 1),
                                 (4223, 1024, 1)]
