"""The chunk program and the pipelined integrator of the port.

Ports of ``tests/test_integrator_pipeline.py::test_lookahead_matches_synchronous``
and ``::test_compaction_under_lookahead_logZ`` at their sizes, configuration
and seeds (a JAX ``jax.random.key(s)`` is the port's generator seeded
``s``), and the CPU's witness that a chunk can be captured as CUDA graphs:
every step of ``engine.ChunkProgram``, run under a ``TorchDispatchMode``,
issues no operation that reads the device from the host or has a shape
that depends on the data, and a whole chunk issues none outside the one
status read per block. The steps' predication is held directly: a step
whose flag is off changes nothing, and a chunk issued after termination
is a no-op.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from massivedatans_tpu_torch.config import RunConfig
from massivedatans_tpu_torch.models.analytic import (
    make_analytic_gaussian_problem,
    true_logZ,
)
from massivedatans_tpu_torch.ns import engine
from massivedatans_tpu_torch.ns.integrator import multi_nested_integrator
from massivedatans_tpu_torch.ns.strategies import make_strategy

torch.set_num_threads(1)

CFG = RunConfig(
    nlive_points=50,
    proposal_batch=128,
    eval_batch=32,
    shelf_capacity=4,
    chunk_iters=20,
    max_fill_rounds=256,
)


def _problem(D=6, ndim=2, seed=21):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.3, 0.7, size=(D, ndim))
    return centers, make_analytic_gaussian_problem(centers, sigma=0.07)


def _run(cfg, problem, **kw):
    return multi_nested_integrator(
        problem, cfg, device="cpu", generator=torch.Generator().manual_seed(4),
        progress=False, **kw)


def test_lookahead_matches_synchronous():
    """:59. Issuing chunks ahead of the reports does not change the
    trajectory."""
    _, problem = _problem(seed=22)
    sync = _run(dataclasses.replace(CFG, pipeline_lookahead=0), problem)
    pipe = _run(dataclasses.replace(CFG, pipeline_lookahead=2), problem)
    np.testing.assert_array_equal(sync.L, pipe.L)
    np.testing.assert_allclose(sync.logZ, pipe.logZ, rtol=0, atol=1e-6)
    assert sync.niterations == pipe.niterations
    assert sync.ndraws == pipe.ndraws
    # the no-op chunks issued after termination add chunks, not rows
    assert pipe.stats["chunks"] >= sync.stats["chunks"]


def test_compaction_under_lookahead_logZ():
    """:133. Compaction and lookahead together (the drain-then-compact
    path) keep the evidence bar and records whose u reproduce their x."""
    centers, problem = _problem(D=8, seed=23)
    cfg = dataclasses.replace(CFG, pile_capacity=1024, pipeline_lookahead=2)
    result = _run(cfg, problem)
    assert result.stats["pile_peak"] <= 1024
    lz_true = true_logZ(centers, sigma=0.07)
    err = result.logZerr + np.sqrt(np.maximum(result.information, 0.0) / 50)
    assert (np.abs(result.logZ - lz_true) < 3.5 * err + 0.8).all()
    sel = result.mask.any(axis=1)
    u = result.u[sel].reshape(-1, 2)
    x = result.x[sel].reshape(-1, 2)
    x2 = problem.transform_batch(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(x, x2, rtol=1e-5, atol=1e-6)


# --- the capture witness ---------------------------------------------------------

# operations that read the device from the host, whose output shape
# depends on the data, or that copy a host tensor to the device
# (``torch.tensor`` of a value: ``lift_fresh``): none may run inside a
# captured step
SYNCING = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
           "aten.unique", "aten._unique", "aten.unique_consecutive",
           "aten.repeat_interleave", "aten.item", "aten.equal",
           "aten.is_nonzero", "aten.masked_scatter", "aten.allclose",
           "aten.lift_fresh")


class Watch(TorchDispatchMode):
    """Records each syncing or data-shaped operation, with whether it ran
    inside a step (``inside`` is set by the wrapped steps)."""

    def __init__(self):
        super().__init__()
        self.inside = False
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bool_index = name.startswith("aten.index.Tensor") and any(
            torch.is_tensor(i) and i.dtype == torch.bool
            for i in (args[1] if len(args) > 1 else ()) if i is not None)
        if name.startswith(SYNCING) or bool_index:
            self.found.append((self.inside, name))
        return func(*args, **(kwargs or {}))


def _watched(prog, watch):
    step = prog._step

    def run(name):
        watch.inside = True
        try:
            return step(name)
        finally:
            watch.inside = False

    prog._step = run


def _program(constrainer, **cfg_kw):
    _, problem = _problem(D=6, seed=25)
    cfg = dataclasses.replace(CFG, constrainer=constrainer, phantom_capacity=4,
                              **cfg_kw)
    gen = torch.Generator().manual_seed(9)
    state = engine.init_state(problem, gen, cfg)
    prog = engine.ChunkProgram(
        problem, cfg, make_strategy(cfg), cfg.resolve_member_capacity(6),
        cfg.chunk_iters, gen, state)
    return prog, state


@pytest.mark.parametrize("constrainer", ["MLFRIENDS", "MULTIELLIPSOIDS",
                                         "SLICE", "GALILEAN", "SUPFRIENDS"])
def test_steps_issue_no_host_read(constrainer):
    """Every step of every round kind the configuration uses, and a whole
    chunk, under the dispatch mode: no syncing or data-shaped operation
    inside a step; outside, none beyond one status read per block."""
    prog, state = _program(constrainer)
    assert "region" in prog.kinds()
    if constrainer in ("MLFRIENDS", "SUPFRIENDS"):
        assert set(prog.kinds()) == {"region", "focus", "column"}
    watch = Watch()
    _watched(prog, watch)
    with watch:
        prog.start(state, 2 ** 30, None)
        for kind in prog.kinds():  # each kind at least once, in a fill
            prog._step(kind)
        prog.finish()
    inside = [name for flag, name in watch.found if flag]
    assert not inside, inside
    outside = [name for flag, name in watch.found if not flag]
    assert len(outside) <= prog.syncs, (outside, prog.syncs)
    assert prog.syncs >= 1


def test_steps_that_are_off_change_nothing():
    """With every dataset terminated no step is on: replaying the whole
    schedule leaves every tensor of the state as it was (but the pile's
    sink row, which takes the writes a step drops)."""
    prog, state = _program("MLFRIENDS")
    state.running.zero_()

    def tensors(st):
        return [st.pile_u[:-1], st.pile_x[:-1]] + engine._leaves(
            st.replace(pile_u=None, pile_x=None))

    before = [t.clone() for t in tensors(prog.carry.state)]
    prog.start(state, 2 ** 30, None)
    for name in ("begin", *prog.kinds(), "end"):
        prog._step(name)
    _, _, rows = prog.finish()
    assert rows == 0
    for a, b in zip(before, tensors(prog.carry.state), strict=True):
        assert torch.equal(a, b)


def test_held_fill_continues_across_blocks():
    """A fill that outruns its slot holds the rest of the block and goes
    on in the next one: a chunk whose every fill needs many rounds still
    runs its iterations, one status read per block."""
    # two candidates a round and two shelf slots: fills take several rounds
    prog, state = _program("MLFRIENDS", eval_batch=2, proposal_batch=8,
                           shelf_capacity=2)
    prog.start(state, 2 ** 30, None)  # R = 1, m = 1
    _, dead, rows = prog.finish()
    st = prog.carry.state
    assert rows == CFG.chunk_iters == int(st.iteration)
    assert int(st.fill_rounds) > 0
    # 2 blocks of 10 slots would do without a hold; every hold adds one
    assert prog.syncs > 2
    assert (dead.idx[:rows] >= 0).any(dim=1).all()


def test_block_plan():
    """Mostly empty fills: slots without rounds, many to a block; mostly
    filling: the mean fill's rounds, two slots; a held fill goes on for
    what a mean fill has left, or half what it ran, within the caps."""
    plan = engine.ChunkProgram.plan
    assert plan(None) == (1, 1, 1)
    assert plan((0.1, 1.5)) == (0, 5, 1)
    assert plan((0.01, 1.0)) == (0, engine._BLOCK_SLOTS, 1)
    assert plan((0.8, 5.2)) == (6, 1, 6)
    assert plan((0.2, 16.0), resume_at=0) == (0, 2, 16)
    assert plan((0.2, 16.0), resume_at=20) == (0, 2, 10)
    assert plan((1.0, 175.0), resume_at=0)[2] == engine._SLOT_ROUNDS


# --- on the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_captured_chunks_equal_the_eager_ones():
    """On a card, the captured path (CUDA graph replays) and the eager run
    of the same steps give the same run bit for bit, launches included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from massivedatans_tpu_torch.ops import neighbors

    _, problem = _problem(D=8, seed=23)
    out = []
    for eager in (False, True):
        neighbors.count_within.launches = 0
        neighbors.bootstrapped_sq_radius.launches = 0
        r = multi_nested_integrator(
            problem, CFG, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(4),
            progress=False, eager=eager)
        out.append((r, neighbors.count_within.launches,
                    neighbors.bootstrapped_sq_radius.launches))
    (g, gc, gb), (e, ec, eb) = out
    assert g.stats["chunk_path"] == "graph" and e.stats["chunk_path"] == "eager"
    assert g.stats["graph_replays"] > 0 and e.stats["graph_replays"] == 0
    np.testing.assert_array_equal(g.logZ, e.logZ)
    np.testing.assert_array_equal(g.L, e.L)
    assert (g.niterations, g.ndraws, g.stats["fill_rounds"], gc, gb) == (
        e.niterations, e.ndraws, e.stats["fill_rounds"], ec, eb)
