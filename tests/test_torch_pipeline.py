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
is a no-op. Under a mesh (ranks with gloo, started by
``parallel.spawn_ranks``) the same witness holds, and each step issues a
fixed sequence of collectives, the same in every state and on every rank,
as a capture of the steps on NCCL groups needs.
"""

import collections
import dataclasses
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from massivedatans_tpu_torch.config import RunConfig
from massivedatans_tpu_torch.models.analytic import (
    make_analytic_gaussian_problem,
    true_logZ,
)
from massivedatans_tpu_torch.ns import engine
from massivedatans_tpu_torch.ns.integrator import multi_nested_integrator
from massivedatans_tpu_torch.ns.strategies import make_strategy
from massivedatans_tpu_torch.parallel import sharded
from massivedatans_tpu_torch.parallel.launch import spawn_ranks

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


# --- the capture witness under a mesh ---------------------------------------------

MESH_TIMEOUT_S = 120
_COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_gather", "gather")


class Collectives:
    """Records each collective this process issues, as (kind, shape,
    dtype, reduce op, mesh axis), in the list of the step that issued it
    (``runs``: one ``(step, calls)`` per step run; ``step`` is set by the
    wrapped steps)."""

    def __init__(self, axes):
        self.axes = axes  # process group -> axis name
        self.runs = []
        self.step = None

    def install(self):
        for kind in _COLLECTIVES:
            setattr(dist, kind, self._recorder(kind, getattr(dist, kind)))

    def _recorder(self, kind, fn):
        def record(*args, **kwargs):
            if self.step is not None:
                # the input: the second argument of the gathers into a
                # tensor or a list, the first of the others
                t = args[1] if kind.startswith("all_gather") else args[0]
                op = kwargs.get("op", dist.ReduceOp.SUM) \
                    if kind == "all_reduce" else None
                self.runs[-1][1].append((kind, tuple(t.shape), str(t.dtype),
                                         str(op), self.axes[kwargs["group"]]))
            return fn(*args, **kwargs)
        return record


def _mesh_program(rank, model_parallel):
    """This rank's chunk program at the sizes of ``_program``: the analytic
    Gaussians (D=6) on a data mesh, or the horns lines (D=6) with the
    spectral axis split over ``model_parallel`` ranks."""
    from massivedatans_tpu_torch.datagen.generators import gen_horns
    from massivedatans_tpu_torch.models.gaussline import make_gaussline_problem

    torch.set_num_threads(1)
    mesh = sharded.make_mesh(rank.world, model_parallel)
    group = sharded.data_axis(mesh)[0]
    model_group = sharded.model_axis(mesh)[0]
    if model_parallel > 1:
        h = gen_horns(6, seed=3)
        problem = make_gaussline_problem(h["x"], h["y"], h["noise_level"])
    else:
        problem = _problem(D=6, seed=25)[1]
    cfg = dataclasses.replace(CFG, phantom_capacity=4)
    gen = torch.Generator().manual_seed(9)
    state = sharded.shard_state(engine.init_state(problem, gen, cfg), mesh)
    prog = engine.ChunkProgram(
        sharded.shard_problem(problem, mesh), cfg, make_strategy(cfg),
        cfg.resolve_member_capacity(6), cfg.chunk_iters, gen, state, group,
        model_group)
    axes = {g: name for g, name in ((group, "data"), (model_group, "model"))
            if g is not None}
    return prog, state, axes


def _mesh_witness_rank(rank, model_parallel):
    """Three chunks (from the initial state, from where the first left
    off, and with every dataset terminated), each step kind run at least
    once in each, under ``Watch`` and ``Collectives``. Returns the kinds,
    the syncing operations found inside and outside the steps, the status
    reads and every step run with its collectives, in order."""
    prog, state, axes = _mesh_program(rank, model_parallel)
    watch, calls = Watch(), Collectives(axes)
    calls.install()
    step = prog._step

    def run(name):
        watch.inside, calls.step = True, name
        calls.runs.append((name, []))
        try:
            return step(name)
        finally:
            watch.inside, calls.step = False, None

    prog._step = run
    with watch:
        for chunk in range(3):
            if chunk == 2:
                state.running.zero_()
            prog.start(state, 2 ** 30, None)
            for kind in prog.kinds():
                prog._step(kind)
            state = prog.finish()[0]
    return dict(kinds=prog.kinds(), found=watch.found, syncs=prog.syncs,
                runs=calls.runs, states=int(state.iteration))


@pytest.mark.parametrize("model_parallel", [1, 2], ids=["data2", "data1_model2"])
def test_mesh_steps_issue_fixed_collectives(model_parallel):
    """On a 2-rank data mesh and on a data 1 x model 2 mesh: no syncing
    or data-shaped operation inside a step (outside, none beyond one
    status read per block); each step issues the same collectives (kind,
    shape, dtype, reduce op, axis) every time it runs, whatever the state;
    and every rank runs the same steps with the same collectives in the
    same order."""
    out = spawn_ranks(_mesh_witness_rank, 2, "gloo", "cpu", MESH_TIMEOUT_S,
                      model_parallel)
    kinds = {"region", "focus"} | ({"column"} if model_parallel > 1 else set())
    for r in out:
        assert set(r["kinds"]) == kinds
        assert not [name for inside, name in r["found"] if inside]
        assert len([name for inside, name in r["found"] if not inside]) \
            <= r["syncs"]
        by_step = collections.defaultdict(set)
        for name, seq in r["runs"]:
            by_step[name].add(tuple(seq))
        assert set(by_step) == {"start", "begin", "end"} | kinds
        for name, seqs in by_step.items():
            assert len(seqs) == 1, (name, seqs)
        # every step votes over the data axis; only a round's likelihood
        # reduces over the model axis
        axes = {name: {c[4] for c in next(iter(seqs))}
                for name, seqs in by_step.items()}
        assert all("data" in a for a in axes.values()), axes
        for name, a in axes.items():
            assert ("model" in a) == (model_parallel > 1 and name in kinds)
        # the first chunk advanced; the last (every dataset off) did not
        assert r["states"] > 0
    assert out[0]["runs"] == out[1]["runs"]
    assert len(out[0]["runs"]) > 3 * (3 + len(kinds))


def _path_rank(rank):
    """The chunk path each setting selects, with a CUDA generator's
    device (selection reads only that) and this rank's gloo group."""
    mesh = sharded.make_mesh(rank.world)
    group = sharded.data_axis(mesh)[0]
    cuda = types.SimpleNamespace(device=torch.device("cuda"))

    def path(**kw):
        return engine.ChunkRunner(None, 0, 1, cuda, **kw).path

    return dict(
        can_capture=(sharded.can_capture(group), sharded.can_capture(None)),
        timeout_s=sharded.group_timeout_s(group),
        paths=[path(), path(eager=True), path(group=group),
               path(model_group=group), path(group=group, eager=True)])


def test_gloo_groups_and_eager_select_the_eager_path():
    """A card without a mesh captures; ``eager=True`` and a gloo group (on
    either axis) run eagerly; the status read's deadline is the group's
    own timeout."""
    for r in spawn_ranks(_path_rank, 2, "gloo", "cpu", MESH_TIMEOUT_S):
        assert r["can_capture"] == (False, True)
        assert r["timeout_s"] == MESH_TIMEOUT_S
        assert r["paths"] == ["graph", "eager", "eager", "eager", "eager"]


def test_status_wait_raises_past_its_deadline():
    """The status read's wait under a mesh: a query that never completes
    raises ``TimeoutError`` naming what it waited for, soon after the
    deadline; one that completes returns."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="rank 3: a block"):
        engine.wait_polled(lambda: False, 0.2, "rank 3: a block")
    assert 0.2 <= time.monotonic() - t0 < 5.0
    polls = iter([False, False, True])
    engine.wait_polled(lambda: next(polls), 0.2, "never")
    assert next(polls, None) is None


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
