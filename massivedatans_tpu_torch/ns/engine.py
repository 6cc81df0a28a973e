"""The joint nested-sampling engine.

Counterpart of ``massivedatans_tpu/ns/engine.py`` (reference
``multi_nested_sampler.py:49-569``), single device:

- the point pile, live-point index matrix and shelves are fixed-shape
  tensors on the device inside one ``EngineState`` dataclass;
- each fill round proposes a candidate batch from the strategy's geometry
  (a region, ellipsoids, or slice or walk chains), scores it against every
  dataset in one ``[B, nx] @ [nx, D]`` product, scatters all acceptances
  into all shelves at once, and feeds back to the strategy which
  candidates beat a running dataset's threshold;
- the streaming logZ/H update (``multi_nested_integrator.py:105-161``) runs
  on the device as part of each iteration, with a per-dataset volume ledger.

The JAX package runs a whole chunk of iterations as one device program
(``lax.while_loop`` over iterations and fill rounds, ``lax.cond`` for the
refocus, the round kind and the rebuild cadence). Here a chunk is a
``ChunkProgram``: a few steps (the chunk start, an iteration's prologue,
one fill round of each kind, an iteration's end) whose control is held in
device flags, each step a no-op on the state where its flag is off. On a
CUDA device every step is captured once as a CUDA graph and the host
replays a schedule of them in blocks, reading one status copy per block;
on the CPU, under a gloo mesh and on request the same steps run eagerly,
with the same operations in the same order. Random draws come from an
explicit ``torch.Generator``, registered with every graph.

Under a dataset mesh (``parallel/sharded.py``) each rank holds a block of
the datasets and passes its data-axis process ``group`` (and, with the
spectral axis sharded, its ``model_group``): every reduction over the
datasets that feeds host control flow or replicated state (the fill and
chunk loop conditions, the rebuild cadence, the strategy and pile votes,
the member set, the phantom candidates, the iteration counter) is taken
over the group, as the JAX package's ``axis_name`` paths do. Every random
draw has a shape that does not depend on the datasets, so the ranks'
generators stay in step. ``group=None`` is the single-device path. With
NCCL groups the steps are captured as on one device, each with its
collectives inside its graph (the JAX package's ``shard_map`` of the
chunk inside one ``jit``): every step issues the same collectives in the
same order whatever the state (its branches are on the configuration
only), every rank reads the same global status, plans the same blocks
and so replays the same graphs in the same order.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time

import torch
import torch.distributed as dist

from massivedatans_tpu_torch.config import RunConfig, require_run_config
from massivedatans_tpu_torch.models.base import Problem
from massivedatans_tpu_torch.ns import shelves as shelves_lib
from massivedatans_tpu_torch.ns.region import Region, ball_offsets, uniform_choice
from massivedatans_tpu_torch.ns.shelves import Shelves
from massivedatans_tpu_torch.parallel.sharded import (
    CALLS,
    all_gather_rows,
    axis_size,
    can_capture,
    global_any,
    global_or_rows,
    group_timeout_s,
)

_NEG_INF = -torch.inf
_I32 = torch.int32


@dataclasses.dataclass
class EngineState:
    # --- point pile (multi_nested_sampler.py:106-107) ---
    pile_u: torch.Tensor      # [P + 1, ndim]; row P is a write sink for
    pile_x: torch.Tensor      # [P + 1, ndim]  appends dropped at capacity
    pile_size: torch.Tensor   # scalar int32
    # --- live points (multi_nested_sampler.py:108-111) ---
    live_idx: torch.Tensor    # [K, D] int32 indices into the pile
    live_L: torch.Tensor      # [K, D]
    shelves: Shelves
    running: torch.Tensor     # [D] bool
    Lmax: torch.Tensor        # [D]
    # --- integration state (multi_nested_integrator.py:90-122) ---
    logZ: torch.Tensor        # [D]
    H: torch.Tensor           # [D]
    # per-dataset volume ledger: a dataset's prior volume shrinks only when
    # it advances (it may skip an iteration whose fill was truncated)
    logVolremaining: torch.Tensor  # [D]
    logwidth: torch.Tensor    # [D] current slab width at each dataset's depth
    last_logwidth: torch.Tensor    # [D] frozen at termination
    rem_logZ: torch.Tensor    # [D] remainder logZ, frozen at termination
    rem_logZerr: torch.Tensor  # [D] remainder logZerr, frozen at termination
    iteration: torch.Tensor   # scalar int32
    ndraws: torch.Tensor      # scalar int64: likelihood-evaluated candidates
    # --- region cache (force_shrink memory, hiermetriclearn.py:53-55) ---
    prev_scale: torch.Tensor  # [ndim]
    prev_radius: torch.Tensor  # scalar
    # --- group decomposition advisory (host-computed, ns/subsets.py) ---
    group_id: torch.Tensor    # [D] int32 connected-component label
    n_groups: int             # number of components (>= 1), a host value
    # --- phantom points (friends.py:54-59,81-84 keep_phantom_points) ---
    phantom_idx: torch.Tensor  # [Q] int32 pile rows; -1 = empty slot
    phantom_L: torch.Tensor    # [Q]
    # --- termination record ---
    term_iter: torch.Tensor   # [D] int32 iteration the dataset stopped; -1 running
    # --- diagnostics ---
    stall_count: torch.Tensor  # [D] int32 iterations with an unfillable shelf
    member_overflow: torch.Tensor  # scalar int32 member-capacity overflows
    fill_rounds: torch.Tensor  # scalar int32 cumulative fill rounds
    draws_at_rebuild: torch.Tensor  # scalar int64 ndraws at the last rebuild

    def replace(self, **kw) -> "EngineState":
        return dataclasses.replace(self, **kw)

    @property
    def pile_capacity(self) -> int:
        return self.pile_u.shape[0] - 1


@dataclasses.dataclass
class DeadChunk:
    """Dead points per dataset: ``[D]`` for one iteration, ``[T, D]`` for
    a chunk's buffer (rows past the executed count stay unwritten)."""

    idx: torch.Tensor       # int32 pile rows (-1 where not advanced)
    L: torch.Tensor         # (-inf where not advanced)
    logwidth: torch.Tensor  # per-dataset slab widths
    running: torch.Tensor


def _safe_logaddexp_update(logZ, H, wi, Li):
    """One streaming (logZ, H) nested-sampling update, -inf-safe."""
    logZnew = torch.logaddexp(logZ, wi)
    t1 = torch.exp(wi - logZnew) * Li
    old = torch.exp(logZ - logZnew) * (H + logZ)
    t2 = torch.where(torch.isfinite(logZ), old, 0.0)
    return logZnew, t1 + t2 - logZnew


def draw_hash_multiplier(generator, device):
    """The random odd multiplier ``a`` of ``_dedup_random``'s hash."""
    return 2 * torch.randint(0, 1 << 31, (), generator=generator,
                             device=device) + 1


def _dedup_random(flat, capacity: int, a):
    """Compact the unique non-negative entries of an int vector.

    When more than ``capacity`` unique values exist, the kept subset is a
    uniform random subsample (the values are ordered by a random bijective
    hash, ``a * (v + 1) mod 2^32`` with the random odd ``a`` of
    ``draw_hash_multiplier``, and the first ``capacity`` are kept): a
    random subsample of live points plus its
    bootstrapped cover radius is still a valid RadFriends region, whereas
    a deterministic subset can miss whole modes. Otherwise the output is
    every unique value in ascending order, independent of the hash.

    The JAX package computes the hash in uint32 wrap-around arithmetic;
    here it is int64 masked to 32 bits, so invalid slots can take a
    sentinel (2^32) that no valid value's hash can reach.
    Returns ``(members_idx[capacity], member_mask[capacity], overflowed)``.
    """
    device = flat.device
    valid = flat >= 0
    v = flat.to(torch.int64)
    h = torch.where(valid, (a * (v + 1)) & 0xFFFFFFFF, 1 << 32)
    sh, order = torch.sort(h)
    sv = v[order]
    ok = sh < (1 << 32)
    first = ok & torch.cat([ok[:1], sh[1:] != sh[:-1]])
    pos = torch.cumsum(first.to(torch.int64), dim=0) - 1
    n_unique = first.sum()
    write_pos = torch.where(first & (pos < capacity), pos, capacity)
    members = torch.zeros((capacity + 1,), dtype=torch.int64, device=device)
    members.scatter_(0, write_pos, torch.where(first, sv, 0))
    n_kept = torch.clamp(n_unique, max=capacity)
    member_mask = torch.arange(capacity, device=device) < n_kept
    # canonical (ascending) order of the kept subset
    members = torch.sort(torch.where(member_mask, members[:capacity],
                                     1 << 62)).values
    members = torch.where(member_mask, members, 0).to(_I32)
    return members, member_mask, (n_unique > capacity).to(_I32)


def unique_members(live_idx, col_mask, capacity: int, a, group=None,
                   extra_idx=None):
    """Compacted unique pile indices over the selected dataset columns
    (replaces ``get_unique_pointsp``, multi_nested_sampler.py:130-132).
    ``a`` is the hash multiplier (``draw_hash_multiplier``); ``extra_idx``:
    more pile rows (phantoms) to include; -1 slots ignored.

    Under a dataset mesh (``group``) each rank's kept set is all-gathered
    (pile indices are global, the pile being replicated) and deduplicated
    again with the same ``a``. A rank keeps the ``capacity`` smallest
    hashes of its own values, so the union holds the ``capacity`` smallest
    of all values: the member set is the single-device one bit for bit,
    overflow or not (the JAX package draws a second key for the gathered
    pass instead). Overflow is the max over ranks of the local flag or the
    gathered pass's flag; the local flags ride the gather, each closing its
    rank's row.
    """
    flat = torch.where(col_mask[None, :], live_idx, -1).reshape(-1)
    if extra_idx is not None:
        flat = torch.cat([flat, extra_idx])
    members, mask, overflow = _dedup_random(flat, capacity, a)
    if group is None:
        return members, mask, overflow
    rows = all_gather_rows(torch.cat([torch.where(mask, members, -1),
                                      overflow.reshape(1)]), group)
    rows = rows.reshape(-1, capacity + 1)
    members, mask, g_overflow = _dedup_random(rows[:, :capacity].reshape(-1),
                                              capacity, a)
    return members, mask, torch.maximum(rows[:, capacity].amax(), g_overflow)


def _build_geometry_from(strategy, state: EngineState, col_mask, generator,
                         cfg: RunConfig, member_capacity: int,
                         carry_cap: bool = True, group=None):
    """Build the strategy geometry from the selected datasets' live points.

    ``carry_cap``: pass the previous global build's force-shrink cap. A
    focused rebuild is a fresh per-mask constrainer (cachedconstrainer.py:
    92-109) and does not; the cap is also dropped when the member set
    overflowed capacity, so the subsample's radius may grow.
    """
    a = draw_hash_multiplier(generator, state.live_idx.device)
    members_idx, member_mask, overflow = unique_members(
        state.live_idx, col_mask, member_capacity, a, group)
    members_u = state.pile_u[members_idx]
    if carry_cap:
        # build_region disables the cap when prev_radius == 0
        prev_radius = torch.where(overflow > 0, 0.0, state.prev_radius)
    else:
        prev_radius = torch.zeros_like(state.prev_radius)
    # phantom members extend the union AFTER the metric fit and radius
    if state.phantom_idx.shape[0] > 0:
        extra_u = state.pile_u[torch.clamp(state.phantom_idx, min=0)]
        extra_mask = state.phantom_idx >= 0
    else:
        extra_u = extra_mask = None
    geom = strategy.build(members_u, member_mask, generator, state.prev_scale,
                          prev_radius, extra_u=extra_u, extra_mask=extra_mask)
    return geom, overflow


def ledger_constant(nlive: int, device):
    """``log(1 - exp(-1/K))`` in float32, the slab-width factor (made on
    the device: a host tensor's copy cannot be captured)."""
    t = torch.full((), -1.0 / nlive, dtype=torch.float32, device=device)
    return torch.log1p(-torch.exp(t))


def init_state(problem: Problem, generator, cfg: RunConfig) -> EngineState:
    """Draw the initial live points, shared across all datasets
    (multi_nested_sampler.py:91-104: the same u serves every dataset)."""
    require_run_config(cfg)
    device = problem.device
    K, D, ndim = cfg.nlive_points, problem.ndata, problem.ndim
    P = cfg.resolve_pile_capacity(D)
    f32 = dict(dtype=torch.float32, device=device)
    u0 = torch.rand((K, ndim), generator=generator, **f32)
    x0 = problem.transform_batch(u0)
    L0 = problem.loglike(x0).to(torch.float32)  # [K, D]
    pile_u = torch.zeros((P + 1, ndim), **f32)
    pile_x = torch.zeros((P + 1, ndim), **f32)
    pile_u[:K] = u0
    pile_x[:K] = x0
    Q = cfg.phantom_capacity
    scalar_i32 = dict(dtype=_I32, device=device)
    return EngineState(
        pile_u=pile_u,
        pile_x=pile_x,
        pile_size=torch.tensor(K, **scalar_i32),
        live_idx=torch.arange(K, **scalar_i32)[:, None].expand(K, D).contiguous(),
        live_L=L0,
        shelves=shelves_lib.init_shelves(cfg.shelf_capacity, D, device),
        running=torch.ones((D,), dtype=torch.bool, device=device),
        Lmax=L0.amax(dim=0),
        logZ=torch.full((D,), _NEG_INF, **f32),
        H=torch.zeros((D,), **f32),
        logVolremaining=torch.zeros((D,), **f32),
        logwidth=ledger_constant(K, device).expand(D).clone(),
        last_logwidth=torch.zeros((D,), **f32),
        rem_logZ=torch.full((D,), _NEG_INF, **f32),
        rem_logZerr=torch.zeros((D,), **f32),
        iteration=torch.tensor(0, **scalar_i32),
        ndraws=torch.tensor(K, dtype=torch.int64, device=device),
        prev_scale=torch.zeros((ndim,), **f32),
        prev_radius=torch.tensor(0.0, **f32),
        group_id=torch.zeros((D,), **scalar_i32),
        n_groups=1,
        phantom_idx=torch.full((Q,), -1, **scalar_i32),
        phantom_L=torch.full((Q,), _NEG_INF, **f32),
        term_iter=torch.full((D,), -1, **scalar_i32),
        stall_count=torch.zeros((D,), **scalar_i32),
        member_overflow=torch.tensor(0, **scalar_i32),
        fill_rounds=torch.tensor(0, **scalar_i32),
        draws_at_rebuild=torch.tensor(0, dtype=torch.int64, device=device),
    )


def _column_proposals(pile_u, live_idx, empty, generator, B: int,
                      norm: str = "euclidean", n_slots: int = 128):
    """Candidates drawn directly from empty-shelf datasets' own RadFriends
    regions (per-column union of balls around that dataset's live points).

    Port of ``engine._column_proposals`` (see its design notes): per-column
    geometry (per-slot whitening, jackknife radius, bounding box) is built
    for ``n_slots`` sampled empty columns, and the B raw candidates fan out
    over those slots; half sample the slot's box and keep points inside its
    union, half sample a ball around one of its live points with the
    1/n_near correction. Candidates credit only their source column.
    Returns ``(u[B, ndim], ok[B], cols[B])``.
    """
    device = pile_u.device
    K, D = live_idx.shape
    ndim = pile_u.shape[1]
    C = max(1, min(n_slots, D))
    # a random subset of the empty columns first (random tiebreak within
    # the empty/non-empty partition), padded with non-empty ones
    tiebreak = torch.rand((D,), generator=generator, device=device)
    slot_cols = torch.argsort(torch.where(empty, tiebreak, 2.0 + tiebreak),
                              stable=True)[:C]
    U_slot = pile_u[live_idx[:, slot_cols]]               # [K, C, ndim]
    mean_c = U_slot.mean(dim=0)                           # [C, ndim]
    scale_c = U_slot.std(dim=0, correction=0) + 1e-12     # population std
    W = (U_slot - mean_c[None]) / scale_c[None]           # [K, C, ndim]

    # per-column jackknife radius in the slot's own whitened frame
    d2_col = None
    for k in range(ndim):
        sq = torch.square(W[:, None, :, k] - W[None, :, :, k])  # [K, K, C]
        if d2_col is None:
            d2_col = sq
        elif norm == "chebyshev":
            d2_col = torch.maximum(d2_col, sq)
        else:
            d2_col = d2_col + sq
    eye = torch.eye(K, dtype=torch.bool, device=device)[:, :, None]
    nn = torch.where(eye, 1e30, d2_col).amin(dim=1)       # [K, C]
    radius_c = torch.sqrt(torch.clamp(nn.amax(dim=0), min=1e-24))  # [C]
    lo_c = W.amin(dim=0) - radius_c[:, None]              # [C, ndim]
    hi_c = W.amax(dim=0) + radius_c[:, None]

    # slot choice restricted to slots whose column is still empty
    slot = uniform_choice(empty[slot_cols], B, generator)  # [B]
    rad = radius_c[slot]

    # box half: uniform in the column's whitened bounding box (+r)
    w_box = lo_c[slot] + (hi_c - lo_c)[slot] * torch.rand(
        (B, ndim), generator=generator, device=device)
    # ball half: around a random live point of the column
    rows = torch.randint(0, K, (B,), generator=generator, device=device)
    w_ball = W[rows, slot] + ball_offsets(generator, B, ndim, rad[:, None],
                                          norm=norm)
    use_box = torch.arange(B, device=device) < (B // 2)
    w = torch.where(use_box[:, None], w_box, w_ball)
    u = w * scale_c[slot] + mean_c[slot]                  # per-slot unwhiten

    sq = torch.square(W[:, slot, :] - w[None, :, :])      # [K, B, ndim]
    d2 = sq.amax(dim=-1) if norm == "chebyshev" else sq.sum(dim=-1)
    nnear = (d2 < torch.square(rad)).sum(dim=0)
    ok_box = nnear > 0
    coin = torch.rand((B,), generator=generator, device=device)
    ok_ball = coin * torch.clamp(nnear, min=1).to(torch.float32) < 1.0
    ok = torch.where(use_box, ok_box, ok_ball)
    in_cube = torch.all((u > 0.0) & (u < 1.0), dim=1)
    cols = slot_cols[slot].to(_I32)
    return u, ok & in_cube & empty.any(), cols


# --- the chunk as a program of captured steps -------------------------------

# the most slots a block holds, and the most rounds a slot or a
# continuation runs (ChunkProgram.plan)
_BLOCK_SLOTS = 16
_SLOT_ROUNDS = 32


def _leaves(tree):
    """The tensors of a state, a geometry or a strategy state, in a fixed
    order: dataclasses by field, tuples in order; other values (the host
    int ``n_groups``) are not leaves."""
    if torch.is_tensor(tree):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in _leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return []


def _clone_tree(tree):
    if torch.is_tensor(tree):
        return tree.clone()
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _clone_tree(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        return tuple(_clone_tree(x) for x in tree)
    return tree


def _pairs(dst, src):
    out = []
    for d, s in zip(_leaves(dst), _leaves(src), strict=True):
        if d is s:
            continue
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"cannot write {s.dtype}{list(s.shape)} into "
                             f"{d.dtype}{list(d.shape)}")
        out.append((d, s))
    return out


def _assign(dst, src):
    """Copy the tensors of ``src`` into those of ``dst``, a tree of the
    same structure, shapes and dtypes; tensors that already are ``dst``'s
    are skipped. ``src`` must not hold views of ``dst``."""
    for d, s in _pairs(dst, src):
        d.copy_(s)


def _commit(dst, src, pred):
    """``_assign`` where the 0-dim bool ``pred`` holds, ``dst`` as it was
    where it does not. Every value is selected before any is written."""
    pairs = _pairs(dst, src)
    vals = [torch.where(pred, s, d) for d, s in pairs]
    for (d, _), v in zip(pairs, vals):
        d.copy_(v)


@dataclasses.dataclass
class ChunkCarry:
    """What a chunk's steps read and write. Every tensor keeps its storage
    for the life of the program: a captured step reads and writes these
    addresses, and a step writes its results into them in place."""

    state: EngineState
    geom: object              # the main geometry
    fgeom: object             # the open fill's geometry (refocus replaces it)
    sstate: object            # the strategy's chains (strategy.init_chains)
    live_bot: torch.Tensor    # [k, D] live_bottom at the iteration's start
    dead: DeadChunk           # [n_iters + 1, D]; row n_iters is a write sink
    budget_in: torch.Tensor   # int64: the chunk's fill-round budget (host)
    n_groups: torch.Tensor    # int32: state.n_groups (host)
    budget: torch.Tensor      # int64: fill rounds left in the chunk
    rnd: torch.Tensor         # int32: rounds of the open fill
    open: torch.Tensor        # bool: an iteration's fill is open
    hold: torch.Tensor        # bool: the open fill outran its slot
    cursor: torch.Tensor      # int32: iterations done, dead rows written
    chunk_rounds: torch.Tensor  # int32: fill rounds run in the chunk
    chunk_fills: torch.Tensor   # int32: the chunk's iterations that ran a round
    status: torch.Tensor      # int64[6]: hold, any running, cursor, rnd,
                              # chunk_rounds, chunk_fills, as the last
                              # "end" step left them


class ChunkProgram:
    """A chunk of up to ``n_iters`` iterations (``run_chunk_inner`` of the
    JAX package) as a few fixed steps over a ``ChunkCarry``:

    - ``start``: the chunk-start geometry build, the budget and cursors;
    - ``begin``: an iteration's prologue (shelf cleaning, the rebuild at
      its cadence, fresh strategy chains), which opens its fill;
    - one fill round of each kind the round schedule uses: ``region`` (the
      strategy's proposals from the fill's geometry), ``focus`` (a refocus
      rebuild from the empty-shelf datasets, then a ``region`` round) and
      ``column`` (``_column_proposals``);
    - ``end``: the advance, the evidence update and the termination check,
      which writes the dead row at the device cursor and closes the fill.

    Every step is predicated on device flags: ``begin`` acts only when no
    fill is open, a dataset runs and the chunk has iterations left; a round
    only while the fill is open and a running dataset still has an empty
    shelf, within the budget and ``cfg.max_fill_rounds``; ``end`` only once
    the fill is done. A step whose flag is off leaves the state, the
    counters and the shelves as they were (its random draws are spent). So
    the host replays a schedule fixed in advance: blocks of ``m`` slots of
    ``begin``, ``R`` rounds (kind by round index) and ``end``, and reads
    one status copy per block. A fill that outruns its ``R`` rounds sets
    ``hold``, which turns every later step of the block off; the next block
    clears it and goes on with rounds ``R..R+C-1`` of that fill (``plan``).

    With ``capture``, each step is captured once as a CUDA graph
    (``torch.cuda.CUDAGraph``, the run's generator registered with it)
    and the blocks are graph replays; without, the same step functions run
    eagerly: on the CPU, under a gloo mesh (whose collectives stage
    through host memory and cannot be captured), and as the card's
    reference. Both dispatch the same operations in the same order, so
    they give the same state bit for bit. Under an NCCL mesh a captured
    step holds its collectives; no process group watches them, so the
    host waits for each block's status under the groups' timeout
    (``wait_polled``) and a rank out of step raises ``TimeoutError``.
    """

    def __init__(self, problem: Problem, cfg: RunConfig, strategy,
                 member_capacity: int, n_iters: int, generator, state,
                 group=None, model_group=None, capture: bool = False):
        self.problem, self.cfg, self.strategy = problem, cfg, strategy
        self.member_capacity, self.n_iters = member_capacity, n_iters
        self.generator = generator
        self.group, self.model_group = group, model_group
        self.device = state.live_L.device
        # nsuperset_draws counts single candidates
        # (multi_nested_sampler.py:373); a round evaluates eval_batch
        self.nsuperset_rounds = max(1, -(-cfg.nsuperset_draws // cfg.eval_batch))
        self.carry = self._make_carry(state)
        self.col_capable = (cfg.use_column_focus and axis_size(group) == 1
                            and isinstance(self.carry.geom, Region))
        # per captured step: its graph, the kernel launches and the
        # collective calls (by kind) that one replay makes
        self.graphs, self.tallies, self.call_tallies = {}, {}, {}
        self.steps = collections.Counter()  # steps run, by name
        self.replays = self.syncs = 0
        self.capture_s = 0.0
        self.pool_bytes = 0  # device memory the captures reserved
        self.rates = None
        self._pinned = self._event = None
        groups = [g for g in (group, model_group) if g is not None]
        # the status read's deadline under a mesh (None: wait as long as
        # the block takes)
        self.timeout_s = (min(group_timeout_s(g) for g in groups)
                          if groups else None)
        if capture:
            self._capture()

    # --- set-up ---

    def _make_carry(self, state) -> ChunkCarry:
        """The carry around ``state``'s own tensors. The geometry and
        chain buffers take their shapes from one build on a copy of the
        run's generator, which leaves the run's draws as they were."""
        cfg, device = self.cfg, self.device
        fork = torch.Generator(device=device)
        fork.set_state(self.generator.get_state())
        geom, _ = _build_geometry_from(self.strategy, state, state.running,
                                       fork, cfg, self.member_capacity,
                                       group=self.group)
        sstate = self.strategy.init_chains(geom, fork)
        K, D = state.live_L.shape
        T = self.n_iters + 1

        def scalar(dtype, value=0):
            return torch.full((), value, dtype=dtype, device=device)

        return ChunkCarry(
            state=state, geom=_clone_tree(geom), fgeom=_clone_tree(geom),
            sstate=_clone_tree(sstate),
            live_bot=torch.zeros((min(cfg.shelf_capacity + 1, K), D),
                                 dtype=torch.float32, device=device),
            dead=DeadChunk(
                idx=torch.full((T, D), -1, dtype=_I32, device=device),
                L=torch.full((T, D), _NEG_INF, dtype=torch.float32,
                             device=device),
                logwidth=torch.zeros((T, D), dtype=torch.float32,
                                     device=device),
                running=torch.zeros((T, D), dtype=torch.bool, device=device)),
            budget_in=scalar(torch.int64), n_groups=scalar(_I32, 1),
            budget=scalar(torch.int64), rnd=scalar(_I32),
            open=scalar(torch.bool), hold=scalar(torch.bool),
            cursor=scalar(_I32), chunk_rounds=scalar(_I32),
            chunk_fills=scalar(_I32),
            status=torch.zeros((6,), dtype=torch.int64, device=device))

    def _capture(self):
        """Capture every step this configuration's schedule uses, into one
        memory pool, on a stream of its own. The kernels' library is
        loaded, the radius workspace of that stream made, the cuBLAS and
        cuSOLVER handles initialised and, under a mesh, each group's NCCL
        communicator used once before, and no eager work is left pending,
        so nothing is allocated outside the pool or created while
        capturing. Under a mesh the capture is thread-local: the process
        group's watchdog thread queries its events meanwhile. A failure
        raises; nothing falls back to the eager path."""
        from massivedatans_tpu_torch.ops import neighbors as kernels

        t0 = time.perf_counter()
        stream = torch.cuda.Stream(self.device)
        kernels.prepare_stream(self.device, stream.cuda_stream)
        with torch.cuda.stream(stream):
            eye = torch.eye(3, device=self.device)
            torch.linalg.cholesky_ex(eye @ eye)
            torch.linalg.solve_triangular(eye, eye[None], upper=False)
            for group in (self.group, self.model_group):
                if group is not None:  # makes its communicator, if none yet
                    dist.all_reduce(torch.zeros(1, device=self.device),
                                    group=group)
        torch.cuda.synchronize(self.device)
        # a capture's entry empties the cache: the reserved memory that
        # remains after it is the pool's
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        mode = "global" if self.timeout_s is None else "thread_local"
        pool = torch.cuda.graph_pool_handle()
        for name in ("start", "begin", "end", *self.kinds()):
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.generator)
            before = [fn.captured for fn in kernels.KERNELS]
            calls = dict(CALLS)
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode=mode):
                self._step(name)
            self.tallies[name] = [fn.captured - b for fn, b in
                                  zip(kernels.KERNELS, before)]
            # a capture issues no collective: its calls count per replay
            self.call_tallies[name] = {k: CALLS[k] - calls[k] for k in CALLS}
            CALLS.update(calls)
            self.graphs[name] = graph
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved

    def kinds(self):
        """The round kinds this configuration's schedule can use."""
        return (("region",) + (("focus",) if self.cfg.use_focus else ())
                + (("column",) if self.col_capable else ()))

    def round_kind(self, r: int, n_groups: int) -> str:
        """The kind of round ``r`` of a fill (multi_nested_sampler.py:
        375-381,415-460): after ``nsuperset_draws`` the geometry is
        refocused every 8th round on the empty-shelf datasets, cycling
        through the groups; column rounds alternate with region rounds
        once the datasets decoupled past ``column_focus_groups``, and take
        3 of 4 rounds once the fill has gone
        ``column_focus_fallback_rounds`` unfilled. A refocus round is never
        a column round (``since`` is then a multiple of 8)."""
        cfg = self.cfg
        since = r - self.nsuperset_rounds
        if since < 0:
            return "region"
        if cfg.use_focus and since % 8 == 0:
            return "focus"
        if self.col_capable and (
                (n_groups > cfg.column_focus_groups and since % 2 == 1)
                or (cfg.column_focus_fallback_rounds > 0
                    and since >= cfg.column_focus_fallback_rounds
                    and since % 4 != 0)):
            return "column"
        return "region"

    # --- the steps ---

    def _step(self, name: str):
        """Run the step ``name`` eagerly (or, inside a capture, record it).
        Steps are looked up here rather than held in a table of bound
        methods: such a table would tie the program, and the process group
        it holds under a mesh, into a reference cycle that outlives the
        run (a gloo group freed at interpreter exit aborts the process)."""
        if name in ("start", "begin", "end"):
            return getattr(self, f"_step_{name}")()
        return self._step_round(name)

    def _step_start(self):
        c, st = self.carry, self.carry.state
        live = global_any(st.running, self.group)
        geom, overflow = _build_geometry_from(
            self.strategy, st, st.running, self.generator, self.cfg,
            self.member_capacity, group=self.group)
        _commit(c.geom, geom, live)
        # the chunk-start build resets the cadence
        _commit((st.member_overflow, st.draws_at_rebuild),
                (st.member_overflow + overflow, st.ndraws), live)
        c.budget.copy_(c.budget_in)
        for t in (c.rnd, c.open, c.hold, c.cursor, c.chunk_rounds,
                  c.chunk_fills):
            t.zero_()
        c.dead.idx.fill_(-1)
        c.dead.L.fill_(_NEG_INF)
        c.dead.logwidth.zero_()
        c.dead.running.zero_()

    def _step_begin(self):
        cfg, c, st = self.cfg, self.carry, self.carry.state
        any_running = global_any(st.running, self.group)
        on = ~c.open & ~c.hold & any_running & (c.cursor < self.n_iters)
        # one bottom-k pass supplies the insertion thresholds' bottom and
        # the per-dataset minimum
        live_bot = shelves_lib.live_bottom(st.live_L, cfg.shelf_capacity)
        shelves = shelves_lib.clean(st.shelves, live_bot[0])
        if cfg.region_rebuild_draws <= 0 and cfg.region_rebuild_every <= 1:
            due = on
        elif cfg.region_rebuild_draws > 0:
            # reference cadence: rebuild after region_rebuild_draws
            # likelihood-evaluated candidates (sample.py:134)
            due = on & (st.ndraws - st.draws_at_rebuild
                        >= cfg.region_rebuild_draws)
        else:
            due = on & ((st.iteration % cfg.region_rebuild_every) == 0)
        geom, overflow = _build_geometry_from(
            self.strategy, st, st.running, self.generator, cfg,
            self.member_capacity, group=self.group)
        _commit(c.geom, geom, due)
        _commit((st.draws_at_rebuild, st.member_overflow),
                (st.ndraws, st.member_overflow + overflow), due)
        # fresh strategy chains every iteration, as in the JAX package
        sstate = self.strategy.init_chains(c.geom, self.generator)
        dst = [c.fgeom, c.sstate, c.live_bot, st.shelves, c.rnd]
        src = [c.geom, sstate, live_bot, shelves, torch.zeros_like(c.rnd)]
        if isinstance(c.geom, Region):  # force_shrink memory (MLFriends)
            dst += [st.prev_scale, st.prev_radius]
            src += [c.geom.metric.scale, c.geom.radius]
        _commit(dst, src, on)
        c.open.copy_(c.open | on)

    def _step_round(self, kind: str):
        """One fill round (reference fill loop, multi_nested_sampler.py:
        365-489): propose, evaluate, scatter the acceptances into every
        shelf, append accepted candidates to the pile, feed the strategy.
        Column proposals draw a ``[D]`` tiebreak and read this rank's
        empty datasets, so they run only where the data axis has one rank
        (the JAX package turns them off under any mesh)."""
        cfg, c, st = self.cfg, self.carry, self.carry.state
        group = self.group
        S, P = cfg.shelf_capacity, st.pile_capacity
        D = st.live_L.shape[1]
        empty = st.running & (st.shelves.count == 0)
        # whether a running dataset still has an empty shelf anywhere rides
        # the round's vote below (one reduction under a mesh)
        going = c.open & ~c.hold & (c.budget > 0) & (c.rnd < cfg.max_fill_rounds)
        if kind == "focus":
            # rebuild the fill's geometry from the empty-shelf datasets'
            # live points only, cycling through the host-computed groups
            cycle = torch.remainder(torch.div(
                c.rnd - self.nsuperset_rounds, 8, rounding_mode="floor"),
                c.n_groups)
            grp_mask = empty & (st.group_id == cycle)
            col_mask = torch.where(
                (c.n_groups <= cfg.column_focus_groups)
                & global_any(grp_mask, group), grp_mask, empty)
            fgeom, overflow = _build_geometry_from(
                self.strategy, st, col_mask, self.generator, cfg,
                self.member_capacity, carry_cap=False, group=group)
        else:
            fgeom = c.fgeom
        if kind == "column":  # the strategy's chains stay as they are
            B_raw = max(cfg.column_proposal_batch or cfg.proposal_batch,
                        cfg.eval_batch)
            u, ok, cols = _column_proposals(
                st.pile_u, st.live_idx, empty, self.generator, B_raw,
                norm=self.strategy.norm, n_slots=cfg.column_slots)
            take = torch.argsort((~ok).to(torch.uint8),
                                 stable=True)[:cfg.eval_batch]
            cand_u, valid, src_col = u[take], ok[take], cols[take]
            sstate = c.sstate
        else:
            cand_u, valid, sstate = self.strategy.propose(
                fgeom, c.sstate, self.generator)
            src_col = None
        cand_x = self.problem.transform_batch(cand_u)
        L = self.problem.loglike_sharded(cand_x, self.model_group)  # [B, D]

        thresh = shelves_lib.insertion_thresholds(c.live_bot, st.shelves)
        space = st.shelves.count < S
        above = st.running[None, :] & (L > thresh[None, :])
        acc = valid[:, None] & space[None, :] & above
        if src_col is not None:
            # column-round candidates only fill their source column
            acc = acc & (src_col[:, None]
                         == torch.arange(D, device=self.device)[None, :])
        # strategy feedback: e.g. slice chains advance when the candidate
        # beats any running dataset's constraint (whitenedmcmc.py:305); and
        # the pile append for candidates accepted by any dataset. Under a
        # mesh both are votes of every rank, taken in one reduction with
        # the empty-shelf flag; a round that is off then appends nothing
        # and evaluates nothing
        vote = torch.cat([above.any(dim=1), acc.any(dim=1), empty.any()[None]])
        vote = global_or_rows(vote, group)
        B = cand_u.shape[0]
        chain_accept, on = vote[:B], going & vote[2 * B]
        newpt, acc, valid = vote[B:2 * B] & on, acc & on, valid & on
        sstate = self.strategy.observe(sstate, cand_u, chain_accept)
        sstate = self.strategy.refresh(fgeom, sstate, self.generator,
                                       chain_accept)

        newpt_i = newpt.to(_I32)
        slots = st.pile_size + torch.cumsum(newpt_i, dim=0, dtype=_I32) - newpt_i
        can_store = newpt & (slots < P)
        write_slots = torch.where(can_store, slots, P).to(torch.int64)
        # appended in place; dropped rows hit the sink row P
        st.pile_u.index_copy_(0, write_slots, cand_u)
        st.pile_x.index_copy_(0, write_slots, cand_x)
        acc = acc & can_store[:, None]
        cand_pile_idx = torch.where(can_store, slots, -1)
        _assign(st.shelves, shelves_lib.append_batch(st.shelves, cand_pile_idx,
                                                     L, acc))
        st.ndraws.add_(valid.sum())
        st.pile_size.add_(can_store.sum(dtype=_I32))
        _commit(c.sstate, sstate, on)
        if kind == "focus":
            _commit((c.fgeom, st.member_overflow),
                    (fgeom, st.member_overflow + overflow), on)
        c.rnd.add_(on.to(_I32))
        c.budget.sub_(on.to(torch.int64))
        c.chunk_rounds.add_(on.to(_I32))
        st.fill_rounds.add_(on.to(_I32))

    def _step_end(self):
        """Close a finished fill: replace each advancing dataset's worst
        live point (multi_nested_sampler.py:494-534), keep the phantoms,
        update the streaming evidence (multi_nested_integrator.py:105-161)
        and check termination; the dead row goes to the device cursor."""
        cfg, c, st = self.cfg, self.carry, self.carry.state
        K, group = cfg.nlive_points, self.group
        device = self.device
        more = global_any(st.running & (st.shelves.count == 0), group)
        done = ~more | (c.budget <= 0) | (c.rnd >= cfg.max_fill_rounds)
        filling = c.open & ~c.hold
        on = filling & done
        hold = c.hold | (filling & ~done)
        # a drained budget means the fill was truncated, not that the
        # contour is unfillable: empty shelves then do not count toward
        # stall termination
        budget_out = c.budget <= 0

        # the argmin row is recovered as a one-hot mask by exact equality
        # with the bottom's first row, ties resolved to the first row
        Lmins = c.live_bot[0]
        hit_raw = st.live_L == Lmins[None, :]
        worst_hit = hit_raw & (torch.cumsum(hit_raw.to(_I32), dim=0) == 1)
        filled = st.shelves.count > 0
        adv = st.running & filled & on
        dead_p = torch.where(worst_hit, st.live_idx, -1).amax(dim=0)
        dead_L = Lmins  # live_L[worst, d] IS the per-column minimum
        head_idx, head_L, shelves = shelves_lib.pop(st.shelves, adv)
        upd = worst_hit & adv[None, :]
        live_idx = torch.where(upd, head_idx[None, :], st.live_idx)
        live_L = torch.where(upd, head_L[None, :], st.live_L)

        # phantom-point memory (friends.py keep_phantom_points); under a
        # mesh the dead set is all-gathered first (rank order is dataset
        # order), which keeps the replicated buffer identical
        phantom = {}
        Q = st.phantom_idx.shape[0]
        if Q > 0:
            # one gather of both rows, in float64 (exact for float32 L
            # and int32 pile rows)
            cand = all_gather_rows(torch.stack([
                torch.where(adv, dead_L, _NEG_INF).to(torch.float64),
                torch.where(adv, dead_p, -1).to(torch.float64)]), group,
                dim=1)
            cand_L, cand_i = cand[0].to(torch.float32), cand[1].to(_I32)
            top_L, sel = torch.topk(torch.cat([st.phantom_L, cand_L]), Q)
            phantom = dict(phantom_idx=torch.cat([st.phantom_idx, cand_i])[sel],
                           phantom_L=top_L)

        logwidth = torch.where(
            adv, ledger_constant(K, device) + st.logVolremaining, st.logwidth)
        wi = logwidth + dead_L
        logZnew, Hnew = _safe_logaddexp_update(st.logZ, st.H, wi, dead_L)
        row = DeadChunk(idx=torch.where(adv, dead_p, -1),
                        L=torch.where(adv, dead_L, _NEG_INF),
                        logwidth=logwidth, running=st.running)
        dest = torch.where(on, c.cursor, self.n_iters).to(torch.int64)[None]
        for buf, value in zip(_leaves(c.dead), _leaves(row)):
            buf.index_copy_(0, dest, value[None])
        new = st.replace(
            shelves=shelves, live_idx=live_idx, live_L=live_L,
            # only the per-dataset minimum is ever replaced, so for K >= 2
            # the live maximum is monotone
            Lmax=(live_L.amax(dim=0) if K == 1 else
                  torch.where(adv, torch.maximum(st.Lmax, head_L), st.Lmax)),
            logZ=torch.where(adv, logZnew, st.logZ),
            H=torch.where(adv, Hnew, st.H),
            logwidth=logwidth,
            last_logwidth=torch.where(st.running, logwidth, st.last_logwidth),
            logVolremaining=st.logVolremaining - torch.where(adv, 1.0 / K, 0.0),
            iteration=st.iteration + 1,
            stall_count=torch.where(
                budget_out, st.stall_count,
                st.stall_count + (st.running & ~filled).to(_I32)),
            **phantom)
        _commit(st, device_termination(new, cfg, K), on)
        c.cursor.add_(on.to(_I32))
        c.chunk_fills.add_((on & (c.rnd > 0)).to(_I32))
        c.open.copy_(c.open & ~on)
        c.hold.copy_(hold)
        c.status.copy_(torch.stack([
            t.to(torch.int64) for t in (
                c.hold, global_any(st.running, group), c.cursor, c.rnd,
                c.chunk_rounds, c.chunk_fills)]))

    # --- the host's schedule ---

    @staticmethod
    def plan(rates, resume_at=None):
        """``(R, m, C)``: rounds per slot, slots per block and the rounds
        that go on with a held fill, from ``rates`` = (the share of
        iterations whose fill runs a round, the mean rounds of such a
        fill), measured on this chunk so far or the last (None: nothing
        measured yet), and the rounds a held fill has run.

        Fills are mostly empty (the shelves hold stock) or long (a slice
        chain's burn-in), so a slot gives no round while most fills are
        empty and else the mean fill's; a block holds half as many slots
        as come before a hold on average (a hold turns the block's later
        slots off, whose steps still run); a held fill goes on for the
        rounds a mean fill has left, or half as many as it ran, whichever
        is more, so that a long fill takes few blocks."""
        share, per_fill = rates if rates else (1.0, 1.0)
        if share < 0.5:
            R, p_hold = 0, share
        else:
            R, p_hold = min(_SLOT_ROUNDS, max(1, math.ceil(per_fill))), 0.5
        m = max(1, min(_BLOCK_SLOTS, round(0.5 / max(p_hold,
                                                     0.5 / _BLOCK_SLOTS))))
        C = max(R, 1)
        if resume_at is not None:
            C = min(_SLOT_ROUNDS, max(1, math.ceil(per_fill) - resume_at,
                                      math.ceil(0.5 * resume_at)))
        return R, m, C

    def _launch(self, name: str):
        self.steps[name] += 1
        graph = self.graphs.get(name)
        if graph is None:
            self._step(name)
            return
        from massivedatans_tpu_torch.ops import neighbors as kernels

        graph.replay()
        self.replays += 1
        # a replay launches the kernels and issues the collectives its
        # capture recorded
        for fn, n in zip(kernels.KERNELS, self.tallies[name]):
            fn.launches += n
        for kind, n in self.call_tallies[name].items():
            CALLS[kind] += n

    def _read_status(self):
        """The host's one read of a block: the status the last ``end``
        step wrote, copied into pinned memory behind an event; under a
        mesh, waited for within the groups' timeout."""
        self.syncs += 1
        status = self.carry.status
        if status.device.type != "cuda":
            return status.tolist()
        if self._pinned is None:
            self._pinned = torch.empty(status.shape, dtype=status.dtype,
                                       pin_memory=True)
            self._event = torch.cuda.Event()
        self._pinned.copy_(status, non_blocking=True)
        self._event.record()
        if self.timeout_s is None:
            self._event.synchronize()
        else:
            wait_polled(self._event.query, self.timeout_s,
                        f"rank {dist.get_rank()}: a chunk block's status "
                        "(a rank out of step?)")
        return self._pinned.tolist()

    def start(self, state: EngineState, fill_budget: int, rates):
        """Load ``state`` into the carry (copying only the tensors that are
        not the carry's own), set the budget and the group count, and
        dispatch the chunk's ``start`` and first block without waiting."""
        c = self.carry
        _assign(c.state, state)
        c.state.n_groups = state.n_groups
        self._n_groups = max(state.n_groups, 1)
        c.budget_in.fill_(fill_budget)
        c.n_groups.fill_(self._n_groups)
        self._hint = rates
        self._cursor, self._resume_at = 0, None
        self._plan = self.plan(rates)
        self._launch("start")
        self._enqueue_block()

    def _enqueue_block(self):
        R, m, C = self._plan
        for slot in range(min(m, self.n_iters - self._cursor)):
            if slot == 0 and self._resume_at is not None:
                self.carry.hold.zero_()  # go on with the held fill
                rounds = range(self._resume_at, self._resume_at + C)
            else:
                self._launch("begin")
                rounds = range(R)
            for r in rounds:
                self._launch(self.round_kind(r, self._n_groups))
            self._launch("end")

    def finish(self):
        """Read each block's status and dispatch the next block until every
        dataset has terminated or ``n_iters`` iterations are done. Returns
        ``(state, dead, rows)`` with the first ``rows`` rows of ``dead``
        written."""
        while True:
            hold, running, cursor, rnd, rounds, fills = self._read_status()
            self._cursor, self._resume_at = cursor, (rnd if hold else None)
            self.rates = (fills / cursor, rounds / max(fills, 1)) \
                if cursor else None
            if not hold and (not running or cursor >= self.n_iters):
                break
            self._plan = self.plan(self.rates or self._hint, self._resume_at)
            self._enqueue_block()
        dead = self.carry.dead
        return self.carry.state, DeadChunk(
            idx=dead.idx[:self.n_iters], L=dead.L[:self.n_iters],
            logwidth=dead.logwidth[:self.n_iters],
            running=dead.running[:self.n_iters]), self._cursor


class ChunkRunner:
    """The chunk programs of one run, one per (configuration, strategy):
    the escalated configuration gets its own. They share one ``EngineState``
    (the first program's carry state), so switching between them copies
    nothing.

    On a CUDA device, without a mesh or on NCCL groups, and unless
    ``eager``, every program is captured (``path == "graph"``); otherwise
    (the CPU, gloo groups, ``eager``) its steps run eagerly
    (``path == "eager"``). ``rates`` are the last chunk's fill rates, from
    which the next chunk's first block plan follows (``ChunkProgram.plan``;
    a checkpoint keeps them, so that a resumed run replays the same plan).
    """

    def __init__(self, problem: Problem, member_capacity: int, n_iters: int,
                 generator, group=None, model_group=None, eager: bool = False):
        self.problem, self.member_capacity = problem, member_capacity
        self.n_iters, self.generator = n_iters, generator
        self.group, self.model_group = group, model_group
        self.capture = (not eager and generator.device.type == "cuda"
                        and can_capture(group) and can_capture(model_group))
        self.programs = {}
        self.rates = None
        self._active = None

    @property
    def path(self) -> str:
        return "graph" if self.capture else "eager"

    def _program(self, cfg, strategy, state) -> ChunkProgram:
        key = (cfg, id(strategy))
        prog = self.programs.get(key)
        if prog is None:
            if self.programs:  # share the first program's state
                state = next(iter(self.programs.values())).carry.state
            prog = self.programs[key] = ChunkProgram(
                self.problem, cfg, strategy, self.member_capacity,
                self.n_iters, self.generator, state, self.group,
                self.model_group, capture=self.capture)
        return prog

    def start(self, state: EngineState, cfg: RunConfig, strategy,
              fill_budget: int | None = None) -> EngineState:
        """Dispatch a chunk from ``state`` (its start and first block) and
        return the state it runs on; ``finish`` completes it."""
        prog = self._program(cfg, strategy, state)
        prog.start(state, fill_budget if fill_budget is not None else (
            cfg.chunk_fill_budget or 2 ** 30), self.rates)
        self._active = prog
        return prog.carry.state

    def finish(self):
        """``(state, dead, rows)`` of the chunk ``start`` dispatched."""
        prog, self._active = self._active, None
        out = prog.finish()
        self.rates = prog.rates or self.rates
        return out

    def stats(self) -> dict:
        progs = self.programs.values()
        return dict(chunk_path=self.path,
                    steps=dict(sum((p.steps for p in progs),
                                   collections.Counter())),
                    graph_replays=sum(p.replays for p in progs),
                    status_reads=sum(p.syncs for p in progs),
                    capture_s=sum(p.capture_s for p in progs),
                    graph_pool_bytes=sum(p.pool_bytes for p in progs))


def wait_polled(done, timeout_s: float, what: str) -> None:
    """Return once ``done()`` is true, polling it and yielding the CPU in
    between; raise ``TimeoutError`` naming ``what`` once ``timeout_s``
    seconds have passed without it."""
    deadline = time.monotonic() + timeout_s
    while not done():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what}: not done after {timeout_s:g} s")
        time.sleep(0)


def remainder_core(live_L, logZ, H, logwidth, Lmax, nlive: int):
    """Remainder integration + termination criterion (reference
    ``integrate_remainder``, multi_nested_integrator.py:26-59), sort-free.

    Returns (remainderZ, remainderZerr, totalZ, totalZerr), each [D].
    """
    L0 = Lmax
    Ls = torch.exp(live_L - L0[None, :])
    Ls_sum = Ls.sum(dim=0)
    Ls_min = torch.exp(live_L.amin(dim=0) - L0)
    Ls_max = torch.exp(0.0 * L0)  # == 1: the max live point equals Lmax
    Lmax_sum = Ls_sum - Ls_min + Ls_max
    Lmin_sum = Ls_sum - Ls_max + Ls_min
    logLmid = torch.log(Ls_sum) + L0
    logZmid = torch.logaddexp(logZ, logwidth + logLmid)
    logZup = torch.logaddexp(logZ, logwidth + torch.log(Lmax_sum) + L0)
    logZlo = torch.logaddexp(logZ, logwidth + torch.log(Lmin_sum) + L0)
    logZerr = logZup - logZlo
    # the reference's sequential H update over the live points telescopes
    # into a closed form (engine.py:969-981 of the JAX package)
    Zf = logZmid
    wgt = torch.exp(logwidth + live_L - Zf[None, :])
    contrib = torch.where(wgt > 0.0, wgt * live_L, 0.0)  # 0 * -inf guard
    prev = torch.where(torch.isfinite(logZ), torch.exp(logZ - Zf) * (H + logZ),
                       0.0)
    Hf = torch.clamp(contrib.sum(dim=0) + prev - Zf, min=0.0)
    totalZerr = logZerr + torch.sqrt(Hf / nlive)
    return logwidth + logLmid, logZerr, logZmid, totalZerr


def resolve_stall_limit(cfg: RunConfig) -> int:
    """Iterations a dataset may sit with an unfillable shelf before being
    force-terminated."""
    return cfg.stall_limit or 2 * max(cfg.check_every, 50)


def device_termination(state: EngineState, cfg: RunConfig, nlive: int):
    """Termination check on the device (multi_nested_integrator.py:136-155):
    tolerance checks every ``cfg.check_every`` iterations, the
    ``max_samples`` cap immediately. Newly terminated datasets freeze their
    remainder estimate and leave ``running``.

    The check is computed every iteration and applied where it is due, so
    the cadence costs no device-to-host read.
    """
    it = state.iteration
    past_min = it > cfg.min_samples
    force_all = (it > cfg.max_samples) if cfg.max_samples else torch.zeros_like(past_min)
    if cfg.check_every <= 1:
        do = torch.ones_like(past_min)
    else:
        do = (((it % cfg.check_every) == 0) & past_min) | force_all
    remZ, remZerr, _totalZ, totalZerr = remainder_core(
        state.live_L, state.logZ, state.H, state.logwidth, state.Lmax, nlive)
    newly = state.running & (totalZerr < cfg.tolerance) & past_min
    newly = torch.where(force_all, state.running, newly)
    # force-terminate datasets the sampler cannot fill
    newly = newly | (state.running & (state.stall_count > resolve_stall_limit(cfg)))
    newly = newly & do
    upd = state.running & do
    return state.replace(
        running=state.running & ~newly,
        rem_logZ=torch.where(upd, remZ, state.rem_logZ),
        rem_logZerr=torch.where(upd, remZerr, state.rem_logZerr),
        term_iter=torch.where(newly, it, state.term_iter),
    )


def _fresh(state: EngineState) -> EngineState:
    """``state`` with copies of its tensors, but for the point pile: a
    chunk appends to the pile in place (the pile is the largest tensor of
    the state, and the state passed in is consumed)."""
    out = _clone_tree(state.replace(pile_u=None, pile_x=None))
    return out.replace(pile_u=state.pile_u, pile_x=state.pile_x)


def run_chunk(problem: Problem, state: EngineState, cfg: RunConfig,
              member_capacity: int, n_iters: int, generator, strategy=None,
              fill_budget: int | None = None, group=None, model_group=None):
    """Run up to ``n_iters`` NS iterations, stopping early once every
    dataset has terminated (``engine.run_chunk_inner`` of the JAX package),
    as a ``ChunkProgram`` of its own: captured on a CUDA device unless a
    mesh group is gloo. Returns ``(state, dead, rows)`` with the
    first ``rows`` rows of ``dead`` written. Under a mesh (``group``: the
    data axis, ``model_group``: the model axis) ``problem`` and ``state``
    are this rank's shards and ``rows`` is the same on every rank. A run
    of many chunks keeps one ``ChunkRunner`` instead (the integrator
    does), so that its programs are built and captured once.
    """
    require_run_config(cfg)
    if strategy is None:
        from massivedatans_tpu_torch.ns.strategies import make_strategy

        strategy = make_strategy(cfg)
    runner = ChunkRunner(problem, member_capacity, n_iters, generator, group,
                         model_group)
    runner.start(_fresh(state), cfg, strategy, fill_budget)
    return runner.finish()


def ns_iteration(problem: Problem, state: EngineState, cfg: RunConfig,
                 member_capacity: int, generator, strategy=None):
    """One joint NS iteration (reference ``__next__`` + integrator body):
    a chunk of one iteration. Returns ``((state, geom, budget_left),
    dead)`` with ``dead`` the iteration's row."""
    if strategy is None:
        from massivedatans_tpu_torch.ns.strategies import make_strategy

        strategy = make_strategy(cfg)
    runner = ChunkRunner(problem, member_capacity, 1, generator)
    runner.start(_fresh(state), cfg, strategy)
    carry = runner._active.carry
    state, dead, _ = runner.finish()
    return (state, carry.geom, int(carry.budget)), DeadChunk(
        idx=dead.idx[0], L=dead.L[0], logwidth=dead.logwidth[0],
        running=dead.running[0])


def capture_tails_idx(state: EngineState):
    """Sorted live points (ascending L) per dataset — the remainder tail
    (multi_nested_integrator.py:149-151): ``(idx_sorted, L_sorted)``."""
    order = torch.argsort(state.live_L, dim=0, stable=True)
    return (torch.gather(state.live_idx, 0, order),
            torch.gather(state.live_L, 0, order))

