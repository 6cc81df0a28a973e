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
(``lax.while_loop``); here the fill loop and the iteration loop are Python
loops. Their round counters are host integers, so the refocus and
column-round decisions read nothing from the device; the loop conditions
read one flag per fill round and the rebuild cadence one flag per
iteration. Random draws come from an explicit ``torch.Generator``.

Under a dataset mesh (``parallel/sharded.py``) each rank holds a block of
the datasets and passes its data-axis process ``group`` (and, with the
spectral axis sharded, its ``model_group``): every reduction over the
datasets that feeds host control flow or replicated state (the fill and
chunk loop conditions, the rebuild cadence, the strategy and pile votes,
the member set, the phantom candidates, the iteration counter) is taken
over the group, as the JAX package's ``axis_name`` paths do. Every random
draw has a shape that does not depend on the datasets, so the ranks'
generators stay in step. ``group=None`` is the single-device path.
"""

from __future__ import annotations

import dataclasses

import torch

from massivedatans_tpu_torch.config import RunConfig, require_run_config
from massivedatans_tpu_torch.models.base import Problem
from massivedatans_tpu_torch.ns import shelves as shelves_lib
from massivedatans_tpu_torch.ns.region import Region, ball_offsets, uniform_choice
from massivedatans_tpu_torch.ns.shelves import Shelves
from massivedatans_tpu_torch.parallel.sharded import (
    all_gather_rows,
    axis_size,
    global_any,
    global_max,
    global_or_rows,
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
    gathered pass's flag.
    """
    flat = torch.where(col_mask[None, :], live_idx, -1).reshape(-1)
    if extra_idx is not None:
        flat = torch.cat([flat, extra_idx])
    members, mask, overflow = _dedup_random(flat, capacity, a)
    if group is None:
        return members, mask, overflow
    gathered = all_gather_rows(torch.where(mask, members, -1), group)
    members, mask, g_overflow = _dedup_random(gathered, capacity, a)
    return members, mask, torch.maximum(global_max(overflow, group),
                                        g_overflow)


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
    """``log(1 - exp(-1/K))`` in float32, the slab-width factor."""
    t = torch.tensor(-1.0 / nlive, dtype=torch.float32, device=device)
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


def _fill_shelves(problem: Problem, state: EngineState, strategy, geom,
                  sstate, cfg: RunConfig, member_capacity: int, generator,
                  budget_left: int | None = None, live_bot=None, group=None,
                  model_group=None):
    """Propose/evaluate/scatter until every running dataset has a queued
    candidate (reference fill loop, multi_nested_sampler.py:365-489).

    ``sstate`` is the strategy's state (``strategy.init_chains``); it is
    carried through the rounds and fed back after each scoring (a refocus
    rebuilds the geometry and keeps it). ``budget_left`` meters fill rounds
    across a chunk; the loop also exits when it reaches zero, leaving some
    shelves empty (those datasets skip this iteration). Returns
    ``(state, budget_left)``.

    Column proposals draw a ``[D]`` tiebreak and read the empty datasets
    of this rank only, so they run only where the data axis has one rank
    (the JAX package turns them off under any mesh; at one rank they keep
    the single-device trajectory).
    """
    S = cfg.shelf_capacity
    # nsuperset_draws counts single candidates (multi_nested_sampler.py:373);
    # a round evaluates eval_batch at once
    nsuperset_rounds = max(1, -(-cfg.nsuperset_draws // cfg.eval_batch))
    focus_every = 8
    if live_bot is None:
        live_bot = shelves_lib.live_bottom(state.live_L, S)
    budget = 2 ** 30 if budget_left is None else budget_left
    col_capable = (cfg.use_column_focus and axis_size(group) == 1
                   and isinstance(geom, Region))
    n_groups = max(state.n_groups, 1)
    D = state.live_L.shape[1]
    P = state.pile_capacity
    device = state.live_L.device
    cols_all = torch.arange(D, device=device)[None, :]
    B_raw = max(cfg.column_proposal_batch or cfg.proposal_batch, cfg.eval_batch)

    pile_size, shelves, ndraws = state.pile_size, state.shelves, state.ndraws
    overflow = torch.zeros((), dtype=_I32, device=device)
    rnd = 0

    def need_more(sh):
        return bool(global_any(state.running & (sh.count == 0), group))

    more = need_more(shelves)
    while rnd < cfg.max_fill_rounds and budget > 0 and more:
        since = rnd - nsuperset_rounds
        # focused draws: after nsuperset_draws rounds, rebuild the geometry
        # from only the empty-shelf datasets' live points, cycling through
        # the host-computed groups (multi_nested_sampler.py:375-381,415-460)
        if cfg.use_focus and since >= 0 and since % focus_every == 0:
            empty = state.running & (shelves.count == 0)
            grp_mask = empty & (state.group_id == (since // focus_every) % n_groups)
            col_mask = empty
            if n_groups <= cfg.column_focus_groups:
                col_mask = torch.where(global_any(grp_mask, group), grp_mask,
                                       empty)
            geom, ovf = _build_geometry_from(
                strategy, state, col_mask, generator,
                cfg, member_capacity, carry_cap=False, group=group)
            overflow = overflow + ovf

        # column rounds: alternate with region rounds once the datasets
        # decoupled past the group-cycling regime, and take 3 of 4 rounds
        # once this fill has gone column_focus_fallback_rounds unfilled
        use_cols = col_capable and since >= 0 and (
            (n_groups > cfg.column_focus_groups and since % 2 == 1)
            or (cfg.column_focus_fallback_rounds > 0
                and since >= cfg.column_focus_fallback_rounds
                and since % 4 != 0))
        if use_cols:
            empty_now = state.running & (shelves.count == 0)
            u, ok, cols = _column_proposals(
                state.pile_u, state.live_idx, empty_now, generator, B_raw,
                norm=strategy.norm, n_slots=cfg.column_slots)
            take = torch.argsort((~ok).to(torch.uint8), stable=True)[:cfg.eval_batch]
            cand_u, valid, src_col = u[take], ok[take], cols[take]
        else:  # column rounds leave sstate as it is
            cand_u, valid, sstate = strategy.propose(geom, sstate, generator)
            src_col = None
        cand_x = problem.transform_batch(cand_u)
        L = problem.loglike_sharded(cand_x, model_group)    # [B, D]

        thresh = shelves_lib.insertion_thresholds(live_bot, shelves)
        space = shelves.count < S
        above = state.running[None, :] & (L > thresh[None, :])
        acc = valid[:, None] & space[None, :] & above
        if src_col is not None:
            # column-round candidates only fill their source column
            acc = acc & (src_col[:, None] == cols_all)

        # strategy feedback: e.g. slice chains advance when the candidate
        # beats any running dataset's constraint (whitenedmcmc.py:305); and
        # the pile append for candidates accepted by any dataset. Under a
        # mesh both are votes of every rank, taken in one reduction
        chain_accept, newpt = above.any(dim=1), acc.any(dim=1)
        if group is not None:
            chain_accept, newpt = global_or_rows(
                torch.stack([chain_accept, newpt]), group)
        sstate = strategy.observe(sstate, cand_u, chain_accept)
        sstate = strategy.refresh(geom, sstate, generator, chain_accept)

        newpt_i = newpt.to(_I32)
        slots = pile_size + torch.cumsum(newpt_i, dim=0, dtype=_I32) - newpt_i
        can_store = newpt & (slots < P)
        write_slots = torch.where(can_store, slots, P).to(torch.int64)
        # appended in place (the pile is the largest tensor of the state,
        # and the state passed in is consumed); dropped rows hit the sink
        state.pile_u.index_copy_(0, write_slots, cand_u)
        state.pile_x.index_copy_(0, write_slots, cand_x)
        acc = acc & can_store[:, None]
        cand_pile_idx = torch.where(can_store, slots, -1)

        shelves = shelves_lib.append_batch(shelves, cand_pile_idx, L, acc)
        ndraws = ndraws + valid.sum()
        pile_size = pile_size + can_store.sum(dtype=_I32)
        rnd += 1
        budget -= 1
        more = need_more(shelves)

    return state.replace(
        pile_size=pile_size, shelves=shelves,
        ndraws=ndraws, member_overflow=state.member_overflow + overflow,
        fill_rounds=state.fill_rounds + rnd,
    ), budget


def ns_iteration(problem: Problem, state: EngineState, cfg: RunConfig,
                 member_capacity: int, generator, strategy=None,
                 geom_carry=None, budget_left: int | None = None, group=None,
                 model_group=None, any_running=None):
    """One joint NS iteration: clean shelves, fill, advance every dataset,
    update the streaming evidence (reference __next__ + integrator body).

    ``geom_carry``: the previous iteration's geometry, reused unless the
    rebuild cadence fires. ``any_running``: ``global_any(state.running,
    group)`` where the caller has it already (the chunk loop's
    condition). Returns ``((state, geom, budget_left), dead)``.
    """
    if strategy is None:
        from massivedatans_tpu_torch.ns.strategies import make_strategy

        strategy = make_strategy(cfg)
    K = cfg.nlive_points
    device = state.live_L.device

    # one bottom-k pass supplies the sorted bottom (insertion thresholds)
    # and the per-dataset minimum; the argmin row is recovered as a one-hot
    # mask by exact equality, ties resolved to the first row
    live_bot = shelves_lib.live_bottom(state.live_L, cfg.shelf_capacity)
    Lmins = live_bot[0]
    hit_raw = state.live_L == Lmins[None, :]
    worst_hit = hit_raw & (torch.cumsum(hit_raw.to(_I32), dim=0) == 1)
    state = state.replace(shelves=shelves_lib.clean(state.shelves, Lmins))
    # a dataset running anywhere on the mesh; ``running`` changes only in
    # device_termination at the end, so this serves the rebuild cadence
    # and the iteration counter alike
    if any_running is None:
        any_running = global_any(state.running, group)

    if geom_carry is None or (
        cfg.region_rebuild_draws <= 0 and cfg.region_rebuild_every <= 1
    ):
        do = True
    elif cfg.region_rebuild_draws > 0:
        # reference cadence: rebuild after region_rebuild_draws
        # likelihood-evaluated candidates (sample.py:134)
        do = bool((state.ndraws - state.draws_at_rebuild
                   >= cfg.region_rebuild_draws) & any_running)
    else:
        do = bool(((state.iteration % cfg.region_rebuild_every) == 0)
                  & any_running)
    if do:
        geom, overflow = _build_geometry_from(
            strategy, state, state.running, generator, cfg, member_capacity,
            group=group)
        state = state.replace(
            draws_at_rebuild=state.ndraws,
            member_overflow=state.member_overflow + overflow)
    else:
        geom = geom_carry
    if isinstance(geom, Region):  # force_shrink memory (MLFriends only)
        state = state.replace(prev_scale=geom.metric.scale,
                              prev_radius=geom.radius)
    # fresh strategy state every iteration, as in the JAX package
    sstate = strategy.init_chains(geom, generator)

    state, budget_left = _fill_shelves(
        problem, state, strategy, geom, sstate, cfg, member_capacity,
        generator, budget_left, live_bot=live_bot, group=group,
        model_group=model_group)
    # a drained budget means the fill was truncated, not that the contour is
    # unfillable: empty shelves then do not count toward stall termination
    budget_out = budget_left <= 0

    # --- advance: replace each dataset's worst live point (.:494-534) ---
    filled = state.shelves.count > 0
    adv = state.running & filled
    dead_p = torch.where(worst_hit, state.live_idx, -1).amax(dim=0)
    dead_L = Lmins  # live_L[worst, d] IS the per-column minimum, bit-exactly

    head_idx, head_L, shelves = shelves_lib.pop(state.shelves, adv)
    upd = worst_hit & adv[None, :]
    live_idx = torch.where(upd, head_idx[None, :], state.live_idx)
    live_L = torch.where(upd, head_L[None, :], state.live_L)

    # --- phantom-point memory (friends.py keep_phantom_points) ---
    # under a mesh the dead set is all-gathered first (rank order is
    # dataset order), which keeps the replicated buffer identical
    Q = state.phantom_idx.shape[0]
    if Q > 0:
        cand_L = all_gather_rows(torch.where(adv, dead_L, _NEG_INF), group)
        cand_i = all_gather_rows(torch.where(adv, dead_p, -1), group)
        all_L = torch.cat([state.phantom_L, cand_L])
        all_i = torch.cat([state.phantom_idx, cand_i])
        top_L, sel = torch.topk(all_L, Q)
        state = state.replace(phantom_idx=all_i[sel], phantom_L=top_L)

    # --- streaming evidence update (multi_nested_integrator.py:105-161) ---
    active = any_running
    logwidth = torch.where(
        adv, ledger_constant(K, device) + state.logVolremaining, state.logwidth)
    wi = logwidth + dead_L
    logZnew, Hnew = _safe_logaddexp_update(state.logZ, state.H, wi, dead_L)
    dead = DeadChunk(
        idx=torch.where(adv, dead_p, -1),
        L=torch.where(adv, dead_L, _NEG_INF),
        logwidth=logwidth,
        running=state.running,
    )
    state = state.replace(
        shelves=shelves,
        live_idx=live_idx,
        live_L=live_L,
        # only the per-dataset minimum is ever replaced, so for K >= 2 the
        # live maximum is monotone
        Lmax=(live_L.amax(dim=0) if K == 1 else
              torch.where(adv, torch.maximum(state.Lmax, head_L), state.Lmax)),
        logZ=torch.where(adv, logZnew, state.logZ),
        H=torch.where(adv, Hnew, state.H),
        logwidth=logwidth,
        last_logwidth=torch.where(state.running, logwidth, state.last_logwidth),
        logVolremaining=state.logVolremaining - torch.where(adv, 1.0 / K, 0.0),
        iteration=state.iteration + active.to(_I32),
        stall_count=(state.stall_count if budget_out else
                     state.stall_count + (state.running & ~filled).to(_I32)),
    )
    state = device_termination(state, cfg, K)
    return (state, geom, budget_left), dead


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


def run_chunk(problem: Problem, state: EngineState, cfg: RunConfig,
              member_capacity: int, n_iters: int, generator, strategy=None,
              fill_budget: int | None = None, group=None, model_group=None):
    """Run up to ``n_iters`` NS iterations, stopping early once every
    dataset has terminated (``engine.run_chunk_inner`` of the JAX package,
    as a host loop). Returns ``(state, dead, rows)`` with the first ``rows``
    rows of ``dead`` written. Under a mesh (``group``: the data axis,
    ``model_group``: the model axis) ``problem`` and ``state`` are this
    rank's shards and ``rows`` is the same on every rank.
    """
    require_run_config(cfg)
    if strategy is None:
        from massivedatans_tpu_torch.ns.strategies import make_strategy

        strategy = make_strategy(cfg)
    geom, overflow0 = _build_geometry_from(
        strategy, state, state.running, generator, cfg, member_capacity,
        group=group)
    state = state.replace(
        member_overflow=state.member_overflow + overflow0,
        draws_at_rebuild=state.ndraws,  # chunk-start build resets the cadence
    )
    budget = fill_budget if fill_budget is not None else (
        cfg.chunk_fill_budget or 2 ** 30)
    D = state.live_L.shape[1]
    device = state.live_L.device
    dead = DeadChunk(
        idx=torch.full((n_iters, D), -1, dtype=_I32, device=device),
        L=torch.full((n_iters, D), _NEG_INF, dtype=torch.float32, device=device),
        logwidth=torch.zeros((n_iters, D), dtype=torch.float32, device=device),
        running=torch.zeros((n_iters, D), dtype=torch.bool, device=device),
    )
    rows = 0
    while rows < n_iters:
        any_running = global_any(state.running, group)
        if not bool(any_running):
            break
        (state, geom, budget), row = ns_iteration(
            problem, state, cfg, member_capacity, generator, strategy, geom,
            budget, group=group, model_group=model_group,
            any_running=any_running)
        dead.idx[rows] = row.idx
        dead.L[rows] = row.L
        dead.logwidth[rows] = row.logwidth
        dead.running[rows] = row.running
        rows += 1
    return state, dead, rows


def capture_tails_idx(state: EngineState):
    """Sorted live points (ascending L) per dataset — the remainder tail
    (multi_nested_integrator.py:149-151): ``(idx_sorted, L_sorted)``."""
    order = torch.argsort(state.live_L, dim=0, stable=True)
    return (torch.gather(state.live_idx, 0, order),
            torch.gather(state.live_L, 0, order))

