"""Per-dataset candidate shelves (queues) as static-shape tensor ops.

Counterpart of ``massivedatans_tpu/ns/shelves.py``. The reference keeps one
Python list per dataset (``multi_nested_sampler.py:117,481-488,521``); a
shelf here is ``idx[S, D]``, ``L[S, D]`` and ``count[D]``, FIFO within the
first ``count[d]`` slots. The JAX package unrolls its compactions over the
S slots (per-column gathers are slow on the TPU); here each compaction is
one scatter into a spare row ``S`` that is sliced off afterwards, which
gives bitwise the same shelves.
"""

from __future__ import annotations

import dataclasses

import torch

_NEG_INF = -torch.inf


@dataclasses.dataclass
class Shelves:
    idx: torch.Tensor    # [S, D] int32 pile indices (valid in slots < count)
    L: torch.Tensor      # [S, D] float32 log-likelihoods
    count: torch.Tensor  # [D] int32


def init_shelves(capacity: int, ndata: int, device) -> Shelves:
    return Shelves(
        idx=torch.full((capacity, ndata), -1, dtype=torch.int32, device=device),
        L=torch.full((capacity, ndata), _NEG_INF, dtype=torch.float32,
                     device=device),
        count=torch.zeros((ndata,), dtype=torch.int32, device=device),
    )


def _with_spare_row(t, fill):
    return torch.cat([t, torch.full_like(t[:1], fill)], dim=0)


def clean(shelves: Shelves, Lmins) -> Shelves:
    """Drop entries with L <= Lmin(d), preserving FIFO order
    (reference ``prepare()``, multi_nested_sampler.py:134-143)."""
    S = shelves.L.shape[0]
    slot = torch.arange(S, device=Lmins.device)[:, None]
    keep = (slot < shelves.count[None, :]) & (shelves.L > Lmins[None, :])
    keep_i = keep.to(torch.int64)
    pos = torch.cumsum(keep_i, dim=0) - keep_i  # exclusive prefix: output slot
    dst = torch.where(keep, pos, S)             # dropped entries -> spare row
    new_idx = _with_spare_row(torch.full_like(shelves.idx, -1), -1)
    new_L = _with_spare_row(torch.full_like(shelves.L, _NEG_INF), _NEG_INF)
    new_idx.scatter_(0, dst, shelves.idx)
    new_L.scatter_(0, dst, shelves.L)
    return Shelves(idx=new_idx[:S], L=new_L[:S],
                   count=keep.sum(dim=0, dtype=torch.int32))


def live_bottom(live_L, capacity: int):
    """Sorted smallest ``capacity + 1`` live L's per dataset, ``[k, D]``
    ascending — the only part of live_L the insertion thresholds read."""
    k = min(capacity + 1, live_L.shape[0])
    return torch.topk(live_L.T, k, dim=1, largest=False, sorted=True).values.T


def insertion_thresholds(live_bot, shelves: Shelves):
    """Corrected acceptance threshold per dataset (reference
    ``Lmins_higher``/``find_nsmallest``, multi_nested_sampler.py:44-47,
    438-447): a new entry at queue position n = count(d) must exceed the
    n-th smallest of the live and shelved L's combined."""
    S = shelves.L.shape[0]
    slot = torch.arange(S, device=live_bot.device)[:, None]
    shelf_vals = torch.where(slot < shelves.count[None, :], shelves.L, torch.inf)
    cat = torch.sort(torch.cat([live_bot, shelf_vals], dim=0), dim=0).values
    return torch.gather(cat, 0, shelves.count[None, :].to(torch.int64))[0]


def append_batch(shelves: Shelves, cand_idx, cand_L, accept) -> Shelves:
    """Append accepted candidates (in batch order) to each dataset's shelf.

    ``cand_idx[B]`` pile indices, ``cand_L[B, D]`` scores, ``accept[B, D]``
    the acceptance mask. Appends are capped at capacity; batch order is kept
    (FIFO like the reference's list.append).
    """
    S, D = shelves.L.shape
    acc_i = accept.to(torch.int64)
    pos = shelves.count[None, :] + torch.cumsum(acc_i, dim=0) - acc_i
    write = accept & (pos < S)
    dst = torch.where(write, pos, S)  # non-writes land in the spare row
    new_idx = _with_spare_row(shelves.idx, -1)
    new_L = _with_spare_row(shelves.L, _NEG_INF)
    new_idx.scatter_(0, dst, cand_idx[:, None].to(torch.int32).expand(-1, D))
    new_L.scatter_(0, dst, cand_L)
    return Shelves(idx=new_idx[:S], L=new_L[:S],
                   count=shelves.count + write.sum(dim=0, dtype=torch.int32))


def pop(shelves: Shelves, active):
    """Pop the FIFO head for every active dataset (multi_nested_sampler.py:521).

    Returns ``(head_idx[D], head_L[D], new_shelves)``; datasets with
    ``active=False`` (or empty shelves) are untouched and return junk.
    """
    head_idx = shelves.idx[0]
    head_L = shelves.L[0]
    do = (active & (shelves.count > 0))[None, :]
    shifted_idx = _with_spare_row(shelves.idx[1:], -1)
    shifted_L = _with_spare_row(shelves.L[1:], _NEG_INF)
    return head_idx, head_L, Shelves(
        idx=torch.where(do, shifted_idx, shelves.idx),
        L=torch.where(do, shifted_L, shelves.L),
        count=torch.where(do[0], shelves.count - 1, shelves.count),
    )
