"""Dataset-parallel execution over a ``torch.distributed`` device mesh.

Counterpart of ``massivedatans_tpu/parallel/sharded.py``. The JAX package
is single-controller: one program shards the dataset axis D over a
``jax.sharding.Mesh`` with ``shard_map``. Here every rank is a process of
its own (``parallel/launch.py``) that runs the same host loop on its
contiguous block of datasets:

- per-dataset state (live points, shelves, logZ/H, running masks) and the
  spectra are sliced on D; rank r of a data axis of size W holds datasets
  ``[r D/W, (r+1) D/W)``, so a gather in rank order gives the
  single-device order;
- the point pile, the proposals and the region are replicated: every rank
  draws from an identically seeded generator with shapes that do not
  depend on D, so one model evaluation per candidate serves every rank;
- the only communication is the JAX package's: an ``all_reduce`` vote for
  the fill loop, an ``all_reduce`` vote that keeps the pile identical, and
  ``all_gather`` of the unique member indices and of the phantom
  candidates; under a (data, model) mesh the likelihood also
  ``all_reduce``-s its partial contractions over the model axis.

With ``group=None`` every collective below is the identity (or the local
reduction), so the single-device path runs the same code without a
process group.

Gloo moves host memory only: a CUDA tensor given to a gloo group is copied
to the host, reduced there and copied back (``_staged``). That is the
path of two ranks sharing one card, which NCCL refuses. No collective
switches backend or device when one fails.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"

# collective calls made by this process, by kind; a reader resets them
CALLS = {"all_reduce": 0, "all_gather": 0, "gather": 0}


def make_mesh(world: int, model_parallel: int = 1,
              device_type: str = "cpu") -> DeviceMesh:
    """The 1-D ``("data",)`` mesh of ``world`` ranks, or with
    ``model_parallel`` > 1 the 2-D ``("data", "model")`` mesh of
    ``world // model_parallel`` x ``model_parallel`` ranks (rank
    ``d * model_parallel + m`` sits at (d, m), as the JAX package reshapes
    its devices). ``device_type`` is where the collectives run: ``cuda``
    for NCCL, ``cpu`` for gloo. Needs the default process group
    (``launch.spawn_ranks`` makes it)."""
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} devices not divisible by "
                         f"model_parallel={model_parallel}")
    if model_parallel == 1:
        return init_device_mesh(device_type, (world,),
                                mesh_dim_names=(DATA_AXIS,))
    return init_device_mesh(device_type, (world // model_parallel,
                                          model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def require_mesh(mesh) -> DeviceMesh:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed DeviceMesh "
            f"(parallel.make_mesh), not {type(mesh).__name__}")
    if DATA_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no {DATA_AXIS!r} axis: "
                         f"{mesh.mesh_dim_names}")
    return mesh


def _axis(mesh: DeviceMesh, name: str):
    """``(group, rank, size)`` of this process on mesh axis ``name``;
    ``(None, 0, 1)`` where the mesh has no such axis."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        return None, 0, 1
    return (mesh.get_group(name), mesh.get_local_rank(name),
            mesh.size(names.index(name)))


def data_axis(mesh: DeviceMesh):
    """``(group, rank, size)`` on the dataset axis."""
    return _axis(mesh, DATA_AXIS)


def model_axis(mesh: DeviceMesh):
    """``(group, rank, size)`` on the model axis; group None when the
    mesh does not shard it."""
    group, rank, size = _axis(mesh, MODEL_AXIS)
    return (group if size > 1 else None), rank, size


def mesh_model_axis(mesh: DeviceMesh):
    """The model axis name if the mesh shards it, else None."""
    return MODEL_AXIS if model_axis(mesh)[2] > 1 else None


def dataset_block(ndata: int, rank: int, size: int) -> slice:
    """Rank ``rank``'s contiguous block of ``ndata`` datasets."""
    if ndata % size:
        raise ValueError(f"{ndata} datasets not divisible by the data axis "
                         f"of {size} ranks")
    n = ndata // size
    return slice(rank * n, (rank + 1) * n)


def model_block(n: int, rank: int, size: int) -> slice:
    """Rank ``rank``'s contiguous block of an axis of length ``n`` split
    over ``size`` ranks (the blocks differ by at most one)."""
    return slice(rank * n // size, (rank + 1) * n // size)


def shard_problem(problem, mesh: DeviceMesh):
    """This rank's datasets and, on a model axis, its spectral slice
    (``Problem.shard``, the counterpart of ``problem_pspecs``)."""
    _, rd, nd = data_axis(mesh)
    _, rm, nm = model_axis(mesh)
    return problem.shard(rd, nd, rm, nm)


# EngineState fields with a trailing dataset axis (``state_pspecs``: the
# JAX package's ``P(DATA_AXIS)`` and ``P(None, DATA_AXIS)``); every other
# field, the pile, the phantoms and the counters, is replicated
_SHARDED_FIELDS = (
    "live_idx", "live_L", "running", "Lmax", "logZ", "H", "logVolremaining",
    "logwidth", "last_logwidth", "rem_logZ", "rem_logZerr", "group_id",
    "term_iter", "stall_count",
)
_SHARDED_SHELF_FIELDS = ("idx", "L", "count")


def shard_state(state, mesh: DeviceMesh):
    """This rank's slice of a full-D ``EngineState``."""
    _, rank, size = data_axis(mesh)
    block = dataset_block(state.live_L.shape[1], rank, size)
    cut = {f: getattr(state, f)[..., block].contiguous()
           for f in _SHARDED_FIELDS}
    shelves = dataclasses.replace(state.shelves, **{
        f: getattr(state.shelves, f)[..., block].contiguous()
        for f in _SHARDED_SHELF_FIELDS})
    return state.replace(shelves=shelves, **cut)


def gather_state(state, mesh: DeviceMesh):
    """The full-D ``EngineState`` on the first rank of this rank's data
    axis (rank order is dataset order; replicated fields are its own),
    None on the others."""
    group = data_axis(mesh)[0]
    full = {f: gather_rows(getattr(state, f), group, dim=-1)
            for f in _SHARDED_FIELDS}
    shelf = {f: gather_rows(getattr(state.shelves, f), group, dim=-1)
             for f in _SHARDED_SHELF_FIELDS}
    if full["live_L"] is None:
        return None
    return state.replace(shelves=dataclasses.replace(state.shelves, **shelf),
                         **full)


# --- collectives ---------------------------------------------------------------

def axis_size(group) -> int:
    """Ranks in ``group``; 1 for ``None`` (single device)."""
    return 1 if group is None else dist.get_world_size(group)


def _staged(x, group):
    """``x`` where the group's backend can reduce it: a CUDA tensor goes
    to host memory for gloo."""
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        return x.cpu()
    return x


def all_reduce(x, group, op=dist.ReduceOp.SUM):
    """The reduction of ``x`` over ``group``, on ``x``'s device; ``x``
    itself is left as it was."""
    CALLS["all_reduce"] += 1
    buf = _staged(x, group)
    buf = buf.clone() if buf is x else buf
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def global_any(x, group):
    """``x.any()`` over the local tensor, then over the ranks of ``group``
    (the JAX package's ``_global_any``)."""
    local = torch.any(x)
    if group is None:
        return local
    return all_reduce(local.to(torch.int32).reshape(1), group)[0] > 0


def global_or_rows(x, group):
    """Elementwise OR of a per-candidate bool vector over the ranks
    (``_global_or_rows``): a candidate accepted by any rank's datasets is
    appended to every rank's pile, which keeps pile indices global."""
    if group is None:
        return x
    return all_reduce(x.to(torch.int32), group) > 0


def global_max(x, group):
    """Elementwise max over the ranks."""
    if group is None:
        return x
    return all_reduce(x, group, op=dist.ReduceOp.MAX)


def gather_rows(x, group, dim: int = 0):
    """Every rank's ``x`` concatenated along ``dim`` in rank order, on the
    first rank of ``group`` only (the result's collection point); None on
    the others."""
    if group is None:
        return x
    CALLS["gather"] += 1
    is_bool = x.dtype == torch.bool
    buf = _staged(x.to(torch.uint8) if is_bool else x, group).contiguous()
    dst = dist.get_global_rank(group, 0)
    parts = ([torch.empty_like(buf) for _ in range(axis_size(group))]
             if dist.get_rank() == dst else None)
    dist.gather(buf, parts, dst=dst, group=group)
    if parts is None:
        return None
    out = torch.cat(parts, dim=dim).to(x.device)
    return out.to(torch.bool) if is_bool else out


def all_gather_rows(x, group, dim: int = 0):
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    JAX package's ``all_gather(...).reshape(-1)`` for ``dim=0``)."""
    if group is None:
        return x
    CALLS["all_gather"] += 1
    is_bool = x.dtype == torch.bool
    buf = _staged(x.to(torch.uint8) if is_bool else x, group).contiguous()
    parts = [torch.empty_like(buf) for _ in range(axis_size(group))]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat(parts, dim=dim).to(x.device)
    return out.to(torch.bool) if is_bool else out
