"""Region-membership kernels: CUDA on the card, plain PyTorch on the CPU.

Counterparts of the two Pallas TPU kernels of
``massivedatans_tpu/ops/pallas_neighbors.py`` (``count_within_pallas`` and
``bootstrapped_sq_radius_pallas``), which in turn replace the reference's C
neighbour kernels (``clustering/cneighbors.c:95-119,125-179``).

Each public function dispatches on the device of its tensors:

- a CUDA tensor launches the hand-written kernel of ``csrc/neighbors.cu``
  (built on first use by ``ops/_build.py``) on the current stream, or
  raises — on a build failure, a launch failure or an input the kernel does
  not take. There is no fallback to the plain version. Each call is one
  launch: outputs are ``torch.empty`` (the kernels write every element),
  and the radius kernel's merge workspace resets itself;
- a CPU tensor runs the plain version (``*_plain``), which computes the
  same squared distances bit for bit (explicit differences summed over the
  coordinates in order, no fused multiply-add).

``count_within.launches`` and ``bootstrapped_sq_radius.launches`` count
kernel launches (plain integers); the plain versions never touch them. A
call made while its stream is captured into a CUDA graph launches nothing:
it adds one to ``captured`` instead, and the engine adds the launches a
graph's capture recorded to ``launches`` at each replay of that graph
(``ns/engine.ChunkProgram``). ``prepare_stream`` makes a stream's radius
workspace before a capture on it.
"""

from __future__ import annotations

import torch

from massivedatans_tpu_torch.ops import _build

_POS_BIG = 1e30
MAX_NDIM = 8   # the kernels keep one point's coordinates in registers
NB_MAX = 32    # bootstrap rounds packed into one 32-bit in-bag mask


def sq_dist_plain(a, b):
    """``[N, M]`` squared euclidean distances from explicit differences."""
    d2 = torch.square(a[:, None, 0] - b[None, :, 0])
    for k in range(1, a.shape[1]):
        d2 = d2 + torch.square(a[:, None, k] - b[None, :, k])
    return d2


def count_within_plain(members, member_mask, points, radius):
    """Number of valid members strictly within ``radius`` of each point."""
    near = (sq_dist_plain(points, members) < torch.square(radius)) & \
        member_mask[None, :]
    return near.sum(dim=1, dtype=torch.int32)


def bootstrapped_sq_radius_plain(w, member_mask, inbag):
    """``max_b max_{i valid, i not in bag b} min_{j in bag b} d2(i, j)``;
    a round whose bag is empty contributes 0."""
    return radius_from_sq_dists(sq_dist_plain(w, w), member_mask, inbag)


def radius_from_sq_dists(d2, member_mask, inbag):
    """The bootstrapped-radius reduction over a ``[M, M]`` matrix of squared
    distances in any norm."""
    out = torch.zeros((), dtype=torch.float32, device=d2.device)
    for b in range(inbag.shape[0]):
        nearest = torch.where(inbag[b][None, :], d2, _POS_BIG).amin(dim=1)
        nearest = torch.where(nearest >= _POS_BIG, 0.0, nearest)
        oob = member_mask & ~inbag[b]
        out = torch.maximum(out, torch.where(oob, nearest, 0.0).amax())
    return out


def _cuda_stream(first, *rest):
    """None for CPU inputs. For CUDA inputs on the current device, the raw
    handle of that device's current stream, which the launchers run on.
    Raises on anything else. Messages are formed only on failure: this
    runs every proposal round."""
    device = first.device
    for t in rest:
        if t.device != device:
            raise ValueError("inputs on several devices: "
                             f"{sorted({str(u.device) for u in (first, *rest)})}")
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    current = torch.cuda.current_device()
    if device.index != current:
        raise ValueError(f"inputs on {device}, current device is cuda:{current}")
    # the handle without building a torch.cuda.Stream object
    return torch._C._cuda_getCurrentRawStream(current)


def _check_cuda_inputs(*named):
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes a contiguous tensor")


_workspaces = {}


def _radius_workspace(device, stream: int):
    """Two zeroed words per (device, stream) that the radius kernel merges
    its blocks through and leaves zero again (``csrc/neighbors.cu``): the
    one fill happens here, at the first call on that stream, or in
    ``prepare_stream``. A stream being captured must have been prepared:
    the workspace would otherwise belong to the graph's memory pool."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "bootstrapped_sq_radius captured on a stream without a "
                "workspace: call neighbors.prepare_stream before capturing")
        ws = _workspaces[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return ws


def prepare_stream(device, stream: int):
    """Load the kernel library (building it if needed) and make the radius
    workspace of the raw CUDA ``stream`` on ``device``, outside any
    capture: a capture on that stream then allocates nothing outside its
    graph's pool."""
    _build.load()
    _radius_workspace(torch.device(device), stream)


def _count_launch(fn):
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1


def count_within(members, member_mask, points, radius):
    """``int32[N]``: for each point, the valid members ``j`` with
    ``|p - m_j|^2 < radius^2`` (strict), as ``count_within_pallas``. One
    launch writes every count: the caller may pass any number of points
    (``ns/region.sample_region`` passes both proposal halves at once)."""
    stream = _cuda_stream(members, member_mask, points, radius)
    if stream is None:
        return count_within_plain(members, member_mask, points, radius)
    _check_cuda_inputs(("members", members, torch.float32),
                       ("member_mask", member_mask, torch.bool),
                       ("points", points, torch.float32),
                       ("radius", radius, torch.float32))
    N, ndim = points.shape
    M = members.shape[0]
    if not (members.shape == (M, ndim) and member_mask.shape == (M,)
            and radius.numel() == 1 and 1 <= ndim <= MAX_NDIM):
        raise ValueError(
            f"count_within takes members [M, ndim], mask [M], points "
            f"[N, ndim], one radius, 1 <= ndim <= {MAX_NDIM}; got "
            f"{tuple(members.shape)}, {tuple(member_mask.shape)}, "
            f"{tuple(points.shape)}, {radius.numel()} values")
    out = torch.empty((N,), dtype=torch.int32, device=points.device)
    rc = _build.load().mdt_count_within(
        points.data_ptr(), N, members.data_ptr(), member_mask.data_ptr(), M,
        ndim, radius.data_ptr(), out.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"count_within kernel launch failed: cudaError {rc}")
    _count_launch(count_within)
    return out


count_within.launches = 0
count_within.captured = 0


def bootstrapped_sq_radius(w, member_mask, inbag):
    """Squared RadFriends radius from precomputed in-bag masks ``[nb, M]``
    (a 0-dim float32 tensor), as ``bootstrapped_sq_radius_pallas``."""
    stream = _cuda_stream(w, member_mask, inbag)
    if stream is None:
        return bootstrapped_sq_radius_plain(w, member_mask, inbag)
    _check_cuda_inputs(("w", w, torch.float32),
                       ("member_mask", member_mask, torch.bool),
                       ("inbag", inbag, torch.bool))
    M, ndim = w.shape
    nb = inbag.shape[0]
    if not (member_mask.shape == (M,) and inbag.shape == (nb, M)
            and 1 <= ndim <= MAX_NDIM and 1 <= nb <= NB_MAX):
        raise ValueError(
            f"bootstrapped_sq_radius takes w [M, ndim], mask [M], inbag "
            f"[nb, M], 1 <= ndim <= {MAX_NDIM}, 1 <= nb <= {NB_MAX}; got "
            f"{tuple(w.shape)}, {tuple(member_mask.shape)}, "
            f"{tuple(inbag.shape)}")
    out = torch.empty((), dtype=torch.float32, device=w.device)
    rc = _build.load().mdt_bootstrap_radius(
        w.data_ptr(), member_mask.data_ptr(), inbag.data_ptr(), M, ndim, nb,
        out.data_ptr(), _radius_workspace(w.device, stream).data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"bootstrapped_sq_radius kernel launch failed: cudaError {rc}")
    _count_launch(bootstrapped_sq_radius)
    return out


bootstrapped_sq_radius.launches = 0
bootstrapped_sq_radius.captured = 0
# the wrappers whose launches a captured graph's replay adds
KERNELS = (count_within, bootstrapped_sq_radius)
