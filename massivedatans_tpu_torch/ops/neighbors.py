"""Region-membership kernels: CUDA on the card, plain PyTorch on the CPU.

Counterparts of the two Pallas TPU kernels of
``massivedatans_tpu/ops/pallas_neighbors.py`` (``count_within_pallas`` and
``bootstrapped_sq_radius_pallas``), which in turn replace the reference's C
neighbour kernels (``clustering/cneighbors.c:95-119,125-179``).

Each public function dispatches on the device of its tensors:

- a CUDA tensor launches the hand-written kernel of ``csrc/neighbors.cu``
  (built on first use by ``ops/_build.py``) on the current stream, or
  raises — on a build failure, a launch failure or an input the kernel does
  not take. There is no fallback to the plain version;
- a CPU tensor runs the plain version (``*_plain``), which computes the
  same squared distances bit for bit (explicit differences summed over the
  coordinates in order, no fused multiply-add).

``count_within.launches`` and ``bootstrapped_sq_radius.launches`` count
kernel launches (plain integers); the plain versions never touch them.
"""

from __future__ import annotations

import torch

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


def _check(cond, what):
    if not cond:
        raise ValueError(what)


def _on_cuda(tensors) -> bool:
    """True for CUDA inputs, False for CPU inputs; raises on anything else."""
    devices = {t.device for t in tensors}
    _check(len(devices) == 1, f"inputs on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return False
    _check(device.type == "cuda", f"unsupported device {device}")
    # the launchers run on the current device's stream
    _check(device.index == torch.cuda.current_device(),
           f"inputs on {device}, current device is cuda:{torch.cuda.current_device()}")
    return True


def _check_cuda_inputs(named):
    for name, t, dtype in named:
        _check(t.dtype == dtype, f"{name}: dtype {t.dtype}, kernel takes {dtype}")
        _check(t.is_contiguous(), f"{name}: kernel takes a contiguous tensor")


def count_within(members, member_mask, points, radius):
    """``int32[N]``: for each point, the valid members ``j`` with
    ``|p - m_j|^2 < radius^2`` (strict), as ``count_within_pallas``."""
    if not _on_cuda((members, member_mask, points, radius)):
        return count_within_plain(members, member_mask, points, radius)
    from massivedatans_tpu_torch.ops import _build

    _check_cuda_inputs((("members", members, torch.float32),
                        ("member_mask", member_mask, torch.bool),
                        ("points", points, torch.float32),
                        ("radius", radius, torch.float32)))
    N, ndim = points.shape
    M = members.shape[0]
    _check(members.shape == (M, ndim), f"members {tuple(members.shape)} vs points {tuple(points.shape)}")
    _check(member_mask.shape == (M,), f"member_mask {tuple(member_mask.shape)}, want ({M},)")
    _check(radius.numel() == 1, "radius must hold one value")
    _check(1 <= ndim <= MAX_NDIM, f"ndim {ndim} outside [1, {MAX_NDIM}]")
    lib = _build.load()
    out = torch.zeros((N,), dtype=torch.int32, device=points.device)
    rc = lib.mdt_count_within(
        points.data_ptr(), N, members.data_ptr(), member_mask.data_ptr(), M,
        ndim, radius.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(points.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"count_within kernel launch failed: cudaError {rc}")
    count_within.launches += 1
    return out


count_within.launches = 0


def bootstrapped_sq_radius(w, member_mask, inbag):
    """Squared RadFriends radius from precomputed in-bag masks ``[nb, M]``
    (a 0-dim float32 tensor), as ``bootstrapped_sq_radius_pallas``."""
    if not _on_cuda((w, member_mask, inbag)):
        return bootstrapped_sq_radius_plain(w, member_mask, inbag)
    from massivedatans_tpu_torch.ops import _build

    _check_cuda_inputs((("w", w, torch.float32),
                        ("member_mask", member_mask, torch.bool),
                        ("inbag", inbag, torch.bool)))
    M, ndim = w.shape
    nb = inbag.shape[0]
    _check(member_mask.shape == (M,), f"member_mask {tuple(member_mask.shape)}, want ({M},)")
    _check(inbag.shape == (nb, M), f"inbag {tuple(inbag.shape)}, want ({nb}, {M})")
    _check(1 <= ndim <= MAX_NDIM, f"ndim {ndim} outside [1, {MAX_NDIM}]")
    _check(1 <= nb <= NB_MAX, f"nbootstraps {nb} outside [1, {NB_MAX}]")
    lib = _build.load()
    out = torch.zeros((), dtype=torch.float32, device=w.device)
    rc = lib.mdt_bootstrap_radius(
        w.data_ptr(), member_mask.data_ptr(), inbag.data_ptr(), M, ndim, nb,
        out.data_ptr(), torch.cuda.current_stream(w.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"bootstrapped_sq_radius kernel launch failed: cudaError {rc}")
    bootstrapped_sq_radius.launches += 1
    return out


bootstrapped_sq_radius.launches = 0
