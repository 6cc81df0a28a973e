"""MLFriends region geometry.

Counterpart of ``massivedatans_tpu/ns/region.py`` (reference layer L2/L3):

- metric learning (reference ``clustering/sdml.py:25-88``),
- the bootstrapped RadFriends radius (``clustering/neighbors.py:211-238``,
  ``cneighbors.c:125-179``),
- region membership counts (``cneighbors.c:95-119``),
- uniform sampling of (union-of-balls ∩ unit cube)
  (``clustering/radfriendsregion.py:117-182``) as fixed-size masked batches.

Member sets are padded to a capacity ``M`` with a validity mask. For the
euclidean norm, the radius and the membership counts go through
``ops/neighbors.py``, which launches the CUDA kernels for tensors on the
card and runs the plain versions for tensors on the CPU; the Chebyshev norm
stays plain PyTorch, as it stays jnp in the JAX package.

Random draws come from an explicit ``torch.Generator`` on the tensors'
device. They differ from JAX's draws for the same seed; the tests hold the
deterministic parts exactly (by feeding both packages the same in-bag
masks) and the random parts by distribution.
"""

from __future__ import annotations

import dataclasses

import torch

from massivedatans_tpu_torch.ops import neighbors as kernels

_POS_BIG = 1e30


@dataclasses.dataclass
class Metric:
    """Diagonal whitening transform (reference sdml.py)."""

    mean: torch.Tensor   # [ndim]
    scale: torch.Tensor  # [ndim]

    def transform(self, u):
        return (u - self.mean) / self.scale

    def untransform(self, w):
        return w * self.scale + self.mean


def fit_metric(u, mask, kind: str = "truncatedscaling") -> Metric:
    """Masked mean/std whitening; ``truncatedscaling`` quantizes the scale
    onto powers of two to avoid metric random-walk (sdml.py:60-88)."""
    mask_f = mask.to(u.dtype)[:, None]
    n = torch.clamp(mask_f.sum(), min=1.0)
    mean = (u * mask_f).sum(dim=0) / n
    var = (torch.square(u - mean) * mask_f).sum(dim=0) / n
    scale = torch.sqrt(torch.clamp(var, min=1e-24))
    if kind == "none":
        return Metric(mean=torch.zeros_like(mean), scale=torch.ones_like(scale))
    if kind == "simplescaling":
        return Metric(mean=mean, scale=scale)
    if kind == "truncatedscaling":
        # round onto a discrete log2 scale relative to the largest axis
        scalemax = scale.max() * 1.001
        logscale = torch.floor(-torch.log2(scale / scalemax)).to(torch.int32)
        return Metric(mean=mean, scale=torch.exp2(-logscale.to(u.dtype)))
    raise ValueError(f"unknown metriclearner {kind!r}")


@dataclasses.dataclass
class Region:
    """Union-of-balls region around (whitened) member points."""

    members_w: torch.Tensor    # [M, ndim] whitened members (rows beyond mask: junk)
    member_mask: torch.Tensor  # [M] bool
    n_members: torch.Tensor    # scalar int32
    metric: Metric
    radius: torch.Tensor       # scalar; ball radius in whitened space
    lo: torch.Tensor           # [ndim] whitened bounding box (members +- radius)
    hi: torch.Tensor           # [ndim]


def pairwise_sqdist(a, b):
    """``[N, M]`` squared euclidean distances from explicit differences
    (the JAX package expands |a|^2 - 2ab + |b|^2 for the MXU; here the
    coordinates are few and the difference form needs no matmul)."""
    return kernels.sq_dist_plain(a, b)


def pairwise_sq_chebyshev(a, b):
    """``[N, M]`` squared Chebyshev (max-norm) distances, the box metric of
    the reference's SupFriends variant (friends.py:14-21,129-143)."""
    out = torch.square(a[:, None, 0] - b[None, :, 0])
    for k in range(1, a.shape[1]):
        out = torch.maximum(out, torch.square(a[:, None, k] - b[None, :, k]))
    return out


def _pairwise(a, b, norm: str):
    if norm == "euclidean":
        return pairwise_sqdist(a, b)
    if norm == "chebyshev":
        return pairwise_sq_chebyshev(a, b)
    raise ValueError(f"unknown norm {norm!r}")


def uniform_choice(mask, n: int, generator):
    """``n`` indices drawn uniformly, with replacement, from the True
    entries of ``mask`` (any pattern, not only a prefix) — JAX's categorical
    over masked logits. With no True entry every index is eligible."""
    weights = mask.to(torch.float32)
    weights = torch.where(mask.any(dim=-1, keepdim=True), weights, 1.0)
    return torch.multinomial(weights, n, replacement=True, generator=generator)


def bootstrap_inbag_rounds(mask, generator, nbootstraps: int):
    """``[nb, M]`` in-bag flags: each round draws n members with replacement
    (``neighbors.py:170-177`` builds the same matrix host-side)."""
    M = mask.shape[0]
    n = mask.sum()
    draw_valid = torch.arange(M, device=mask.device) < n  # exactly n draws
    choice = uniform_choice(mask.expand(nbootstraps, M), M, generator)
    hits = torch.zeros((nbootstraps, M), dtype=torch.int32, device=mask.device)
    hits.scatter_add_(1, choice,
                      draw_valid.to(torch.int32).expand(nbootstraps, M))
    return hits > 0


def bootstrapped_sq_radius(w, mask, generator, nbootstraps: int,
                           norm: str = "euclidean"):
    """Squared RadFriends radius: max over bootstrap rounds of the largest
    nearest-in-bag distance of any out-of-bag member (cneighbors.c:125-179).
    With ``norm="chebyshev"`` this is the SupFriends box radius."""
    inbag = bootstrap_inbag_rounds(mask, generator, nbootstraps)
    if norm == "euclidean":
        return kernels.bootstrapped_sq_radius(w, mask, inbag)
    return kernels.radius_from_sq_dists(_pairwise(w, w, norm), mask, inbag)


def jackknife_sq_radius(w, mask, norm: str = "euclidean"):
    """Squared leave-one-out radius: the largest nearest-OTHER-neighbour
    distance over the members (friends.py:30-33,71-75)."""
    M = mask.shape[0]
    d2 = _pairwise(w, w, norm)
    eye = torch.eye(M, dtype=torch.bool, device=w.device)
    nearest = torch.where(eye | ~mask[None, :], _POS_BIG, d2).amin(dim=1)
    # a single valid member has no neighbour: radius 0 (the box proposal
    # still covers the point itself)
    nearest = torch.where(nearest >= _POS_BIG, 0.0, nearest)
    return torch.where(mask, nearest, 0.0).amax()


def build_region(members_u, member_mask, generator, nbootstraps: int = 10,
                 metriclearner: str = "truncatedscaling", prev_scale=None,
                 prev_radius=None, norm: str = "euclidean",
                 estimator: str = "bootstrap", extra_u=None,
                 extra_mask=None) -> Region:
    """Whiten + bootstrap-radius region build (hiermetriclearn.py:48-92).

    ``force_shrink``: when the quantized metric scale is unchanged from the
    previous build, the radius may only shrink (hiermetriclearn.py:88-91).
    ``extra_u``/``extra_mask``: phantom points (friends.py:79-84) appended
    as additional ball centres AFTER the metric fit and the radius estimate.
    """
    metric = fit_metric(members_u, member_mask, metriclearner)
    w = metric.transform(members_u)
    if estimator == "jackknife":
        r2 = jackknife_sq_radius(w, member_mask, norm=norm)
    elif estimator == "bootstrap":
        r2 = bootstrapped_sq_radius(w, member_mask, generator, nbootstraps,
                                    norm=norm)
    else:
        raise ValueError(f"unknown radius estimator {estimator!r}")
    radius = torch.sqrt(r2)
    if prev_scale is not None and prev_radius is not None:
        same_metric = torch.all(prev_scale == metric.scale)
        radius = torch.where(same_metric & (prev_radius > 0.0),
                             torch.minimum(radius, prev_radius), radius)
    if extra_u is not None:
        w = torch.cat([w, metric.transform(extra_u)], dim=0)
        member_mask = torch.cat([member_mask, extra_mask])
    valid = member_mask[:, None]
    lo = torch.where(valid, w, torch.inf).amin(dim=0) - radius
    hi = torch.where(valid, w, -torch.inf).amax(dim=0) + radius
    return Region(
        members_w=w,
        member_mask=member_mask,
        n_members=member_mask.sum(dtype=torch.int32),
        metric=metric,
        radius=radius,
        lo=lo,
        hi=hi,
    )


def count_within(region: Region, w_points, norm: str = "euclidean"):
    """Number of member balls containing each point (cneighbors.c:95-119)."""
    if norm == "euclidean":
        return kernels.count_within(region.members_w, region.member_mask,
                                    w_points, region.radius)
    d2 = _pairwise(w_points, region.members_w, norm)
    near = (d2 < torch.square(region.radius)) & region.member_mask[None, :]
    return near.sum(dim=1, dtype=torch.int32)


def ball_offsets(generator, n: int, ndim: int, radius, norm: str = "euclidean"):
    """Uniform offsets within a radius-``radius`` ball: unit direction times
    ``R * U^(1/ndim)`` (radfriendsregion.py:157). A Chebyshev ball is an
    axis-aligned cube: uniform per-coordinate offsets."""
    device = radius.device
    if norm == "chebyshev":
        return radius * (2.0 * torch.rand((n, ndim), generator=generator,
                                          device=device) - 1.0)
    direction = torch.randn((n, ndim), generator=generator, device=device)
    direction = direction / torch.linalg.vector_norm(direction, dim=1,
                                                     keepdim=True)
    rr = radius * torch.rand((n, 1), generator=generator,
                             device=device) ** (1.0 / ndim)
    return direction * rr


def sample_region(region: Region, generator, nprop: int,
                  norm: str = "euclidean"):
    """Draw ``nprop`` candidates uniform on (union-of-balls ∩ unit cube).

    Half the batch uses the whitened-bounding-box proposal, half the
    ball-around-random-member proposal with the 1/n_near multiplicity
    correction (radfriendsregion.py:129-182). Returns ``(u, ok)``.

    Both halves are counted in one ``count_within`` call over the joined
    batch (one kernel launch per round on the card). The count draws no
    random numbers, so the generator's order stays box ``rand``, member
    ``multinomial``, direction ``randn``, radius ``rand``, coin ``rand``,
    that of counting each half on its own: a seed gives the same ``(u, ok)``.
    """
    device = region.members_w.device
    ndim = region.members_w.shape[1]
    n_box = nprop // 2
    n_ball = nprop - n_box

    # --- box proposals ---
    w_box = region.lo + (region.hi - region.lo) * torch.rand(
        (n_box, ndim), generator=generator, device=device)

    # --- ball proposals ---
    mem = uniform_choice(region.member_mask, n_ball, generator)
    center = region.members_w[mem]
    w_ball = center + ball_offsets(generator, n_ball, ndim, region.radius,
                                   norm=norm)
    coin = torch.rand((n_ball,), generator=generator, device=device)

    w_all = torch.cat([w_box, w_ball], dim=0)
    nnear = count_within(region, w_all, norm=norm)
    ok_box = nnear[:n_box] > 0
    ok_ball = coin * nnear[n_box:].to(coin.dtype) < 1.0  # accept w.p. 1/nnear
    ok = torch.cat([ok_box, ok_ball], dim=0)
    u = region.metric.untransform(w_all)
    in_cube = torch.all((u > 0.0) & (u < 1.0), dim=1)
    return u, ok & in_cube
