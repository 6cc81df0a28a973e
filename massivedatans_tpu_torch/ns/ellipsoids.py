"""Multi-ellipsoid bounding geometry (MultiNest-style).

Counterpart of ``massivedatans_tpu/ns/ellipsoids.py`` (reference
``elldrawer.py:25-102``, which delegates to ``nestle`` and enlarges volumes
3x):

- a fixed budget of ``N_ELLIPSOIDS`` ellipsoids assigned by
  ``KMEANS_ITERS`` Lloyd iterations of k-means on the members,
- per-cluster mean and covariance (the global cluster's for degenerate
  clusters), scaled so every assigned point lies inside, then
  volume-enlarged by ``ENLARGE``,
- sampling: pick an ellipsoid by volume, draw uniform inside it, accept
  with probability 1/(number of containing ellipsoids).

Everything stays on the device and reads nothing back: a Cholesky factor
that fails (a covariance that is not positive definite) becomes NaN, as the
JAX package's does on the CPU, instead of raising. Distances are expanded
as ``|w|^2 - 2 w.c + |c|^2``, as the JAX package writes them, so that the
k-means assignments agree with it away from near-ties.
"""

from __future__ import annotations

import dataclasses

import torch

from massivedatans_tpu_torch.ns.region import uniform_choice

N_ELLIPSOIDS = 4  # the JAX package's fixed budget
ENLARGE = 3.0     # volume enlargement (elldrawer.py's 3x)
KMEANS_ITERS = 8


@dataclasses.dataclass
class Ellipsoids:
    mean: torch.Tensor      # [E, ndim]
    cov_chol: torch.Tensor  # [E, ndim, ndim] Cholesky of the scaled covariance
    inv_chol: torch.Tensor  # [E, ndim, ndim] its inverse (for Mahalanobis)
    log_vol: torch.Tensor   # [E] log volume (up to a common constant)
    valid: torch.Tensor     # [E] bool


def _one_hot(assign, n: int, dtype):
    """``[M, n]`` one-hot rows (``F.one_hot`` checks its input range with
    host reads on the CPU)."""
    return (assign[:, None] == torch.arange(n, device=assign.device)).to(dtype)


def _sq_dist(w, centers):
    return (torch.square(w).sum(dim=1)[:, None] - 2.0 * w @ centers.T
            + torch.square(centers).sum(dim=1)[None, :])


def _kmeans_assign(w, mask, generator, n_clusters: int, init_idx=None):
    """Masked Lloyd iterations from ``n_clusters`` random valid members (or
    the members ``init_idx``); returns hard assignments ``[M]`` (int64)."""
    if init_idx is None:
        init_idx = uniform_choice(mask, n_clusters, generator)
    centers = w[init_idx]
    maskf = mask.to(w.dtype)[:, None]
    for _ in range(KMEANS_ITERS):
        assign = torch.argmin(_sq_dist(w, centers), dim=1)
        onehot = _one_hot(assign, n_clusters, w.dtype) * maskf  # [M, E]
        counts = onehot.sum(dim=0)
        sums = onehot.T @ w
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1.0),
                              centers)
    return torch.argmin(_sq_dist(w, centers), dim=1)


def _cholesky_or_nan(a):
    """Batched lower Cholesky factor with no host sync: a matrix that is
    not positive definite gives an all-NaN factor (``jnp.linalg.cholesky``
    on the CPU) instead of an error."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[..., None, None], torch.nan, chol)


def fit_ellipsoids(w, mask, generator, init_idx=None) -> Ellipsoids:
    """Bounding ellipsoids of the valid rows of ``w[M, ndim]``.

    ``init_idx``: the k-means start members (default: drawn uniformly from
    the valid rows with ``generator``)."""
    M, ndim = w.shape
    E = N_ELLIPSOIDS
    assign = _kmeans_assign(w, mask, generator, E, init_idx=init_idx)
    maskf = mask.to(w.dtype)
    onehot = _one_hot(assign, E, w.dtype) * maskf[:, None]  # [M, E]
    counts = onehot.sum(dim=0)
    valid = counts >= (ndim + 1)
    # degenerate clusters fall back to the global cluster statistics
    g_n = torch.clamp(maskf.sum(), min=1.0)
    g_mean = (w * maskf[:, None]).sum(dim=0) / g_n
    g_cov = ((w - g_mean) * maskf[:, None]).T @ (w - g_mean) / g_n

    means = torch.where(valid[:, None],
                        (onehot.T @ w) / torch.clamp(counts[:, None], min=1.0),
                        g_mean[None, :])                      # [E, ndim]
    diff = w[None, :, :] - means[:, None, :]                  # [E, M, ndim]
    wdiff = diff * onehot.T[:, :, None]
    covs = wdiff.transpose(1, 2) @ diff / torch.clamp(counts, min=1.0)[:, None, None]
    covs = torch.where(valid[:, None, None], covs, g_cov[None])
    eye = torch.eye(ndim, dtype=w.dtype, device=w.device)
    covs = covs + 1e-10 * eye[None]

    # scale each ellipsoid so all its assigned points are inside:
    # f2 = max Mahalanobis^2 over assigned points, then enlarge the volume
    chol = _cholesky_or_nan(covs)
    inv_chol = torch.linalg.solve_triangular(chol, eye.expand(E, ndim, ndim),
                                             upper=False)
    z = diff @ inv_chol.transpose(1, 2)                       # [E, M, ndim]
    m2 = torch.square(z).sum(dim=2)
    sel = _one_hot(assign, E, torch.bool).T & mask[None, :]   # [E, M]
    f2 = torch.where(sel, m2, 0.0).amax(dim=1)
    f2 = torch.clamp(f2, min=1e-12)
    scale = torch.sqrt(f2) * ENLARGE ** (1.0 / ndim)
    chol = chol * scale[:, None, None]
    inv_chol = inv_chol / scale[:, None, None]
    logdet = torch.log(torch.clamp(
        torch.abs(torch.diagonal(chol, dim1=1, dim2=2)), min=1e-30)).sum(dim=1)
    keep = valid | (torch.arange(E, device=w.device) == 0)
    return Ellipsoids(mean=means, cov_chol=chol, inv_chol=inv_chol,
                      log_vol=torch.where(keep, logdet, -torch.inf),
                      valid=keep)


def count_containing(ells: Ellipsoids, u):
    """Number of ellipsoids containing each point ``[N]`` (int32)."""
    z = (u[None, :, :] - ells.mean[:, None, :]) @ ells.inv_chol.transpose(1, 2)
    inside = (torch.square(z).sum(dim=2) <= 1.0) & ells.valid[:, None]  # [E, N]
    return inside.sum(dim=0, dtype=torch.int32)


def _categorical(logits, n: int, generator):
    """``n`` draws from the distribution ``softmax(logits)``; entries that
    are not finite get no weight (all do, if none is finite)."""
    finite = torch.isfinite(logits)
    top = torch.where(finite, logits, -torch.inf).amax()
    weights = torch.where(finite, torch.exp(logits - top), 0.0)
    weights = torch.where(finite.any(), weights, 1.0)
    return torch.multinomial(weights, n, replacement=True, generator=generator)


def sample_ellipsoids(ells: Ellipsoids, generator, nprop: int):
    """Draw ``nprop`` candidates uniform on the union of ellipsoids.

    Returns the points ``[nprop, ndim]`` and an accept mask with the 1/n
    multiplicity correction applied."""
    ndim = ells.mean.shape[1]
    device = ells.mean.device
    pick = _categorical(torch.where(ells.valid, ells.log_vol, -torch.inf),
                        nprop, generator)
    direction = torch.randn((nprop, ndim), generator=generator, device=device)
    direction = direction / torch.linalg.vector_norm(direction, dim=1,
                                                     keepdim=True)
    radius = torch.rand((nprop, 1), generator=generator,
                        device=device) ** (1.0 / ndim)
    z = direction * radius
    w = ells.mean[pick] + torch.einsum("nij,nj->ni", ells.cov_chol[pick], z)
    n = count_containing(ells, w)  # >= 1 by construction
    coin = torch.rand((nprop,), generator=generator, device=device)
    ok = coin * n.to(coin.dtype) < 1.0
    return w, ok
