"""The port's region kernels against the Pallas kernels and scipy.

On the CPU the wrappers run their plain PyTorch versions, which are held
here against the JAX package's Pallas kernels (interpret mode) and a scipy
float64 oracle on the same numpy inputs. The ``cuda``-marked tests hold the
hand-written CUDA kernels against the plain versions on the card; run them
there with ``python -m pytest tests/test_torch_neighbors.py -m cuda
--noconftest``: that machine has no JAX, so this module imports the JAX
package only inside the tests that compare against it.
"""

import numpy as np
import pytest
import scipy.spatial
import torch

from massivedatans_tpu_torch.ops import neighbors

torch.set_num_threads(1)

TIE = 1e-4  # distance band around r where f32 and f64 may disagree


def _pallas():
    """The JAX package's Pallas kernels and jax.numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from massivedatans_tpu.ops import pallas_neighbors

    return pallas_neighbors, jnp


def _count_case(seed, M, N, n_valid, r, lo=0.0, hi=1.0, ndim=3):
    rng = np.random.default_rng(seed)
    members = rng.uniform(size=(M, ndim)).astype(np.float32)
    mask = np.arange(M) < n_valid
    pts = rng.uniform(lo, hi, size=(N, ndim)).astype(np.float32)
    return members, mask, pts, np.float32(r)


@pytest.mark.parametrize("M, N, n_valid, r, lo, hi", [
    (128, 300, 100, 0.2, -0.2, 1.2),
    (8192, 640, 7000, 0.05, 0.0, 1.0),   # several 1024-wide Pallas tiles
])
def test_count_within_plain_matches_pallas_and_scipy(M, N, n_valid, r, lo, hi):
    pallas_neighbors, jnp = _pallas()
    members, mask, pts, r = _count_case(3, M, N, n_valid, r, lo, hi)
    got = neighbors.count_within(torch.from_numpy(members),
                                 torch.from_numpy(mask),
                                 torch.from_numpy(pts), torch.tensor(r))
    assert got.dtype == torch.int32 and got.shape == (N,)
    got = got.numpy()
    pallas = np.asarray(pallas_neighbors.count_within_pallas(
        jnp.asarray(members), jnp.asarray(mask), jnp.asarray(pts),
        jnp.float32(r), interpret=True))
    d = scipy.spatial.distance.cdist(pts, members[:n_valid])
    want = (d < r).sum(axis=1)
    boundary = (np.abs(d - r) < TIE).sum(axis=1)
    assert (np.abs(got - want) <= boundary).all()
    assert (np.abs(got - pallas) <= boundary).all()


@pytest.mark.parametrize("ndim, r", [(4, 0.2), (5, 0.3)])
def test_count_within_plain_matches_pallas_and_scipy_muse_ndim(ndim, r):
    """MUSE runs the region at ndim 5 (FULL) and 4 (ZSOL): the main-path
    shape, 256 points against 1,664 members."""
    pallas_neighbors, jnp = _pallas()
    members, mask, pts, r = _count_case(ndim, 1664, 256, 1500, r, ndim=ndim)
    got = neighbors.count_within(torch.from_numpy(members),
                                 torch.from_numpy(mask),
                                 torch.from_numpy(pts), torch.tensor(r)).numpy()
    pallas = np.asarray(pallas_neighbors.count_within_pallas(
        jnp.asarray(members), jnp.asarray(mask), jnp.asarray(pts),
        jnp.float32(r), interpret=True))
    d = scipy.spatial.distance.cdist(pts, members[:1500])
    boundary = (np.abs(d - r) < TIE).sum(axis=1)
    assert (got > 0).any()
    assert (np.abs(got - (d < r).sum(axis=1)) <= boundary).all()
    assert (np.abs(got - pallas) <= boundary).all()


def _oracle_radius(w, mask, inbag):
    d = scipy.spatial.distance.cdist(w, w) ** 2
    want = 0.0
    for b in range(inbag.shape[0]):
        oob = mask & ~inbag[b]
        if not oob.any() or not inbag[b].any():
            continue
        want = max(want, d[np.ix_(oob, inbag[b])].min(axis=1).max())
    return want


@pytest.mark.parametrize("M, ndim, nb, n_valid, empty_round", [
    (64, 2, 8, 50, False),
    (96, 3, 10, 80, True),
    (4096, 3, 10, 3500, False),
    (1664, 5, 10, 1500, False),   # MUSE FULL at the member capacity
])
def test_bootstrap_radius_plain_matches_pallas_and_oracle(M, ndim, nb, n_valid,
                                                          empty_round):
    pallas_neighbors, jnp = _pallas()
    rng = np.random.default_rng(M)
    w = rng.uniform(size=(M, ndim)).astype(np.float32)
    mask = np.arange(M) < n_valid
    inbag = rng.random((nb, M)) < 0.6
    inbag[:, ~mask] = False
    if empty_round:
        inbag[1] = False  # a round whose bag is empty contributes nothing
    got = neighbors.bootstrapped_sq_radius(
        torch.from_numpy(w), torch.from_numpy(mask), torch.from_numpy(inbag))
    assert got.dtype == torch.float32 and got.shape == ()
    pallas = float(pallas_neighbors.bootstrapped_sq_radius_pallas(
        jnp.asarray(w), jnp.asarray(mask), jnp.asarray(inbag), interpret=True))
    want = _oracle_radius(w, mask, inbag)
    # explicit differences (port) and |a|^2 - 2ab + |b|^2 (Pallas) round
    # differently in f32
    assert np.isclose(float(got), pallas, rtol=1e-5, atol=1e-6), (got, pallas)
    assert np.isclose(float(got), want, rtol=1e-5, atol=1e-6), (got, want)


def test_cpu_tensors_do_not_count_launches():
    members, mask, pts, r = _count_case(0, 64, 32, 60, 0.3)
    before = (neighbors.count_within.launches,
              neighbors.bootstrapped_sq_radius.launches)
    neighbors.count_within(torch.from_numpy(members), torch.from_numpy(mask),
                           torch.from_numpy(pts), torch.tensor(r))
    inbag = torch.rand((4, 64), generator=torch.Generator().manual_seed(0)) < 0.5
    neighbors.bootstrapped_sq_radius(torch.from_numpy(members),
                                     torch.from_numpy(mask), inbag)
    assert (neighbors.count_within.launches,
            neighbors.bootstrapped_sq_radius.launches) == before


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [256, 1000, 1664, 8192, 16384])
def test_count_within_kernel_matches_plain_on_card(M):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(M)
    members = torch.randn((M, 3), generator=g, device="cuda")
    mask = torch.arange(M, device="cuda") < (M - M // 7)
    pts = 3.0 * (2.0 * torch.rand((256, 3), generator=g, device="cuda") - 1.0)
    radius = torch.tensor(0.45, device="cuda")
    before = neighbors.count_within.launches
    got = neighbors.count_within(members, mask, pts, radius)
    torch.cuda.synchronize()
    assert neighbors.count_within.launches == before + 1
    # same explicit-difference arithmetic without FMA: bitwise equal
    assert torch.equal(got, neighbors.count_within_plain(members, mask, pts,
                                                         radius))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [256, 1000, 1664, 8192, 16384])
def test_bootstrap_radius_kernel_matches_plain_on_card(M):
    _need_card()
    from massivedatans_tpu_torch.ns.region import bootstrap_inbag_rounds

    g = torch.Generator(device="cuda").manual_seed(M)
    w = torch.randn((M, 3), generator=g, device="cuda")
    mask = torch.arange(M, device="cuda") < (M - M // 5)
    inbag = bootstrap_inbag_rounds(mask, g, 10)
    before = neighbors.bootstrapped_sq_radius.launches
    got = neighbors.bootstrapped_sq_radius(w, mask, inbag)
    torch.cuda.synchronize()
    assert neighbors.bootstrapped_sq_radius.launches == before + 1
    want = neighbors.bootstrapped_sq_radius_plain(w, mask, inbag)
    assert float(got) > 0
    assert torch.isclose(got, want, rtol=1e-5, atol=0.0), (got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1664, 16384])
def test_count_within_kernel_matches_plain_on_card_ndim5(M):
    """MUSE FULL's dimension (ZSOL has 4)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(M + 5)
    members = torch.randn((M, 5), generator=g, device="cuda")
    mask = torch.arange(M, device="cuda") < (M - M // 7)
    pts = 3.0 * (2.0 * torch.rand((256, 5), generator=g, device="cuda") - 1.0)
    radius = torch.tensor(0.9, device="cuda")
    before = neighbors.count_within.launches
    got = neighbors.count_within(members, mask, pts, radius)
    torch.cuda.synchronize()
    assert neighbors.count_within.launches == before + 1
    want = neighbors.count_within_plain(members, mask, pts, radius)
    assert int(want.sum()) > 0
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1664, 16384])
def test_bootstrap_radius_kernel_matches_plain_on_card_ndim5(M):
    _need_card()
    from massivedatans_tpu_torch.ns.region import bootstrap_inbag_rounds

    g = torch.Generator(device="cuda").manual_seed(M + 5)
    w = torch.randn((M, 5), generator=g, device="cuda")
    mask = torch.arange(M, device="cuda") < (M - M // 5)
    inbag = bootstrap_inbag_rounds(mask, g, 10)
    before = neighbors.bootstrapped_sq_radius.launches
    got = neighbors.bootstrapped_sq_radius(w, mask, inbag)
    torch.cuda.synchronize()
    assert neighbors.bootstrapped_sq_radius.launches == before + 1
    want = neighbors.bootstrapped_sq_radius_plain(w, mask, inbag)
    assert float(got) > 0
    assert torch.isclose(got, want, rtol=1e-5, atol=0.0), (got, want)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take():
    _need_card()
    members = torch.rand((64, 9), device="cuda")  # ndim 9 > MAX_NDIM
    mask = torch.ones(64, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError):
        neighbors.count_within(members, mask, members, torch.tensor(0.1, device="cuda"))
    w = torch.rand((64, 3), device="cuda")
    with pytest.raises(ValueError):
        neighbors.bootstrapped_sq_radius(
            w, mask, torch.ones((33, 64), dtype=torch.bool, device="cuda"))
