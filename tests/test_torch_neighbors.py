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


def _sample_region_two_calls(reg, generator, nprop, norm):
    """``sample_region`` as it was before the fused count: each half
    counted on its own, from the plain count, in the same draw order."""
    from massivedatans_tpu_torch.ns import region

    def count(w_points):
        if norm == "euclidean":
            return neighbors.count_within_plain(reg.members_w, reg.member_mask,
                                                w_points, reg.radius)
        return region.count_within(reg, w_points, norm=norm)

    ndim = reg.members_w.shape[1]
    n_box = nprop // 2
    n_ball = nprop - n_box
    w_box = reg.lo + (reg.hi - reg.lo) * torch.rand((n_box, ndim),
                                                    generator=generator)
    ok_box = count(w_box) > 0
    mem = region.uniform_choice(reg.member_mask, n_ball, generator)
    w_ball = reg.members_w[mem] + region.ball_offsets(generator, n_ball, ndim,
                                                      reg.radius, norm=norm)
    nnear = count(w_ball)
    coin = torch.rand((n_ball,), generator=generator)
    ok_ball = coin * nnear.to(coin.dtype) < 1.0
    w_all = torch.cat([w_box, w_ball], dim=0)
    u = reg.metric.untransform(w_all)
    in_cube = torch.all((u > 0.0) & (u < 1.0), dim=1)
    return u, torch.cat([ok_box, ok_ball], dim=0) & in_cube


@pytest.mark.parametrize("norm", ["euclidean", "chebyshev"])
@pytest.mark.parametrize("ndim, nprop", [(3, 512), (5, 512), (2, 33)])
def test_sample_region_fused_count_equals_two_calls(norm, ndim, nprop):
    from massivedatans_tpu_torch.ns import region

    rng = np.random.default_rng(ndim + nprop)
    M = 300
    members = torch.from_numpy(rng.uniform(0.2, 0.8, size=(M, ndim)).astype(np.float32))
    mask = torch.from_numpy(np.arange(M) < 250)
    reg = region.build_region(members, mask, torch.Generator().manual_seed(1),
                              norm=norm)
    got = region.sample_region(reg, torch.Generator().manual_seed(7), nprop,
                               norm=norm)
    want = _sample_region_two_calls(reg, torch.Generator().manual_seed(7),
                                    nprop, norm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert 0 < int(got[1].sum()) < nprop


def _card_count_case(seed, N, M, ndim):
    g = torch.Generator(device="cuda").manual_seed(seed)
    members = torch.randn((M, ndim), generator=g, device="cuda")
    mask = torch.arange(M, device="cuda") < (M - M // 7)
    pts = 3.0 * (2.0 * torch.rand((N, ndim), generator=g, device="cuda") - 1.0)
    # wide enough in every ndim that points find members
    radius = torch.tensor(0.2 + 0.25 * ndim, device="cuda")
    return members, mask, pts, radius


@pytest.mark.cuda
@pytest.mark.parametrize("N, M, ndim",
                         [(256, M, 3) for M in (256, 1000, 1664, 8192, 16384)]
                         + [(256, M, 5) for M in (1664, 16384)]
                         + [(512, M, 3) for M in (1, 63, 1000, 1664, 4100, 16384)]
                         + [(512, 1664, d) for d in (1, 2, 4, 5, 6, 7, 8)]
                         + [(512, 16384, 8)]
                         + [(2048, 1664, d) for d in (3, 5)])
def test_count_within_kernel_matches_plain_on_card(N, M, ndim):
    """Bitwise (same explicit-difference arithmetic without FMA). N=512 is
    the main path: both proposal halves of a round in one call; N=2048 a
    round of an escalated chunk (eval_batch_max 512); M=4100 and 16384
    stream the members through two shared-memory buffers."""
    _need_card()
    members, mask, pts, radius = _card_count_case(M + ndim + N, N, M, ndim)
    before = neighbors.count_within.launches
    got = neighbors.count_within(members, mask, pts, radius)
    torch.cuda.synchronize()
    assert neighbors.count_within.launches == before + 1
    want = neighbors.count_within_plain(members, mask, pts, radius)
    assert torch.equal(got, want)
    if M >= 1000:
        assert int(want.sum()) > 0


def _card_radius_case(seed, M, ndim, nb):
    from massivedatans_tpu_torch.ns.region import bootstrap_inbag_rounds

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((M, ndim), generator=g, device="cuda")
    mask = torch.arange(M, device="cuda") < max(1, M - M // 5)
    return w, mask, bootstrap_inbag_rounds(mask, g, nb)


@pytest.mark.cuda
@pytest.mark.parametrize("M, ndim, nb",
                         [(M, 3, nb) for M in (1, 63, 256, 1000, 1664, 8192, 16384)
                          for nb in (1, 3, 10, 32)]
                         + [(1664, d, nb) for d in (1, 2, 4, 5, 6, 7, 8)
                            for nb in (3, 10)]
                         + [(16384, 5, 10)])
def test_bootstrap_radius_kernel_matches_plain_on_card(M, ndim, nb):
    """Bitwise. nb 10 runs the templated instantiation, the others the
    generic one; M 1 and 63 give column spans that do not fill a cluster."""
    _need_card()
    w, mask, inbag = _card_radius_case(M * 37 + nb + ndim, M, ndim, nb)
    before = neighbors.bootstrapped_sq_radius.launches
    got = neighbors.bootstrapped_sq_radius(w, mask, inbag)
    torch.cuda.synchronize()
    assert neighbors.bootstrapped_sq_radius.launches == before + 1
    want = neighbors.bootstrapped_sq_radius_plain(w, mask, inbag)
    assert got.shape == () and got.dtype == torch.float32
    assert torch.equal(got, want), (float(got), float(want))
    if M >= 256:
        assert float(want) > 0
    # twice in a row: the merge workspace came back to zero
    assert torch.equal(neighbors.bootstrapped_sq_radius(w, mask, inbag), want)


@pytest.mark.cuda
def test_kernels_launch_alone_without_a_fill():
    """In the profiler, a call of either wrapper runs its own kernel and no
    other device work: no zero-fill comes before it."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    members, mask, pts, radius = _card_count_case(1, 512, 1664, 3)
    w, wmask, inbag = _card_radius_case(2, 1664, 3, 10)
    neighbors.count_within(members, mask, pts, radius)
    neighbors.bootstrapped_sq_radius(w, wmask, inbag)  # makes its workspace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            neighbors.count_within(members, mask, pts, radius)
            neighbors.bootstrapped_sq_radius(w, wmask, inbag)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0}
    # a trace may miss a launch, never invent one: exactly our two kernels
    assert len(kernels) == 2, kernels
    assert all("count_within" in k or "bootstrap_radius" in k for k in kernels), kernels


@pytest.mark.cuda
def test_one_count_launch_per_region_round_in_a_fit(monkeypatch):
    _need_card()
    from massivedatans_tpu_torch.cli import run_fit
    from massivedatans_tpu_torch.config import RunConfig
    from massivedatans_tpu_torch.datagen.generators import gen_horns
    from massivedatans_tpu_torch.ns import region

    rounds = []
    sample = region.sample_region
    monkeypatch.setattr(region, "sample_region",
                        lambda *a, **k: rounds.append(1) or sample(*a, **k))
    data = gen_horns(50)
    neighbors.count_within.launches = 0
    result = run_fit(data["x"], data["y"], RunConfig(nlive_points=100,
                                                     max_samples=300), "cuda")
    assert np.isfinite(result.logZ).all()
    assert len(rounds) > 0
    assert neighbors.count_within.launches == len(rounds)


@pytest.mark.cuda
def test_one_count_launch_per_region_round_when_escalated(monkeypatch):
    """Escalated chunks (eval_batch_max = 4 x eval_batch) propose 2048
    points per region round, still counted in one launch."""
    _need_card()
    from massivedatans_tpu_torch.config import RunConfig
    from massivedatans_tpu_torch.models.analytic import make_analytic_gaussian_problem
    from massivedatans_tpu_torch.ns import region
    from massivedatans_tpu_torch.ns.integrator import multi_nested_integrator

    sizes = []
    sample = region.sample_region
    monkeypatch.setattr(region, "sample_region",
                        lambda reg, g, n, **k: sizes.append(n) or sample(reg, g, n, **k))
    # tight 5-D modes: late fills need several rounds per iteration
    centers = np.random.default_rng(5).uniform(0.2, 0.8, size=(8, 5))
    cfg = RunConfig(nlive_points=100, eval_batch=32, eval_batch_max=128,
                    proposal_batch=512, shelf_capacity=4, chunk_iters=25,
                    max_fill_rounds=512, max_samples=1000)
    neighbors.count_within.launches = 0
    result = multi_nested_integrator(
        make_analytic_gaussian_problem(centers, sigma=0.02), cfg,
        device="cuda", progress=False)
    assert np.isfinite(result.logZ).all()
    assert result.stats["big_batch_chunks"] > 0
    assert set(sizes) == {512, 2048}
    assert neighbors.count_within.launches == len(sizes)
