"""Post-processing and diagnostics (reference layer L7, survey §1).

The port's own copy of ``massivedatans_tpu/postprocess.py``: numpy and
matplotlib, which is imported inside the plotting functions only, so the
module imports where matplotlib is missing. The region demos build their
region with this package's ``ns/region.py`` on the CPU, and the best-fit
plots read the port's problems (``nn.Module`` buffers and
``predict_one``).

Functional equivalents of the reference plotting scripts:
- ``posterior_samples`` / ``check_output``  — checkoutput.py
- ``plot_posterior``                         — plotposterior.py
- ``plot_evidences``                         — plotevidences.py:17-36 (Bayes
  factors vs the analytic no-signal evidence)
- ``plot_scaling``                           — plotscaling.py (model
  evaluations vs dataset count, against linear and sqrt(N) curves)
- ``muse_maps``                              — musefuse_postprocess.py:99-174
  (per-spaxel posterior parameter / logZ maps)
"""

from __future__ import annotations

import json

import numpy as np


def posterior_weights(out: dict, d: int) -> np.ndarray:
    """Normalized posterior weights for dataset ``d`` from an output dict
    (columns of ``w`` + ``L``; checkoutput.py:29-33)."""
    w = out["w"][:, d].astype(np.float64) + out["L"][:, d].astype(np.float64)
    w[~np.isfinite(w)] = -np.inf
    p = np.exp(w - w.max())
    return p / p.sum()


def posterior_samples(out: dict, d: int, size: int = 1000, rng=None):
    """Equal-weight resampled posterior draws ``[size, ndim]``."""
    rng = rng or np.random.default_rng(0)
    p = posterior_weights(out, d)
    i = rng.choice(np.arange(len(p)), size=size, replace=True, p=p)
    return out["x"][i, d, :]


def analytic_nosignal_logZ(y: np.ndarray, noise_level: float = 0.01):
    """Evidence of the no-signal model: logZ0 = sum(-0.5 (y/sigma)^2)
    (plotevidences.py:17)."""
    return np.sum(-0.5 * (y / noise_level) ** 2, axis=0)


def bayes_factors(out: dict, y: np.ndarray, noise_level: float = 0.01):
    """log10 Bayes factors vs the no-signal model (plotevidences.py:20)."""
    logZ0 = analytic_nosignal_logZ(y, noise_level)
    return np.log10(np.exp(1.0)) * (out["logZ"] - logZ0)


def plot_evidences(out: dict, y, noise_level=0.01, path="plotevidences.pdf",
                   blim_clip=4.0):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    B = bayes_factors(out, y, noise_level)
    B = np.clip(B, None, blim_clip)
    plt.figure(figsize=(6, 4))
    bins = np.linspace(min(B.min(), -5), max(B.max() + 1, 5), 60)
    plt.hist(B, bins=bins, color="k", histtype="step", density=True)
    plt.xlabel("log10 Bayes factor B")
    plt.ylabel("Frequency")
    plt.savefig(path, bbox_inches="tight")
    plt.close()
    return B


def plot_posterior(out: dict, truth: dict | None = None, d: int = 0,
                   path="posterior.pdf", param_names=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = posterior_samples(out, d, size=2000)
    ndim = xs.shape[1]
    names = param_names or [f"p{j}" for j in range(ndim)]
    fig, axes = plt.subplots(1, ndim, figsize=(3 * ndim, 3))
    for j, ax in enumerate(np.atleast_1d(axes)):
        ax.hist(xs[:, j], bins=40, histtype="step", color="k")
        ax.set_xlabel(names[j])
        if truth and names[j] in truth:
            ax.axvline(np.atleast_1d(truth[names[j]])[d], color="r", ls=":")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return xs


def recovered_redshifts(out: dict, rest_wave: float = 440.0,
                        std_cut: float = 50.0, size: int = 1000, rng=None):
    """Population redshift recovery (plotposterior.py:19-33): per dataset,
    resample the posterior of the line position mu (param 1); datasets with
    mu.std() < ``std_cut`` are well-constrained and contribute
    ``z = mean(mu)/rest_wave - 1``.

    Returns ``(zs, constrained_mask)`` — the recovered redshifts of the
    constrained datasets and the per-dataset mask.
    """
    rng = rng or np.random.default_rng(0)
    D = out["logZ"].shape[0]
    zs, mask = [], np.zeros(D, bool)
    for d in range(D):
        mu = posterior_samples(out, d, size=size, rng=rng)[:, 1]
        if mu.std() < std_cut:
            mask[d] = True
            zs.append(mu.mean() / rest_wave - 1.0)
    return np.asarray(zs), mask


def plot_posterior_z(out: dict, path="plotposteriorz.pdf",
                     rest_wave: float = 440.0, alpha: float = 2.0,
                     beta: float = 7.0):
    """Recovered-redshift histogram against the injected Beta(alpha, beta)
    distribution (plotposterior.py:57-67) — the reference's
    posterior-recovery acceptance test for the ``gensimple`` suite."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy import stats

    zs, mask = recovered_redshifts(out, rest_wave=rest_wave)
    plt.figure(figsize=(5, 2.5))
    plt.hist(zs, bins=10, histtype="step", density=True,
             label="Well-constrained lines")
    grid = np.linspace(0, 1, 500)
    plt.plot(grid, stats.beta(alpha, beta).pdf(grid), "-", color="k",
             label="Input redshift distribution")
    plt.ylabel("Frequency")
    plt.xlabel("Redshift")
    plt.xlim(0, 1)
    plt.legend(fontsize=7)
    plt.savefig(path, bbox_inches="tight")
    plt.close()
    return zs, mask


def plot_scaling(stats_files, path="scaling.pdf"):
    """Model evaluations vs dataset count with linear / sqrt(N) guide curves
    (plotscaling.py:11-41) — the repository's headline claim."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    points = []
    for fn in stats_files:
        with open(fn) as fh:
            s = json.load(fh)
        points.append((s["ndata"], s["ndraws"], s.get("duration", 0)))
    points.sort()
    N = np.array([p[0] for p in points], float)
    draws = np.array([p[1] for p in points], float)
    plt.figure(figsize=(6, 4))
    plt.plot(N, draws, "o-", color="k", label="measured")
    plt.plot(N, draws[0] * N / N[0], ":", color="gray", label="linear")
    plt.plot(N, draws[0] * np.sqrt(N / N[0]), "--", color="r",
             label=r"$\sqrt{N}$")
    plt.xscale("log")
    plt.yscale("log")
    plt.xlabel("number of datasets N")
    plt.ylabel("model evaluations")
    plt.legend(loc="best")
    plt.savefig(path, bbox_inches="tight")
    plt.close()
    return N, draws


def muse_maps(out: dict, flat_positions, mask_shape, param_names=None,
              path_prefix="musemap"):
    """Per-spaxel posterior-mean parameter maps + logZ map
    (musefuse_postprocess.py:99-174). ``flat_positions`` are the fitted
    spaxels' positions on the flattened (ny*nx) field
    (MuseCube.flat_positions())."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ndata = out["logZ"].shape[0]
    ndim = out["x"].shape[2]
    names = param_names or [f"p{j}" for j in range(ndim)]
    ny, nx = mask_shape
    flat_positions = np.asarray(flat_positions)[:ndata]
    maps = {}
    for j in range(ndim):
        img = np.full(ny * nx, np.nan)
        for d in range(ndata):
            p = posterior_weights(out, d)
            img[flat_positions[d]] = (p * out["x"][:, d, j]).sum()
        maps[names[j]] = img.reshape(ny, nx)
    img = np.full(ny * nx, np.nan)
    img[flat_positions] = out["logZ"]
    maps["logZ"] = img.reshape(ny, nx)

    for name, img2d in maps.items():
        plt.figure(figsize=(5, 4))
        plt.imshow(img2d, origin="lower")
        plt.colorbar()
        plt.title(name)
        plt.savefig(f"{path_prefix}_{name}.pdf", bbox_inches="tight")
        plt.close()
    return maps


def _weighted_quantiles(x, q):
    xs = np.sort(np.asarray(x, float))
    return np.quantile(xs, q)


def plot_corner(samples, labels=None, quantiles=(0.16, 0.5, 0.84), bins=40,
                path=None, show_titles=True):
    """Dependency-free corner plot: marginal histograms on the diagonal,
    pairwise 2-D histograms below, quantile titles. Stand-in for the external
    ``corner.corner`` call in the reference (plotmuseposterior.py:36-39)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    samples = np.asarray(samples, float)
    ndim = samples.shape[1]
    names = labels or [f"p{j}" for j in range(ndim)]
    fig, axes = plt.subplots(ndim, ndim, figsize=(2.2 * ndim, 2.2 * ndim))
    axes = np.atleast_2d(axes)
    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i, j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                ax.hist(samples[:, i], bins=bins, histtype="step", color="k")
                for q in quantiles:
                    ax.axvline(_weighted_quantiles(samples[:, i], q),
                               color="k", ls="--", lw=0.8)
                if show_titles and quantiles:
                    lo, mid, hi = (_weighted_quantiles(samples[:, i], q)
                                   for q in quantiles[:3])
                    ax.set_title(
                        f"{names[i]} = {mid:.2f}"
                        f"$^{{+{hi - mid:.2f}}}_{{-{mid - lo:.2f}}}$",
                        fontsize=10)
                ax.set_yticks([])
            else:
                ax.hist2d(samples[:, j], samples[:, i], bins=bins,
                          cmap="Greys")
            if i == ndim - 1:
                ax.set_xlabel(names[j])
            else:
                ax.set_xticklabels([])
            if j == 0 and i > 0:
                ax.set_ylabel(names[i])
    fig.tight_layout()
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_muse_posterior(out: dict, labels=None, transforms=None,
                        min_finite=4000, size=100000,
                        path_prefix="museposterior", rng=None):
    """Per-spaxel corner plots of the MUSE posterior
    (plotmuseposterior.py:13-41): for every dataset with at least
    ``min_finite`` finite posterior weights, resample ``size`` weighted draws
    and render a corner plot with 16/50/84% quantile titles.

    ``transforms`` maps column index -> callable applied to the samples
    (the reference log10-transforms the continuum and SFage columns,
    plotmuseposterior.py:27-30). Returns the list of datasets plotted."""
    rng = rng or np.random.default_rng()
    ndata = out["logZ"].shape[0]
    ndim = out["x"].shape[2]
    names = labels or (["Z", "logSFtau", "SFage", "z", "EBV"]
                       if ndim == 5 else [f"p{j}" for j in range(ndim)])
    transforms = transforms or {}
    done = []
    for d in range(ndata):
        w = out["w"][:, d].astype(np.float64) + out["L"][:, d].astype(np.float64)
        mask = np.isfinite(w)
        if mask.sum() < min_finite:
            continue
        jparent = np.where(mask)[0]
        p = np.exp(w[jparent] - w[jparent].max())
        p = p / p.sum()
        j = rng.choice(jparent, size=size, p=p)
        cols = [np.asarray(transforms.get(k, lambda v: v)(out["x"][:, d, k][j]))
                for k in range(ndim)]
        data = np.transpose(cols)
        plot_corner(data, labels=names,
                    path=f"{path_prefix}_{d + 1}.pdf")
        done.append(d)
    return done


def _demo_likelihood(x, y):
    """Curved chain of Gaussian blobs: a 2-D multimodal test surface for the
    region-visualisation demos (pres/plotcontour.py)."""
    cx = np.linspace(0.0, 4.0, 16)
    cy = 0.25 * cx ** 2 - 0.1 * cx
    cw = 1.0 / (1.5 + 8.0 * cy ** 2)
    cs = 0.22
    l = np.zeros(np.broadcast(x, y).shape)
    for k in range(cx.size):
        l = l + cw[k] * np.exp(
            -0.5 * (((x - cx[k]) / cs) ** 2 + ((y - cy[k]) / cs) ** 2))
    return np.log(l + 1e-300)


def _demo_region_mask(points_xy, grid_xy, key=0):
    """Build a RadFriends region from 2-D live points and evaluate grid
    membership with the framework's region machinery (ns/region.py), on
    the CPU; ``key`` seeds the bootstrap's generator."""
    import torch

    from massivedatans_tpu_torch.ns import region as region_lib

    members = torch.as_tensor(np.asarray(points_xy), dtype=torch.float32)
    mask = torch.ones(members.shape[0], dtype=torch.bool)
    reg = region_lib.build_region(members, mask,
                                  torch.Generator().manual_seed(key))
    w = reg.metric.transform(torch.as_tensor(np.asarray(grid_xy),
                                             dtype=torch.float32))
    return (region_lib.count_within(reg, w) > 0).numpy()


def plot_region_demo(path_prefix="plotcontour", nlive=100, nlevels=5,
                     seed=1, npoints=10000):
    """Nested-sampling region illustration (pres/plotcontour.py): for a
    sequence of likelihood level sets, plot the surviving prior samples and
    the RadFriends region boundary built from the first ``nlive`` of them."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    gx = np.linspace(-2.5, 6.5, 100)
    gy = np.linspace(-2.5, 6.5, 100)
    X, Y = np.meshgrid(gx, gy)
    XY = np.transpose([X.ravel(), Y.ravel()])
    L = _demo_likelihood(X, Y)
    inner = np.sort(L[20:-20, 20:-20].ravel())
    levels = list(inner[:: max(1, inner.size // (nlevels + 2) - 1)])[2:2 + nlevels]

    plt.figure(figsize=(6, 3), frameon=False)
    plt.axis("off")
    plt.contour(X, Y, L, levels)
    plt.savefig(f"{path_prefix}.pdf", bbox_inches="tight")
    plt.close()

    rng = np.random.default_rng(seed)
    px = rng.uniform(-2, 6, size=npoints)
    py = rng.uniform(-2, 6, size=npoints)
    pl = _demo_likelihood(px, py)
    outputs = []
    for i, level in enumerate(levels):
        keep = pl > level
        xl, yl = px[keep][:nlive], py[keep][:nlive]
        if xl.size < 4:
            break
        inside = _demo_region_mask(np.transpose([xl, yl]), XY, key=i)
        plt.figure(figsize=(6, 2.4), frameon=False)
        plt.axis("off")
        plt.contour(X, Y, L, [level], colors=["k"], linestyles=[":"])
        plt.plot(xl, yl, ".", color="k")
        plt.contour(X, Y, inside.reshape(X.shape) * 1.0, [0.5],
                    colors=["orange"])
        path = f"{path_prefix}_{i + 1}.pdf"
        plt.savefig(path, bbox_inches="tight")
        plt.close()
        outputs.append(path)
    return outputs


def plot_joint_region_demo(path_prefix="plotjointcontour", nlive=100,
                           nlevels=5, seed=1, npoints=10000):
    """Joint-run illustration (pres/plotjointcontour.py): two overlapping
    Gaussian likelihoods; at each level, points satisfying both constraints
    (shared model evaluations) vs points unique to one dataset."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def like(x, y, cx, cy):
        return -0.5 * (((x - cx) / 0.5) ** 2 + ((y - cy) / 0.25) ** 2)

    gx = np.linspace(-2.5, 6.5, 100)
    gy = np.linspace(-2.5, 6.5, 100)
    X, Y = np.meshgrid(gx, gy)
    L1 = like(X, Y, 2.0, 1.1)
    L2 = like(X, Y, 2.3, 1.25)
    inner = np.sort(L1[20:-20, 20:-20].ravel())
    levels = list(inner[:: max(1, inner.size // (nlevels + 2) - 1)])[2:2 + nlevels]

    rng = np.random.default_rng(seed)
    px = rng.uniform(-2, 6, size=npoints)
    py = rng.uniform(-2, 6, size=npoints)
    l1 = like(px, py, 2.0, 1.1)
    l2 = like(px, py, 2.3, 1.25)
    outputs = []
    for i, level in enumerate(levels):
        m1, m2 = l1 > level, l2 > level
        both = m1 & m2
        only1 = m1 & ~m2
        only2 = m2 & ~m1
        plt.figure(figsize=(6, 2.4), frameon=False)
        plt.axis("off")
        plt.plot(px[both][:nlive], py[both][:nlive], ".", color="k",
                 label="shared")
        plt.plot(px[only1][:nlive], py[only1][:nlive], "x", color="c")
        plt.plot(px[only2][:nlive], py[only2][:nlive], "+", color="m")
        plt.contour(X, Y, L1, [level], colors=["c"], linestyles=[":"])
        plt.contour(X, Y, L2, [level], colors=["m"], linestyles=[":"])
        path = f"{path_prefix}_{i + 1}.pdf"
        plt.savefig(path, bbox_inches="tight")
        plt.close()
        outputs.append(path)
    return outputs


def _best_sample(out: dict, d: int):
    """Index and parameters of dataset ``d``'s highest-likelihood sample."""
    L = out["L"][:, d].astype(np.float64)
    L[~np.isfinite(L)] = -np.inf
    i = int(np.argmax(L))
    return i, out["x"][i, d, :]


def _predict(problem, x):
    """``problem.predict_one`` of a host parameter vector, as a numpy
    curve on the host (None for a problem without a curve)."""
    import torch

    xt = torch.as_tensor(np.asarray(x), dtype=torch.float32,
                         device=problem.device)
    with torch.no_grad():
        ypred = problem.predict_one(xt)
    return None if ypred is None else ypred.cpu().numpy()


def _host(problem, name):
    """A buffer of ``problem`` as a host array, or None."""
    t = getattr(problem, name, None)
    return None if t is None else t.detach().cpu().numpy()


def plot_bestfit(out: dict, problem, datasets=None, path_prefix="bestfit"):
    """Best-fit model curve vs observed spectrum per dataset. The reference
    emits these from inside the MUSE likelihood whenever a spaxel's Lmax
    improves (musefuse.py:385-404,437-460); here they render post-hoc from
    the recorded samples via ``Problem.predict_one``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grid = _host(problem, "x")
    obs = _host(problem, "y")
    outputs = []
    for d in datasets if datasets is not None else range(out["logZ"].shape[0]):
        i, xbest = _best_sample(out, d)
        ypred = _predict(problem, xbest)
        if ypred is None:
            return []
        g = grid if grid is not None else np.arange(ypred.shape[0])
        plt.figure(figsize=(6, 3))
        if obs is not None:
            plt.plot(g, obs[:, d], color="0.6", lw=0.7, label="data")
        plt.plot(g, ypred, color="r", lw=1.2,
                 label=f"best fit (L={out['L'][i, d]:.1f})")
        plt.xlabel("x")
        plt.legend(loc="best")
        path = f"{path_prefix}_{d}.pdf"
        plt.savefig(path, bbox_inches="tight")
        plt.close()
        outputs.append(path)
    return outputs


def plot_muse_bestfit(out: dict, problem, datasets=None,
                      path_prefix="musebestfit"):
    """MUSE best-fit spectra with the analytically-marginalized amplitude
    re-applied: ``s = (m . y/var) / (m^2 . 1/var)`` (cmuselike.c:48-64,
    musefuse.py:385-404)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    wl = problem.md.data_wl.detach().cpu().numpy()
    y_over_v = _host(problem, "y_over_v")
    inv_v = _host(problem, "inv_v")
    outputs = []
    for d in datasets if datasets is not None else range(out["logZ"].shape[0]):
        i, xbest = _best_sample(out, d)
        m = _predict(problem, xbest)
        s1 = float(m @ y_over_v[:, d])
        s2 = float((m ** 2) @ inv_v[:, d]) + 1e-10
        s = s1 / s2
        good = inv_v[:, d] > 0
        yobs = np.where(good, y_over_v[:, d] / np.maximum(inv_v[:, d], 1e-30),
                        np.nan)
        plt.figure(figsize=(7, 3))
        plt.plot(wl, yobs, color="0.6", lw=0.7, label="spaxel")
        plt.plot(wl, s * m, color="r", lw=1.2,
                 label=f"best fit s={s:.3g} (L={out['L'][i, d]:.1f})")
        plt.xlabel("wavelength [nm]")
        plt.legend(loc="best")
        path = f"{path_prefix}_{d}.pdf"
        plt.savefig(path, bbox_inches="tight")
        plt.close()
        outputs.append(path)
    return outputs
