"""Both packages' mean-field VI of the MUSE refine, on the CPU, from one
fit of the port and on the same normals.

    python3 tools/torch_muse_vi_trace.py --save muse_fit.npz  # card
    JAX_PLATFORMS=cpu python3 tools/jax_muse_vi_witness.py muse_fit.npz

Reads the port's fit of ``chip_smoke.py``'s MUSE fixture (capped at 2,000
iterations) and the chain seeds the port's ``refine`` took from it, checks
that the JAX CLI's code picks the same seeds (``jax_refine_counts
.refine_init_u``), then runs from them, as ``refine`` does:

- the JAX package's ``run_vi(key(1))`` on its own MUSE FULL problem of the
  fixture;
- the port's ``run_vi`` on its own problem of the fixture, with the
  normals of JAX's ``key(1)`` schedule (``massivedatans_tpu/infer/vi.py``:
  ``split(key, 4)``, then one ``split`` per step) fed in through ``draw=``.

Prints one JSON line per run, the port's on the card (the ``logZ_iw`` of
the file) first: the spaxels whose ``logZ_IW`` is not finite, how many
spaxels with a star have ``logZ_IW`` within 3 logZerr + 0.5 of the fit's
logZ (``chip_smoke.muse_star_counts``) and, for ``--spaxel`` (but for the
card's run), its final variational mean and sigma in z-space and its
``logZ_IW``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _summary(name, iw, fit, empty, wall=None, mu=None, sigma=None,
             spaxel=None):
    import numpy as np

    import chip_smoke as cs

    iw = np.asarray(iw)
    out = dict(run=name, wall_s=wall, iw_finite=int(np.isfinite(iw).sum()),
               iw_nonfinite=np.nonzero(~np.isfinite(iw))[0].tolist(),
               **cs.muse_star_counts(iw, fit["logZ"], fit["logZerr"], empty))
    if mu is not None:
        out.update(spaxel=spaxel, mu=np.asarray(mu)[spaxel].tolist(),
                   sigma=np.asarray(sigma)[spaxel].tolist(),
                   logZ_iw=float(iw[spaxel]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("fit", help=".npz written by tools/torch_muse_vi_trace.py "
                                "--save")
    ap.add_argument("--spaxel", type=int, default=33)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax
    import numpy as np
    import torch

    import chip_smoke as cs
    from jax_refine_counts import muse_problem, refine_init_u
    from massivedatans_tpu.infer import run_vi as jax_run_vi
    from massivedatans_tpu_torch.infer import run_vi
    from massivedatans_tpu_torch.muse.likelihood import make_muse_problem
    from massivedatans_tpu_torch.muse.model import load_template_grid

    fit = dict(np.load(args.fit))
    jp, truths = muse_problem()
    init_u = fit["init_u"]
    assert np.array_equal(refine_init_u(fit, jp.ndim), init_u)
    D, ndim = init_u.shape
    s = args.spaxel
    empty = np.asarray(truths["empty"], bool)[:D]
    print(json.dumps(_summary("port on the card", fit["logZ_iw"], fit,
                              empty)), flush=True)

    t0 = time.perf_counter()
    want = jax_run_vi(jp, jax.random.key(1), init_u=init_u)
    jax.block_until_ready(want.logZ_iw)
    print(json.dumps(_summary("jax", want.logZ_iw, fit, empty,
                              time.perf_counter() - t0, want.mu, want.sigma,
                              s)), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        cube, tpl, _ = cs.muse_fixture(tmp)
        md = load_template_grid(tpl, data_wl_nm=cube.wavelength_nm, zlo=0.0,
                                zhi=0.5, device="cpu")
    tp = make_muse_problem(md, cube.y, cube.var)
    key, k_fit, k_final, k_iw = jax.random.split(jax.random.key(1), 4)
    state = dict(key=k_fit, steps=0)
    finals = iter((k_final, k_iw))

    def draw(n):
        if n == 8 and state["steps"] < 1500:  # run_vi's mc_samples, steps
            state["key"], k = jax.random.split(state["key"])
            state["steps"] += 1
        else:
            k = next(finals)
        return torch.from_numpy(np.array(jax.random.normal(k, (n, D, ndim))))

    t0 = time.perf_counter()
    got = run_vi(tp, None, device="cpu", init_u=init_u, draw=draw)
    assert state["steps"] == 1500 and next(finals, None) is None
    print(json.dumps(_summary("port on the CPU, JAX's normals",
                              got.logZ_iw.numpy(), fit, empty,
                              time.perf_counter() - t0, got.mu.numpy(),
                              got.sigma.numpy(), s)), flush=True)


if __name__ == "__main__":
    main()
