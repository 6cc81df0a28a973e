"""Trace one spaxel's mean-field VI fit in the MUSE refine of chip_smoke.py.

    python3 tools/torch_muse_vi_trace.py --spaxel 33          # on a card
    python3 tools/torch_muse_vi_trace.py --spaxel 33 --every 50
    python3 tools/torch_muse_vi_trace.py --save muse_fit.npz

Builds the kernels, fits the MUSE fixture of ``chip_smoke.py`` capped at
2,000 iterations (``chip_smoke.muse_fit``), then runs ``run_vi`` as
``run_refine`` does (the JAX CLI's chain seeds, generator seed 1, 1,500
steps) with ``infer.vi._elbo_samples`` wrapped to record, for the spaxel
given, the variational mean and log sigma in z-space and the smallest and
largest z drawn, every ``--every`` steps and at every step around the
first one whose parameters are not finite. One JSON line per record, then
one with the step at which the fit's parameters first went non-finite
(null if never) and the spaxel's final logZ_IW. ``--save`` writes the NS
fit's arrays (``u``, ``w``, ``L``, ``logZ``, ``logZerr``), the chain seeds
(``init_u``) and every spaxel's ``logZ_iw`` to an ``.npz``, the input of
``tools/jax_muse_vi_witness.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--spaxel", type=int, default=33)
    ap.add_argument("--every", type=int, default=100)
    ap.add_argument("--save", default=None,
                    help="write the fit, the seeds and logZ_iw here (.npz)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from massivedatans_tpu_torch.cli import refine_init_u
    from massivedatans_tpu_torch.config import set_fp32_precision
    from massivedatans_tpu_torch.infer import run_vi, vi
    from massivedatans_tpu_torch.muse.likelihood import make_muse_problem
    from massivedatans_tpu_torch.muse.model import load_template_grid
    from massivedatans_tpu_torch.ops import _build

    set_fp32_precision()
    cs._build_all(_build)
    s = args.spaxel
    with tempfile.TemporaryDirectory() as tmp:
        fixture = cs.muse_fixture(tmp)
        fit, _ = cs.muse_fit(fixture, 2000)
        cube, tpl, _ = fixture
        md = load_template_grid(tpl, data_wl_nm=cube.wavelength_nm, zlo=0.0,
                                zhi=0.5, device=cs.DEVICE)
    problem = make_muse_problem(md, cube.y, cube.var)
    init_u = refine_init_u(fit, problem.ndim)

    records, first_bad = [], [None]
    elbo_samples = vi._elbo_samples

    def traced(log_post, mu, log_sigma, eps):
        step = len(records)
        m = mu.detach()[s]
        ls = log_sigma.detach()[s]
        z = m[None] + torch.exp(ls)[None] * eps[:, s]
        finite = bool(torch.isfinite(m).all() & torch.isfinite(ls).all())
        if not finite and first_bad[0] is None:
            first_bad[0] = step
        records.append(dict(step=step, mu=m.tolist(), log_sigma=ls.tolist(),
                            z_min=z.amin(dim=0).tolist(),
                            z_max=z.amax(dim=0).tolist()))
        return elbo_samples(log_post, mu, log_sigma, eps)

    vi._elbo_samples = traced
    try:
        res = run_vi(problem, torch.Generator(device=cs.DEVICE).manual_seed(1),
                     device=cs.DEVICE, init_u=init_u)
    finally:
        vi._elbo_samples = elbo_samples
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
        np.savez(args.save, u=fit.u, w=fit.w, L=fit.L, logZ=fit.logZ,
                 logZerr=fit.logZerr, init_u=init_u,
                 logZ_iw=res.logZ_iw.cpu().numpy())
    near = set(range(first_bad[0] - 3, first_bad[0] + 1)) \
        if first_bad[0] is not None else set()
    for r in records:
        if r["step"] % args.every == 0 or r["step"] in near:
            print(json.dumps(r))
    print(json.dumps(dict(spaxel=s, init_u=init_u[s].tolist(),
                          ns_logZ=float(fit.logZ[s]),
                          ns_logZerr=float(fit.logZerr[s]),
                          first_nonfinite_step=first_bad[0],
                          logZ_iw=float(res.logZ_iw[s]))))


if __name__ == "__main__":
    main()
