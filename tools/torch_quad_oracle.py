"""Quadrature evidences of the first spectra of the 10^4 horns stream.

    JAX_PLATFORMS=cpu python3 tools/torch_quad_oracle.py [K] [out.json]

``gen_horns(10000)`` (the port's copy of the generator) is the stream of
``tools/scaling_bench.py`` and of ``bench.py``'s ndata = 10^4 workload;
its first spectra differ from those of ``gen_horns(1000)``, which
``quad_logZ.json`` covers. This computes the midpoint-rule evidence of the
first K (default 100) datasets of that stream with the functions and grids
of ``tools/quad_oracle.py`` (``quadrature_logZ`` of
``tests/test_quadrature_oracle.py`` on the coarse grid 96 x 1600 x 96 and
the fine grid 160 x 3000 x 160, in (A, mu, sigma)) and writes them, with
the per-dataset |fine - coarse| as ``conv_abs_diff``, to
``quad_logZ_horns10000.json`` (the payload keys of ``quad_logZ.json``,
``"n_gen": 10000``). A host tool: the test module it reads imports JAX,
hence ``JAX_PLATFORMS=cpu``. About 2.5 minutes on 8 CPU cores.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from massivedatans_tpu_torch.datagen.generators import gen_horns  # noqa: E402
from tests.test_quadrature_oracle import quadrature_logZ  # noqa: E402

N_GEN = 10000
GRIDS = dict(coarse=(96, 1600, 96), fine=(160, 3000, 160))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    K = int(argv[0]) if argv else 100
    out_path = argv[1] if len(argv) > 1 else os.path.join(
        ROOT, "quad_logZ_horns10000.json")
    data = gen_horns(N_GEN)
    x = np.asarray(data["x"], float)
    y = np.asarray(data["y"], float)[:, :K]
    noise = float(data["noise_level"])
    out = {}
    for name, (n_a, n_mu, n_sig) in GRIDS.items():
        t0 = time.time()
        out[name] = quadrature_logZ(x, y, noise, n_a=n_a, n_mu=n_mu,
                                    n_sig=n_sig)
        print(f"{name} grid {n_a}x{n_mu}x{n_sig}: {time.time() - t0:.1f}s",
              flush=True)
    conv = np.abs(out["fine"] - out["coarse"])
    payload = {
        "family": "horns",
        "n_gen": N_GEN,
        "ndata": K,
        "grid": list(GRIDS["fine"]),
        "grid_coarse": list(GRIDS["coarse"]),
        "logZ": [round(float(v), 4) for v in out["fine"]],
        "conv_abs_diff": [round(float(v), 4) for v in conv],
        "conv_max_abs_diff": round(float(conv.max()), 5),
        "prior": "A=10^(2u-2), mu=400+400u, sig=10^(2u) "
                 "(gensimple_horns / sample.py:52-58 equivalents)",
    }
    with open(out_path, "w") as fh:
        json.dump(payload, fh, indent=1)
    print(f"wrote {out_path}: conv_max_abs_diff={payload['conv_max_abs_diff']}")


if __name__ == "__main__":
    main()
