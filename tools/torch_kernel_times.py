"""Time the PyTorch port's two region kernels of one source tree on a card.

    python3 tools/torch_kernel_times.py [--root DIR] [--label NAME]

Imports ``massivedatans_tpu_torch`` from ``DIR`` (default: this checkout),
builds its kernels, and prints one JSON line per case: CUDA-event ms per
call over back-to-back calls (host issue included) and profiler device ms
per call (every kernel the call launches, fills included), at the main-path
shapes. Two trees timed in one call on one card, in turns (A, B, B, A),
compare two versions of the kernels and their wrappers. The timing helpers
are ``chip_smoke.py``'s, from this checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [("count_within", dict(N=512, M=64)),     # the launch floor
         ("count_within", dict(N=256, M=1664)),   # one half of a round
         ("count_within", dict(N=512, M=1664)),   # both halves
         ("count_within", dict(N=512, M=16384)),
         ("bootstrapped_sq_radius", dict(M=64, nb=10)),  # the floor
         ("bootstrapped_sq_radius", dict(M=1664, nb=10)),
         ("bootstrapped_sq_radius", dict(M=16384, nb=10))]


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA card", file=sys.stderr)
        return 1
    smoke = _smoke()
    sys.path.insert(0, os.path.abspath(args.root))
    from massivedatans_tpu_torch.ops import _build, neighbors
    from massivedatans_tpu_torch.ns.region import bootstrap_inbag_rounds

    assert os.path.dirname(os.path.abspath(neighbors.__file__)).startswith(
        os.path.abspath(args.root))
    _build.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape in CASES:
        for ndim in (3, 5):
            M = shape["M"]
            n = 200 if M <= 1664 else 20
            mask = torch.arange(M, device="cuda") < (M - M // 7)
            members = torch.randn((M, ndim), generator=gen, device="cuda")
            if name == "count_within":
                pts = torch.rand((shape["N"], ndim), generator=gen, device="cuda")
                radius = torch.tensor(0.25 * ndim, device="cuda")
                call = lambda: neighbors.count_within(members, mask, pts, radius)  # noqa: E731
            else:
                inbag = bootstrap_inbag_rounds(mask, gen, shape["nb"])
                call = lambda: neighbors.bootstrapped_sq_radius(members, mask, inbag)  # noqa: E731
            print(json.dumps(dict(
                label=args.label or args.root, kernel=name, ndim=ndim, **shape,
                ms=smoke._time_ms(call, n), device_ms=smoke._device_ms(call, n))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
