"""Where the radius kernel's time goes: time variants of it on a card.

    python3 tools/torch_radius_variants.py

Builds ``csrc/neighbors.cu`` several times with parts of the radius kernel
switched off or its cluster narrowed, and prints one JSON line per
(variant, M): profiler device us and CUDA-event ms per call at ndim 3,
nb 10. The variants are made by patching a copy of the source (under
``massivedatans_tpu_torch/_build/variants``); their results are not the
radius, only their times mean anything:

- ``base``: the kernel as it is;
- ``no_ticket``: one atomicMax per cluster straight into the output, in
  place of the self-resetting workspace and its ticket;
- ``no_compute``: no distance/min loop (staging, merges and ticket stay);
- ``no_compute_no_ticket``: both;
- ``spansK``: clusters of at most K column spans (K = 4, 2, 1).

A patch that no longer matches the source stops the script: update the
patches with the kernel.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, "massivedatans_tpu_torch", "csrc", "neighbors.cu")
OUT = os.path.join(HERE, "massivedatans_tpu_torch", "_build", "variants")

TICKET = """      atomicMax(ws, __float_as_uint(rmax));
      __threadfence();
      const unsigned ticket = atomicAdd(ws + 1, 1u);
      if (ticket == gridDim.y - 1) {  // the last cluster: every max is in
        __threadfence();
        out[0] = __uint_as_float(atomicExch(ws, 0u));
        atomicExch(ws + 1, 0u);
      }"""
LOOP_HEAD = """    for (int j = warp; j < len; j += kRadiusWarps) {
      const uint32_t bag = s_bag[buf][j];  // one column per warp: uniform"""
LOOP_TAIL = """            nearest[r][b] = fminf(nearest[r][b], d2[r]);
          }
        }
      }
    }"""
SPANS = "min(kClusterMax, (m + kMinSpan - 1) / kMinSpan)"
PATCHES = [
    (TICKET, "#ifdef NO_TICKET\n      atomicMax(reinterpret_cast<unsigned*>(out), "
             "__float_as_uint(rmax));\n#else\n" + TICKET + "\n#endif"),
    (LOOP_HEAD, "#ifndef NO_COMPUTE\n" + LOOP_HEAD),
    (LOOP_TAIL, LOOP_TAIL + "\n#endif"),
    (SPANS, "min(SPANS, (m + kMinSpan - 1) / kMinSpan)"),
]
VARIANTS = {"base": ["-DSPANS=8"], "no_ticket": ["-DSPANS=8", "-DNO_TICKET"],
            "no_compute": ["-DSPANS=8", "-DNO_COMPUTE"],
            "no_compute_no_ticket": ["-DSPANS=8", "-DNO_COMPUTE", "-DNO_TICKET"],
            "spans4": ["-DSPANS=4"], "spans2": ["-DSPANS=2"],
            "spans1": ["-DSPANS=1"]}
SHAPES = (64, 1664, 16384)


def _patched_source() -> str:
    with open(SRC) as fh:
        src = fh.read()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"patch no longer matches {SRC}:\n{old}")
        src = src.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "neighbors_variants.cu")
    with open(path, "w") as fh:
        fh.write(src)
    return path


def main():
    if not torch.cuda.is_available():
        print("torch_radius_variants: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from massivedatans_tpu_torch.ns.region import bootstrap_inbag_rounds
    from massivedatans_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    src = _patched_source()

    def build(name):
        lib = os.path.join(OUT, f"lib_{name}.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *VARIANTS[name],
                        "-o", lib, src], check=True)
        return name, lib

    with ThreadPoolExecutor(len(VARIANTS)) as ex:  # one nvcc per variant
        libs = dict(ex.map(build, VARIANTS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for M in SHAPES:
        w = torch.randn((M, 3), generator=gen, device="cuda")
        mask = torch.arange(M, device="cuda") < M - M // 5
        inbag = bootstrap_inbag_rounds(mask, gen, 10)
        for name, path in libs.items():
            fn = ctypes.CDLL(path).mdt_bootstrap_radius
            fn.argtypes = [p, p, p, i, i, i, p, p, p]
            ws = torch.zeros(2, dtype=torch.int32, device="cuda")
            out = torch.zeros((), device="cuda")

            def call():
                rc = fn(w.data_ptr(), mask.data_ptr(), inbag.data_ptr(), M, 3,
                        10, out.data_ptr(), ws.data_ptr(), stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: cudaError {rc}")

            n = 200 if M <= 1664 else 20
            print(json.dumps(dict(variant=name, M=M, ndim=3, nb=10,
                                  device_us=smoke._device_ms(call, n) * 1e3,
                                  event_ms=smoke._time_ms(call, n))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
