"""HDF5 input/output with the reference's on-disk contract.

Input: generator files with ``x [nx]``, ``y [nx, N]`` (sample.py:28-31).
Output: ``<data>_<constrainer>_nlive<k>_<ndata>.out8.hdf5`` with datasets
``logZ, logZerr, u, x, L, w, mask, ndraws`` plus ``.stats.json``
(sample.py:200-217), so the reference's post-processing scripts
(checkoutput/plotevidences/plotscaling) work unchanged on our outputs.

The port's own copy of ``massivedatans_tpu/io/hdf5io.py``:
same schema, so each package reads the
other's files.
"""

from __future__ import annotations

import json
import os

import numpy as np


def load_spectra(path: str, ndata: int = 0):
    """Load ``x`` and the first ``ndata`` spectra (sample.py:28-31)."""
    import h5py

    with h5py.File(path, "r") as f:
        x = np.array(f["x"])
        y = np.array(f["y"][:, :ndata]) if ndata else np.array(f["y"])
    return x, y


def output_prefix(data_path: str, constrainer: str, nlive: int, ndata: int) -> str:
    return "%s_%s_nlive%d_%d.out8" % (data_path, constrainer, nlive, ndata)


def write_results(prefix: str, result, compress: bool = True):
    """Write the reference output schema (sample.py:202-217)."""
    import h5py

    kw = dict(compression="gzip", shuffle=True) if compress else {}
    with h5py.File(prefix + ".hdf5", "w") as f:
        f.create_dataset("logZ", data=result.logZ, **kw)
        f.create_dataset("logZerr", data=result.logZerr, **kw)
        f.create_dataset("u", data=result.u, **kw)
        f.create_dataset("x", data=result.x, **kw)
        f.create_dataset("L", data=result.L, **kw)
        f.create_dataset("w", data=result.w, **kw)
        f.create_dataset("mask", data=result.mask, **kw)
        f.create_dataset("ndraws", data=result.ndraws)
        stats = getattr(result, "stats", None) or {}
        if "stalled_mask" in stats:
            # per-dataset truncation flag: True where the sampler could not
            # fill the shelf and the evidence was force-terminated early
            # (no reference equivalent — the reference would spin forever,
            # multi_nested_sampler.py:422-428)
            f.create_dataset("stalled", data=np.asarray(
                stats["stalled_mask"], bool))

    extra = {}
    stats = getattr(result, "stats", None) or {}
    for k in ("stalled", "member_overflow", "pile_peak", "interrupted"):
        if k in stats:
            extra[k] = int(stats[k])
    if "stalled_mask" in stats:
        extra["n_stalled_datasets"] = int(np.asarray(
            stats["stalled_mask"]).sum())
    with open(prefix + ".stats.json", "w") as fh:
        json.dump(
            dict(
                ndraws=int(result.ndraws),
                duration=float(result.duration),
                ndata=int(result.logZ.shape[0]),
                niter=int(result.u.shape[0]),  # total weight rows incl. tail
                **extra,
            ),
            fh,
            indent=4,
        )


def read_results(prefix_or_file: str) -> dict:
    import h5py

    path = prefix_or_file
    if not os.path.exists(path) and os.path.exists(path + ".hdf5"):
        path = path + ".hdf5"
    out = {}
    with h5py.File(path, "r") as f:
        for k in ("logZ", "logZerr", "u", "x", "L", "w", "mask", "ndraws"):
            if k in f:
                out[k] = np.array(f[k])
    return out
