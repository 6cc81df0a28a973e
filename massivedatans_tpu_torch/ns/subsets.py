"""Subset decomposition: which datasets share live points?

Host-side replacement of reference ``generate_subsets_graph`` /
``generate_subsets_nograph`` (multi_nested_sampler.py:175-355). The engine's
batched proposals already parallelize across disjoint groups inside one
region, so decomposition is an *advisory* accelerator here (survey §7: keep
it off the hot path): the integrator computes component labels at chunk
boundaries and the fill loop cycles its focused rebuilds through groups.

Implements the reference's short-circuits exactly:
- a single selected dataset is its own group (:209,267),
- fewer than 2*nlive unique live points ⇒ all connected (:218-224,276-282),
- a superpoint (live in every selected dataset) ⇒ all connected (:226-231).

The union-find over the bipartite dataset/point graph runs in native C++
(``csrc/unionfind.cpp``, built with the host C++ compiler on first use into
``massivedatans_tpu_torch/_build/`` by ``ops/_build.py``), with the
pure-numpy union-find as the plain version where no compiler is found.

The port's own copy of ``massivedatans_tpu/ns/subsets.py``: same names,
signatures and labels.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np

from massivedatans_tpu_torch.ops import _build

log = logging.getLogger("massivedatans_tpu_torch")
_lib = None
_lib_tried = False


def _load_native():
    """The native union-find, or None (logged) where it cannot be built."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        lib = _build.load_host()
        lib.decompose_components.restype = ctypes.c_int32
        lib.decompose_components.argtypes = [
            np.ctypeslib.ndpointer(np.int32, flags="F_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
    except Exception as e:  # toolchain missing: numpy union-find
        log.info("native unionfind unavailable (%s); using numpy", e)
        _lib = None
    return _lib


def _localize(live_idx: np.ndarray, selected: np.ndarray):
    """Map pile indices to [0, n_points) over the selected columns."""
    sub = live_idx[:, selected]
    uniq, local = np.unique(sub, return_inverse=True)
    local_full = np.zeros_like(live_idx)
    local_full[:, selected] = local.reshape(sub.shape)
    return local_full, uniq


def _components_numpy(live_local, selected, K, D, n_points):
    parent = np.arange(D + n_points, dtype=np.int64)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for d in np.where(selected)[0]:
        for p in live_local[:, d]:
            ra, rb = find(d), find(D + p)
            if ra != rb:
                parent[rb] = ra

    labels = np.full(D, -1, np.int32)
    remap = {}
    for d in np.where(selected)[0]:
        r = find(d)
        if r not in remap:
            remap[r] = len(remap)
        labels[d] = remap[r]
    return labels, len(remap)


def component_labels(live_idx: np.ndarray, selected=None,
                     nlive_points: int | None = None):
    """Component id per dataset (-1 = unselected). Returns (labels, count).

    ``live_idx`` is the [K, D] matrix of pile indices; ``selected`` a bool
    mask of datasets to decompose (default: all).
    """
    live_idx = np.asarray(live_idx, np.int32)
    K, D = live_idx.shape
    if selected is None:
        selected = np.ones(D, bool)
    selected = np.asarray(selected, bool)
    n_sel = int(selected.sum())
    labels = np.full(D, -1, np.int32)
    if n_sel == 0:
        return labels, 0
    if n_sel == 1:
        labels[selected] = 0
        return labels, 1

    live_local, uniq = _localize(live_idx, selected)
    n_points = len(uniq)

    # reference short-circuits: few unique points or a shared superpoint
    if nlive_points is not None and n_points < 2 * nlive_points:
        labels[selected] = 0
        return labels, 1
    counts = np.zeros(n_points, np.int64)
    for d in np.where(selected)[0]:
        counts[np.unique(live_local[:, d])] += 1
    if (counts == n_sel).any():  # superpoint: live in every selected dataset
        labels[selected] = 0
        return labels, 1

    lib = _load_native()
    if lib is not None:
        live_f = np.asfortranarray(live_local, np.int32)
        sel_u8 = np.ascontiguousarray(selected, np.uint8)
        out = np.zeros(D, np.int32)
        n = lib.decompose_components(live_f, sel_u8, K, D, n_points, out)
        return out, int(n)
    return _components_numpy(live_local, selected, K, D, n_points)


def generate_subsets(live_idx: np.ndarray, selected=None,
                     nlive_points: int | None = None):
    """Reference-compatible view: yields (dataset_mask, unique point ids)
    per connected component (generate_subsets_* contract)."""
    live_idx = np.asarray(live_idx)
    labels, n = component_labels(live_idx, selected, nlive_points)
    for g in range(n):
        mask = labels == g
        pts = np.unique(live_idx[:, mask])
        yield mask, pts
