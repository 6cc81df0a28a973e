"""Carry problems and sampler states across from the JAX package.

Both converters take plain numpy arrays, so this package never imports JAX
to use them: a caller holding JAX objects passes
``{name: np.asarray(value) ...}``.
"""

from __future__ import annotations

import numpy as np
import torch

from massivedatans_tpu_torch.models.analytic import AnalyticBimodal, AnalyticGaussian
from massivedatans_tpu_torch.models.gaussline import GaussLine
from massivedatans_tpu_torch.muse.likelihood import MuseProblem
from massivedatans_tpu_torch.muse.model import model_data_from_numpy
from massivedatans_tpu_torch.ns.engine import EngineState
from massivedatans_tpu_torch.ns.shelves import Shelves


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def problem_from_numpy(arrays, kind: str, device="cpu"):
    """The port's problem from the JAX problem's data arrays.

    ``kind="gaussline"``: ``x, y, ysq, noise_level`` (``GaussLineData``);
    ``kind="analytic_gaussian"``: ``centers, sigma``
    (``AnalyticGaussianData``); ``kind="analytic_bimodal"``: ``centers_a,
    centers_b, sigma`` (``AnalyticBimodalData``);
    ``kind="muse"`` or ``"muse_zsol"``: the ``MuseModelData`` fields
    ``templates, ages, age_weight, model_wl, calzetti, data_wl, z_grid,
    norm_index, zlo, zhi`` and the ``MuseLikeData`` fields ``y_over_v,
    inv_v, yy``. Arrays are used as given (float32), so both packages score
    the same numbers.
    """
    f32 = torch.float32
    if kind == "gaussline":
        return GaussLine(
            x=_t(arrays["x"], device, f32),
            y=_t(arrays["y"], device, f32),
            ysq=_t(arrays["ysq"], device, f32),
            noise_level=_t(arrays["noise_level"], device, f32),
        )
    if kind == "analytic_gaussian":
        return AnalyticGaussian(
            centers=_t(arrays["centers"], device, f32),
            sigma=_t(arrays["sigma"], device, f32),
        )
    if kind == "analytic_bimodal":
        return AnalyticBimodal(
            centers_a=_t(arrays["centers_a"], device, f32),
            centers_b=_t(arrays["centers_b"], device, f32),
            sigma=_t(arrays["sigma"], device, f32),
        )
    if kind in ("muse", "muse_zsol"):
        md = model_data_from_numpy(
            arrays["templates"], arrays["ages"], arrays["model_wl"],
            arrays["data_wl"], arrays["zlo"], arrays["zhi"],
            int(arrays["norm_index"]), age_weight=arrays["age_weight"],
            calzetti=arrays["calzetti"], z_grid=arrays["z_grid"],
            device=device)
        return MuseProblem(
            md, _t(arrays["y_over_v"], device, f32),
            _t(arrays["inv_v"], device, f32), _t(arrays["yy"], device, f32),
            zsol=kind == "muse_zsol")
    raise ValueError(f"unknown problem kind {kind!r}")


def state_from_numpy(fields, device="cpu") -> EngineState:
    """The port's ``EngineState`` from the fields of a JAX ``EngineState``.

    ``fields`` maps every JAX field name to a numpy array; ``shelves`` maps
    ``idx``/``L``/``count`` (or is an ``(idx, L, count)`` tuple). The JAX
    ``key`` is ignored: the port's randomness lives in a
    ``torch.Generator``. The pile gains the port's write-sink row.
    """
    sh = fields["shelves"]
    if not isinstance(sh, dict):
        sh = dict(zip(("idx", "L", "count"), sh))
    kw = {}
    for f in EngineState.__dataclass_fields__:
        if f in ("shelves", "pile_u", "pile_x", "n_groups"):
            continue
        kw[f] = _t(fields[f], device)
    for f in ("pile_u", "pile_x"):
        pile = np.asarray(fields[f], np.float32)
        kw[f] = _t(np.concatenate([pile, np.zeros_like(pile[:1])]), device)
    kw["ndraws"] = kw["ndraws"].to(torch.int64)
    kw["draws_at_rebuild"] = kw["draws_at_rebuild"].to(torch.int64)
    return EngineState(
        shelves=Shelves(idx=_t(sh["idx"], device), L=_t(sh["L"], device),
                        count=_t(sh["count"], device)),
        n_groups=max(int(fields["n_groups"]), 1),
        **kw,
    )
