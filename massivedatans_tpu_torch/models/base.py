"""Problem definition layer.

Counterpart of ``massivedatans_tpu/models/base.py``: a problem is a prior
transform plus a log-likelihood that scores a *batch* of parameter vectors
against every dataset at once, returning ``L[B, D]``. Here a problem is an
``nn.Module`` whose data are buffers, so ``problem.to(device)`` moves them,
and both methods are written batch-first (no vmap).
"""

from __future__ import annotations

import torch
from torch import nn


class Problem(nn.Module):
    """A many-dataset inference problem.

    Subclasses register their data as buffers and implement

    - ``transform_batch(u[B, ndim]) -> x[B, ndim]`` (reference
      ``priortransform``, sample.py:52-58, batched), and
    - ``loglike(x[B, ndim]) -> L[B, D]`` (reference ``multi_loglikelihood``,
      sample.py:101-108, against all datasets).

    ``loglike_paired`` and ``predict_one`` are optional hooks.
    """

    name = "problem"

    def __init__(self, ndim: int, ndata: int):
        super().__init__()
        self.ndim = ndim
        self.ndata = ndata

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    def transform_batch(self, u):
        raise NotImplementedError

    def loglike(self, x):
        raise NotImplementedError

    def forward(self, x):
        return self.loglike(x)

    def loglike_paired(self, x):
        raise NotImplementedError(
            "loglike_paired (one likelihood per dataset, for the gradient "
            "backends) is not ported yet (ROADMAP.md queue 1, item 13)")

    def predict_one(self, x):
        """One model curve ``ypred[nx]`` for the parameter vector
        ``x[ndim]`` (the JAX ``Problem.predict_fn``), for best-fit plots."""
        raise NotImplementedError(
            f"{type(self).__name__} has no predict_one; the plotting layer "
            "that reads it is not ported yet (ROADMAP.md queue 1, item 16)")

    def loglike_sharded(self, x, model_axis_name=None):
        raise NotImplementedError(
            "the spectral-axis sharded likelihood is not ported yet "
            "(ROADMAP.md queue 1, item 15)")
