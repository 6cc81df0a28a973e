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

    ``loglike_paired`` and ``predict_one`` have defaults that a subclass
    may override: the paired likelihood falls back to the diagonal of the
    ``[D, D]`` batch likelihood, and ``predict_one`` gives ``None`` (no
    model curve).
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
        """``L[..., d]``: dataset d scored against its own parameter vector
        ``x[..., d, :]``, for the gradient backends (``infer/``).

        This default takes the diagonal of the full ``[D, D]`` batch
        likelihood, O(D^2) per call, once for each index of the leading
        axes: flattening them into the batch would pair row ``n*D + d``
        with dataset ``d`` only by accident of the layout and grow the
        block to ``[n*D, n*D]``. Subclasses with an O(D) paired kernel
        override it.
        """
        lead = x.shape[:-2]
        flat = x.reshape(-1, *x.shape[-2:])
        rows = [torch.diagonal(self.loglike(xi)) for xi in flat]
        return torch.stack(rows).reshape(*lead, x.shape[-2])

    def predict_one(self, x):
        """One model curve ``ypred[nx]`` for the parameter vector
        ``x[ndim]`` (the JAX ``Problem.predict``), for best-fit plots;
        ``None`` for a problem without a model curve."""
        return None

    def loglike_sharded(self, x, model_axis_name=None):
        raise NotImplementedError(
            "the spectral-axis sharded likelihood is not ported yet "
            "(ROADMAP.md queue 1, item 15)")
