"""Problem definition layer.

Counterpart of ``massivedatans_tpu/models/base.py``: a problem is a prior
transform plus a log-likelihood that scores a *batch* of parameter vectors
against every dataset at once, returning ``L[B, D]``. Here a problem is an
``nn.Module`` whose data are buffers, so ``problem.to(device)`` moves them,
and both methods are written batch-first (no vmap).

Under a device mesh (``parallel/sharded.py``) each rank holds
``problem.shard(...)``: its block of datasets and, where the model
declares a spectral layout, its slice of the spectral axis. Each model
declares its own layout (the counterpart of the JAX package's
``problem_pspecs`` and ``MODEL_PSPEC_REGISTRY``).
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
    model curve). ``shard`` and ``loglike_sharded`` serve the device mesh:
    a subclass without ``shard`` cannot run on one, and one without its
    own ``loglike_sharded`` cannot shard the spectral axis.
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

    def shard(self, rank_data: int, n_data: int, rank_model: int = 0,
              n_model: int = 1) -> "Problem":
        """This rank's part of the problem on a mesh of ``n_data`` x
        ``n_model`` ranks: datasets in the contiguous block
        ``parallel.sharded.dataset_block(ndata, rank_data, n_data)`` and,
        for ``n_model`` > 1, the spectral slice ``model_block``."""
        raise ValueError(f"{type(self).__name__} declares no sharded layout "
                         "(Problem.shard)")

    def require_no_model_axis(self, n_model: int) -> None:
        """Raise for a model axis, in ``shard`` of a model without a
        spectral layout (``problem_pspecs``, sharded.py:120-124)."""
        if n_model > 1:
            raise ValueError(f"mesh has a model axis but {type(self).__name__} "
                             "has no model-parallel layout")

    def loglike_sharded(self, x, model_group=None):
        """``L[B, D]`` of this rank's datasets. Under a (data, model) mesh
        ``model_group`` is the model axis and the spectral contraction is
        reduced over it; with ``None`` this is ``loglike``."""
        if model_group is None:
            return self.loglike(x)
        raise ValueError(f"{type(self).__name__} has no model-parallel "
                         "likelihood")
