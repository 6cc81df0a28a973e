"""Gradient-based per-dataset backends: batched HMC and mean-field VI.

Counterpart of ``massivedatans_tpu/infer/``: D independent chains, or D
variational fits, advance together, each step one forward and one
backward pass through the prior transform and the paired likelihood of
all D datasets. Used to refine nested-sampling posteriors and to cross-check
their evidences with an independent estimator (``cli.run_refine``).
"""

from massivedatans_tpu_torch.infer.hmc import HMCResult, run_hmc  # noqa: F401
from massivedatans_tpu_torch.infer.vi import VIResult, run_vi      # noqa: F401
