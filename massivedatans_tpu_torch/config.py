"""Run configuration and numeric precision.

``RunConfig`` is the JAX package's own (``massivedatans_tpu/config.py``, a
numpy-free, JAX-free dataclass), re-exported so both packages read one
definition. It is frozen, so the device is an argument of the entry points
and never a config field.
"""

from __future__ import annotations

import torch

from massivedatans_tpu.config import RunConfig  # noqa: F401


def set_fp32_precision() -> None:
    """Full float32 matmuls and convolutions, no TF32, and assert it.

    The chi^2 likelihood needs >= 11 mantissa bits on its matmul inputs
    (massivedatans_tpu/models/gaussline.py:15-23); TF32 keeps 10.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
