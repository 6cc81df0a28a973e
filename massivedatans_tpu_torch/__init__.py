"""massivedatans_tpu_torch — collaborative nested sampling on PyTorch/CUDA.

The PyTorch port of ``massivedatans_tpu``: one joint nested-sampling run
over many datasets, where every model evaluation is scored against all
datasets at once. Plain tensor code is PyTorch; the two region kernels that
the JAX package wrote in Pallas for the TPU are hand-written CUDA kernels for
Hopper (``csrc/neighbors.cu``). The JAX package stays the reference: this
package imports none of its JAX modules, only its numpy-only ones (config,
data generators, HDF5 schema, progress, subset decomposition).
"""

__version__ = "0.1.0"
