"""massivedatans_tpu_torch — collaborative nested sampling on PyTorch/CUDA.

The PyTorch port of ``massivedatans_tpu``: one joint nested-sampling run
over many datasets, where every model evaluation is scored against all
datasets at once. Plain tensor code is PyTorch; the two region kernels that
the JAX package wrote in Pallas for the TPU are hand-written CUDA kernels for
Hopper (``csrc/neighbors.cu``). The JAX package stays the reference: this
package imports nothing of it, and nothing of JAX. It keeps its own copies
of the numpy code it needs (config, data generators, HDF5 schema,
progress, subset decomposition with its native union-find, FITS and ds9
readers, MUSE cube loading and fixtures).
"""

__version__ = "0.1.0"
