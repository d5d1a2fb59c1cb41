"""
heybuddy_tpu_torch: the PyTorch / CUDA (NVIDIA H100) port of heybuddy_tpu.

The port carries featurization in every formulation of the JAX package
(audio -> log-mel -> frozen speech embedding), the wake-word head with
``predict``, and ``extract`` (labelled negative-feature shards), with
hand-written Hopper kernels for every Pallas kernel of the JAX package
(``ops/kernels``). The package imports torch, numpy and scipy, and never jax
or the JAX package.
"""

from heybuddy_tpu_torch import device as _device  # noqa: F401  (TF32 settings)

__version__ = "0.1.0"
