"""
heybuddy_tpu_torch: the PyTorch / CUDA (NVIDIA H100) port of heybuddy_tpu.

This slice carries the serving path: ``predict`` (audio -> log-mel patches ->
frozen speech embedding -> wake-word head), with hand-written Hopper kernels
for the mel-patch and fused-embedding stages (``ops/kernels``). The package
imports torch, numpy and scipy, and never jax or the JAX package.
"""

from heybuddy_tpu_torch import device as _device  # noqa: F401  (TF32 settings)

__version__ = "0.1.0"
