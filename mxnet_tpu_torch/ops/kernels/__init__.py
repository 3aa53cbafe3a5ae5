"""Hand-written Hopper kernels of the port, one wrapper module each.

Counterpart of ``mxnet_tpu/ops/pallas/``. Every wrapper launches its CUDA
kernel for CUDA tensors, runs its plain PyTorch version for CPU tensors,
and raises for anything else; none falls back from a CUDA tensor. The
sources are ``mxnet_tpu_torch/csrc/*.cu``, built at first launch by
``_build``.
"""

from . import batch_norm, flash_attention, layer_norm, paged_attention

__all__ = ["layer_norm", "flash_attention", "paged_attention",
           "batch_norm"]
