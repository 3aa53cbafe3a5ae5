"""PyTorch/CUDA port of ``mxnet_tpu``: four paths, each end to end on an
H100 — the Transformer served through ``ContinuousBatcher``, the same
server replaying forced target histories (``submit(prefix_ids=...)``,
``suffix_wide``), the BERT pretraining step and the ResNet-50 v1 training
step.

The package mirrors the JAX package's module paths so each counterpart is
easy to find (``gluon/model_zoo/transformer.py`` ports
``mxnet_tpu/gluon/model_zoo/transformer.py`` and so on). It imports
``torch`` and never ``jax`` or ``mxnet_tpu``. The Pallas kernels these
paths run (LayerNorm forward and backward, flash-attention forward and
its two backward kernels, paged decode and paged window attention, the
BatchNorm statistics and backward reductions) are hand-written CUDA
kernels for Hopper under ``csrc/``, built with ``nvcc`` at first launch
(``ops/kernels/_build.py``).

Entry points (``InferStep``, ``ContinuousBatcher``, ``TrainStep``, model
constructors) run on ``device="cuda"`` unless the caller passes
``device="cpu"``; a CUDA request without a card raises ``MXNetError``.
"""

from .base import MXNetError
from .context import resolve_device

__all__ = ["MXNetError", "resolve_device"]
