"""Operators of the port: plain functions on tensors.

Counterpart of ``mxnet_tpu/ops/`` for the serving and training slices:
``nn`` (layer_norm, fully_connected, embedding, activations, dropout,
log_softmax, pick), ``contrib`` (flash_attention), ``optimizer_op``
(adamw_update) and the hand-written kernels under ``kernels``.
"""

from . import contrib, kernels, nn, optimizer_op

__all__ = ["nn", "contrib", "optimizer_op", "kernels"]
