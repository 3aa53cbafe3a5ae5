"""Counterpart of ``mxnet_tpu/optimizer/`` for the training slice."""

from .optimizer import AdamW, Optimizer

__all__ = ["Optimizer", "AdamW"]
