"""Counterpart of ``mxnet_tpu/optimizer/`` for the training and vision
slices."""

from .optimizer import SGD, AdamW, Optimizer

__all__ = ["Optimizer", "SGD", "AdamW"]
