"""Counterpart of ``mxnet_tpu/parallel/`` for the serving and training
slices."""

from .infer import InferStep
from .step import TrainStep

__all__ = ["InferStep", "TrainStep"]
