"""Counterpart of ``mxnet_tpu/gluon/nn/`` for the serving, training and
vision slices."""

from .activations import GELU, Activation
from .attention import MultiHeadAttention
from .basic_layers import (BatchNorm, Dense, Dropout, Embedding,
                           HybridSequential, LayerNorm)
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D

__all__ = ["Activation", "BatchNorm", "Conv2D", "Dense",
           "Dropout", "Embedding", "GELU", "GlobalAvgPool2D",
           "HybridSequential", "LayerNorm", "MaxPool2D",
           "MultiHeadAttention"]
