"""Counterpart of ``mxnet_tpu/gluon/nn/`` for the serving and training
slices."""

from .activations import GELU
from .attention import MultiHeadAttention
from .basic_layers import Dense, Dropout, Embedding, LayerNorm

__all__ = ["Dense", "Dropout", "Embedding", "GELU", "LayerNorm",
           "MultiHeadAttention"]
