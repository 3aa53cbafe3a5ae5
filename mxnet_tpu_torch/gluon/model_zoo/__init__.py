"""Counterpart of ``mxnet_tpu/gluon/model_zoo/`` for the serving,
training and vision slices."""

from . import vision
from .bert import BERTModel, PretrainLoss, bert_base
from .transformer import TransformerModel, transformer_base

__all__ = ["BERTModel", "PretrainLoss", "bert_base", "TransformerModel",
           "transformer_base", "vision"]
