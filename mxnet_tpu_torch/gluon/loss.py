"""Loss blocks of the training slice.

Counterpart of ``mxnet_tpu/gluon/loss.py``: ``SoftmaxCrossEntropyLoss``
(:129-140) with a sparse (integer) label, the form the BERT pretraining
loss uses.
"""

from __future__ import annotations

from torch import nn

from ..ops import nn as _ops

__all__ = ["SoftmaxCrossEntropyLoss"]


class SoftmaxCrossEntropyLoss(nn.Module):
    """``-log_softmax(pred)[label]`` along ``axis``, then the mean over
    every axis but ``batch_axis``: one loss per sample, in ``pred``'s
    dtype. ``from_logits=True`` takes ``pred`` as log-probabilities."""

    def __init__(self, axis=-1, from_logits=False, batch_axis=0):
        super().__init__()
        self._axis = axis
        self._from_logits = from_logits
        self._batch_axis = batch_axis

    def forward(self, pred, label):
        if not self._from_logits:
            pred = _ops.log_softmax(pred, axis=self._axis)
        loss = -_ops.pick(pred, label, axis=self._axis, keepdims=True)
        axes = tuple(i for i in range(loss.ndim) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss
