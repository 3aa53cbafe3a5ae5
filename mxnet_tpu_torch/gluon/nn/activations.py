"""Activation blocks of the training slice.

Counterpart of ``mxnet_tpu/gluon/nn/activations.py``: ``GELU`` (:74-76),
the exact erf form (``LeakyReLU(act_type="gelu")``).
"""

from __future__ import annotations

from torch import nn

from ...ops import nn as _ops

__all__ = ["GELU"]


class GELU(nn.Module):
    def forward(self, x):
        return _ops.gelu(x)
