"""Activation blocks of the training and vision slices.

Counterpart of ``mxnet_tpu/gluon/nn/activations.py``: ``Activation``
(:11-25) for ``relu`` and ``tanh``, and ``GELU`` (:74-76), the exact erf
form (``LeakyReLU(act_type="gelu")``).
"""

from __future__ import annotations

from torch import nn

from ...base import MXNetError
from ...ops import nn as _ops

__all__ = ["Activation", "GELU"]


class Activation(nn.Module):
    """Applies ``activation`` (``"relu"`` or ``"tanh"``)."""

    _ACTS = {"relu": _ops.relu, "tanh": _ops.tanh}

    def __init__(self, activation):
        super().__init__()
        if activation not in self._ACTS:
            raise MXNetError(f"activation {activation!r} is not ported; use "
                             "'relu' or 'tanh'")
        self._act = activation

    def forward(self, x):
        return self._ACTS[self._act](x)


class GELU(nn.Module):
    def forward(self, x):
        return _ops.gelu(x)
