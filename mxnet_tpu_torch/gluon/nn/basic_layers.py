"""Basic layers of the serving and training slices as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``: ``Dense``,
``Embedding``, ``LayerNorm`` and ``Dropout``. Parameter names (``weight``,
``bias``, ``gamma``, ``beta``) and layouts (Dense weight ``(units,
in_units)``) match the JAX package one to one, so its saved parameters
load by name (``mxnet_tpu_torch.convert``). Parameters start at zero
(LayerNorm gamma at one); a model fills them from a seed or a file.
"""

from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops import nn as _ops

__all__ = ["Dense", "Embedding", "LayerNorm", "Dropout"]


def _zeros(shape, dtype, device):
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


class Dense(nn.Module):
    """Fully-connected layer over the last axis: ``out = act(x @ W.T +
    b)``, W (units, in_units) -- the JAX package's ``flatten=False`` form,
    the only one the port's models use. ``activation`` is None, ``"relu"``
    or ``"tanh"`` (the BERT pooler)."""

    _ACTS = {"relu": _ops.relu, "tanh": _ops.tanh}

    def __init__(self, units, in_units, activation=None, use_bias=True,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        if activation is not None and activation not in self._ACTS:
            raise MXNetError(f"Dense activation {activation!r} is not "
                             "ported; use None, 'relu' or 'tanh'")
        dev = resolve_device(device)
        self._act = activation
        self.weight = _zeros((units, in_units), dtype, dev)
        self.bias = _zeros((units,), dtype, dev) if use_bias else None

    def forward(self, x):
        out = _ops.fully_connected(x, self.weight, self.bias)
        return out if self._act is None else self._ACTS[self._act](out)


class Embedding(nn.Module):
    """Index -> dense vector lookup; weight (input_dim, output_dim)."""

    def __init__(self, input_dim, output_dim, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.weight = _zeros((input_dim, output_dim), dtype,
                             resolve_device(device))

    def forward(self, ids):
        return _ops.embedding(ids, self.weight)


class LayerNorm(nn.Module):
    """Layer normalization over ``axis`` (reference:
    ``src/operator/nn/layer_norm.cc``)."""

    def __init__(self, in_channels, axis=-1, epsilon=1e-5,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones((in_channels,), dtype=dtype,
                                             device=dev))
        self.beta = _zeros((in_channels,), dtype, dev)

    def forward(self, x):
        return _ops.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                               eps=self._epsilon)


class Dropout(nn.Module):
    """Dropout with rate ``rate`` in training mode, its mask drawn from the
    port's seeded generator (``ops.nn.dropout``); the identity in eval
    mode."""

    def __init__(self, rate):
        super().__init__()
        self._rate = float(rate)

    def forward(self, x):
        return _ops.dropout(x, self._rate, training=self.training)
