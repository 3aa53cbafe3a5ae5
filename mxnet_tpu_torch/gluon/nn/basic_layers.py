"""Basic layers of the serving, training and vision slices as
``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``: ``Dense``,
``Embedding``, ``LayerNorm``, ``BatchNorm``, ``Dropout`` and
``HybridSequential``. Parameter names (``weight``, ``bias``, ``gamma``,
``beta``, ``running_mean``, ``running_var``) and layouts (Dense weight
``(units, in_units)``) match the JAX package one to one, so its saved
parameters load by name (``mxnet_tpu_torch.convert``). Parameters start
at zero (LayerNorm and BatchNorm gamma at one); a model fills them from
a seed or a file. BatchNorm's running statistics are buffers, not
parameters: nothing trains them (the JAX package's ``grad_req="null"``).
"""

from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops import nn as _ops

__all__ = ["Dense", "Embedding", "LayerNorm", "BatchNorm", "Dropout",
           "HybridSequential"]


def _zeros(shape, dtype, device):
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


class Dense(nn.Module):
    """Fully-connected layer: ``out = act(x @ W.T + b)``, W (units,
    in_units). With ``flatten`` (the default, as in the JAX package) the
    axes after the first are flattened into ``in_units``; with
    ``flatten=False`` the product runs over the last axis. ``activation``
    is None, ``"relu"`` or ``"tanh"`` (the BERT pooler)."""

    _ACTS = {"relu": _ops.relu, "tanh": _ops.tanh}

    def __init__(self, units, in_units, activation=None, use_bias=True,
                 flatten=True, dtype=torch.float32, device="cuda"):
        super().__init__()
        if activation is not None and activation not in self._ACTS:
            raise MXNetError(f"Dense activation {activation!r} is not "
                             "ported; use None, 'relu' or 'tanh'")
        dev = resolve_device(device)
        self._act = activation
        self._flatten = flatten
        self.weight = _zeros((units, in_units), dtype, dev)
        self.bias = _zeros((units,), dtype, dev) if use_bias else None

    def forward(self, x):
        out = _ops.fully_connected(x, self.weight, self.bias,
                                   flatten=self._flatten)
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


class BatchNorm(nn.Module):
    """Batch normalization over ``axis`` with moving-average statistics
    (``mxnet_tpu/gluon/nn/basic_layers.py:270-338``). In training mode
    (and without ``use_global_stats``) the batch statistics normalise and
    the running ones move in place to ``momentum * running + (1 -
    momentum) * batch``, the batch variance being the population variance
    the op returns (not ``F.batch_norm``'s unbiased one); the update is
    computed in f32 and rounded once to the buffers' dtype. ``scale=False``
    fixes gamma at one and ``center=False`` freezes beta: neither then
    takes a gradient."""

    def __init__(self, in_channels, axis=1, momentum=0.9, epsilon=1e-5,
                 center=True, scale=True, use_global_stats=False,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = nn.Parameter(torch.ones((in_channels,), device=dev),
                                  requires_grad=scale)
        self.beta = nn.Parameter(torch.zeros((in_channels,), device=dev),
                                 requires_grad=center)
        self.register_buffer("running_mean",
                             torch.zeros((in_channels,), device=dev))
        self.register_buffer("running_var",
                             torch.ones((in_channels,), device=dev))

    def forward(self, x):
        training = self.training and not self._use_global_stats
        rm, rv = self.running_mean, self.running_var
        out, mean, var = _ops.batch_norm(
            x, self.gamma, self.beta, rm, rv, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=training)
        if training:
            m = self._momentum
            with torch.no_grad():
                rm.copy_(m * rm.float() + (1 - m) * mean.float())
                rv.copy_(m * rv.float() + (1 - m) * var.float())
        return out


class HybridSequential(nn.Sequential):
    """Children run in order, named by their index (``features.0``,
    ``features.1``, ...), as the JAX package's ``HybridSequential``
    names them in saved parameters."""

    def add(self, *blocks):
        for b in blocks:
            self.append(b)
        return self


class Dropout(nn.Module):
    """Dropout with rate ``rate`` in training mode, its mask drawn from the
    port's seeded generator (``ops.nn.dropout``); the identity in eval
    mode."""

    def __init__(self, rate):
        super().__init__()
        self._rate = float(rate)

    def forward(self, x):
        return _ops.dropout(x, self._rate, training=self.training)
