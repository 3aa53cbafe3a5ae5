"""Convolution and pooling layers of the vision slice.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: ``Conv2D``,
``MaxPool2D`` and ``GlobalAvgPool2D``, channel-first
(``"NCHW"``, the default) or channel-last (``"NHWC"``). The weight is
``(channels, in_channels / groups, kh, kw)`` in both layouts, as in the
JAX package, so saved parameters load by name and serve either layout.
The JAX package infers ``in_channels`` from the first input; the port
has no deferred initialisation, so it is given at construction.
"""

from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops import nn as _ops

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]

_LAYOUTS = ("NCHW", "NHWC")


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),) * 2


def _check_layout(layout):
    if layout not in _LAYOUTS:
        raise MXNetError(f"unsupported layout {layout!r}; use 'NCHW' or "
                         "'NHWC'")


class Conv2D(nn.Module):
    """2-d convolution with an optional bias (on by default, as in the
    JAX package)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", use_bias=True,
                 in_channels=0, dtype=torch.float32, device="cuda"):
        super().__init__()
        _check_layout(layout)
        if in_channels < 1:
            raise MXNetError("Conv2D needs in_channels: the port has no "
                             "deferred shape inference")
        dev = resolve_device(device)
        self._kwargs = dict(stride=_pair(strides), pad=_pair(padding),
                            dilate=_pair(dilation), num_group=groups,
                            layout=layout)
        self.weight = nn.Parameter(torch.zeros(
            (channels, in_channels // groups) + _pair(kernel_size),
            dtype=dtype, device=dev))
        self.bias = nn.Parameter(torch.zeros((channels,), dtype=dtype,
                                             device=dev)) \
            if use_bias else None

    def forward(self, x):
        return _ops.convolution(x, self.weight, self.bias, **self._kwargs)


class _Pooling(nn.Module):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout):
        super().__init__()
        _check_layout(layout)
        self._kwargs = dict(
            kernel=_pair(pool_size),
            stride=_pair(strides if strides is not None else pool_size),
            pad=_pair(padding), global_pool=global_pool,
            pool_type=pool_type,
            pooling_convention="full" if ceil_mode else "valid",
            layout=layout)

    def forward(self, x):
        return _ops.pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", layout)
