"""ResNet v1 of the vision slice.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``:
``BasicBlockV1``, ``BottleneckV1``, ``ResNetV1``, ``get_resnet`` and the
``resnet*_v1`` constructors, channel-first (``layout="NCHW"``) or
channel-last (``"NHWC"``, the layout whose BatchNorms run kernels B7 and
B8). The module tree mirrors the JAX package's, so structural names equal
the keys of its ``save_parameters`` (``features.1.gamma``,
``features.4.0.body.3.weight``, ``features.4.0.downsample.0.weight``,
``output.weight``; running statistics as buffers of the same names) and
its files load with ``mxnet_tpu_torch.convert``. In ``BottleneckV1`` the
1x1 body convolutions carry a bias and the 3x3 one does not, as in the
JAX package. The JAX package infers input channels from the first batch;
here they are derived from the architecture (3 image channels at the
stem). Depths 18 and 50 only; the 34/101/152 depths, the thumbnail stem
and ResNet v2 are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ....base import MXNetError
from ....context import resolve_device
from ....initializer import xavier_
from ...nn import (Activation, BatchNorm, Conv2D, Dense, GlobalAvgPool2D,
                   HybridSequential, MaxPool2D)

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "get_resnet",
           "resnet18_v1", "resnet50_v1"]


def _bn_axis(layout):
    return -1 if layout[-1] == "C" else 1


def _conv3x3(channels, stride, in_channels, layout, device):
    return Conv2D(channels, 3, stride, 1, use_bias=False,
                  in_channels=in_channels, layout=layout, device=device)


class BasicBlockV1(nn.Module):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device="cuda"):
        super().__init__()
        ax = _bn_axis(layout)
        self.body = HybridSequential().add(
            _conv3x3(channels, stride, in_channels, layout, device),
            BatchNorm(channels, axis=ax, device=device),
            Activation("relu"),
            _conv3x3(channels, 1, channels, layout, device),
            BatchNorm(channels, axis=ax, device=device))
        self.downsample = HybridSequential().add(
            Conv2D(channels, 1, stride, use_bias=False,
                   in_channels=in_channels, layout=layout, device=device),
            BatchNorm(channels, axis=ax, device=device)) \
            if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(residual + self.body(x))


class BottleneckV1(nn.Module):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device="cuda"):
        super().__init__()
        ax = _bn_axis(layout)
        mid = channels // 4
        self.body = HybridSequential().add(
            Conv2D(mid, 1, stride, in_channels=in_channels, layout=layout,
                   device=device),
            BatchNorm(mid, axis=ax, device=device),
            Activation("relu"),
            _conv3x3(mid, 1, mid, layout, device),
            BatchNorm(mid, axis=ax, device=device),
            Activation("relu"),
            Conv2D(channels, 1, 1, in_channels=mid, layout=layout,
                   device=device),
            BatchNorm(channels, axis=ax, device=device))
        self.downsample = HybridSequential().add(
            Conv2D(channels, 1, stride, use_bias=False,
                   in_channels=in_channels, layout=layout, device=device),
            BatchNorm(channels, axis=ax, device=device)) \
            if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)


class ResNetV1(nn.Module):
    """ResNet v1: ``layers[i]`` blocks in stage i + 1 with ``channels[i +
    1]`` output channels, the stem at ``channels[0]``. Input (N, 3, H, W)
    or, with ``layout="NHWC"``, (N, H, W, 3); output (N, classes) logits.
    Parameters start as the layers leave them; ``initialize(seed)``
    draws Xavier weights."""

    def __init__(self, block, layers, channels, classes=1000,
                 layout="NCHW", device="cuda"):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV1 needs one more channel count than "
                             "stages")
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError(f"unsupported layout {layout!r}")
        dev = resolve_device(device)
        self._layout = layout
        ax = _bn_axis(layout)
        self.features = HybridSequential()
        self.features.add(
            Conv2D(channels[0], 7, 2, 3, use_bias=False, in_channels=3,
                   layout=layout, device=dev),
            BatchNorm(channels[0], axis=ax, device=dev),
            Activation("relu"),
            MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride, channels[i],
                layout, dev))
        self.features.add(GlobalAvgPool2D(layout=layout))
        self.output = Dense(classes, channels[-1], device=dev)

    @staticmethod
    def _make_layer(block, layers, channels, stride, in_channels, layout,
                    device):
        stage = HybridSequential().add(
            block(channels, stride, channels != in_channels,
                  in_channels=in_channels, layout=layout, device=device))
        for _ in range(layers - 1):
            stage.add(block(channels, 1, False, in_channels=channels,
                            layout=layout, device=device))
        return stage

    def initialize(self, seed=0):
        """Seeded Xavier init (``initializer.xavier_``); running means
        stay 0 and running variances 1."""
        return xavier_(self, seed)

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
}
_BLOCKS = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}


def get_resnet(version, num_layers, **kwargs):
    """ResNet ``version`` (1 only) of depth ``num_layers``; ``kwargs``
    reach ``ResNetV1`` (``classes``, ``layout``, ``device``)."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"invalid resnet depth {num_layers}; options "
                         f"{sorted(resnet_spec)}")
    if version != 1:
        raise MXNetError("ResNet v2 is not ported yet; use version 1")
    block_type, layers, channels = resnet_spec[num_layers]
    return ResNetV1(_BLOCKS[block_type], layers, channels, **kwargs)


def _make(layers):
    def f(**kwargs):
        return get_resnet(1, layers, **kwargs)

    f.__name__ = f"resnet{layers}_v1"
    f.__doc__ = f"ResNet-{layers} v1 (``get_resnet(1, {layers}, ...)``)."
    return f


resnet18_v1 = _make(18)
resnet50_v1 = _make(50)
