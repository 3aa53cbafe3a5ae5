"""Seeded parameter initialisation of the port's models.

Counterpart of ``mxnet_tpu/initializer.py``'s ``Xavier()`` (uniform,
factor ``avg``, magnitude 3). The numbers come from a CPU
``torch.Generator``, so one seed gives the same weights on any device
(they are not the JAX package's numbers: carry those through
``mxnet_tpu_torch.convert``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["xavier_", "xavier_bound"]


def xavier_bound(shape, magnitude=3.0):
    """Half-width of the uniform Xavier draw for a weight of ``shape``
    (``mxnet_tpu/initializer.py:246-250``): both fans are multiplied by
    the receptive field ``prod(shape[2:])`` of a convolution weight."""
    hw = math.prod(shape[2:])
    fan_in, fan_out = shape[1] * hw, shape[0] * hw
    return math.sqrt(magnitude / ((fan_in + fan_out) / 2.0))


@torch.no_grad()
def xavier_(module, seed=0):
    """Fill ``module``'s parameters in place: Xavier on every weight
    (matrices and convolution kernels), LayerNorm and BatchNorm gamma
    one, biases and beta zero. Buffers (BatchNorm's running statistics)
    keep their construction values. Returns ``module``."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "gamma":
            p.fill_(1.0)
        elif leaf in ("bias", "beta"):
            p.zero_()
        else:
            scale = xavier_bound(p.shape)
            w = torch.rand(p.shape, generator=gen) * (2 * scale) - scale
            p.copy_(w)
    return module
