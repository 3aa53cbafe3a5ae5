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

__all__ = ["xavier_"]


@torch.no_grad()
def xavier_(module, seed=0):
    """Fill ``module``'s parameters in place: Xavier on every matrix,
    LayerNorm gamma one, biases and beta zero. Returns ``module``."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "gamma":
            p.fill_(1.0)
        elif leaf in ("bias", "beta"):
            p.zero_()
        else:
            fan_out, fan_in = p.shape[0], p.shape[1]
            scale = math.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
            w = torch.rand(p.shape, generator=gen) * (2 * scale) - scale
            p.copy_(w)
    return module
