"""Optimizer update ops of the training slice.

Counterpart of ``mxnet_tpu/ops/optimizer_op.py``: ``adamw_update``
(:69-79). Elementwise work that the JAX package leaves to XLA, so plain
PyTorch here. Pure: it returns new tensors, and the caller writes them
back.
"""

from __future__ import annotations

import torch

__all__ = ["adamw_update"]


def adamw_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """Adam with decoupled weight decay (Loshchilov & Hutter): ``wd`` is
    not in the moments. Returns ``(new_weight, new_mean, new_var)``."""
    g = grad * rescale_grad
    if clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    update = new_mean / (torch.sqrt(new_var) + epsilon) + wd * weight
    return weight - eta * lr * update, new_mean, new_var
