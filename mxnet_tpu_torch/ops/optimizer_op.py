"""Optimizer update ops of the training and vision slices.

Counterpart of ``mxnet_tpu/ops/optimizer_op.py``: ``sgd_update`` (:30),
``sgd_mom_update`` (:38) and ``adamw_update`` (:69-79). Elementwise work
that the JAX package leaves to XLA, so plain PyTorch here. Pure: each
returns new tensors, and the caller writes them back.
"""

from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adamw_update"]


def _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient):
    """``rescale_grad * grad``, clipped to ``clip_gradient`` when that is
    >= 0, plus ``wd * weight`` (``optimizer_op.py:22-26``)."""
    g = grad * rescale_grad
    if clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """Plain SGD: ``weight - lr * g``. Returns the new weight."""
    g = _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient)
    return weight - lr * g


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """SGD with momentum: ``mom = momentum * mom - lr * g``, ``weight +=
    mom``. Returns ``(new_weight, new_mom)``."""
    g = _apply_wd_rescale(weight, grad, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


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
