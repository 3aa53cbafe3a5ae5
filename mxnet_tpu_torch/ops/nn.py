"""Neural-network operators of the serving and training slices.

Counterpart of ``mxnet_tpu/ops/nn.py`` (``layer_norm``,
``fully_connected``, ``Activation``, ``Dropout``, ``log_softmax``) and
the ``Embedding`` and ``pick`` ops of ``mxnet_tpu/ops/tensor.py``. Dense
products stay ``F.linear``, as the JAX package leaves them to XLA;
LayerNorm routes to kernels K1 (forward) and B2 (backward) by the JAX
package's rule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import random as _random
from .kernels import layer_norm as _kln

__all__ = ["layer_norm", "fully_connected", "embedding", "relu", "tanh",
           "gelu", "dropout", "log_softmax", "pick"]


class _LayerNormFn(torch.autograd.Function):
    """K1 forward, B2 backward over a (rows, C) view (the JAX package's
    ``layer_norm_fused`` custom_vjp, ``pallas/layer_norm.py:149-167``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        out, mean, rstd = _kln.layer_norm_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dg, db = _kln.layer_norm_bwd(x, gamma, mean, rstd,
                                         dy.contiguous())
        return dx, dg.to(gamma.dtype), db.to(gamma.dtype), None


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """LayerNorm (``mxnet_tpu/ops/nn.py:478``). Last-axis norms with
    lane-aligned channels and gamma in the activation dtype go through
    kernel K1, differentiated by kernel B2 (``:487-488``); everything else
    takes the f32-statistics composition (``:499-511``), output in the
    activation dtype, differentiated by torch autograd."""
    if not output_mean_var and _kln.supports(data, axis) \
            and gamma.dtype == data.dtype:
        C = data.shape[-1]
        out = _LayerNormFn.apply(data.reshape(-1, C).contiguous(), gamma,
                                 beta, float(eps))
        return out.reshape(data.shape)
    xf = data.float()
    mean = xf.mean(dim=axis, keepdim=True)
    var = xf.var(dim=axis, unbiased=False, keepdim=True)
    inv = torch.rsqrt(var + eps)
    shape = [1] * data.ndim
    shape[axis] = data.shape[axis]
    out = (xf - mean) * inv * gamma.float().reshape(shape) \
        + beta.float().reshape(shape)
    out = out.to(data.dtype)
    if output_mean_var:
        return (out, mean.squeeze(axis).to(data.dtype),
                var.squeeze(axis).to(data.dtype))
    return out


def fully_connected(data, weight, bias=None):
    """``data @ weight.T + bias`` over the last axis, weight (num_hidden,
    in_units): ``mxnet_tpu/ops/nn.py:161`` with ``flatten=False``."""
    return F.linear(data, weight, bias)


def embedding(ids, weight):
    """Row gather of ``weight`` (input_dim, output_dim) by integer ids."""
    return F.embedding(ids.long(), weight)


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def gelu(x):
    """Exact (erf) GELU: ``Activation(act_type="gelu")``
    (``mxnet_tpu/ops/nn.py:151``)."""
    return F.gelu(x, approximate="none")


def dropout(data, p, training=True):
    """Inverted dropout (``mxnet_tpu/ops/nn.py:556``): keep each element
    with probability ``1 - p`` and scale it by ``1 / (1 - p)``; the
    identity when not training or ``p <= 0``. The mask comes from the
    port's generator for the tensor's device (``mxnet_tpu_torch.random``),
    so a seed fixes it."""
    if not training or p <= 0.0:
        return data
    keep = 1.0 - p
    mask = torch.empty_like(data).bernoulli_(
        keep, generator=_random.generator(data.device))
    return torch.where(mask != 0, data / keep, 0.0)


def log_softmax(data, axis=-1):
    """``log_softmax`` (``mxnet_tpu/ops/nn.py:61``)."""
    return torch.log_softmax(data, dim=axis)


def pick(data, index, axis=-1, keepdims=False):
    """Element of ``data`` at integer ``index`` along ``axis``
    (``pick``, ``mxnet_tpu/ops/tensor.py:416``): the sparse-label gather
    of a cross-entropy."""
    idx = index.long().unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)
