"""Neural-network operators of the serving, training and vision slices.

Counterpart of ``mxnet_tpu/ops/nn.py`` (``layer_norm``, ``batch_norm``,
``fully_connected``, ``convolution``, ``pooling``, ``Activation``,
``Dropout``, ``log_softmax``) and the ``Embedding`` and ``pick`` ops of
``mxnet_tpu/ops/tensor.py``. Dense products stay ``F.linear`` and
convolutions ``F.conv*d``, as the JAX package leaves both to XLA outside
any Pallas kernel; LayerNorm routes to kernels K1 (forward) and B2
(backward), channel-last BatchNorm to kernels B7 (statistics) and B8
(backward reductions).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from .kernels import batch_norm as _kbn
from .kernels import layer_norm as _kln

__all__ = ["layer_norm", "batch_norm", "fully_connected", "convolution",
           "pooling", "embedding", "relu", "tanh", "gelu", "dropout",
           "log_softmax", "pick"]


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


def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight.T + bias``, weight (num_hidden, in_units)
    (``mxnet_tpu/ops/nn.py:161``): with ``flatten`` the axes after the
    first are flattened into one, else the product runs over the last
    axis."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, bias)


def _tuplify(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),) * 2


# axis orders that view a channel-last (N, H, W, C) tensor as (N, C, H, W)
# and back
_TO_CF, _TO_CL = (0, 3, 1, 2), (0, 2, 3, 1)


def _check_2d(name, data):
    if data.ndim != 4:
        raise MXNetError(f"{name}: only 2-d (4-dimensional) inputs are "
                         f"ported, got shape {tuple(data.shape)}")


def convolution(data, weight, bias=None, stride=None, dilate=None, pad=None,
                num_group=1, layout=None):
    """2-d convolution (``mxnet_tpu/ops/nn.py:177-216``), weight (O, I/g,
    kh, kw) in both layouts. ``layout`` ending in ``C`` takes and returns
    channel-last tensors: the permuted view of a contiguous channel-last
    tensor is already ``channels_last``-strided, cuDNN returns the same
    format, so neither side copies (asserted on the card). The kernel
    size is the weight's."""
    _check_2d("convolution", data)
    stride = _tuplify(stride if stride is not None else 1)
    dilate = _tuplify(dilate if dilate is not None else 1)
    pad = _tuplify(pad if pad is not None else 0)
    if not (bool(layout) and layout[-1] == "C"):
        return F.conv2d(data, weight, bias, stride, pad, dilate, num_group)
    out = F.conv2d(data.permute(_TO_CF), weight, bias, stride, pad, dilate,
                   num_group).permute(_TO_CL)
    if not out.is_contiguous():
        if out.device.type == "cuda":
            raise MXNetError("convolution: the channel-last output is not "
                             "contiguous (a layout copy would follow)")
        out = out.contiguous()
    return out


def pooling(data, kernel=None, pool_type="max", global_pool=False,
            pooling_convention="valid", stride=None, pad=None,
            count_include_pad=True, layout=None):
    """2-d max or average pooling (``mxnet_tpu/ops/nn.py:259-317``).
    ``layout`` ending in ``C`` selects channel-last. ``"full"`` (ceil)
    convention pads the high side until the last window fits, as the JAX
    package does: every window of the JAX formula is kept, and an average
    with ``count_include_pad`` divides by the kernel's size."""
    _check_2d("pooling", data)
    channel_last = bool(layout) and layout[-1] == "C"
    sp0 = 1 if channel_last else 2
    if pool_type not in ("max", "avg"):
        raise MXNetError(f"pool_type {pool_type!r} is not ported; use "
                         "'max' or 'avg'")
    if global_pool:
        axes = (sp0, sp0 + 1)
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    kernel = _tuplify(kernel)
    stride = _tuplify(stride if stride is not None else 1)
    pad = _tuplify(pad if pad is not None else 0)
    extra = [0, 0]
    if pooling_convention == "full":
        for i in range(2):
            rem = (data.shape[sp0 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            extra[i] = stride[i] - rem if rem else 0
    x = data.permute(_TO_CF) if channel_last else data
    # torch pads at most half a window on each side, symmetrically; any
    # other padding is made explicit (-inf for max, 0 for avg)
    implicit = pool_type == "max" and not any(extra) and all(
        p <= k // 2 for p, k in zip(pad, kernel))
    if implicit:
        out = F.max_pool2d(x, kernel, stride, pad)
    else:
        pads = []
        for p, e in zip(reversed(pad), reversed(extra)):
            pads += [p, p + e]
        fill = -math.inf if pool_type == "max" else 0.0
        xp = F.pad(x, pads, value=fill) if any(pads) else x
        if pool_type == "max":
            out = F.max_pool2d(xp, kernel, stride)
        else:
            size = math.prod(kernel)
            summed = F.avg_pool2d(xp, kernel, stride) * size
            if count_include_pad:
                out = summed / size
            else:
                ones = F.pad(torch.ones_like(x), pads, value=0.0)
                out = summed / (F.avg_pool2d(ones, kernel, stride) * size)
    if channel_last:
        out = out.permute(_TO_CL).contiguous()
    return out.to(data.dtype)


# ---------------------------------------------------------- batch norm
def _bn_bshape(data, axis):
    shape = [1] * data.ndim
    shape[axis] = data.shape[axis]
    return shape


def _bn_stats_shifted(data, axis):
    """Channel-first (or any non-last axis) statistics: the torch
    counterpart of the JAX package's shifted one-pass form
    (``mxnet_tpu/ops/nn.py:357-378``), f32 sums of ``x - s`` and its
    square with ``s`` the channel's element at index 0 of every other
    axis. Not a kernel's plain version: the kernels take channel-last
    views only."""
    red = tuple(i for i in range(data.ndim) if i != axis)
    n = math.prod(data.shape[i] for i in red)
    idx = tuple(slice(None) if i == axis else 0 for i in range(data.ndim))
    s = data[idx].detach().float()
    xs = data.float() - s.reshape(_bn_bshape(data, axis))
    s1 = xs.sum(dim=red)
    s2 = (xs * xs).sum(dim=red)
    return s + s1 / n, s2 / n - (s1 / n) ** 2


def _bn_apply(data, mean, var, gamma, beta, eps, bshape):
    """Normalise as one multiply-add in the activation dtype
    (``mxnet_tpu/ops/nn.py:388-397``): per-channel scale and shift in f32,
    cast once. Returns ``(out, inv)``."""
    inv = torch.rsqrt(var + eps)
    scale = inv * gamma.float()
    shift = beta.float() - mean * scale
    out = torch.addcmul(shift.to(data.dtype).reshape(bshape), data,
                        scale.to(data.dtype).reshape(bshape))
    return out, inv


class _BatchNormFn(torch.autograd.Function):
    """Training BatchNorm (the JAX package's ``_bn_train`` custom_vjp,
    ``mxnet_tpu/ops/nn.py:331-446``): ``(out, batch mean, batch var)``,
    the statistics f32 and not differentiable. A channel-last tensor goes
    to kernel B7 for the statistics and B8 for the backward reductions
    every time, where the JAX package sends it to its Pallas kernels only
    under ``MXTPU_FUSED_BN=pallas``: on the TPU, XLA fuses the jnp shifted
    form into one pass just as well (``:348-350``), while eager PyTorch
    has no such fusion, so here the kernels are its counterpart. Other
    axes take ``_bn_stats_shifted`` and torch sums."""

    @staticmethod
    def forward(ctx, data, gamma, beta, eps, axis):
        bshape = _bn_bshape(data, axis)
        fused = _kbn.supports(data, axis)
        if fused:
            C = data.shape[-1]
            data = data.contiguous()
            mean, var = _kbn.bn_stats(data.reshape(-1, C))
        else:
            mean, var = _bn_stats_shifted(data, axis)
        out, inv = _bn_apply(data, mean, var, gamma, beta, eps, bshape)
        ctx.save_for_backward(data, gamma, mean, inv)
        ctx.axis, ctx.fused, ctx.beta_dtype = axis, fused, beta.dtype
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        """The closed form of ``_bn_train_bwd_rule`` (``:406-446``): dx in
        f32, cast to the activation dtype; dgamma and dbeta in the
        parameters' dtypes. The statistics' cotangents are ignored."""
        data, gamma, mean, inv = ctx.saved_tensors
        axis = ctx.axis
        bshape = _bn_bshape(data, axis)
        red = tuple(i for i in range(data.ndim) if i != axis)
        n = math.prod(data.shape[i] for i in red)
        dyf = dy.float()
        xhat = (data.float() - mean.reshape(bshape)) * inv.reshape(bshape)
        if ctx.fused:
            C = data.shape[-1]
            sum_dy, sum_dy_xhat = _kbn.bn_bwd_reduce(
                data.reshape(-1, C), dy.contiguous().reshape(-1, C), mean,
                inv)
        else:
            sum_dy = dyf.sum(dim=red)
            sum_dy_xhat = (dyf * xhat).sum(dim=red)
        gscale = (gamma.float() * inv).reshape(bshape)
        dx = gscale * (dyf - (sum_dy / n).reshape(bshape)
                       - xhat * (sum_dy_xhat / n).reshape(bshape))
        return (dx.to(data.dtype), sum_dy_xhat.to(gamma.dtype),
                sum_dy.to(ctx.beta_dtype), None, None)


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               axis=1, training=False):
    """BatchNorm (``mxnet_tpu/ops/nn.py:452-476``). Pure: returns ``(out,
    mean, var)``; the caller (the ``BatchNorm`` layer) applies the
    moving-average update. In training without ``use_global_stats`` the
    batch statistics (population variance) normalise and come back cast
    to the moving statistics' dtypes, not differentiable; otherwise the
    moving statistics normalise and come back as they are. ``fix_gamma``
    normalises with gamma = 1 (no gradient reaches gamma). ``momentum``
    is the layer's and unused here."""
    axis = axis % data.ndim
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training and not use_global_stats:
        out, mean, var = _BatchNormFn.apply(data, g, beta, float(eps), axis)
        return out, mean.to(moving_mean.dtype), var.to(moving_var.dtype)
    mean = moving_mean.float()
    var = moving_var.float()
    out, _ = _bn_apply(data, mean, var, g, beta, eps,
                       _bn_bshape(data, axis))
    return out, mean.to(moving_mean.dtype), var.to(moving_var.dtype)


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
