"""K1 and B2: fused LayerNorm forward and backward — wrappers of
``csrc/layer_norm.cu`` and ``csrc/layer_norm_bwd.cu``.

Counterpart of ``mxnet_tpu/ops/pallas/layer_norm.py`` (``_fwd_kernel``,
launched by ``_ln_fwd_impl``; ``_bwd_kernel``, launched by
``_ln_bwd_impl``). ``layer_norm_fwd`` and ``layer_norm_bwd`` launch their
CUDA kernels for CUDA tensors and run ``layer_norm_plain`` /
``layer_norm_bwd_plain``, the same arithmetic in plain PyTorch, for CPU
tensors; any other device raises. ``launches`` counts K1 launches and
``launches_bwd`` B2 launches (one per call: its row pass and its
partials reduction).
"""

from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from . import _build

__all__ = ["layer_norm_fwd", "layer_norm_plain", "layer_norm_bwd",
           "layer_norm_bwd_plain", "supports"]

launches = 0
launches_bwd = 0

# rows per block of B2's row pass (kRowsPerBlock in csrc/layer_norm_bwd.cu):
# each block writes one partial row of dgamma and one of dbeta
ROWS_PER_BLOCK = 32

_P = ctypes.c_void_p
_ARGTYPES = (_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, _P)
_BWD_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, _P)


def supports(data, axis) -> bool:
    """Can the fused kernel serve this call? The TPU kernel's rule
    (``layer_norm.py:170-177``): last axis, C % 128 == 0, 128 <= C <= 4096."""
    C = data.shape[-1]
    return (axis in (-1, data.ndim - 1)) and C % 128 == 0 \
        and 128 <= C <= 4096 and data.ndim >= 2


def layer_norm_plain(x, gamma, beta, eps=1e-5):
    """Plain PyTorch version: ``(out, mean (rows, 1), rstd (rows, 1))``
    with f32 statistics and the centred variance."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = xc * rstd * gamma.float() + beta.float()
    return out.to(x.dtype), mean, rstd


def layer_norm_fwd(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of 2-D ``x`` (rows, C); gamma and beta
    (C,) in x's dtype. Returns ``(out, mean, rstd)``."""
    global launches
    if x.device.type == "cpu":
        return layer_norm_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise MXNetError(f"layer_norm: no kernel for device {x.device}")
    _build.check_cuda_args("layer_norm", x, gamma, beta)
    if x.ndim != 2 or not supports(x, -1):
        raise MXNetError(f"layer_norm kernel takes (rows, C) with C % 128 "
                         f"== 0 and 128 <= C <= 4096, got {tuple(x.shape)}")
    rows, C = x.shape
    if gamma.shape != (C,) or beta.shape != (C,) \
            or gamma.dtype != x.dtype or beta.dtype != x.dtype:
        raise MXNetError("layer_norm kernel: gamma and beta must be (C,) "
                         "in x's dtype")
    code = _build.dtype_code(x)
    out = torch.empty_like(x)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    fn = _build.entry("mxtt_layer_norm_fwd", _ARGTYPES)
    _build.check(fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                    out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows,
                    C, float(eps), code, _build.stream_handle(x.device)),
                 "layer_norm")
    launches += 1
    return out, mean, rstd


def layer_norm_bwd_plain(x, gamma, mean, rstd, dy):
    """Plain PyTorch version of the backward: ``(dx in x's dtype, dgamma
    f32 (C,), dbeta f32 (C,))`` from the forward's f32 ``mean`` and
    ``rstd`` (rows, 1)."""
    xf = x.float()
    dyf = dy.float()
    xhat = (xf - mean) * rstd
    dyg = dyf * gamma.float()
    m1 = dyg.mean(dim=1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=1, keepdim=True)
    dx = (dyg - m1 - xhat * m2) * rstd
    return dx.to(x.dtype), (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


def layer_norm_bwd(x, gamma, mean, rstd, dy):
    """Backward of ``layer_norm_fwd`` for 2-D ``x`` (rows, C): ``x``,
    ``gamma`` and the forward's ``mean``/``rstd`` (rows, 1) f32, ``dy``
    like ``x``. Returns ``(dx, dgamma, dbeta)``; dgamma and dbeta are f32
    sums over the rows, reduced in a fixed order (the same bits on every
    run)."""
    global launches_bwd
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, gamma, mean, rstd, dy)
    if x.device.type != "cuda":
        raise MXNetError(f"layer_norm_bwd: no kernel for device {x.device}")
    _build.check_cuda_args("layer_norm_bwd", x, gamma, mean, rstd, dy)
    if x.ndim != 2 or not supports(x, -1):
        raise MXNetError(f"layer_norm_bwd kernel takes (rows, C) with C % "
                         f"128 == 0 and 128 <= C <= 4096, got "
                         f"{tuple(x.shape)}")
    rows, C = x.shape
    if gamma.shape != (C,) or gamma.dtype != x.dtype \
            or dy.shape != x.shape or dy.dtype != x.dtype:
        raise MXNetError("layer_norm_bwd kernel: gamma must be (C,) and dy "
                         "(rows, C), both in x's dtype")
    for t in (mean, rstd):
        if t.numel() != rows or t.dtype != torch.float32:
            raise MXNetError("layer_norm_bwd kernel: mean and rstd must be "
                             "f32 with one value per row")
    code = _build.dtype_code(x)
    dx = torch.empty_like(x)
    dgb = torch.empty((2, C), dtype=torch.float32, device=x.device)
    nparts = -(-rows // ROWS_PER_BLOCK)
    work = torch.empty((max(2 * nparts * C, 1),), dtype=torch.float32,
                       device=x.device)
    fn = _build.entry("mxtt_layer_norm_bwd", _BWD_ARGTYPES)
    _build.check(fn(x.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
                    rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                    dgb[0].data_ptr(), dgb[1].data_ptr(), work.data_ptr(),
                    rows, C, code, _build.stream_handle(x.device)),
                 "layer_norm_bwd")
    launches_bwd += 1
    return dx, dgb[0], dgb[1]
