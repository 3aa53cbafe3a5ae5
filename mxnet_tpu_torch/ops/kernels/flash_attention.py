"""K2, B4a, B4b: flash attention forward and its two-kernel backward —
wrappers of ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``.

Counterpart of ``mxnet_tpu/ops/pallas/flash_attention.py``: ``_fwd_kernel``
(launched by ``_flash_fwd_impl``), ``_bwd_dkdv_kernel`` and
``_bwd_dq_kernel`` (launched by ``_flash_bwd_pallas``).
``flash_attention_fwd``, ``flash_attention_bwd_dkdv`` and
``flash_attention_bwd_dq`` launch their CUDA kernels for CUDA tensors and
run ``flash_attention_plain``, ``flash_attention_bwd_dkdv_plain`` and
``flash_attention_bwd_dq_plain`` (the same masked math in plain PyTorch)
for CPU tensors; any other device raises. ``flash_attention_bwd`` is the
whole backward: ``delta = rowsum(dout * out)`` as a PyTorch op (as the JAX
package computes it outside its kernels), then both kernels.
``launches``, ``launches_bwd_dkdv`` and ``launches_bwd_dq`` count the
three kernels' launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...base import MXNetError
from . import _build

__all__ = ["flash_attention_fwd", "flash_attention_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_bwd_dkdv", "flash_attention_bwd_dkdv_plain",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_plain",
           "NEG_INF"]

NEG_INF = -1e30  # the TPU kernel's masked-score sentinel
launches = 0
launches_bwd_dkdv = 0
launches_bwd_dq = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
             _I, _I, _P)
# q, k, v, dout, lse, delta, vl, outputs (dk, dv | dq); BH, H, Sq, Sk, D,
# sm_scale, causal, dtype, stream
_DKDV_ARGTYPES = (_P,) * 9 + (_I,) * 5 + (ctypes.c_float, _I, _I, _P)
_DQ_ARGTYPES = (_P,) * 8 + (_I,) * 5 + (ctypes.c_float, _I, _I, _P)


def _key_mask(B, Sq, Sk, valid_length, causal, device):
    """(B, 1, Sq, Sk) bool: keys below valid_length (clamped to Sk) and,
    when causal, at or below the query position."""
    kpos = torch.arange(Sk, device=device)
    mask = torch.ones((B, 1, Sq, Sk), dtype=torch.bool, device=device)
    if valid_length is not None:
        vl = valid_length.to(device=device, dtype=torch.int64)
        mask = mask & (kpos.view(1, 1, 1, Sk) < vl.view(B, 1, 1, 1))
    if causal:
        qpos = torch.arange(Sq, device=device)
        mask = mask & (kpos.view(1, 1, 1, Sk) <= qpos.view(1, 1, Sq, 1))
    return mask


def flash_attention_plain(q, k, v, valid_length=None, causal=False,
                          sm_scale=None):
    """Plain PyTorch version over (B, H, S, D): ``(out, lse (B, H, Sq))``.
    A row without a visible key outputs 0 (its kernel loop never runs)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    mask = _key_mask(B, Sq, Sk, valid_length, causal, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_fwd(q, k, v, valid_length=None, causal=False,
                        sm_scale=None):
    """Softmax(q·kᵀ·scale)·v over (B, H, S, D) operands, O(S) memory.
    ``valid_length`` (B,) int masks keys at or past it. Returns
    ``(out (B, H, Sq, D), lse (B, H, Sq) f32)``."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, valid_length, causal, sm_scale)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_attention: no kernel for device {q.device}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if k.shape != (B, H, Sk, D) or v.shape != k.shape:
        raise MXNetError(f"flash_attention: k/v {tuple(k.shape)} / "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError("flash_attention: q, k, v must share one dtype")
    if D != 64:
        raise MXNetError(f"flash_attention kernel takes head dim 64, got {D}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    tensors = [q, k, v]
    vl_ptr = None
    if valid_length is not None:
        if valid_length.shape != (B,) or valid_length.dtype != torch.int32:
            raise MXNetError("flash_attention: valid_length must be (B,) "
                             "int32")
        tensors.append(valid_length)
        vl_ptr = valid_length.data_ptr()
    _build.check_cuda_args("flash_attention", *tensors)
    code = _build.dtype_code(q)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _build.entry("mxtt_flash_attention_fwd", _ARGTYPES)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), vl_ptr,
                    out.data_ptr(), lse.data_ptr(), B * H, H, Sq, Sk, D,
                    float(sm_scale), int(bool(causal)), code,
                    _build.stream_handle(q.device)),
                 "flash_attention")
    launches += 1
    return out, lse


# ------------------------------------------------------------- backward
def _bwd_scores(q, k, v, valid_length, lse, delta, do, causal, sm_scale):
    """f32 ``(p, ds)`` (B, H, Sq, Sk) recomputed from the saved lse, with
    ``p = 0`` exactly outside the mask (a row whose keys are all masked
    has lse about -1e30, where ``exp(s - lse)`` would not give 0)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    mask = _key_mask(B, Sq, Sk, valid_length, causal, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * sm_scale


def flash_attention_bwd_dkdv_plain(q, k, v, valid_length, lse, delta, do,
                                   causal=False, sm_scale=None):
    """Plain PyTorch version of B4a: ``(dk, dv)`` in k's and v's dtype."""
    p, ds = _bwd_scores(q, k, v, valid_length, lse, delta, do, causal,
                        sm_scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, valid_length, lse, delta, do,
                                 causal=False, sm_scale=None):
    """Plain PyTorch version of B4b: ``dq`` in q's dtype."""
    _, ds = _bwd_scores(q, k, v, valid_length, lse, delta, do, causal,
                        sm_scale)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def _delta(out, do):
    """``rowsum(dout * out)`` in f32, (B, H, Sq)."""
    return (do.float() * out.float()).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, valid_length, out, lse, do,
                              causal=False, sm_scale=None):
    """Plain PyTorch version of the whole backward: ``(dq, dk, dv)``."""
    delta = _delta(out, do)
    dk, dv = flash_attention_bwd_dkdv_plain(q, k, v, valid_length, lse,
                                            delta, do, causal, sm_scale)
    dq = flash_attention_bwd_dq_plain(q, k, v, valid_length, lse, delta, do,
                                      causal, sm_scale)
    return dq, dk, dv


def _bwd_launch_args(kernel, q, k, v, valid_length, lse, delta, do,
                     sm_scale):
    """Check the backward kernels' operands; returns the C entries'
    shared arguments ``(vl_ptr, BH, H, Sq, Sk, D, sm_scale, dtype)``."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if k.shape != (B, H, Sk, D) or v.shape != k.shape \
            or do.shape != q.shape:
        raise MXNetError(f"{kernel}: q/dout {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)} / {tuple(v.shape)} do not match")
    if any(t.dtype != q.dtype for t in (k, v, do)):
        raise MXNetError(f"{kernel}: q, k, v, dout must share one dtype")
    if any(t.shape != (B, H, Sq) or t.dtype != torch.float32
           for t in (lse, delta)):
        raise MXNetError(f"{kernel}: lse and delta must be (B, H, Sq) f32")
    if D != 64:
        raise MXNetError(f"{kernel} kernel takes head dim 64, got {D}")
    tensors = [q, k, v, do, lse, delta]
    vl_ptr = None
    if valid_length is not None:
        if valid_length.shape != (B,) or valid_length.dtype != torch.int32:
            raise MXNetError(f"{kernel}: valid_length must be (B,) int32")
        tensors.append(valid_length)
        vl_ptr = valid_length.data_ptr()
    _build.check_cuda_args(kernel, *tensors)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    return (vl_ptr, B * H, H, Sq, Sk, D, float(sm_scale),
            _build.dtype_code(q))


def flash_attention_bwd_dkdv(q, k, v, valid_length, lse, delta, do,
                             causal=False, sm_scale=None):
    """B4a: ``(dk, dv)`` of attention over (B, H, S, D) operands, from the
    forward's f32 ``lse`` and ``delta = rowsum(dout * out)`` (B, H, Sq);
    ``valid_length`` (B,) int32 or None (full length)."""
    global launches_bwd_dkdv
    if q.device.type == "cpu":
        return flash_attention_bwd_dkdv_plain(q, k, v, valid_length, lse,
                                              delta, do, causal, sm_scale)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_attention_bwd_dkdv: no kernel for device "
                         f"{q.device}")
    vl_ptr, BH, H, Sq, Sk, D, scale, code = _bwd_launch_args(
        "flash_attention_bwd_dkdv", q, k, v, valid_length, lse, delta, do, sm_scale)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _build.entry("mxtt_flash_attention_bwd_dkdv", _DKDV_ARGTYPES)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), vl_ptr, dk.data_ptr(),
                    dv.data_ptr(), BH, H, Sq, Sk, D, scale, int(bool(causal)),
                    code, _build.stream_handle(q.device)),
                 "flash_attention_bwd_dkdv")
    launches_bwd_dkdv += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, valid_length, lse, delta, do,
                           causal=False, sm_scale=None):
    """B4b: ``dq`` of attention over (B, H, S, D) operands; arguments as
    ``flash_attention_bwd_dkdv``."""
    global launches_bwd_dq
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, valid_length, lse,
                                            delta, do, causal, sm_scale)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_attention_bwd_dq: no kernel for device "
                         f"{q.device}")
    vl_ptr, BH, H, Sq, Sk, D, scale, code = _bwd_launch_args(
        "flash_attention_bwd_dq", q, k, v, valid_length, lse, delta, do, sm_scale)
    dq = torch.empty_like(q)
    fn = _build.entry("mxtt_flash_attention_bwd_dq", _DQ_ARGTYPES)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), vl_ptr, dq.data_ptr(),
                    BH, H, Sq, Sk, D, scale, int(bool(causal)), code,
                    _build.stream_handle(q.device)),
                 "flash_attention_bwd_dq")
    launches_bwd_dq += 1
    return dq


def flash_attention_bwd(q, k, v, valid_length, out, lse, do, causal=False,
                        sm_scale=None):
    """Gradients ``(dq, dk, dv)`` of ``flash_attention_fwd`` from its
    ``out`` and ``lse`` and the output gradient ``do`` (B, H, Sq, D):
    ``delta`` as a PyTorch op, then B4a and B4b."""
    delta = _delta(out, do)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, valid_length, lse, delta, do,
                                      causal, sm_scale)
    dq = flash_attention_bwd_dq(q, k, v, valid_length, lse, delta, do,
                                causal, sm_scale)
    return dq, dk, dv
