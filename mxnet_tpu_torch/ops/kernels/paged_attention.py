"""K3 and B6: paged attention — wrappers of ``csrc/paged_attention.cu``
and ``csrc/paged_window_attention.cu``.

Counterpart of ``mxnet_tpu/ops/pallas/paged_flash_attention.py``:
``paged_decode_attention`` (K3, ``_decode_kernel``, one query per row)
and ``paged_window_attention`` (B6, ``_window_kernel``, an S-query window
per row at a per-row offset). Each launches its CUDA kernel, which reads
the ``(num_pages, page_size, H, D)`` pools in place through the page
table, for CUDA tensors, and runs its plain version — gather the
``(B, P*page_size, H, D)`` view, then masked softmax, as
``paged_decode_reference`` / ``paged_window_reference`` do — for CPU
tensors; any other device raises. ``launches`` counts K3's launches,
``launches_window`` B6's.
"""

from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from . import _build
from .flash_attention import NEG_INF

__all__ = ["paged_decode_attention", "paged_decode_plain",
           "paged_window_attention", "paged_window_plain"]

launches = 0
launches_window = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
             _I, _P)
_WINDOW_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    ctypes.c_float, _I, _P)


def paged_decode_plain(q, k_pool, v_pool, page_table, pos, sm_scale):
    """Plain PyTorch version: gather the pages, mask keys past ``pos``."""
    B, H, D = q.shape
    ps = k_pool.shape[1]
    P = page_table.shape[1]
    table = page_table.long()
    k = k_pool[table].reshape(B, P * ps, H, D).float()
    v = v_pool[table].reshape(B, P * ps, H, D).float()
    s = torch.einsum("bhd,blhd->bhl", q.float(), k) * sm_scale
    keys = torch.arange(P * ps, device=q.device)
    mask = keys.view(1, 1, -1) <= pos.long().view(B, 1, 1)
    probs = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return torch.einsum("bhl,blhd->bhd", probs, v).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, page_table, pos, sm_scale):
    """Single-token attention over paged K/V. q ``(B, H, D)``; pools
    ``(num_pages, page_size, H, D)``; ``page_table`` ``(B, P)`` int32;
    ``pos`` ``(B,)`` int32 — row ``b`` attends keys at positions
    ``<= pos[b]`` (already scattered into the pools). Returns
    ``(B, H, D)``."""
    global launches
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, page_table, pos,
                                  sm_scale)
    if q.device.type != "cuda":
        raise MXNetError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    B, H, D = q.shape
    if k_pool.ndim != 4 or tuple(k_pool.shape[2:]) != (H, D) \
            or v_pool.shape != k_pool.shape:
        raise MXNetError(f"paged_decode_attention: pools "
                         f"{tuple(k_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise MXNetError("paged_decode_attention: q and the pools must "
                         "share one dtype")
    if page_table.ndim != 2 or page_table.shape[0] != B \
            or pos.shape != (B,) or page_table.dtype != torch.int32 \
            or pos.dtype != torch.int32:
        raise MXNetError("paged_decode_attention: page_table must be "
                         "(B, P) int32 and pos (B,) int32")
    if D != 64 or q.dtype != torch.float32:
        raise MXNetError(f"paged_decode_attention kernel takes float32 with "
                         f"head dim 64, got {q.dtype} with {D}")
    _build.check_cuda_args("paged_decode_attention", q, k_pool, v_pool,
                           page_table, pos)
    code = _build.dtype_code(q)
    out = torch.empty_like(q)
    fn = _build.entry("mxtt_paged_decode_attention", _ARGTYPES)
    _build.check(fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                    B, H, D, k_pool.shape[1], page_table.shape[1],
                    float(sm_scale), code, _build.stream_handle(q.device)),
                 "paged_decode_attention")
    launches += 1
    return out


def paged_window_plain(q, k_pool, v_pool, page_table, q_offset, window_vl,
                       sm_scale):
    """Plain PyTorch version (``paged_window_reference``, :304): gather
    the pages, mask keys past each query's position, zero the padding
    queries."""
    B, S, H, D = q.shape
    ps = k_pool.shape[1]
    P = page_table.shape[1]
    table = page_table.long()
    k = k_pool[table].reshape(B, P * ps, H, D).float()
    v = v_pool[table].reshape(B, P * ps, H, D).float()
    s = torch.einsum("bshd,blhd->bhsl", q.float(), k) * sm_scale
    steps = torch.arange(S, device=q.device)
    keys = torch.arange(P * ps, device=q.device)
    q_abs = q_offset.long().view(B, 1, 1, 1) + steps.view(1, 1, S, 1)
    s = torch.where(keys.view(1, 1, 1, -1) <= q_abs, s, NEG_INF)
    out = torch.einsum("bhsl,blhd->bshd", torch.softmax(s, dim=-1), v)
    if window_vl is not None:
        live = steps.view(1, S, 1, 1) < window_vl.long().view(B, 1, 1, 1)
        out = torch.where(live, out, 0.0)
    return out.to(q.dtype)


def paged_window_attention(q, k_pool, v_pool, page_table, q_offset,
                           window_vl, sm_scale):
    """S-query window attention over paged K/V. q ``(B, S, H, D)``; pools
    ``(num_pages, page_size, H, D)``; ``page_table`` ``(B, P)`` int32;
    ``q_offset`` ``(B,)`` int32 — query ``i`` of row ``b`` sits at
    ``q_offset[b] + i`` and attends keys at positions ``<=`` it (already
    scattered into the pools); ``window_vl`` ``(B,)`` int32 or None —
    queries ``i >= window_vl[b]`` output 0. Returns ``(B, S, H, D)``."""
    global launches_window
    if q.device.type == "cpu":
        return paged_window_plain(q, k_pool, v_pool, page_table, q_offset,
                                  window_vl, sm_scale)
    if q.device.type != "cuda":
        raise MXNetError(f"paged_window_attention: no kernel for device "
                         f"{q.device}")
    if q.ndim != 4:
        raise MXNetError(f"paged_window_attention: q must be (B, S, H, D), "
                         f"got {tuple(q.shape)}")
    B, S, H, D = q.shape
    if k_pool.ndim != 4 or tuple(k_pool.shape[2:]) != (H, D) \
            or v_pool.shape != k_pool.shape:
        raise MXNetError(f"paged_window_attention: pools "
                         f"{tuple(k_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise MXNetError("paged_window_attention: q and the pools must "
                         "share one dtype")
    if window_vl is None:
        window_vl = torch.full((B,), S, dtype=torch.int32, device=q.device)
    if page_table.ndim != 2 or page_table.shape[0] != B \
            or q_offset.shape != (B,) or window_vl.shape != (B,) \
            or page_table.dtype != torch.int32 \
            or q_offset.dtype != torch.int32 \
            or window_vl.dtype != torch.int32:
        raise MXNetError("paged_window_attention: page_table must be "
                         "(B, P) int32, q_offset and window_vl (B,) int32")
    if D != 64 or q.dtype != torch.float32:
        raise MXNetError(f"paged_window_attention kernel takes float32 with "
                         f"head dim 64, got {q.dtype} with {D}")
    _build.check_cuda_args("paged_window_attention", q, k_pool, v_pool,
                           page_table, q_offset, window_vl)
    code = _build.dtype_code(q)
    out = torch.empty_like(q)
    fn = _build.entry("mxtt_paged_window_attention", _WINDOW_ARGTYPES)
    _build.check(fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    page_table.data_ptr(), q_offset.data_ptr(),
                    window_vl.data_ptr(), out.data_ptr(), B, S, H, D,
                    k_pool.shape[1], page_table.shape[1], float(sm_scale),
                    code, _build.stream_handle(q.device)),
                 "paged_window_attention")
    launches_window += 1
    return out
