"""B7 and B8: the BatchNorm reductions over a channel-last (M, C) view --
wrappers of ``csrc/batch_norm.cu``.

Counterpart of ``mxnet_tpu/ops/pallas/batch_norm.py`` (``_stats_kernel``,
launched by ``_stats_call`` under ``bn_stats``; ``_bwd_kernel``, launched
by ``_bwd_call`` under ``bn_bwd_reduce``). ``bn_stats`` and
``bn_bwd_reduce`` launch their CUDA kernels for CUDA tensors and run
``bn_stats_plain`` / ``bn_bwd_reduce_plain``, the same arithmetic in
plain PyTorch, for CPU tensors; any other device raises.
``launches_stats`` counts B7 launches and ``launches_bwd`` B8 launches
(one per call: its partial pass and the fixed-order reduction of the
partials).
"""

from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from . import _build

__all__ = ["bn_stats", "bn_stats_plain", "bn_bwd_reduce",
           "bn_bwd_reduce_plain", "supports"]

launches_stats = 0
launches_bwd = 0

# threads per block and rows in flight per thread (kThreads, kUnroll in
# csrc/batch_norm.cu); the tiling below sizes the partials workspace
THREADS = 256
UNROLL = 4
BLOCKS_PER_SM = 4

_P = ctypes.c_void_p
_I = ctypes.c_int
_STATS_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_BWD_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)


def supports(x, axis) -> bool:
    """Can the kernels serve this BatchNorm? The JAX package's rule
    (``batch_norm.py:227-236``): channel-last only (the (M, C) view must be
    free of layout copies), at least two rows."""
    if x.ndim < 2 or axis not in (-1, x.ndim - 1):
        return False
    M = 1
    for d in x.shape[:-1]:
        M *= d
    return M >= 2 and x.shape[-1] >= 1


def tiling(M, C, itemsize, vec, sms):
    """``(chunk_rows, nchunks)``: rows per block and row chunks of one
    launch. Blocks of ``THREADS`` threads span min(C / V, 32) vectors of V
    channels (V = 16 bytes / itemsize with ``vec``, else 1); the chunks
    are as many as give about ``BLOCKS_PER_SM`` blocks per SM, but no
    fewer than two rounds of ``UNROLL`` rows per thread."""
    V = 16 // itemsize if vec else 1
    nvec = -(-C // V)
    tx = min(nvec, 32)
    ty = THREADS // tx
    ncol = -(-nvec // tx)
    most = max(1, -(-M // (2 * UNROLL * ty)))
    nchunks = max(1, min(-(-BLOCKS_PER_SM * sms // ncol), most))
    chunk_rows = -(-M // nchunks)
    return chunk_rows, -(-M // chunk_rows)


def bn_stats_plain(x2d):
    """Plain PyTorch version of B7: ``(mean, var)`` f32 (C,) from the
    shifted sums, the shift being row 0."""
    M = x2d.shape[0]
    xf = x2d.float()
    xs = xf - xf[0]
    s1 = xs.sum(dim=0)
    s2 = (xs * xs).sum(dim=0)
    return xf[0] + s1 / M, s2 / M - (s1 / M) ** 2


def bn_bwd_reduce_plain(x2d, dy2d, mean, inv):
    """Plain PyTorch version of B8: ``(sum dy, sum dy * xhat)`` f32 (C,)
    with ``xhat = (x - mean) * inv``."""
    dyf = dy2d.float()
    xhat = (x2d.float() - mean) * inv
    return dyf.sum(dim=0), (dyf * xhat).sum(dim=0)


def _launch_args(name, *tensors):
    """Checks shared by both kernels; returns ``(M, C, dtype code,
    chunk_rows, nchunks, vec)`` and raises for what the kernels do not
    take."""
    x = tensors[0]
    _build.check_cuda_args(name, *tensors)
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise MXNetError(f"{name} kernel takes a non-empty (M, C) view, got "
                         f"{tuple(x.shape)}")
    M, C = x.shape
    code = _build.dtype_code(x)
    V = 16 // x.element_size()
    vec = C % V == 0 and all(t.data_ptr() % 16 == 0 for t in tensors
                             if t.dim() == 2)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return (M, C, code) + tiling(M, C, x.element_size(), vec, sms) \
        + (int(vec),)


def bn_stats(x2d):
    """Per-channel ``(mean, var)`` (population variance) of ``x2d`` (M, C),
    f32 or bf16; both f32 (C,)."""
    global launches_stats
    if x2d.device.type == "cpu":
        return bn_stats_plain(x2d)
    if x2d.device.type != "cuda":
        raise MXNetError(f"bn_stats: no kernel for device {x2d.device}")
    M, C, code, chunk_rows, nchunks, vec = _launch_args("bn_stats", x2d)
    out = torch.empty((2, C), dtype=torch.float32, device=x2d.device)
    work = torch.empty((2 * nchunks * C,), dtype=torch.float32,
                       device=x2d.device)
    fn = _build.entry("mxtt_bn_stats", _STATS_ARGTYPES)
    _build.check(fn(x2d.data_ptr(), out.data_ptr(), work.data_ptr(), M, C,
                    chunk_rows, nchunks, vec, code,
                    _build.stream_handle(x2d.device)), "bn_stats")
    launches_stats += 1
    return out[0], out[1]


def bn_bwd_reduce(x2d, dy2d, mean, inv):
    """``(sum dy, sum dy * xhat)`` per channel of ``x2d``/``dy2d`` (M, C),
    same dtype, from f32 ``mean`` and ``inv`` (C,); both f32 (C,), reduced
    in a fixed order (the same bits on every run)."""
    global launches_bwd
    if x2d.device.type == "cpu":
        return bn_bwd_reduce_plain(x2d, dy2d, mean, inv)
    if x2d.device.type != "cuda":
        raise MXNetError(f"bn_bwd_reduce: no kernel for device "
                         f"{x2d.device}")
    M, C, code, chunk_rows, nchunks, vec = _launch_args(
        "bn_bwd_reduce", x2d, dy2d, mean, inv)
    if dy2d.shape != x2d.shape or dy2d.dtype != x2d.dtype:
        raise MXNetError("bn_bwd_reduce kernel: dy must be (M, C) in x's "
                         "dtype")
    for t in (mean, inv):
        if t.shape != (C,) or t.dtype != torch.float32:
            raise MXNetError("bn_bwd_reduce kernel: mean and inv must be "
                             "f32 (C,)")
    out = torch.empty((2, C), dtype=torch.float32, device=x2d.device)
    work = torch.empty((2 * nchunks * C,), dtype=torch.float32,
                       device=x2d.device)
    fn = _build.entry("mxtt_bn_bwd_reduce", _BWD_ARGTYPES)
    _build.check(fn(x2d.data_ptr(), dy2d.data_ptr(), mean.data_ptr(),
                    inv.data_ptr(), out.data_ptr(), work.data_ptr(), M, C,
                    chunk_rows, nchunks, vec, code,
                    _build.stream_handle(x2d.device)), "bn_bwd_reduce")
    launches_bwd += 1
    return out[0], out[1]
