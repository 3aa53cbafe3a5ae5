"""Multi-head attention of the serving slice.

Counterpart of ``mxnet_tpu/gluon/nn/attention.py`` (``MultiHeadAttention``)
in its default transpose-free (B, S, H, D) layout: ``forward``, the
incremental ``prefill``/``project_kv``/``attend`` and the paged
``init_page_pool``/``paged_step``. The fused QKV projection keeps the
interleaved per-head layout of ``:95-106``: reshape to ``(B, S, H, 3D)``,
then slice q, k and v, so the JAX package's weights load unchanged.

Attention runs through ``ops.contrib.flash_attention`` (dense below
``MXTPU_ATTN_DENSE_MAX``, kernel K2 above) and, for the paged decode step,
``ops.kernels.paged_attention`` (kernel K3 for CUDA tensors, the plain
gather path for CPU tensors). Paged pools are updated IN PLACE (the JAX
package returns new arrays); the methods still return them so the call
shapes match.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...base import MXNetError
from ...ops.contrib import flash_attention
from ...ops.kernels.paged_attention import paged_decode_attention
from .basic_layers import Dense, Dropout

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(nn.Module):
    """Fused multi-head attention.

    ``self_attention`` uses one interleaved QKV projection (``qkv_proj``);
    otherwise ``q_proj``/``k_proj``/``v_proj``. ``causal`` masks keys above
    the query (decoder self-attention)."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 self_attention=True, causal=False, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        if units % num_heads != 0:
            raise MXNetError(
                f"units {units} not divisible by num_heads {num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._head_dim = units // num_heads
        self._causal = causal
        self._self_attention = self_attention
        kw = dict(use_bias=use_bias, flatten=False, dtype=dtype,
                  device=device)
        if self_attention:
            self.qkv_proj = Dense(3 * units, units, **kw)
        else:
            self.q_proj = Dense(units, units, **kw)
            self.k_proj = Dense(units, units, **kw)
            self.v_proj = Dense(units, units, **kw)
        self.out_proj = Dense(units, units, **kw)
        self.drop = Dropout(dropout) if dropout else None

    def _sm_scale(self):
        return 1.0 / math.sqrt(self._head_dim)

    def _heads(self, x):
        # (B, L, units) -> (B, L, H, D)
        return x.reshape(x.shape[0], x.shape[1], self._num_heads,
                         self._head_dim)

    def _qkv(self, query):
        """Interleaved per-head QKV: (B, S, H, 3D), then q, k, v slices."""
        qkv = self.qkv_proj(query)
        B, S = qkv.shape[0], qkv.shape[1]
        qkv = qkv.reshape(B, S, self._num_heads, 3 * self._head_dim)
        d = self._head_dim
        return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]

    def _finish(self, out):
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self._units))
        return self.drop(out) if self.drop is not None else out

    def forward(self, query, key=None, value=None, valid_length=None):
        """``valid_length`` (B,) counts the non-padding KEY positions per
        row."""
        if self._self_attention:
            q, k, v = self._qkv(query)
        else:
            key = query if key is None else key
            value = key if value is None else value
            q = self._heads(self.q_proj(query))
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value))
        out = flash_attention(q, k, v, valid_length, causal=self._causal,
                              sm_scale=self._sm_scale())
        return self._finish(out)

    # ----------------------------------------------------- incremental mode
    def prefill(self, query, valid_length=None):
        """Self-attention forward that also returns the projected
        ``(B, S, H, D)`` K/V for seeding a decode cache (``:222``)."""
        if not self._self_attention:
            raise MXNetError("prefill() is the self-attention cache seed; "
                             "cross-attention uses project_kv()")
        q, k, v = self._qkv(query)
        out = flash_attention(q, k, v, valid_length, causal=self._causal,
                              sm_scale=self._sm_scale())
        return self._finish(out), k, v

    def project_kv(self, key, value=None):
        """Cross-attention: project the static memory once into
        ``(B, S, H, D)`` K/V reused by every decode step (``:246``)."""
        if self._self_attention:
            raise MXNetError("project_kv() needs self_attention=False")
        value = key if value is None else value
        return self._heads(self.k_proj(key)), self._heads(self.v_proj(value))

    def attend(self, query, k, v, valid_length=None):
        """Attention of a projected query over precomputed ``(B, S, H, D)``
        K/V from ``project_kv`` (``:257``)."""
        if self._self_attention:
            raise MXNetError("attend() runs over external K/V; "
                             "self-attention caches use paged_step()")
        q = self._heads(self.q_proj(query))
        out = flash_attention(q, k, v, valid_length, causal=self._causal,
                              sm_scale=self._sm_scale())
        return self._finish(out)

    # ------------------------------------------------------------ paged mode
    # K/V live in shared (num_pages, page_size, H, D) pools; row b's
    # logical position p sits in page page_table[b, p // page_size]. Page 0
    # is the TRASH page: inactive rows write there and unallocated table
    # entries point at it (serving.pages.PagePool owns the free list).

    def init_page_pool(self, num_pages, page_size, dtype=None):
        """Zeroed ``(num_pages, page_size, H, D)`` K/V pools (``:331``);
        two separate tensors, since the port updates them in place."""
        w = self.out_proj.weight
        shape = (int(num_pages), int(page_size), self._num_heads,
                 self._head_dim)
        dt = w.dtype if dtype is None else dtype
        return (torch.zeros(shape, dtype=dt, device=w.device),
                torch.zeros(shape, dtype=dt, device=w.device))

    def paged_step(self, query, k_pool, v_pool, page_table, pos, active):
        """One incremental self-attention step through the paged cache
        (``:343-407``). ``query`` (B, 1, units); ``page_table`` (B, P)
        int32; ``pos`` (B,) int32 is each row's cache length (this token's
        position); ``active`` (B,) bool. The new token's K/V land at
        ``(page, pos % page_size)``, inactive rows at (trash page 0, 0) --
        duplicate indices there are harmless because nothing reads page 0
        for a live row. Then K3 (CUDA) or the plain gather path (CPU)
        attends over keys ``<= pos``. Returns ``(out, k_pool, v_pool)``."""
        if not self._self_attention:
            raise MXNetError("paged_step() updates a self-attention cache; "
                             "cross-attention uses attend()")
        q, k_t, v_t = self._qkv(query)
        B = query.shape[0]
        page_size = k_pool.shape[1]
        P = page_table.shape[1]
        pos_l = pos.long()
        rows = torch.arange(B, device=query.device)
        # a table column past the width clamps, as the JAX gather does
        slot = torch.where(active, pos_l // page_size, 0).clamp(0, P - 1)
        page = torch.where(active, page_table[rows, slot].long(), 0)
        off = torch.where(active, pos_l % page_size, 0)
        k_pool[page, off] = k_t[:, 0].to(k_pool.dtype)
        v_pool[page, off] = v_t[:, 0].to(v_pool.dtype)
        out = paged_decode_attention(q[:, 0].contiguous(), k_pool, v_pool,
                                     page_table, pos, self._sm_scale())
        return self._finish(out[:, None]), k_pool, v_pool
