"""Multi-head attention of the serving slice.

Counterpart of ``mxnet_tpu/gluon/nn/attention.py`` (``MultiHeadAttention``)
in its default transpose-free (B, S, H, D) layout: ``forward``, the
incremental ``prefill``/``project_kv``/``attend`` and the paged
``init_page_pool``/``paged_step``/``paged_window_step``. The fused QKV
projection keeps the interleaved per-head layout of ``:95-106``: reshape
to ``(B, S, H, 3D)``, then slice q, k and v, so the JAX package's weights
load unchanged.

Attention runs through ``ops.contrib.flash_attention`` (dense below
``MXTPU_ATTN_DENSE_MAX``, kernel K2 above) and, for the paged steps of a
causal layer, ``ops.kernels.paged_attention`` (kernels K3 and B6 for CUDA
tensors, their plain gather versions for CPU tensors). A non-causal layer
takes the paged steps' dense branch on every device, as the JAX package
routes it (``:389-405``, ``:465-476``): gather the pages, then
``flash_attention(causal=False, q_offset=pos)`` over every gathered key.
Paged pools are updated IN PLACE (the JAX package returns new arrays);
the methods still return them so the call shapes match.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...base import MXNetError
from ...ops.contrib import flash_attention
from ...ops.kernels.paged_attention import (paged_decode_attention,
                                            paged_window_attention)
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

    def _paged_dense(self, q, k_pool, v_pool, page_table, pos):
        """The non-causal layer's branch: gather the ``(B, P*page_size, H,
        D)`` view through the table and attend over every gathered key
        (``causal=False``; ``q_offset`` only shifts a causal mask)."""
        B = q.shape[0]
        rows = page_table.shape[1] * k_pool.shape[1]
        table = page_table.long()
        k = k_pool[table].reshape(B, rows, self._num_heads, self._head_dim)
        v = v_pool[table].reshape(B, rows, self._num_heads, self._head_dim)
        return flash_attention(q, k, v, None, causal=False,
                               sm_scale=self._sm_scale(), q_offset=pos)

    def paged_step(self, query, k_pool, v_pool, page_table, pos, active):
        """One incremental self-attention step through the paged cache
        (``:343-407``). ``query`` (B, 1, units); ``page_table`` (B, P)
        int32; ``pos`` (B,) int32 is each row's cache length (this token's
        position); ``active`` (B,) bool. The new token's K/V land at
        ``(page, pos % page_size)``, inactive rows at (trash page 0, 0) --
        duplicate indices there are harmless because nothing reads page 0
        for a live row. Then a causal layer attends over keys ``<= pos``
        through K3 (CUDA) or its plain gather version (CPU); a non-causal
        one takes the dense branch. Returns ``(out, k_pool, v_pool)``."""
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
        if self._causal:
            out = paged_decode_attention(q[:, 0].contiguous(), k_pool,
                                         v_pool, page_table, pos,
                                         self._sm_scale())[:, None]
        else:
            out = self._paged_dense(q, k_pool, v_pool, page_table, pos)
        return self._finish(out), k_pool, v_pool

    def paged_window_step(self, query, k_pool, v_pool, page_table, pos,
                          active, window_vl=None):
        """An S-token window through the paged cache in one pass
        (``:409-476``). ``query`` (B, S, units): token ``i`` of row ``b``
        sits at absolute position ``pos[b] + i`` (``pos`` (B,) int32).
        The window's K/V scatter through the table first; a padding token
        (``i >= window_vl[b]``, int32 (B,) or None for none) or an
        inactive row writes to (trash page 0, 0), where duplicate indices
        are harmless. Then a causal layer attends every query over the
        row's history and the window's earlier tokens through B6 (CUDA)
        or its plain version (CPU), padding queries giving 0; a non-causal
        one takes the dense branch, whose padding rows are garbage (callers
        read rows ``< window_vl`` only). Returns ``(out, k_pool,
        v_pool)``."""
        if not self._self_attention:
            raise MXNetError("paged_window_step() updates a self-attention "
                             "cache; cross-attention uses attend()")
        q, k_t, v_t = self._qkv(query)
        B, S = query.shape[0], query.shape[1]
        page_size = k_pool.shape[1]
        P = page_table.shape[1]
        steps = torch.arange(S, device=query.device)
        abs_pos = pos.long()[:, None] + steps[None, :]
        live = active[:, None].expand(B, S)
        if window_vl is not None:
            live = live & (steps[None, :] < window_vl.long()[:, None])
        rows = torch.arange(B, device=query.device)[:, None]
        # a table column past the width clamps, as the JAX gather does
        slot = torch.where(live, abs_pos // page_size, 0).clamp(0, P - 1)
        page = torch.where(live, page_table[rows, slot].long(), 0)
        off = torch.where(live, abs_pos % page_size, 0)
        k_pool[page, off] = k_t.to(k_pool.dtype)
        v_pool[page, off] = v_t.to(v_pool.dtype)
        if self._causal:
            out = paged_window_attention(q.contiguous(), k_pool, v_pool,
                                         page_table, pos, window_vl,
                                         self._sm_scale())
        else:
            out = self._paged_dense(q, k_pool, v_pool, page_table, pos)
        return self._finish(out), k_pool, v_pool
