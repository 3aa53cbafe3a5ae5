"""Fused attention op of the serving and training slices.

Counterpart of ``_flash_attention_op`` in ``mxnet_tpu/ops/contrib.py``
(:504-559) in its BSHD layout, the one the port's models use, with the
same routing: an offset query (``q_offset``), a single query, or
``max(Sq, Sk) <= MXTPU_ATTN_DENSE_MAX`` (default 256, read per call,
:438-441) takes the exact dense path, differentiated by torch autograd as
the JAX package leaves it to XLA; everything else goes through a BHSD
transpose (:549-553) to kernel K2, differentiated by kernels B4a and B4b
(the JAX package's ``flash_attention`` custom_vjp). The port has one
backward; the JAX package's ``MXTPU_FLASH_BWD`` picks between two
implementations of the same math, both oracles for it.
"""

from __future__ import annotations

import math
import os

import torch

from .kernels.flash_attention import (flash_attention_bwd,
                                      flash_attention_fwd)

__all__ = ["flash_attention"]


def _dense_max_seq() -> int:
    return int(os.environ.get("MXTPU_ATTN_DENSE_MAX", "256"))


def _masked_softmax_probs(s, valid_length, causal, q_offset=None):
    """Mask + softmax over f32 scores (B, H, Sq, Sk) as ``:444-471``: keys
    past valid_length and acausal keys drop out; ``q_offset`` (scalar or
    (B,)) shifts query positions; rows left with no key give zeros, not
    the NaN a softmax over all -inf yields."""
    Sq, Sk = s.shape[2], s.shape[3]
    dev = s.device
    if valid_length is not None:
        vl = torch.as_tensor(valid_length, device=dev).long()
        mask = torch.arange(Sk, device=dev).view(1, 1, 1, Sk) < \
            vl.view(-1, 1, 1, 1)
        s = torch.where(mask, s, -math.inf)
    if causal:
        qi = torch.arange(Sq, device=dev).view(1, 1, Sq, 1)
        ki = torch.arange(Sk, device=dev).view(1, 1, 1, Sk)
        if q_offset is not None:
            off = torch.as_tensor(q_offset, device=dev).long()
            qi = qi + off.reshape(-1, 1, 1, 1)
        s = torch.where(qi >= ki, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    if valid_length is not None:
        p = torch.where(torch.isfinite(s).any(dim=-1, keepdim=True), p, 0.0)
    return p


def _dense_attention_bshd(q, k, v, valid_length, causal, sm_scale,
                          q_offset=None):
    """Exact attention over (B, S, H, D) operands (``:489``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    p = _masked_softmax_probs(s, valid_length, causal, q_offset)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)


class _FlashAttentionFn(torch.autograd.Function):
    """K2 forward, B4a + B4b backward over contiguous (B, H, S, D)
    operands; ``valid_length`` None means full length (``:494-495``)."""

    @staticmethod
    def forward(ctx, q, k, v, valid_length, causal, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, valid_length, causal,
                                       sm_scale)
        ctx.save_for_backward(q, k, v, valid_length, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, valid_length, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, valid_length, out, lse,
                                         do.contiguous(), ctx.causal,
                                         ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(query, key, value, valid_length=None, causal=False,
                    sm_scale=None, q_offset=None):
    """Softmax attention over (B, S, H, D) operands. ``valid_length``
    (B,) masks padding keys; ``q_offset`` (scalar or (B,)) is the
    absolute position of query row 0 for the causal mask (incremental
    decode)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(query.shape[-1])
    Sq, Sk = query.shape[1], key.shape[1]
    if q_offset is not None or Sq == 1 or max(Sq, Sk) <= _dense_max_seq():
        return _dense_attention_bshd(query, key, value, valid_length,
                                     bool(causal), float(sm_scale),
                                     q_offset)
    vl = None if valid_length is None else torch.as_tensor(
        valid_length, device=query.device).to(torch.int32).contiguous()
    tq, tk, tv = (x.transpose(1, 2).contiguous()
                  for x in (query, key, value))
    out = _FlashAttentionFn.apply(tq, tk, tv, vl, bool(causal),
                                  float(sm_scale))
    return out.transpose(1, 2)
