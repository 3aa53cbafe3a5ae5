"""Transformer encoder-decoder, serving protocol.

Counterpart of ``mxnet_tpu/gluon/model_zoo/transformer.py``: the pre-LN
encoder and decoder layers, ``TransformerModel`` with tied logits and its
paged decode protocol (``init_paged_state`` / ``prefill_paged`` /
``decode_step_paged``, and the forced-prefix replay
``prefill_suffix_paged`` over ``decode_window_paged``), and
``transformer_base``. Parameter names match
the JAX package's structural names (``encoder.layers.0.ln1.gamma``,
``decoder.layer0.self_attn.qkv_proj.weight``, ...), so
``mxnet_tpu_torch.convert`` loads its saved parameters one to one.

The paged state is a dict of tensors updated IN PLACE (the JAX package
returns new arrays): per-decoder-layer ``k_pools``/``v_pools``
``(num_pages, page_size, H, D)``, per-slot cross-attention memory
``cross_k``/``cross_v`` ``(slots, mem_len, H, D)`` and ``mem_vl``
``(slots,)`` int32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...initializer import xavier_
from ..nn import Dense, Dropout, Embedding, LayerNorm, MultiHeadAttention

__all__ = ["TransformerModel", "transformer_base"]


class _FFN(nn.Module):
    def __init__(self, units, hidden_size, dropout, dtype, device):
        super().__init__()
        self.ffn_1 = Dense(hidden_size, units, activation="relu",
                           flatten=False, dtype=dtype, device=device)
        self.ffn_2 = Dense(units, hidden_size, flatten=False, dtype=dtype,
                           device=device)
        self.drop = Dropout(dropout)

    def forward(self, x):
        return self.drop(self.ffn_2(self.ffn_1(x)))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, units, hidden_size, num_heads, dropout, dtype,
                 device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = LayerNorm(units, **kw)
        self.attn = MultiHeadAttention(units, num_heads, dropout=dropout,
                                       **kw)
        self.ln2 = LayerNorm(units, **kw)
        self.ffn = _FFN(units, hidden_size, dropout, **kw)
        self.drop = Dropout(dropout)

    def forward(self, x, valid_length=None):
        x = x + self.drop(self.attn(self.ln1(x), valid_length=valid_length))
        return x + self.ffn(self.ln2(x))


class TransformerDecoderLayer(nn.Module):
    def __init__(self, units, hidden_size, num_heads, dropout, dtype,
                 device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = LayerNorm(units, **kw)
        self.self_attn = MultiHeadAttention(units, num_heads,
                                            dropout=dropout, causal=True,
                                            **kw)
        self.ln2 = LayerNorm(units, **kw)
        self.cross_attn = MultiHeadAttention(units, num_heads,
                                             dropout=dropout,
                                             self_attention=False, **kw)
        self.ln3 = LayerNorm(units, **kw)
        self.ffn = _FFN(units, hidden_size, dropout, **kw)
        self.drop = Dropout(dropout)

    def prefill(self, x, memory, mem_valid_length=None):
        """Full-prefix forward seeding the decode state: ``(y, (k_self,
        v_self), (k_mem, v_mem))`` (``:96``)."""
        a, k_s, v_s = self.self_attn.prefill(self.ln1(x))
        x = x + self.drop(a)
        k_m, v_m = self.cross_attn.project_kv(memory)
        c = self.cross_attn.attend(self.ln2(x), k_m, v_m,
                                   valid_length=mem_valid_length)
        x = x + self.drop(c)
        y = x + self.ffn(self.ln3(x))
        return y, (k_s, v_s), (k_m, v_m)

    def step_paged(self, x, k_pool, v_pool, page_table, pos, active,
                   cross_kv, mem_valid_length=None):
        """One token per row over the paged pool (``:124``)."""
        a, k_pool, v_pool = self.self_attn.paged_step(
            self.ln1(x), k_pool, v_pool, page_table, pos, active)
        x = x + self.drop(a)
        c = self.cross_attn.attend(self.ln2(x), cross_kv[0], cross_kv[1],
                                   valid_length=mem_valid_length)
        x = x + self.drop(c)
        y = x + self.ffn(self.ln3(x))
        return y, k_pool, v_pool

    def step_window_paged(self, x, k_pool, v_pool, page_table, pos, active,
                          cross_kv, mem_valid_length=None, window_vl=None):
        """``step_paged`` widened to an S-token window at per-row
        positions ``pos[b] + i``, all in one pass (``:138``);
        ``window_vl`` marks each row's padding tail."""
        a, k_pool, v_pool = self.self_attn.paged_window_step(
            self.ln1(x), k_pool, v_pool, page_table, pos, active,
            window_vl=window_vl)
        x = x + self.drop(a)
        c = self.cross_attn.attend(self.ln2(x), cross_kv[0], cross_kv[1],
                                   valid_length=mem_valid_length)
        x = x + self.drop(c)
        y = x + self.ffn(self.ln3(x))
        return y, k_pool, v_pool


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers, units, hidden_size, num_heads, dropout,
                 dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(units, hidden_size, num_heads, dropout,
                                    dtype, device)
            for _ in range(num_layers))
        self.ln = LayerNorm(units, dtype=dtype, device=device)

    def forward(self, x, valid_length=None):
        for layer in self.layers:
            x = layer(x, valid_length=valid_length)
        return self.ln(x)


class TransformerDecoder(nn.Module):
    """Layers are attributes ``layer0``, ``layer1``, ... as in the JAX
    package, so the parameter names match."""

    def __init__(self, num_layers, units, hidden_size, num_heads, dropout,
                 dtype, device):
        super().__init__()
        self._n = num_layers
        for i in range(num_layers):
            setattr(self, f"layer{i}",
                    TransformerDecoderLayer(units, hidden_size, num_heads,
                                            dropout, dtype, device))
        self.ln = LayerNorm(units, dtype=dtype, device=device)

    def layer(self, i):
        return getattr(self, f"layer{i}")


class TransformerModel(nn.Module):
    """Encoder-decoder with tied target embedding / output projection.

    ``device`` defaults to ``"cuda"`` (``MXNetError`` without a card);
    parameters start at zero (LayerNorm gamma at one) until
    ``initialize(seed)`` or ``convert.load_mxnet_tpu_params`` fills
    them."""

    def __init__(self, src_vocab=32768, tgt_vocab=32768, units=512,
                 hidden_size=2048, num_layers=6, num_heads=8,
                 max_length=1024, dropout=0.1, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self._units = units
        self.src_embed = Embedding(src_vocab, units, dtype=dtype, device=dev)
        self.tgt_embed = Embedding(tgt_vocab, units, dtype=dtype, device=dev)
        self.pos_embed = Embedding(max_length, units, dtype=dtype,
                                   device=dev)
        self.drop = Dropout(dropout)
        self.encoder = TransformerEncoder(num_layers, units, hidden_size,
                                          num_heads, dropout, dtype, dev)
        self.decoder = TransformerDecoder(num_layers, units, hidden_size,
                                          num_heads, dropout, dtype, dev)

    @property
    def device(self) -> torch.device:
        return self.tgt_embed.weight.device

    def initialize(self, seed=0):
        """Seeded Xavier init (``initializer.xavier_``), the JAX package's
        ``initializer.Xavier()`` on every weight; biases and beta zero,
        gamma one."""
        return xavier_(self, seed)

    def _embed(self, embed, ids):
        B, S = ids.shape[0], ids.shape[1]
        pos = torch.arange(S, device=ids.device).reshape(1, S).expand(B, S)
        return self.drop(embed(ids) * (self._units ** 0.5)
                         + self.pos_embed(pos))

    def _embed_step(self, tokens, pos):
        """Single-position target embedding; ``pos`` scalar or (B,)."""
        B = tokens.shape[0]
        ids = tokens.reshape(B, 1)
        pos_ids = torch.as_tensor(pos, device=tokens.device).reshape(
            -1, 1).expand(B, 1)
        return self.drop(self.tgt_embed(ids) * (self._units ** 0.5)
                         + self.pos_embed(pos_ids))

    def _embed_window(self, tokens, pos):
        """Target embedding of an S-token window: row ``r``'s token ``j``
        at position ``pos[r] + j`` (``:548-550``)."""
        S = tokens.shape[1]
        pos_ids = pos.long()[:, None] + torch.arange(S, device=tokens.device)
        return self.drop(self.tgt_embed(tokens) * (self._units ** 0.5)
                         + self.pos_embed(pos_ids))

    def _logits(self, out):
        """Tied logits ``out @ W_tgt_embedᵀ`` (``:239-243``)."""
        return torch.matmul(out, self.tgt_embed.weight.t())

    def encode(self, src_ids, valid_length=None):
        """Source ids -> (B, S, units) memory; padding past
        ``valid_length`` is masked out of attention."""
        return self.encoder(self._embed(self.src_embed, src_ids),
                            valid_length=valid_length)

    def prefill_parts(self, src_ids, tgt_prefix, src_valid_length=None):
        """Encode the source and run the target prefix: ``(last_logits,
        [(k_s, v_s)], [(k_m, v_m)], mem_vl)`` (``:294``)."""
        memory = self.encode(src_ids, src_valid_length)
        x = self._embed(self.tgt_embed, tgt_prefix)
        self_parts, cross_parts = [], []
        for i in range(self.decoder._n):
            x, kv_s, kv_m = self.decoder.layer(i).prefill(
                x, memory, mem_valid_length=src_valid_length)
            self_parts.append(kv_s)
            cross_parts.append(kv_m)
        out = self.decoder.ln(x)
        logits = self._logits(out[:, -1:, :])[:, 0]
        return logits, self_parts, cross_parts, src_valid_length

    # -------------------------------------------------------- paged decode
    def init_paged_state(self, slots, num_pages, page_size, mem_len,
                         dtype=None):
        """Zeroed paged decode state (``:364``): ``num_pages`` counts
        every pool row, the trash page included."""
        k_pools, v_pools, cross_k, cross_v = [], [], [], []
        for i in range(self.decoder._n):
            layer = self.decoder.layer(i)
            kp, vp = layer.self_attn.init_page_pool(num_pages, page_size,
                                                    dtype)
            k_pools.append(kp)
            v_pools.append(vp)
            ca = layer.cross_attn
            shape = (int(slots), int(mem_len), ca._num_heads, ca._head_dim)
            dt = kp.dtype
            cross_k.append(torch.zeros(shape, dtype=dt, device=self.device))
            cross_v.append(torch.zeros(shape, dtype=dt, device=self.device))
        return {"k_pools": k_pools, "v_pools": v_pools,
                "cross_k": cross_k, "cross_v": cross_v,
                "mem_vl": torch.zeros((int(slots),), dtype=torch.int32,
                                      device=self.device)}

    def prefill_paged(self, src_ids, tgt_prime, src_valid_length, state,
                      slot_ids, first_pages, active):
        """Admission prefill into pages (``:390``): row ``r``'s BOS K/V go
        to ``(first_pages[r], 0)`` (trash page 0 when inactive) and its
        memory projections to slot ``slot_ids[r]``. Padding rows carry the
        out-of-range slot id ``slots``; the JAX package relies on scatter
        semantics to drop those writes, torch indexing would raise or write
        out of bounds, so they are masked here. Returns ``(last_logits,
        state)``."""
        if tgt_prime.shape[1] != 1:
            raise MXNetError("prefill_paged primes with a single BOS column")
        logits, self_parts, cross_parts, vl = self.prefill_parts(
            src_ids, tgt_prime, src_valid_length)
        B, S = src_ids.shape[0], src_ids.shape[1]
        slots, mem_len = state["cross_k"][0].shape[:2]
        if S > mem_len:
            raise MXNetError(f"source width {S} exceeds the paged state's "
                             f"memory width {mem_len}")
        pages = torch.where(active, first_pages.long(), 0)
        keep = (slot_ids >= 0) & (slot_ids < slots)
        sid = slot_ids[keep].long()
        for i in range(self.decoder._n):
            k_s, v_s = self_parts[i]
            kp, vp = state["k_pools"][i], state["v_pools"][i]
            kp[pages, 0] = k_s[:, 0].to(kp.dtype)
            vp[pages, 0] = v_s[:, 0].to(vp.dtype)
            for buf, part in ((state["cross_k"][i], cross_parts[i][0]),
                              (state["cross_v"][i], cross_parts[i][1])):
                padded = F.pad(part[keep], (0, 0, 0, 0, 0, mem_len - S))
                buf[sid] = padded.to(buf.dtype)
        if vl is None:
            vl = torch.full((B,), S, dtype=torch.int32, device=self.device)
        state["mem_vl"][sid] = vl[keep].to(torch.int32)
        return logits, state

    def decode_step_paged(self, tokens, pos, state, page_tables, active):
        """One decode step over the slot batch (``:565``): ``tokens``
        (slots,) at per-row positions ``pos`` (slots,) int32, read and
        written through ``page_tables`` (slots, P) int32. Inactive rows
        write the trash page and their logits are garbage. Returns
        ``(logits (slots, vocab), state)``."""
        x = self._embed_step(tokens, pos)
        for i in range(self.decoder._n):
            x, _, _ = self.decoder.layer(i).step_paged(
                x, state["k_pools"][i], state["v_pools"][i], page_tables,
                pos, active, (state["cross_k"][i], state["cross_v"][i]),
                mem_valid_length=state["mem_vl"])
        out = self.decoder.ln(x)
        return self._logits(out)[:, 0], state

    def decode_window_paged(self, tokens, pos, state, page_tables, active,
                            window_vl=None):
        """An S-token window through the paged cache in one forward
        (``:526-563``): ``tokens`` (rows, S) at per-row positions ``pos[r]
        + j`` (``pos`` (rows,) int32); ``window_vl`` (rows,) int32 marks
        tokens ``>= window_vl[r]`` as padding (their K/V go to the trash
        page, their logits are garbage). Returns ``(logits (rows, S,
        vocab), state)``; column ``j`` predicts position ``pos[r] + j +
        1``, as ``decode_step_paged`` run position by position does up to
        float rounding."""
        x = self._embed_window(tokens, pos)
        for i in range(self.decoder._n):
            x, _, _ = self.decoder.layer(i).step_window_paged(
                x, state["k_pools"][i], state["v_pools"][i], page_tables,
                pos, active, (state["cross_k"][i], state["cross_v"][i]),
                mem_valid_length=state["mem_vl"], window_vl=window_vl)
        return self._logits(self.decoder.ln(x)), state

    def prefill_suffix_paged(self, tokens, token_vl, q_offset, state,
                             page_tables, slot_ids, active, wide=False):
        """Replay a forced target history into the rows' pages
        (``:442-524``): ``tokens`` (rows, S) left-aligned, ``token_vl``
        (rows,) of them real, at absolute positions ``q_offset[r] + j``,
        read and written through ``page_tables`` (rows, P). The slots'
        cross memory and ``mem_vl`` must already be in ``state`` (a prior
        ``prefill_paged``); no encoder runs. Padding rows carry the
        out-of-range slot id ``slots``: the JAX gather clamps it, torch
        indexing would raise, so the index is clamped here, and an empty
        slot's ``mem_vl`` of 0 is raised to 1 so that its masked softmax
        stays finite; their outputs are discarded.

        The sequential form runs one ``decode_step_paged`` per position
        with ``live = active & (j < token_vl)``, the bit-exact stream;
        ``wide=True`` runs one ``decode_window_paged`` pass (kernel B6 on
        the card), the same math rounded in another order. Returns
        ``(logits (rows, vocab) at position token_vl - 1, state)``."""
        slots = state["cross_k"][0].shape[0]
        sid = slot_ids.long().clamp(0, slots - 1)
        sub = {"k_pools": state["k_pools"], "v_pools": state["v_pools"],
               "cross_k": [c[sid] for c in state["cross_k"]],
               "cross_v": [c[sid] for c in state["cross_v"]],
               "mem_vl": state["mem_vl"][sid].clamp(min=1)}
        B, S = tokens.shape
        if wide:
            logits, _ = self.decode_window_paged(
                tokens, q_offset, sub, page_tables, active,
                window_vl=token_vl)
            idx = (token_vl.long() - 1).clamp(0, S - 1)
            return logits[torch.arange(B, device=logits.device), idx], state
        last = None
        for j in range(S):
            lg, _ = self.decode_step_paged(
                tokens[:, j], q_offset + j, sub, page_tables,
                active & (j < token_vl))
            last = lg if last is None else \
                torch.where((token_vl == j + 1)[:, None], lg, last)
        return last, state


def transformer_base(**kwargs):
    """Transformer-base width: units 512, FFN 2048, 6+6 layers, 8 heads."""
    return TransformerModel(units=512, hidden_size=2048, num_layers=6,
                            num_heads=8, **kwargs)
