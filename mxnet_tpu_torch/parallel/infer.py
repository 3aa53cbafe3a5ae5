"""Serving engine over a paged-protocol model.

Counterpart of ``mxnet_tpu/parallel/infer.py`` (``InferStep``), paged
protocol only: ``init_paged_state`` (``:449``), ``prefill_paged``
(``:558``), the forced-prefix replay ``prefill_suffix_paged`` (``:585``)
and ``decode_iter`` (``:621``), greedy sampling (``_sample_tokens``,
``:59-74``). PyTorch runs eagerly, so the jitted
programs become plain calls and ``decode_iter``'s ``fori_loop`` a Python
loop; every call runs the model in eval mode under
``torch.inference_mode()`` and performs no host sync (the tokens it
returns stay on the device until the caller reads them). Paged state is
updated in place.
"""

from __future__ import annotations

import functools

import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["InferStep"]


def _sample_tokens(logits):
    """Greedy next-token choice from (B, V) logits (``top_k`` and
    ``sample`` are not ported yet)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _inference(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.inference_mode():
            return fn(*args, **kwargs)
    return wrapped


class InferStep:
    """Serving engine over ``net`` (a model with ``init_paged_state`` /
    ``prefill_paged`` / ``decode_step_paged``).

    ``device`` defaults to ``"cuda"``; without a card that raises
    ``MXNetError`` (pass ``device="cpu"`` to run on the CPU). The net is
    moved to the device and put in eval mode."""

    def __init__(self, net, bos_id: int = 1, eos_id: int = 2,
                 pad_id: int = 0, device="cuda"):
        self.device = resolve_device(device)
        for attr in ("init_paged_state", "prefill_paged",
                     "decode_step_paged"):
            if not hasattr(net, attr):
                raise MXNetError(f"{type(net).__name__} does not implement "
                                 f"the paged protocol ({attr})")
        self._net = net.to(self.device).eval()
        self._bos, self._eos, self._pad = int(bos_id), int(eos_id), \
            int(pad_id)

    def _tensor(self, x, dtype):
        return torch.as_tensor(x, device=self.device).to(dtype)

    @_inference
    def init_paged_state(self, slots, num_pages, page_size, mem_len):
        """Zeroed pools and slot buffers. ``num_pages`` counts allocatable
        pages; one extra trash page (id 0) is added, matching
        ``serving.pages.PagePool`` ids."""
        return self._net.init_paged_state(int(slots), int(num_pages) + 1,
                                          int(page_size), int(mem_len))

    @_inference
    def prefill_paged(self, state, src, src_valid_length, slot_ids,
                      first_pages, active):
        """One admission: prefill the padded batch into pages and slot
        buffers, choose each row's first token. Returns ``(tok0 (rows,)
        int32 tensor on the device, state)``."""
        src = self._tensor(src, torch.int64)
        vl = self._tensor(src_valid_length, torch.int32)
        prime = torch.full((src.shape[0], 1), self._bos, dtype=torch.int64,
                           device=self.device)
        logits, state = self._net.prefill_paged(
            src, prime, vl, state, self._tensor(slot_ids, torch.int64),
            self._tensor(first_pages, torch.int64),
            self._tensor(active, torch.bool))
        return _sample_tokens(logits.float()), state

    @_inference
    def prefill_suffix_paged(self, state, tokens, token_vl, q_offset,
                             page_tables, slot_ids, active, wide=False):
        """Replay each row's forced history (``tokens`` (rows, S), the
        first ``token_vl[r]`` real, at positions ``q_offset[r] + j``) into
        its pages and choose its first new token; the slots' cross memory
        comes from an earlier ``prefill_paged``, no encoder runs.
        ``wide`` replays in one window pass (kernel B6 on the card) in
        place of one decode step per position. Padding rows carry slot id
        ``slots`` and an all-trash table. Returns ``(tok0 (rows,) int32
        tensor on the device, state)``."""
        logits, state = self._net.prefill_suffix_paged(
            self._tensor(tokens, torch.int32),
            self._tensor(token_vl, torch.int32),
            self._tensor(q_offset, torch.int32), state,
            self._tensor(page_tables, torch.int32),
            self._tensor(slot_ids, torch.int64),
            self._tensor(active, torch.bool), wide=bool(wide))
        return _sample_tokens(logits.float()), state

    @_inference
    def decode_iter(self, state, page_tables, tokens, lengths, active,
                    steps=1):
        """``steps`` decode tokens for every live row (``:519-544``). Row
        ``r``'s step ``j`` places its previous token at position
        ``lengths[r] + j``; a row that emits EOS is finished for the rest
        of the burst (its later tokens are ``pad_id`` and its writes go
        to the trash page). Returns ``(buf (slots, steps) int32 tensor,
        state)``."""
        steps = max(int(steps), 1)
        tables = self._tensor(page_tables, torch.int32)
        tok = self._tensor(tokens, torch.int32)
        lengths = self._tensor(lengths, torch.int32)
        fin = ~self._tensor(active, torch.bool)
        buf = torch.full((tok.shape[0], steps), self._pad, dtype=torch.int32,
                         device=self.device)
        for j in range(steps):
            logits, state = self._net.decode_step_paged(
                tok, lengths + j, state, tables, ~fin)
            nxt = _sample_tokens(logits.float())
            nxt = torch.where(fin, self._pad, nxt)
            buf[:, j] = nxt
            fin = fin | (nxt == self._eos)
            tok = nxt
        return buf, state
