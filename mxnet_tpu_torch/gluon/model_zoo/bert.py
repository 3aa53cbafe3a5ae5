"""BERT encoder, the pretraining slice's model.

Counterpart of ``mxnet_tpu/gluon/model_zoo/bert.py:27-167, 215-232``:
``PositionwiseFFN``, the post-LN ``BERTEncoderLayer``, ``BERTEncoder``
(without ``remat``), ``BERTModel`` (embeddings, encoder, tanh pooler) and
``bert_base``. Parameter names match the JAX package's structural names
(``word_embed.weight``, ``encoder.layers.0.attention.qkv_proj.weight``,
``encoder.layers.0.ffn.ffn_1.bias``, ``pooler.weight``, ...), so
``mxnet_tpu_torch.convert`` loads its saved parameters one to one.
Self-attention runs through ``ops.contrib.flash_attention``: the dense
path up to ``MXTPU_ATTN_DENSE_MAX`` keys, kernels K2/B4 above; every
LayerNorm through K1/B2. ``PretrainLoss`` is ``bench.py``'s tied-embedding
masked-LM loss.
"""

from __future__ import annotations

import torch
from torch import nn

from ...context import resolve_device
from ...initializer import xavier_
from ..loss import SoftmaxCrossEntropyLoss
from ..nn import GELU, Dense, Dropout, Embedding, LayerNorm, \
    MultiHeadAttention

__all__ = ["PositionwiseFFN", "BERTEncoderLayer", "BERTEncoder",
           "BERTModel", "bert_base", "PretrainLoss"]


class PositionwiseFFN(nn.Module):
    def __init__(self, units, hidden_size, dropout, dtype, device):
        super().__init__()
        self.ffn_1 = Dense(hidden_size, units, flatten=False, dtype=dtype,
                           device=device)
        self.act = GELU()
        self.ffn_2 = Dense(units, hidden_size, flatten=False, dtype=dtype,
                           device=device)
        self.drop = Dropout(dropout)

    def forward(self, x):
        return self.drop(self.ffn_2(self.act(self.ffn_1(x))))


class BERTEncoderLayer(nn.Module):
    """Post-LN transformer encoder layer (original BERT arrangement)."""

    def __init__(self, units, hidden_size, num_heads, dropout, dtype,
                 device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attention = MultiHeadAttention(units, num_heads,
                                            dropout=dropout, **kw)
        self.ln_attn = LayerNorm(units, **kw)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout, **kw)
        self.ln_ffn = LayerNorm(units, **kw)
        self.drop = Dropout(dropout)

    def forward(self, x, valid_length=None):
        attn = self.drop(self.attention(x, valid_length=valid_length))
        x = self.ln_attn(x + attn)
        return self.ln_ffn(x + self.ffn(x))


class BERTEncoder(nn.Module):
    def __init__(self, num_layers, units, hidden_size, num_heads, dropout,
                 dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(
            BERTEncoderLayer(units, hidden_size, num_heads, dropout, dtype,
                             device)
            for _ in range(num_layers))

    def forward(self, x, valid_length=None):
        for layer in self.layers:
            x = layer(x, valid_length)
        return x


class BERTModel(nn.Module):
    """Embeddings + encoder + pooler.

    ``forward(token_ids, token_types=None, valid_length=None)`` ->
    ``(sequence_output (B, S, units), pooled_output (B, units))``;
    ``valid_length`` (B,) masks padding keys in every attention layer.
    ``device`` defaults to ``"cuda"`` (``MXNetError`` without a card);
    parameters start at zero (LayerNorm gamma at one) until
    ``initialize(seed)`` or ``convert.load_mxnet_tpu_params`` fills them.
    """

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 type_vocab_size=2, dropout=0.1, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(dtype=dtype, device=dev)
        self.word_embed = Embedding(vocab_size, units, **kw)
        self.token_type_embed = Embedding(type_vocab_size, units, **kw)
        self.position_embed = Embedding(max_length, units, **kw)
        self.embed_ln = LayerNorm(units, **kw)
        self.embed_drop = Dropout(dropout)
        self.encoder = BERTEncoder(num_layers, units, hidden_size, num_heads,
                                   dropout, dtype, dev)
        self.pooler = Dense(units, units, activation="tanh", flatten=False,
                            **kw)

    def initialize(self, seed=0):
        """Seeded Xavier init (``initializer.xavier_``)."""
        return xavier_(self, seed)

    def forward(self, token_ids, token_types=None, valid_length=None):
        B, S = token_ids.shape[0], token_ids.shape[1]
        positions = torch.arange(S, device=token_ids.device).reshape(
            1, S).expand(B, S)
        emb = self.word_embed(token_ids) + self.position_embed(positions)
        if token_types is not None:
            emb = emb + self.token_type_embed(token_types)
        emb = self.embed_drop(self.embed_ln(emb))
        seq = self.encoder(emb, valid_length)
        return seq, self.pooler(seq[:, 0, :])


def bert_base(**kwargs):
    """BERT-base width: units 768, FFN 3072, 12 layers, 12 heads."""
    return BERTModel(units=768, hidden_size=3072, num_layers=12,
                     num_heads=12, **kwargs)


class PretrainLoss:
    """``bench.py:51-65``: logits of the sequence output against the tied
    word embedding, then ``SoftmaxCrossEntropyLoss`` over every position.
    The embedding is read from ``net`` at call time, so ``TrainStep``'s
    cast parameters are the ones used."""

    def __init__(self, net):
        self.net = net
        self.ce = SoftmaxCrossEntropyLoss()

    def __call__(self, seq_out, pooled, label):
        w = self.net.word_embed.weight
        logits = seq_out.reshape(-1, seq_out.shape[-1]) @ w.t()
        return self.ce(logits, label.reshape(-1))
