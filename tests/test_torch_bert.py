"""The port's BERT and its layers against the JAX package's, on the CPU.

A tiny BERT (2 layers, units 128 so every LayerNorm takes the kernel
route, 2 heads, FFN 512, vocab 97) is built and initialised by the JAX
package, saved with ``save_parameters`` and carried into the port through
``mxnet_tpu_torch.convert``. The same numpy token ids, token types and
ragged valid lengths then go through both models' forward, on the dense
attention path and (``MXTPU_ATTN_DENSE_MAX=0`` on both sides) on the
flash path: the Pallas kernel in interpret mode / the port's plain K2.

Tolerance: float32 on both sides, two layers deep, summed in different
orders: 1e-5 absolute and relative on O(1) activations.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JaxBERT
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.convert import load_mxnet_tpu_params, read_params_npz
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import BERTModel
from mxnet_tpu_torch.gluon.nn import Dropout

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(vocab_size=97, units=128, hidden_size=512, num_layers=2,
           num_heads=2, max_length=64, dropout=0.0)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    mx.random.seed(0)
    jnet = JaxBERT(**CFG)
    jnet.initialize(mx.initializer.Xavier())
    jnet._probe_shapes(nd.zeros((2, 8), dtype="int32"))
    path = str(tmp_path_factory.mktemp("params") / "bert.npz")
    jnet.save_parameters(path)
    tnet = BERTModel(device="cpu", **CFG).eval()
    load_mxnet_tpu_params(path, tnet)
    return jnet, tnet, path


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else
                      getattr(x, "data", x))


def test_every_parameter_carried(models):
    _, tnet, path = models
    arrays = read_params_npz(path)
    assert set(arrays) == set(dict(tnet.named_parameters()))
    for name, p in tnet.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), arrays[name])


@pytest.mark.parametrize("dense_max", ["256", "0"])
def test_forward_matches_jax(models, monkeypatch, dense_max):
    """Sequence and pooled outputs with token types and padding masked
    (valid lengths S, 1 and a ragged one)."""
    monkeypatch.setenv("MXTPU_ATTN_DENSE_MAX", dense_max)
    jnet, tnet, _ = models
    rng = np.random.RandomState(1)
    ids = rng.randint(0, CFG["vocab_size"], size=(3, 24)).astype(np.int32)
    types = (np.arange(24)[None, :] >= 10).astype(np.int32).repeat(3, 0)
    vl = np.array([24, 1, 17], np.int32)
    want = jnet(nd.array(ids, dtype="int32"), nd.array(types, dtype="int32"),
                nd.array(vl, dtype="int32"))
    with torch.no_grad():
        got = tnet(*(torch.from_numpy(a) for a in (ids, types, vl)))
    for w, g in zip(want, got):  # sequence, pooled
        assert np.isfinite(_np(g)).all()
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.RandomState(2)
    logits = (rng.randn(6, 11) * 3).astype(np.float32)
    label = rng.randint(0, 11, size=(6,)).astype(np.int32)
    want = jgluon.loss.SoftmaxCrossEntropyLoss()(
        nd.array(logits), nd.array(label, dtype="int32"))
    got = SoftmaxCrossEntropyLoss()(torch.from_numpy(logits),
                                    torch.from_numpy(label))
    assert got.shape == (6,)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_dropout_mask_follows_the_seed():
    """One seed repeats the mask, another seed changes it; kept elements
    are scaled by 1/(1-p); eval mode is the identity."""
    x = torch.ones((64, 128))
    drop = Dropout(0.25).train()

    def mask(seed):
        trandom.seed(seed)
        return drop(x)

    a, b, c = mask(7), mask(7), mask(8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    torch.testing.assert_close(torch.unique(a),
                               torch.tensor([0.0, 1.0 / 0.75]))
    assert 0.2 < float((a == 0).float().mean()) < 0.3
    assert torch.equal(drop.eval()(x), x)
