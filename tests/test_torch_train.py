"""The port's ``TrainStep`` against the JAX package's, on the CPU.

A tiny BERT (2 layers, units 128, 2 heads, FFN 512, vocab 97, dropout 0)
is built and initialised by the JAX package, saved with
``save_parameters`` and carried into the port through
``mxnet_tpu_torch.convert``. Both packages then train it for three AdamW
steps under ``bench.py``'s tied-embedding masked-LM loss, on the same
numpy batch with token types and ragged valid lengths (S, 1 and one
between), on the dense attention path and on the flash path
(``MXTPU_ATTN_DENSE_MAX=0`` on both sides: the Pallas forward in
interpret mode and the JAX backward / the port's plain K2 and B4).

Tolerance: in float32 both sides differ only in summation order, so the
losses and every parameter after three steps agree within 1e-5
(absolute and relative). The key-projection bias has a gradient that is
zero in exact arithmetic (softmax ignores a shift shared by all keys), so
AdamW's normalised step turns round-off there into parameter
differences that grow with the learning rate; at ``bench.py``'s 1e-4
they stay well inside 1e-5. Under ``compute_dtype="bfloat16"`` the two
frameworks round the bf16 activations at different places; the losses
agree within 2e-2 relative.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JaxBERT
from mxnet_tpu.parallel import TrainStep as JaxTrainStep
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon.model_zoo import BERTModel, PretrainLoss
from mxnet_tpu_torch.optimizer import AdamW
from mxnet_tpu_torch.parallel import TrainStep

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(vocab_size=97, units=128, hidden_size=512, num_layers=2,
           num_heads=2, max_length=64, dropout=0.0)
STEPS = 3
OPT = dict(learning_rate=1e-4, wd=0.01)  # bench.py's learning rate


@pytest.fixture(autouse=True)
def _jax_telemetry_to_tmp(tmp_path):
    """If another test in this process enabled the JAX package's
    telemetry, keep whatever its TrainStep records out of the repo's
    ``telemetry/`` directory."""
    tel = mx.telemetry
    saved = tel._LOG
    if saved is not None:
        tel._LOG = tel.EventLog(str(tmp_path / "telemetry"))
    yield
    if saved is not None:
        tel._LOG.close()
        tel._LOG = saved


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    mx.random.seed(0)
    jnet = JaxBERT(**CFG)
    jnet.initialize(mx.initializer.Xavier())
    jnet._probe_shapes(nd.zeros((2, 8), dtype="int32"))
    path = str(tmp_path_factory.mktemp("params") / "bert.npz")
    jnet.save_parameters(path)
    return path


def _batch():
    rng = np.random.RandomState(3)
    B, S, V = 4, 24, CFG["vocab_size"]
    ids = rng.randint(0, V, size=(B, S)).astype(np.int32)
    types = (np.arange(S)[None, :] >= 12).astype(np.int32).repeat(B, 0)
    vl = np.array([24, 1, 17, 9], np.int32)
    labels = rng.randint(0, V, size=(B, S)).astype(np.int32)
    return ids, types, vl, labels


def _jax_run(path, compute_dtype, steps=STEPS, multipliers=None):
    jnet = JaxBERT(**CFG)
    jnet.initialize()
    jnet._probe_shapes(nd.zeros((2, 8), dtype="int32"))
    jnet.load_parameters(path)
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()
    word_w = jnet.word_embed.weight

    class JaxPretrainLoss:  # bench.py:51-65
        def __call__(self, seq_out, pooled, label):
            logits = seq_out.reshape(-1, seq_out.shape[-1]).dot(
                word_w.data().T)
            return ce(logits, label.reshape(-1))

    opt = jopt.AdamW(**OPT)
    if multipliers is not None:
        multipliers(jnet._collect_params_with_prefix(), opt)
    step = JaxTrainStep(jnet, JaxPretrainLoss(), opt,
                        compute_dtype=compute_dtype,
                        state_dtype=compute_dtype)
    batch = [nd.array(a, dtype="int32") for a in _batch()]
    losses = [float(step(*batch).asscalar()) for _ in range(steps)]
    step.sync_params()
    params = {n: p.data().asnumpy()
              for n, p in jnet._collect_params_with_prefix().items()}
    return losses, params


def _port_step(path, compute_dtype=None, steps_per_call=1):
    net = BERTModel(device="cpu", **CFG)
    load_mxnet_tpu_params(path, net)
    return net, TrainStep(net, PretrainLoss(net), AdamW(**OPT),
                          compute_dtype=compute_dtype,
                          state_dtype=compute_dtype,
                          steps_per_call=steps_per_call, device="cpu")


def _port_run(path, compute_dtype=None):
    net, step = _port_step(path, compute_dtype)
    losses = [float(step(*_batch())) for _ in range(STEPS)]
    return losses, {n: p.detach().numpy()
                    for n, p in net.named_parameters()}


@pytest.mark.parametrize("dense_max", ["256", "0"])
def test_float32_steps_match_jax(saved, monkeypatch, dense_max):
    monkeypatch.setenv("MXTPU_ATTN_DENSE_MAX", dense_max)
    want_l, want_p = _jax_run(saved, None)
    got_l, got_p = _port_run(saved)
    np.testing.assert_allclose(got_l, want_l, **TOL)
    assert got_l[-1] < got_l[0]
    assert set(got_p) == set(want_p)
    for n in want_p:
        np.testing.assert_allclose(got_p[n], want_p[n], err_msg=n, **TOL)
    # no gradient reaches the pooler: with wd it only decays
    pooler = want_p["pooler.weight"]
    assert np.abs(pooler).max() > 0
    np.testing.assert_allclose(got_p["pooler.weight"], pooler, **TOL)


def test_bfloat16_losses_match_jax(saved):
    want_l, _ = _jax_run(saved, "bfloat16")
    got_l, got_p = _port_run(saved, "bfloat16")
    np.testing.assert_allclose(got_l, want_l, rtol=2e-2)
    assert all(p.dtype == np.float32 for p in got_p.values())  # masters


def test_steps_per_call_equals_single_steps(saved):
    """One call with ``steps_per_call=2`` on two stacked microbatches
    gives the parameters of two single steps and their mean loss."""
    ids, types, vl, labels = _batch()
    half = [a[:2] for a in (ids, types, vl, labels)], \
        [a[2:] for a in (ids, types, vl, labels)]
    net1, step1 = _port_step(saved)
    single = [float(step1(*mb)) for mb in half]
    net2, step2 = _port_step(saved, steps_per_call=2)
    both = float(step2(ids, types, vl, labels))
    np.testing.assert_allclose(both, np.mean(single), rtol=1e-6)
    for (n, a), (_, b) in zip(net1.named_parameters(),
                              net2.named_parameters()):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy(), err_msg=n)


def _multipliers(params, opt):
    """``lr_mult`` 0 on a parameter with a gradient, ``wd_mult`` 0 on one
    without (the pooler, which otherwise only decays), both set on the
    parameters; and an optimizer ``set_lr_mult`` on a third, which both
    packages' ``TrainStep`` ignore."""
    params["word_embed.weight"].lr_mult = 0.0
    params["pooler.weight"].wd_mult = 0.0
    opt.set_lr_mult({"position_embed.weight": 0.0})


def test_lr_and_wd_multipliers(saved):
    """``lr_mult`` 0 on a parameter freezes it although it has a
    gradient; ``wd_mult`` 0 stops the decay of one that has none (the
    pooler); the optimizer's ``set_lr_mult`` dict is not read, so the
    parameter it names moves."""
    net, step = _port_step(saved)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    _multipliers(dict(net.named_parameters()), step._optimizer)
    step(*_batch())
    after = dict(net.named_parameters())
    for frozen in ("word_embed.weight", "pooler.weight"):
        assert torch.equal(after[frozen], before[frozen]), frozen
    for moved in ("token_type_embed.weight", "position_embed.weight"):
        assert not torch.equal(after[moved], before[moved]), moved


def test_multipliers_match_jax(saved):
    """The same multipliers in both packages: one step leaves every
    parameter within 1e-5 of the JAX step's, the frozen ones unchanged
    and the one named only in ``set_lr_mult`` moved in both."""
    _, want = _jax_run(saved, None, steps=1, multipliers=_multipliers)
    net, step = _port_step(saved)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    _multipliers(dict(net.named_parameters()), step._optimizer)
    step(*_batch())
    got = {n: p.detach().numpy() for n, p in net.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)
    for frozen in ("word_embed.weight", "pooler.weight"):
        np.testing.assert_array_equal(got[frozen], before[frozen].numpy())
        np.testing.assert_array_equal(want[frozen], before[frozen].numpy())
    moved = "position_embed.weight"
    assert not np.array_equal(got[moved], before[moved].numpy())
    assert not np.array_equal(want[moved], before[moved].numpy())
