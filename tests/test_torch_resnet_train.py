"""The port's ``TrainStep`` against the JAX package's on a narrow
channel-last ResNet, on the CPU.

The JAX package builds and initialises ``ResNetV1(BottleneckV1, [1, 1, 1,
1], [16, 32, 64, 128, 256], classes=10, layout="NHWC")``, saves it, and
the port loads the file. Both packages then train it with
``SoftmaxCrossEntropyLoss`` and ``SGD(learning_rate=0.1, momentum=0.9)``
(``bench_resnet50.py``'s optimizer) on one numpy batch of 8 images of
32x32 with float32 labels; the smallest BatchNorm (stage 4, 1x1) sees 8
rows. The JAX side runs its Pallas BatchNorm kernels in interpret mode
(``MXTPU_FUSED_BN=pallas``); the port's channel-last BatchNorm runs the
plain versions of B7 and B8 on the CPU.

Tolerances. Float32: both sides sum in other orders, and each SGD step
at learning rate 0.1 amplifies that round-off about tenfold (the losses
differ by 3e-7, 1.2e-6 and 1.7e-5 relative over the three steps), so
after three steps losses, parameters and running statistics agree
within 1e-4 (relative; absolute too for the latter two). The biases of
the convolutions that feed a BatchNorm have a gradient that is zero in
exact arithmetic (BatchNorm removes any per-channel shift); they move
by round-off only, far inside the absolute bound. ``steps_per_call=2``
(two updates): losses within 1e-4 relative, parameters and statistics
within 2e-5. bfloat16: the two frameworks round the bf16 activations at
other places, so losses agree within 2e-2 relative and the running
statistics (stored in bf16, as the JAX package leaves them) within 3e-2
of the largest entry of each.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.parallel import TrainStep as JaxTrainStep
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.optimizer import SGD
from mxnet_tpu_torch.parallel import TrainStep

NARROW = ([1, 1, 1, 1], [16, 32, 64, 128, 256])
OPT = dict(learning_rate=0.1, momentum=0.9)
TOL = dict(rtol=2e-5, atol=2e-5)  # two SGD updates
TOL3 = dict(rtol=1e-4, atol=1e-4)  # three
N, H = 8, 32


@pytest.fixture(autouse=True)
def _pallas_bn(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_BN", "pallas")


@pytest.fixture(autouse=True)
def _jax_telemetry_to_tmp(tmp_path):
    """Keep anything the JAX TrainStep records out of the repo's
    ``telemetry/`` directory if another test enabled telemetry."""
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
    jnet = jvision.ResNetV1(jvision.BottleneckV1, *NARROW, classes=10,
                            layout="NHWC")
    jnet.initialize(mx.initializer.Xavier())
    jnet._probe_shapes(nd.zeros((1, H, H, 3)))
    path = str(tmp_path_factory.mktemp("params") / "narrow.npz")
    jnet.save_parameters(path)
    return path


def _batch(n=N, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, H, H, 3).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    return x, y


def _jax_run(path, steps, compute_dtype=None, steps_per_call=1, batch=None):
    jnet = jvision.ResNetV1(jvision.BottleneckV1, *NARROW, classes=10,
                            layout="NHWC")
    jnet.initialize()
    jnet._probe_shapes(nd.zeros((1, H, H, 3)))
    jnet.load_parameters(path)
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()

    class _Loss:  # bench_resnet50.py:29-31
        def __call__(self, out, label):
            return ce(out, label)

    step = JaxTrainStep(jnet, _Loss(), jopt.SGD(**OPT),
                        compute_dtype=compute_dtype,
                        state_dtype=compute_dtype,
                        steps_per_call=steps_per_call)
    x, y = batch if batch is not None else _batch()
    losses = [float(step(nd.array(x), nd.array(y)).asscalar())
              for _ in range(steps)]
    step.sync_params()
    vals = {n: p.data().asnumpy()
            for n, p in jnet._collect_params_with_prefix().items()}
    return losses, vals


def _port_run(path, steps, compute_dtype=None, steps_per_call=1,
              batch=None):
    net = vision.ResNetV1(vision.BottleneckV1, *NARROW, classes=10,
                          layout="NHWC", device="cpu")
    load_mxnet_tpu_params(path, net)
    step = TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(**OPT),
                     compute_dtype=compute_dtype, state_dtype=compute_dtype,
                     steps_per_call=steps_per_call, device="cpu")
    x, y = batch if batch is not None else _batch()
    losses = [float(step(x, y)) for _ in range(steps)]
    return losses, net


def _compare(net, want, tol, skip=()):
    got = net.state_dict()
    assert set(got) == set(want)
    for n, w in want.items():
        if n in skip:
            continue
        np.testing.assert_allclose(got[n].float().numpy(),
                                   w.astype(np.float32), err_msg=n, **tol)


def test_float32_sgd_steps_match_jax(saved):
    want_l, want = _jax_run(saved, 3)
    got_l, net = _port_run(saved, 3)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    assert got_l[-1] < got_l[0]
    _compare(net, want, TOL3)
    assert net.features[1].running_mean.dtype == torch.float32
    # the running statistics moved from their initial 0 and 1
    assert not np.allclose(want["features.1.running_var"], 1.0)
    assert not np.allclose(want["features.7.0.body.7.running_mean"], 0.0)


def test_steps_per_call_keeps_the_last_microstep_statistics(saved):
    """One call with ``steps_per_call=2`` on two stacked microbatches:
    both microsteps read the statistics the call started with, and only
    the last one's update is kept (the JAX package's scan). Chaining the
    two updates, as two single steps do, gives other statistics."""
    x1, y1 = _batch(seed=1)
    x2, y2 = _batch(seed=2)
    both = (np.concatenate([x1, x2]), np.concatenate([y1, y2]))
    want_l, want = _jax_run(saved, 1, steps_per_call=2, batch=both)
    got_l, net = _port_run(saved, 1, steps_per_call=2, batch=both)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    _compare(net, want, TOL)
    # the rule has power here: chained updates land elsewhere
    chained = vision.ResNetV1(vision.BottleneckV1, *NARROW, classes=10,
                              layout="NHWC", device="cpu")
    load_mxnet_tpu_params(saved, chained)
    step = TrainStep(chained, SoftmaxCrossEntropyLoss(), SGD(**OPT),
                     device="cpu")
    step(x1, y1)
    step(x2, y2)
    for n, p in chained.named_parameters():  # the same parameters
        np.testing.assert_allclose(p.detach().numpy(), want[n], err_msg=n,
                                   **TOL)
    rm = chained.features[1].running_mean.numpy()
    assert np.abs(rm - want["features.1.running_mean"]).max() > 1e-3


def test_bfloat16_step_matches_jax(saved):
    """One step under ``compute_dtype="bfloat16"``: the loss, the f32
    master parameters, and the running statistics, which end in bf16 in
    both packages (the frozen values are cast to the compute dtype and
    the update is stored as it came back)."""
    want_l, want = _jax_run(saved, 1, compute_dtype="bfloat16")
    got_l, net = _port_run(saved, 1, compute_dtype="bfloat16")
    np.testing.assert_allclose(got_l, want_l, rtol=2e-2)
    got = net.state_dict()
    for n, w in want.items():
        if n.endswith(("running_mean", "running_var")):
            assert str(w.dtype) == "bfloat16", (n, w.dtype)
            assert got[n].dtype == torch.bfloat16, n
            w = w.astype(np.float32)
            np.testing.assert_allclose(
                got[n].float().numpy(), w, rtol=0,
                atol=3e-2 * max(1.0, float(np.abs(w).max())), err_msg=n)
        else:
            assert got[n].dtype == torch.float32, n  # f32 masters


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("wd,rescale,clip", [(0.0, 1.0, -1.0),
                                             (1e-4, 0.5, 0.05)])
def test_sgd_update_ops_match_jax(momentum, wd, rescale, clip):
    """``sgd_update`` / ``sgd_mom_update`` against the JAX ops (float32,
    elementwise: within 1e-7)."""
    from mxnet_tpu.ops import optimizer_op as jops
    from mxnet_tpu_torch.ops import optimizer_op as ops

    rng = np.random.RandomState(7)
    w, g, m = (rng.randn(5, 4).astype(np.float32) for _ in range(3))
    kw = dict(lr=0.1, wd=wd, rescale_grad=rescale, clip_gradient=clip)
    if momentum:
        want = jops.sgd_mom_update(w, g, m, momentum=momentum, **kw)
        got = ops.sgd_mom_update(*(torch.from_numpy(a) for a in (w, g, m)),
                                 momentum=momentum, **kw)
    else:
        want = (jops.sgd_update(w, g, **kw),)
        got = (ops.sgd_update(torch.from_numpy(w), torch.from_numpy(g),
                              **kw),)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7,
                                   atol=1e-7)


def test_softmax_cross_entropy_takes_float_labels():
    """``bench_resnet50.py`` passes float32 labels; the loss picks by
    their integer value, as the JAX loss does."""
    rng = np.random.RandomState(8)
    pred = rng.randn(6, 1000).astype(np.float32)
    label = rng.randint(0, 1000, 6).astype(np.float32)
    want = jgluon.loss.SoftmaxCrossEntropyLoss()(nd.array(pred),
                                                 nd.array(label)).asnumpy()
    got = SoftmaxCrossEntropyLoss()(torch.from_numpy(pred),
                                    torch.from_numpy(label))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_xavier_keeps_the_matrices_bits():
    """Convolution fans do not change a matrix's draw: a BERT's weights
    are the same bits as ``xavier_`` drew them with fans from
    ``shape[0]`` and ``shape[1]`` alone."""
    import math

    from mxnet_tpu_torch.gluon.model_zoo import BERTModel

    net = BERTModel(vocab_size=11, units=32, hidden_size=64, num_layers=1,
                    num_heads=2, max_length=8, dropout=0.0,
                    device="cpu").initialize(3)
    gen = torch.Generator().manual_seed(3)
    for name, p in net.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gamma", "bias", "beta"):
            continue
        assert p.ndim == 2, name
        scale = math.sqrt(3.0 / ((p.shape[1] + p.shape[0]) / 2.0))
        want = torch.rand(p.shape, generator=gen) * (2 * scale) - scale
        assert torch.equal(p.detach(), want), name
