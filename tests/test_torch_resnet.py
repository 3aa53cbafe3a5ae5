"""The port's ResNet v1 and its layers against the JAX package's, on the
CPU.

Convolution and pooling: the port's ops against the JAX ops on the same
numpy inputs, channel-first and channel-last, with stride, padding,
dilation, groups, the ``"full"`` (ceil) convention and
``count_include_pad``; float32 sums in other orders agree within 1e-5
(absolute and relative).

Models: the JAX package builds and initialises (Xavier) ``resnet18_v1``
and the narrow bottleneck net ``ResNetV1(BottleneckV1, [1, 1, 1, 1],
[16, 32, 64, 128, 256], classes=10)``, saves them with
``save_parameters``, and the port loads the file
(``convert.load_mxnet_tpu_params``, running statistics included). The
logits of both packages on one numpy batch agree within 1e-4 relative to
the largest logit in inference mode and in training mode (batch
statistics), in both layouts: float32 through up to 18 convolutions and
BatchNorms, summed in other orders. ``resnet50_v1``'s structural names
and shapes equal the JAX package's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ops import nn as jops
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.initializer import xavier_, xavier_bound
from mxnet_tpu_torch.ops import nn as ops

TOL = dict(rtol=1e-5, atol=1e-5)
NARROW = ([1, 1, 1, 1], [16, 32, 64, 128, 256])


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("k,stride,pad,dilate,groups,bias", [
    (7, 2, 3, 1, 1, False), (3, 1, 1, 1, 1, True), (1, 2, 0, 1, 1, True),
    (3, 2, 2, 2, 2, True)])
def test_convolution_matches_jax(layout, k, stride, pad, dilate, groups,
                                 bias):
    rng = np.random.RandomState(0)
    N, C, H, W, O = 2, 4, 11, 9, 6
    shape = (N, H, W, C) if layout == "NHWC" else (N, C, H, W)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(O, C // groups, k, k).astype(np.float32)
    b = rng.randn(O).astype(np.float32) if bias else None
    kw = dict(stride=(stride,) * 2, dilate=(dilate,) * 2, pad=(pad,) * 2,
              num_group=groups, layout=layout)
    want = jops.convolution(jnp.asarray(x), jnp.asarray(w),
                            None if b is None else jnp.asarray(b),
                            kernel=(k, k), no_bias=b is None, **kw)
    got = ops.convolution(torch.from_numpy(x), torch.from_numpy(w),
                          None if b is None else torch.from_numpy(b), **kw)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("pool_type,k,stride,pad,conv,include", [
    ("max", 3, 2, 1, "valid", True), ("max", 3, 2, 0, "full", True),
    ("max", 2, 2, 1, "full", True), ("max", 3, 1, 2, "valid", True),
    ("avg", 3, 2, 1, "valid", True), ("avg", 3, 2, 1, "full", True),
    ("avg", 3, 2, 1, "full", False), ("avg", 2, 2, 0, "valid", False)])
def test_pooling_matches_jax(layout, pool_type, k, stride, pad, conv,
                             include):
    rng = np.random.RandomState(1)
    N, C, H, W = 2, 3, 10, 7
    shape = (N, H, W, C) if layout == "NHWC" else (N, C, H, W)
    x = rng.randn(*shape).astype(np.float32)
    kw = dict(kernel=(k, k), pool_type=pool_type, stride=(stride,) * 2,
              pad=(pad,) * 2, pooling_convention=conv,
              count_include_pad=include, layout=layout)
    want = np.asarray(jops.pooling(jnp.asarray(x), **kw))
    got = ops.pooling(torch.from_numpy(x), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_global_pooling_matches_jax(layout, pool_type):
    x = np.random.RandomState(2).randn(2, 5, 4, 3).astype(np.float32)
    kw = dict(global_pool=True, pool_type=pool_type, layout=layout)
    want = np.asarray(jops.pooling(jnp.asarray(x), **kw))
    np.testing.assert_allclose(ops.pooling(torch.from_numpy(x), **kw),
                               want, **TOL)


def test_fully_connected_flattens_like_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 1, 1, 6).astype(np.float32)
    w = rng.randn(4, 6).astype(np.float32)
    want = np.asarray(jops.fully_connected(jnp.asarray(x), jnp.asarray(w)))
    got = ops.fully_connected(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", [(30, 512), (64, 3, 7, 7),
                                   (256, 64, 1, 1), (8, 4, 3, 3)])
def test_xavier_bound_matches_the_jax_formula(shape):
    """The JAX Xavier (uniform, avg, magnitude 3) multiplies both fans by
    the receptive field (``initializer.py:246-247``)."""
    hw = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
    want = math.sqrt(3.0 / ((shape[1] * hw + shape[0] * hw) / 2.0))
    assert xavier_bound(shape) == want
    net = torch.nn.Module()
    net.weight = torch.nn.Parameter(torch.zeros(shape))
    xavier_(net, seed=1)
    w = net.weight.detach()
    assert float(w.abs().max()) <= want
    assert float(w.abs().max()) > 0.9 * want


def _jax_net(name_or_net, layout, x_shape):
    if isinstance(name_or_net, str):
        net = jvision.get_model(name_or_net, layout=layout)
    else:
        net = name_or_net
    mx.random.seed(0)
    net.initialize(mx.initializer.Xavier())
    net._probe_shapes(nd.zeros(x_shape))
    return net


def _narrow_jax(layout, classes=10):
    return jvision.ResNetV1(jvision.BottleneckV1, *NARROW, classes=classes,
                            layout=layout)


def _narrow_port(layout, classes=10):
    return vision.ResNetV1(vision.BottleneckV1, *NARROW, classes=classes,
                           layout=layout, device="cpu")


def _batch(layout, N, H):
    x = np.random.RandomState(4).rand(N, H, H, 3).astype(np.float32)
    return x if layout == "NHWC" else np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("model", ["narrow", "resnet18_v1"])
def test_resnet_logits_match_jax(tmp_path, layout, model, monkeypatch):
    if layout == "NHWC":
        monkeypatch.setenv("MXTPU_FUSED_BN", "pallas")
    N, H = 4, 32
    x = _batch(layout, N, H)
    probe = (1, H, H, 3) if layout == "NHWC" else (1, 3, H, H)
    jnet = _jax_net(_narrow_jax(layout) if model == "narrow" else model,
                    layout, probe)
    path = str(tmp_path / "net.npz")
    jnet.save_parameters(path)
    net = _narrow_port(layout) if model == "narrow" else \
        vision.get_model(model, layout=layout, device="cpu")
    load_mxnet_tpu_params(path, net)
    for training in (False, True):
        if training:
            with jautograd.record():
                want = jnet(nd.array(x)).asnumpy()
            net.train()
        else:
            want = jnet(nd.array(x)).asnumpy()
            net.eval()
        with torch.no_grad():
            got = net(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (N, 10 if model == "narrow"
                                           else 1000)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"training={training}")
    # the training-mode forward moved the running statistics alike
    jvals = {k: p.data().asnumpy()
             for k, p in jnet._collect_params_with_prefix().items()}
    for k, b in net.named_buffers():
        np.testing.assert_allclose(b.numpy(), jvals[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_resnet50_v1_names_and_shapes_match_jax():
    jnet = jvision.get_model("resnet50_v1", layout="NHWC")
    jnet.initialize()
    jnet._probe_shapes(nd.zeros((1, 32, 32, 3)))
    want = {k: tuple(p.shape)
            for k, p in jnet._collect_params_with_prefix().items()}
    net = vision.resnet50_v1(layout="NHWC", device="cpu")
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == want
    assert len(got) == 299
    assert sum(math.prod(s) for s in got.values()) == 25_629_032
    # the 1x1 body convolutions carry a bias, the 3x3 one does not
    assert "features.4.0.body.0.bias" in got
    assert "features.4.0.body.3.bias" not in got
    assert "features.4.0.body.6.bias" in got


def test_load_carries_running_statistics_exactly(tmp_path):
    """Running statistics are buffers in the port and load under the
    parameters' rule: every name present, exact shapes, nothing left."""
    jnet = _jax_net("resnet18_v1", "NHWC", (1, 32, 32, 3))
    rng = np.random.RandomState(5)
    for k, p in jnet._collect_params_with_prefix().items():
        if k.endswith(("running_mean", "running_var")):
            p.set_data(nd.array(rng.rand(*p.shape).astype(np.float32)))
    path = str(tmp_path / "r18.npz")
    jnet.save_parameters(path)
    net = vision.resnet18_v1(layout="NHWC", device="cpu")
    load_mxnet_tpu_params(path, net)
    jvals = {k: p.data().asnumpy()
             for k, p in jnet._collect_params_with_prefix().items()}
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jvals[k], err_msg=k)
    arrays = dict(jvals)
    del arrays["features.1.running_var"]
    with pytest.raises(MXNetError, match="running_var"):
        load_mxnet_tpu_params(arrays, net)
    arrays = dict(jvals, extra=np.zeros(1, np.float32))
    with pytest.raises(MXNetError, match="extra"):
        load_mxnet_tpu_params(arrays, net)
    arrays = dict(jvals)
    arrays["features.1.running_mean"] = np.zeros(3, np.float32)
    with pytest.raises(MXNetError, match="shape mismatch"):
        load_mxnet_tpu_params(arrays, net)


def test_get_model_and_defaults():
    with pytest.raises(MXNetError, match="not in the port's zoo"):
        vision.get_model("vgg16")
    with pytest.raises(MXNetError, match="v2 is not ported"):
        vision.get_resnet(2, 18, device="cpu")
    with pytest.raises(MXNetError, match="invalid resnet depth"):
        vision.get_resnet(1, 34, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA is not available"):
            vision.resnet50_v1(layout="NHWC")


@pytest.mark.parametrize("shape", [(2, 3, 8), (1, 3, 4, 4, 4)])
def test_convolution_and_pooling_take_only_2d_inputs(shape):
    """Only the 2-d ops are ported; other ranks raise."""
    x = torch.zeros(shape)
    with pytest.raises(MXNetError, match="only 2-d"):
        ops.convolution(x, torch.zeros((2, 3) + (1,) * (len(shape) - 2)))
    with pytest.raises(MXNetError, match="only 2-d"):
        ops.pooling(x, kernel=2)
