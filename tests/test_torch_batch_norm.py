"""The port's BatchNorm against the JAX package's, on the CPU.

Kernel functions: ``bn_stats_plain`` and ``bn_bwd_reduce_plain`` (what
the B7 and B8 wrappers run for CPU tensors) against the JAX package's
``bn_stats`` and ``bn_bwd_reduce`` (the Pallas kernels in interpret
mode), at the JAX package's own test shapes (``test_batch_norm_pallas``:
narrow C, which the JAX package folds into 128 lanes, and C = 600; mean
0 and 200) and in the cancellation regime (mean 1000, std 0.5). The
tolerances are the JAX package's own for its kernels against numpy:
both sides sum in float32 in different orders (and the JAX package
merges its folded copies with Chan's formula), so means agree within
1e-4 * max(1, |mean|), variances within 1e-4 relative, the backward sums
within 1e-4.

The op and the layer: ``ops.nn.batch_norm`` in training mode against the
JAX ``BatchNorm`` op (``mxnet_tpu.ops.nn.batch_norm``) -- out, batch mean
and var, and the gradients dx, dgamma, dbeta -- channel-last with
``MXTPU_FUSED_BN=pallas`` (the JAX Pallas route; the port's B7/B8 route)
and channel-first in the JAX default mode (both shifted one-pass jnp /
torch), in float32 and bfloat16; the inference branch; and the
``BatchNorm`` layer's running update. Float32 results differ only in
summation order (1e-5 absolute and relative, dgamma and dbeta relative to
their largest entry since they sum over all rows); bfloat16 activations
are rounded at other places in the two frameworks (2e-2, two bf16 ulps
of O(1) values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd
from mxnet_tpu.ops import nn as jops
from mxnet_tpu.ops.pallas import batch_norm as jbn
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.nn import BatchNorm
from mxnet_tpu_torch.ops import nn as ops
from mxnet_tpu_torch.ops.kernels import batch_norm as kbn


@pytest.mark.parametrize("shape", [(4, 7, 7, 8), (8, 14, 14, 64),
                                   (2, 5, 3, 16), (2, 1, 49, 160),
                                   (16, 3, 3, 600), (64, 2, 2, 2048)])
@pytest.mark.parametrize("mean_scale", [0.0, 200.0])
def test_bn_stats_plain_matches_jax(shape, mean_scale):
    rng = np.random.default_rng(0)
    C = shape[-1]
    x = rng.normal(mean_scale, 0.7, shape).astype(np.float32).reshape(-1, C)
    want_m, want_v = jbn.bn_stats(jnp.asarray(x))
    got_m, got_v = kbn.bn_stats(torch.from_numpy(x))
    assert got_m.dtype == torch.float32 and got_v.shape == (C,)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=0,
                               atol=1e-4 * max(1.0, mean_scale))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=1e-4, atol=1e-6)


def test_bn_stats_plain_cancellation_regime():
    """mean / std = 2000: the unshifted one-pass form is useless in f32;
    the shifted one stays within 1e-4 relative of the float64 variance,
    as the JAX kernel does."""
    rng = np.random.default_rng(1)
    x = rng.normal(1000.0, 0.5, (8, 16, 16, 8)).astype(np.float32)
    x = x.reshape(-1, 8)
    ref = x.astype(np.float64).var(0)
    _, got = kbn.bn_stats(torch.from_numpy(x))
    _, want = jbn.bn_stats(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(want), ref, rtol=1e-4)


def test_bn_stats_bf16_input():
    """bf16 input, f32 statistics, as B7 takes it."""
    rng = np.random.default_rng(5)
    x = rng.normal(3.0, 2.0, (300, 64)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want_m, want_v = jbn.bn_stats(jnp.asarray(x, jnp.bfloat16))
    got_m, got_v = kbn.bn_stats(xt)
    assert got_m.dtype == torch.float32
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-4)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-4)


@pytest.mark.parametrize("shape", [(4, 7, 7, 8), (8, 6, 6, 64),
                                   (2, 3, 3, 300)])
def test_bn_bwd_reduce_plain_matches_jax(shape):
    rng = np.random.default_rng(4)
    C = shape[-1]
    x = rng.normal(2.0, 1.0, shape).astype(np.float32).reshape(-1, C)
    dy = rng.normal(0, 1, shape).astype(np.float32).reshape(-1, C)
    mean = x.mean(0)
    inv = (1.0 / np.sqrt(x.var(0) + 1e-3)).astype(np.float32)
    want = jbn.bn_bwd_reduce(*(jnp.asarray(a) for a in (x, dy, mean, inv)))
    got = kbn.bn_bwd_reduce(*(torch.from_numpy(a) for a in (x, dy, mean,
                                                            inv)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_supports_follows_the_jax_rule():
    for shape, axis in [((4, 5, 5, 8), -1), ((4, 5, 5, 8), 3),
                        ((4, 8, 5, 5), 1), ((1, 8), -1), ((2, 1), -1),
                        ((7,), -1)]:
        x = np.zeros(shape, np.float32)
        assert kbn.supports(torch.from_numpy(x), axis) == \
            jbn.supports(jnp.asarray(x), axis), (shape, axis)


def test_wrappers_raise_off_cpu_and_cuda():
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(MXNetError, match="no kernel"):
        kbn.bn_stats(x)
    with pytest.raises(MXNetError, match="no kernel"):
        kbn.bn_bwd_reduce(x, x, torch.zeros(8, device="meta"),
                          torch.zeros(8, device="meta"))


def _bn_case(layout, seed=2):
    rng = np.random.default_rng(seed)
    shape = (4, 6, 5, 16) if layout == "NHWC" else (4, 16, 6, 5)
    C = 16
    x = rng.normal(1.5, 1.0, shape).astype(np.float32)
    g = rng.normal(1.0, 0.1, (C,)).astype(np.float32)
    b = rng.normal(0.0, 0.1, (C,)).astype(np.float32)
    dy = rng.normal(0, 1, shape).astype(np.float32)
    mm = rng.normal(0, 0.1, (C,)).astype(np.float32)
    mv = rng.uniform(0.5, 1.5, (C,)).astype(np.float32)
    return x, g, b, dy, mm, mv, (-1 if layout == "NHWC" else 1)


def _jax_bn(x, g, b, dy, mm, mv, axis, dtype, training=True):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def f(x_, g_, b_):
        out, m, v = jops.batch_norm(
            x_, g_, b_, jnp.asarray(mm), jnp.asarray(mv), eps=1e-3,
            fix_gamma=False, training=training, axis=axis)
        return out, (m, v)

    out, vjp, (m, v) = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(g),
                               jnp.asarray(b), has_aux=True)
    grads = vjp(jnp.asarray(dy, jdt))
    return [np.asarray(t, np.float32) for t in (out, m, v, *grads)]


def _port_bn(x, g, b, dy, mm, mv, axis, dtype, training=True):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    gt = torch.from_numpy(g).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    out, m, v = ops.batch_norm(xt, gt, bt, torch.from_numpy(mm),
                               torch.from_numpy(mv), eps=1e-3,
                               fix_gamma=False, training=training,
                               axis=axis)
    assert not m.requires_grad and not v.requires_grad
    assert out.dtype == dtype and m.dtype == torch.float32
    grads = torch.autograd.grad(out, (xt, gt, bt),
                                torch.from_numpy(dy).to(dtype))
    assert grads[0].dtype == dtype and grads[1].dtype == torch.float32
    return [t.detach().float().numpy() for t in (out, m, v, *grads)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_batch_norm_op_matches_jax(monkeypatch, layout, dtype):
    """Forward (out, mean, var) and gradients (dx, dgamma, dbeta)."""
    if layout == "NHWC":
        monkeypatch.setenv("MXTPU_FUSED_BN", "pallas")
    case = _bn_case(layout)
    want = _jax_bn(*case, dtype)
    got = _port_bn(*case, dtype)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for name, a, w in zip(("out", "mean", "var", "dx", "dgamma", "dbeta"),
                          got, want):
        scale = max(1.0, float(np.abs(w).max())) \
            if name in ("dgamma", "dbeta") else 1.0
        np.testing.assert_allclose(a, w, rtol=tol, atol=tol * scale,
                                   err_msg=name)


def test_batch_norm_op_routes_channel_last_to_the_kernels(monkeypatch):
    """A channel-last CPU tensor reaches the B7/B8 wrappers (which run
    their plain versions on the CPU); channel-first does not."""
    calls = []
    monkeypatch.setattr(kbn, "bn_stats", lambda x: calls.append("stats")
                        or kbn.bn_stats_plain(x))
    monkeypatch.setattr(kbn, "bn_bwd_reduce",
                        lambda *a: calls.append("bwd")
                        or kbn.bn_bwd_reduce_plain(*a))
    for layout in ("NCHW", "NHWC"):
        x, g, b, dy, mm, mv, axis = _bn_case(layout)
        _port_bn(x, g, b, dy, mm, mv, axis, torch.float32)
        assert calls == ([] if layout == "NCHW" else ["stats", "bwd"])


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_batch_norm_op_inference_matches_jax(layout):
    """Outside training the moving statistics normalise."""
    case = _bn_case(layout, seed=6)
    want = _jax_bn(*case, torch.float32, training=False)
    x, g, b, dy, mm, mv, axis = case
    out, m, v = ops.batch_norm(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(b), torch.from_numpy(mm),
                               torch.from_numpy(mv), eps=1e-3,
                               fix_gamma=False, axis=axis)
    for a, w in zip((out, m, v), want[:3]):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5, atol=1e-5)


def test_fix_gamma_gives_gamma_no_gradient():
    x, g, b, dy, mm, mv, axis = _bn_case("NHWC")
    gt = torch.from_numpy(g * 3).requires_grad_()
    xt = torch.from_numpy(x)
    out, _, _ = ops.batch_norm(xt, gt, torch.from_numpy(b),
                               torch.from_numpy(mm), torch.from_numpy(mv),
                               fix_gamma=True, training=True, axis=axis)
    ref, _, _ = ops.batch_norm(xt, torch.ones(16), torch.from_numpy(b),
                               torch.from_numpy(mm), torch.from_numpy(mv),
                               fix_gamma=False, training=True, axis=axis)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert not out.requires_grad


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_batch_norm_layer_running_update_matches_jax(monkeypatch, layout):
    """Two training-mode calls of the layer (momentum 0.9, eps 1e-5):
    outputs and running statistics (population variance) against the
    JAX layer under ``autograd.record``."""
    if layout == "NHWC":
        monkeypatch.setenv("MXTPU_FUSED_BN", "pallas")
    axis = -1 if layout == "NHWC" else 1
    xs = [_bn_case(layout, seed=s)[0] for s in (7, 8)]
    jl = jgluon.nn.BatchNorm(axis=axis, in_channels=16)
    jl.initialize()
    pl = BatchNorm(16, axis=axis, device="cpu")
    for x in xs:
        with jautograd.record():
            want = jl(nd.array(x)).asnumpy()
        got = pl(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for name in ("running_mean", "running_var"):
        want = getattr(jl, name).data().asnumpy()
        got = getattr(pl, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    # eval mode normalises with the running statistics and leaves them
    pl.eval()
    before = pl.running_var.clone()
    pl(torch.from_numpy(xs[0]))
    assert torch.equal(pl.running_var, before)
