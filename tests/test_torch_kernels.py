"""The port's kernel modules against the JAX package, on the CPU.

Each hand-written Hopper kernel of ``mxnet_tpu_torch`` runs its plain
PyTorch version for CPU tensors; these tests hold those plain versions
(and the ops that route to them) against the JAX package's Pallas kernels
run as the JAX tests run them here: in interpret mode. Inputs are made
with numpy from a seed and handed to both sides as numpy arrays.

Tolerance: both sides compute in float32 but sum in different orders
(Pallas blocks of 128 keys, torch reductions), so results agree to a few
ulps of the largest partial sum: 1e-5 absolute and relative on O(1)
values. bfloat16 operands (the LayerNorm backward) are rounded the same
way on both sides; the bfloat16 dx then differs by at most one rounding
of its f32 value, held at 2e-2 of the tensor's largest magnitude.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import contrib as jax_contrib
from mxnet_tpu.ops import nn as jax_nn
from mxnet_tpu.ops.pallas import layer_norm as jax_ln
from mxnet_tpu.ops.pallas import paged_flash_attention as jax_pfa
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import contrib, nn
from mxnet_tpu_torch.ops.kernels import flash_attention as k_fa
from mxnet_tpu_torch.ops.kernels import layer_norm as k_ln
from mxnet_tpu_torch.ops.kernels import paged_attention as k_pa

jax_fa = importlib.import_module("mxnet_tpu.ops.pallas.flash_attention")

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("rows,C", [(8, 512), (300, 128), (1, 256)])
def test_layer_norm_plain_matches_pallas(rows, C):
    rng = np.random.RandomState(rows + C)
    x = (rng.randn(rows, C) * 3 + 1).astype(np.float32)
    g = rng.randn(C).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    want = jax_ln._ln_fwd_impl(jnp.asarray(x), jnp.asarray(g),
                               jnp.asarray(b), 1e-5)
    got = k_ln.layer_norm_fwd(torch.from_numpy(x), torch.from_numpy(g),
                              torch.from_numpy(b), 1e-5)
    for w, o in zip(want, got):  # out, mean, rstd
        np.testing.assert_allclose(_np(o), np.asarray(w), **TOL)
    assert k_ln.launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("shape,axis", [((2, 5, 256), -1), ((3, 100), -1),
                                        ((4, 128, 6), 1)])
def test_layer_norm_op_routing_matches_jax(shape, axis):
    """``ops.nn.layer_norm`` routes like ``mxnet_tpu/ops/nn.py:487``:
    the kernel path for a lane-aligned last axis, the f32 composition
    otherwise; both agree with the JAX op."""
    rng = np.random.RandomState(len(shape))
    x = rng.randn(*shape).astype(np.float32)
    C = shape[axis]
    g = rng.rand(C).astype(np.float32) + 0.5
    b = rng.randn(C).astype(np.float32)
    want = jax_nn.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                             axis=axis)
    got = nn.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(b), axis=axis)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert k_ln.supports(torch.from_numpy(x), axis) == \
        jax_ln.supports(jnp.asarray(x), axis)


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("B,H,Sq,Sk,vl,causal", [
    (3, 2, 40, 40, [40, 0, 17], False),   # ragged S, one empty row
    (2, 2, 37, 37, None, True),           # causal, ragged S
    (2, 1, 24, 50, [50, 9], True),        # causal with Sq != Sk and vl
    (1, 2, 130, 130, [129], False),       # more than one 128-key block
])
def test_flash_attention_plain_matches_pallas(B, H, Sq, Sk, vl, causal):
    rng = np.random.RandomState(B * Sq + Sk)
    D = 16
    q = rng.randn(B, H, Sq, D).astype(np.float32)
    k = rng.randn(B, H, Sk, D).astype(np.float32)
    v = rng.randn(B, H, Sk, D).astype(np.float32)
    vl_np = None if vl is None else np.asarray(vl, np.int32)
    scale = D ** -0.5
    want_o, want_lse = jax_fa._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if vl_np is None else jnp.asarray(vl_np), causal, scale, 128,
        128)
    got_o, got_lse = k_fa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if vl_np is None else torch.from_numpy(vl_np), causal, scale)
    np.testing.assert_allclose(_np(got_o), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(_np(got_lse), np.asarray(want_lse), **TOL)
    if vl is not None and 0 in vl:
        assert not _np(got_o)[vl.index(0)].any()  # empty row outputs 0
    assert k_fa.launches == 0


@pytest.mark.parametrize("dense_max", ["256", "0"])
def test_flash_attention_op_routing_matches_jax(monkeypatch, dense_max):
    """``ops.contrib.flash_attention`` against ``_flash_attention_op``
    (``mxnet_tpu/ops/contrib.py:504``) with ``MXTPU_ATTN_DENSE_MAX`` set
    on both sides: 256 keeps S=40 on the dense path, 0 sends it to the
    flash kernel (Pallas interpret / the port's plain K2). A row with
    valid_length 0 gives zeros, not NaN, on both routes."""
    monkeypatch.setenv("MXTPU_ATTN_DENSE_MAX", dense_max)
    rng = np.random.RandomState(7)
    shape = (3, 40, 2, 16)  # (B, S, H, D)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    vl = np.array([40, 0, 23], np.int32)
    for causal in (False, True):
        want = jax_contrib._flash_attention_op(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            valid_length=jnp.asarray(vl), causal=causal, layout="BSHD")
        got = contrib.flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            valid_length=torch.from_numpy(vl), causal=causal)
        assert got.shape == shape and np.isfinite(_np(got)).all()
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_flash_attention_op_offset_query_matches_jax():
    """A single query at per-row offsets (the decode contract) takes the
    dense path on both sides whatever the length."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 1, 2, 16).astype(np.float32)
    k = rng.randn(2, 300, 2, 16).astype(np.float32)
    v = rng.randn(2, 300, 2, 16).astype(np.float32)
    off = np.array([5, 299], np.int32)
    want = jax_contrib._flash_attention_op(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        layout="BSHD", q_offset=jnp.asarray(off))
    got = contrib.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, q_offset=torch.from_numpy(off))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


# ------------------------------------------------------------------ B2
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [128, 768])
@pytest.mark.parametrize("rows", [1, 255, 257, 600])
def test_layer_norm_bwd_plain_matches_pallas(rows, C, dtype):
    """``layer_norm_bwd_plain`` against ``_ln_bwd_impl`` (Pallas,
    interpret mode) from the same forward statistics: rows below, at and
    past one 256-row block, and the training path's C=768."""
    rng = np.random.RandomState(rows * 7 + C)
    x = (rng.randn(rows, C) * 3 + 1).astype(np.float32)
    g = (rng.rand(C) + 0.5).astype(np.float32)
    dy = rng.randn(rows, C).astype(np.float32)
    jx, jg, jdy = (jnp.asarray(a).astype(dtype) for a in (x, g, dy))
    _, mean, rstd = jax_ln._ln_fwd_impl(jx, jg, jg, 1e-5)
    want = jax_ln._ln_bwd_impl(jx, jg, mean, rstd, jdy)
    tdt = getattr(torch, dtype)
    got = k_ln.layer_norm_bwd(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt),
        torch.tensor(np.asarray(mean)), torch.tensor(np.asarray(rstd)),
        torch.from_numpy(dy).to(tdt))
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    for w, o in zip(want, got):  # dx, dgamma, dbeta
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(_np(o), w, **TOL)
        else:
            err = np.abs(_np(o.float()) - w).max()
            assert err <= 2e-2 * np.abs(w).max(), err
    assert k_ln.launches_bwd == 0


@pytest.mark.parametrize("route", ["kernel", "composition"])
def test_layer_norm_op_gradient_matches_jax(route):
    """Gradients of ``ops.nn.layer_norm`` against ``jax.grad`` of the JAX
    op: the kernel route (K1 forward, B2 backward) and the composition
    (torch autograd)."""
    shape, axis = ((2, 5, 128), -1) if route == "kernel" else ((4, 96, 6), 1)
    rng = np.random.RandomState(11)
    x = rng.randn(*shape).astype(np.float32)
    C = shape[axis]
    g = (rng.rand(C) + 0.5).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)

    def jloss(x, g, b):
        return (jax_nn.layer_norm(x, g, b, axis=axis) * w).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    (nn.layer_norm(tx, tg, tb, axis=axis) * torch.from_numpy(w)).sum() \
        .backward()
    for t, wg in zip((tx, tg, tb), want):
        np.testing.assert_allclose(_np(t.grad), np.asarray(wg), **TOL)


# ------------------------------------------------------------------ B4
@pytest.mark.parametrize("oracle", ["pallas", "xla"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,vl", [(128, [128, 0]), (200, [1, 200])])
def test_flash_attention_bwd_plain_matches_jax(S, vl, causal, oracle):
    """``flash_attention_bwd_plain`` against both JAX backwards, called
    directly: ``_flash_bwd_pallas`` (the two Pallas kernels, interpret
    mode) and ``_flash_bwd_xla`` (the blockwise scan). B2 H2 D64; valid
    lengths 0, 1 and S; S=200 is not a multiple of the 128-row Pallas
    block."""
    rng = np.random.RandomState(S + sum(vl) + causal)
    q, k, v, do = (rng.randn(2, 2, S, 64).astype(np.float32)
                   for _ in range(4))
    vl_np = np.asarray(vl, np.int32)
    scale = 64 ** -0.5
    jq, jk, jv, jdo, jvl = (jnp.asarray(a) for a in (q, k, v, do, vl_np))
    out, lse = jax_fa._flash_fwd(jq, jk, jv, jvl, causal, scale, 128, 128)
    if oracle == "pallas":
        want = jax_fa._flash_bwd_pallas(jq, jk, jv, jvl, out, lse, jdo,
                                        causal, scale)
    else:
        want = jax_fa._flash_bwd_xla(jq, jk, jv, jvl, out, lse, jdo, causal,
                                     scale, 128)
    got = k_fa.flash_attention_bwd(
        *(torch.from_numpy(a) for a in (q, k, v, vl_np)),
        torch.tensor(np.asarray(out)), torch.tensor(np.asarray(lse)),
        torch.from_numpy(do), causal, scale)
    for w, o in zip(want, got):  # dq, dk, dv
        np.testing.assert_allclose(_np(o), np.asarray(w), **TOL)
    row0 = vl.index(0) if 0 in vl else None
    if row0 is not None:  # no visible key: no gradient anywhere
        assert not any(_np(o)[row0].any() for o in got)
    assert k_fa.launches_bwd_dkdv == 0 and k_fa.launches_bwd_dq == 0


@pytest.mark.parametrize("dense_max", ["256", "0"])
@pytest.mark.parametrize("vl,causal", [(None, False), ([40, 0, 23], False),
                                       ([40, 0, 23], True)])
def test_flash_attention_op_gradient_matches_jax(monkeypatch, dense_max,
                                                 vl, causal):
    """Gradients of ``ops.contrib.flash_attention`` (BSHD) against
    ``jax.grad`` of ``_flash_attention_op``: ``MXTPU_ATTN_DENSE_MAX=256``
    keeps S=40 on the dense path (torch autograd / XLA), 0 sends it to
    the flash route (K2 + B4 / the Pallas forward and its backward)."""
    monkeypatch.setenv("MXTPU_ATTN_DENSE_MAX", dense_max)
    rng = np.random.RandomState(5)
    shape = (3, 40, 2, 64)  # (B, S, H, D)
    q, k, v, w = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    vl_np = None if vl is None else np.asarray(vl, np.int32)

    def jloss(q, k, v):
        out = jax_contrib._flash_attention_op(
            q, k, v, valid_length=None if vl is None else jnp.asarray(vl_np),
            causal=causal, layout="BSHD")
        return (out * w).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = contrib.flash_attention(
        tq, tk, tv, None if vl is None else torch.from_numpy(vl_np),
        causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    for t, wg in zip((tq, tk, tv), want):
        assert np.isfinite(_np(t.grad)).all()
        np.testing.assert_allclose(_np(t.grad), np.asarray(wg), **TOL)


# ------------------------------------------------------------------ K3
def test_paged_decode_plain_matches_pallas():
    """Mid-page tails, an inactive row whose whole table is the trash
    page, and a finished row whose pos is past the table's capacity
    (the decode loop keeps passing ``lengths + j``)."""
    rng = np.random.RandomState(0)
    num_pages, ps, H, D, P = 9, 4, 2, 16, 3
    kp = rng.randn(num_pages, ps, H, D).astype(np.float32)
    vp = rng.randn(num_pages, ps, H, D).astype(np.float32)
    q = rng.randn(4, H, D).astype(np.float32)
    table = np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0], [6, 7, 8]], np.int32)
    pos = np.array([5, 9, 0, 17], np.int32)  # 17 > P * ps - 1
    scale = D ** -0.5
    args = [jnp.asarray(a) for a in (q, kp, vp, table, pos)]
    want_kernel = jax_pfa.paged_decode_attention(*args, sm_scale=scale)
    want_ref = jax_pfa.paged_decode_reference(*args, sm_scale=scale)
    got = k_pa.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, pos)), scale)
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), np.asarray(want_kernel), **TOL)
    np.testing.assert_allclose(_np(got), np.asarray(want_ref), **TOL)
    assert k_pa.launches == 0


def test_wrappers_refuse_other_devices():
    """No silent route: a tensor on neither the CPU nor CUDA raises."""
    x = torch.zeros((2, 128), device="meta")
    with pytest.raises(MXNetError):
        k_ln.layer_norm_fwd(x, x[0], x[0])
    with pytest.raises(MXNetError):
        k_ln.layer_norm_bwd(x, x[0], x[:, :1], x[:, :1], x)
    q = torch.zeros((1, 1, 4, 32), device="meta")
    with pytest.raises(MXNetError):
        k_fa.flash_attention_fwd(q, q, q)
    stats = torch.zeros((1, 1, 4), device="meta")
    with pytest.raises(MXNetError):
        k_fa.flash_attention_bwd_dkdv(q, q, q, None, stats, stats, q)
    with pytest.raises(MXNetError):
        k_fa.flash_attention_bwd_dq(q, q, q, None, stats, stats, q)
    with pytest.raises(MXNetError):
        k_pa.paged_decode_attention(
            torch.zeros((1, 1, 32), device="meta"),
            torch.zeros((2, 4, 1, 32), device="meta"),
            torch.zeros((2, 4, 1, 32), device="meta"),
            torch.zeros((1, 1), dtype=torch.int32, device="meta"),
            torch.zeros((1,), dtype=torch.int32, device="meta"), 1.0)
    ints = dict(dtype=torch.int32, device="meta")
    with pytest.raises(MXNetError):
        k_pa.paged_window_attention(
            torch.zeros((1, 2, 1, 64), device="meta"),
            torch.zeros((2, 4, 1, 64), device="meta"),
            torch.zeros((2, 4, 1, 64), device="meta"),
            torch.zeros((1, 1), **ints), torch.zeros((1,), **ints),
            torch.ones((1,), **ints), 1.0)
