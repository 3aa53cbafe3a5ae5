"""Paged window attention (kernel B6's plain version) and the paged steps
of ``MultiHeadAttention`` against the JAX package, on the CPU.

Kernel: ``paged_window_plain`` (what the B6 wrapper runs for CPU tensors)
against ``paged_window_reference`` and against the Pallas
``paged_window_attention`` run in interpret mode, as
``tests/test_paged.py`` runs it, on every row: offsets 0, mid-page and
crossing a page, windows of 1, 3 and 8 queries, with and without padding
queries, and an all-trash padding row as the batcher pads its replay
call. Padding queries must come out exactly 0.

Layer: ``paged_window_step`` (causal: B6's route; non-causal: the dense
gather) and ``paged_step`` in both causal settings against the JAX layer
(its dense fallback on the CPU) with the same weights and pools, on live
rows (the dense branch leaves padding rows garbage), and the written
pools on every page but the trash page, whose duplicate writes land in
either order.

Tolerance: float32 on both sides, summed in another order: 1e-5
absolute and relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.gluon.nn import MultiHeadAttention as JaxMHA
from mxnet_tpu.ops.pallas import paged_flash_attention as jax_pfa
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon.nn import MultiHeadAttention
from mxnet_tpu_torch.ops.kernels import paged_attention as k_pa

TOL = dict(rtol=1e-5, atol=1e-5)
PS, H, D = 4, 2, 16
# rows 0 and 1 own pages; row 2 is a padding row: all-trash table
TABLE = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
OFFSETS = {"zero": [0, 0, 0], "mid_page": [2, 1, 0],
           "page_crossing": [3, 6, 0]}


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else
                      getattr(x, "data", x))


def _window_case(S, offsets, padded):
    rng = np.random.RandomState(S * 10 + offsets[1])
    kp = rng.randn(9, PS, H, D).astype(np.float32)
    vp = rng.randn(9, PS, H, D).astype(np.float32)
    q = rng.randn(3, S, H, D).astype(np.float32)
    off = np.array(offsets, np.int32)
    # padded: row 1 pads its last two queries (all of them at S=1), the
    # padding row keeps one live query as the batcher gives it
    vl = np.array([S, max(S - 2, 0), 1], np.int32) if padded else None
    return q, kp, vp, off, vl


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("offsets", list(OFFSETS))
def test_window_plain_matches_reference_and_pallas(offsets, S, padded):
    q, kp, vp, off, vl = _window_case(S, OFFSETS[offsets], padded)
    scale = D ** -0.5
    jargs = [jnp.asarray(a) for a in (q, kp, vp, TABLE, off)]
    jvl = None if vl is None else jnp.asarray(vl)
    want_ref = jax_pfa.paged_window_reference(*jargs, jvl, sm_scale=scale)
    want_kernel = jax_pfa.paged_window_attention(*jargs, jvl,
                                                 sm_scale=scale)
    t = torch.from_numpy
    tvl = None if vl is None else t(vl)
    before = k_pa.launches_window
    got = k_pa.paged_window_plain(t(q), t(kp), t(vp), t(TABLE), t(off), tvl,
                                  scale)
    routed = k_pa.paged_window_attention(t(q), t(kp), t(vp), t(TABLE),
                                         t(off), tvl, scale)
    assert k_pa.launches_window == before  # CPU tensors: no kernel
    torch.testing.assert_close(routed, got, rtol=0, atol=0)
    assert got.shape == q.shape and got.dtype == torch.float32
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(_np(got), np.asarray(want_kernel), **TOL)
    if vl is not None:
        for b, n in enumerate(vl):
            assert (_np(got)[b, n:] == 0).all()
            assert (np.asarray(want_kernel)[b, n:] == 0).all()


# ----------------------------------------------------------------- layer
UNITS = 32  # H=2 heads of D=16


@pytest.fixture(scope="module", params=[True, False],
                ids=["causal", "noncausal"])
def layers(request):
    mx.random.seed(3)
    jmha = JaxMHA(UNITS, H, dropout=0.0, causal=request.param)
    jmha.initialize(mx.initializer.Xavier())
    jmha.prefill(nd.array(np.zeros((1, 2, UNITS), np.float32)))
    arrays = {n: p.data().asnumpy()
              for n, p in jmha._collect_params_with_prefix().items()}
    tmha = MultiHeadAttention(UNITS, H, causal=request.param,
                              device="cpu").eval()
    load_mxnet_tpu_params(arrays, tmha)
    return jmha, tmha


def _pools(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(9, PS, H, D).astype(np.float32) for _ in range(2)]


def _check_step(jout, jkp, jvp, tout, tkp, tvp, live):
    """Outputs on the live (row, query) pairs; pools past the trash
    page."""
    got, want = _np(tout), _np(jout)
    for b, q in zip(*np.nonzero(live)):
        np.testing.assert_allclose(got[b, q], want[b, q], **TOL)
    assert np.isfinite(got[live]).all()
    np.testing.assert_allclose(_np(tkp)[1:], np.asarray(jkp)[1:], **TOL)
    np.testing.assert_allclose(_np(tvp)[1:], np.asarray(jvp)[1:], **TOL)


def test_paged_window_step_matches_jax(layers, monkeypatch):
    """A 4-token window: row 0 from position 2 across a page edge, row 1
    from 5 with two padding tokens, row 2 inactive on the trash table."""
    monkeypatch.delenv("MXTPU_FLASH_PAGED", raising=False)
    jmha, tmha = layers
    rng = np.random.RandomState(7)
    S = 4
    x = rng.randn(3, S, UNITS).astype(np.float32)
    pos = np.array([2, 5, 0], np.int32)
    active = np.array([True, True, False])
    vl = np.array([4, 2, 1], np.int32)
    kp, vp = _pools(8)
    jout, jkp, jvp = jmha.paged_window_step(
        nd.array(x), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(TABLE),
        jnp.asarray(pos), jnp.asarray(active), jnp.asarray(vl))
    t = torch.from_numpy
    with torch.inference_mode():
        tout, tkp, tvp = tmha.paged_window_step(
            t(x), t(kp.copy()), t(vp.copy()), t(TABLE), t(pos), t(active),
            t(vl))
    live = active[:, None] & (np.arange(S)[None, :] < vl[:, None])
    _check_step(jout, jkp, jvp, tout, tkp, tvp, live)
    if tmha._causal:  # B6's route zeroes the padding queries' attention
        bias = _np(tmha.out_proj.bias)
        np.testing.assert_array_equal(_np(tout)[1, 2:],
                                      np.broadcast_to(bias, (2, UNITS)))


def test_paged_step_matches_jax(layers, monkeypatch):
    """One token per row (row 1 mid-page, row 0 at a page edge, row 2
    inactive); the non-causal layer attends every gathered key (C2)."""
    monkeypatch.delenv("MXTPU_FLASH_PAGED", raising=False)
    jmha, tmha = layers
    rng = np.random.RandomState(9)
    x = rng.randn(3, 1, UNITS).astype(np.float32)
    pos = np.array([4, 6, 0], np.int32)
    active = np.array([True, True, False])
    kp, vp = _pools(10)
    jout, jkp, jvp = jmha.paged_step(
        nd.array(x), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(TABLE),
        jnp.asarray(pos), jnp.asarray(active))
    t = torch.from_numpy
    with torch.inference_mode():
        tout, tkp, tvp = tmha.paged_step(
            t(x), t(kp.copy()), t(vp.copy()), t(TABLE), t(pos), t(active))
    _check_step(jout, jkp, jvp, tout, tkp, tvp, active[:, None])
