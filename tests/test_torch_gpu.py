"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Each test decides inside itself whether a card is present and
skips without one. On a machine with a card (which has no JAX, so the
suite's conftest cannot load there) run them with
``python -m pytest --noconftest tests/test_torch_gpu.py -q``.

Tolerance: float32 kernels sum in another order than the plain versions
(1e-5 absolute and relative for LayerNorm, 2e-5 for attention over up
to 512 keys); bfloat16 outputs (LayerNorm and flash attention; the paged
kernel serves the float32 cache only) are compared within 2 bf16 ulps of
O(1) values (2e-2). The paged window kernel (B6) is held against its
plain version on CPU copies at 1e-5 absolute and relative: it sums at
most 176 keys per query in another order.

The backward kernels (B2 LayerNorm, B4a/B4b flash attention) are held
against their plain versions run on CPU copies of the same inputs in
float32, out of the kernels' reach: max_abs_err <= 1e-4 * max(1,
max|ref|) for float32 operands, 3e-2 * max(1, max|ref|) for bfloat16
(outputs rounded to bfloat16, sums over up to 8192 rows); and
||got - ref||_2 / ||ref||_2 <= 1e-5 (float32) or 1e-2 (bfloat16), since
max|ref| comes from outlier rows (a one-key row gathers every query's
gradient) and the first bound alone would pass a kernel wrong on most
rows.

The BatchNorm reductions (B7 statistics, B8 backward sums) are held the
same way against their plain versions on CPU float32 copies of the same
inputs (bf16 inputs widen exactly, so float32 bounds apply to both
dtypes: the sums differ in order only), the mean within 1e-5 * max(1,
max|x|) since it is a sample plus a shifted sum and near-zero means carry
the sample's rounding; the cancellation input (mean
1000, std 0.5) is also held against the float64 variance within 1e-4
relative, the bound the JAX package's kernel meets.
"""

import pytest
import torch

from mxnet_tpu_torch.ops.kernels import batch_norm as k_bn
from mxnet_tpu_torch.ops.kernels import flash_attention as k_fa
from mxnet_tpu_torch.ops.kernels import layer_norm as k_ln
from mxnet_tpu_torch.ops.kernels import paged_attention as k_pa

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows,C", [(8, 512), (4096, 512), (33, 4096),
                                    (8192, 768)])
def test_layer_norm_kernel(rows, C, dtype, tol):
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(rows + C)
    x = (torch.randn(rows, C, generator=g) * 3 + 1).to(dev, dtype)
    gamma = torch.randn(C, generator=g).to(dev, dtype)
    beta = torch.randn(C, generator=g).to(dev, dtype)
    before = k_ln.launches
    got = k_ln.layer_norm_fwd(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    want = k_ln.layer_norm_plain(x, gamma, beta, 1e-5)
    assert k_ln.launches == before + 1
    _close(got[0], want[0], tol)
    _close(got[1], want[1], 1e-5)
    _close(got[2], want[2], 1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,S,D,vl", [(8, 8, 512, 64, [512, 0, 300, 1,
                                                         511, 64, 65, 200]),
                                        (16, 12, 512, 64, [512, 0, 300, 1,
                                                           511, 64, 65, 200,
                                                           256, 384, 500, 17,
                                                           129, 450, 333,
                                                           77]),
                                        (2, 3, 77, 64, None),
                                        (1, 2, 130, 64, [129])])
def test_flash_attention_kernel(B, H, S, D, vl, causal, dtype, tol):
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(B * S + D)
    q, k, v = (torch.randn(B, H, S, D, generator=g).to(dev, dtype)
               for _ in range(3))
    vlt = None if vl is None else torch.tensor(vl, dtype=torch.int32,
                                               device=dev)
    before = k_fa.launches
    out, lse = k_fa.flash_attention_fwd(q, k, v, vlt, causal)
    torch.cuda.synchronize()
    want_out, want_lse = k_fa.flash_attention_plain(q, k, v, vlt, causal)
    assert k_fa.launches == before + 1
    _close(out, want_out, tol)
    _close(lse, want_lse, 1e-4)


def test_paged_decode_kernel():
    """8 slots, page_size 16, P=5, float32 (the only cache dtype the
    kernel takes): rows mid-page, an inactive row on the trash page and a
    finished row whose pos is past the capacity."""
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(0)
    slots, H, D, ps, P = 8, 8, 64, 16, 5
    num_pages = 1 + slots * P
    kp = torch.randn(num_pages, ps, H, D, generator=g).to(dev)
    vp = torch.randn(num_pages, ps, H, D, generator=g).to(dev)
    q = torch.randn(slots, H, D, generator=g).to(dev)
    table = (1 + torch.arange(slots * P, dtype=torch.int32)).reshape(
        slots, P)
    table[3] = 0  # inactive row: trash page only
    pos = torch.tensor([0, 15, 16, 0, 40, 79, 95, 7], dtype=torch.int32)
    table, pos = table.to(dev), pos.to(dev)
    before = k_pa.launches
    got = k_pa.paged_decode_attention(q, kp, vp, table, pos, D ** -0.5)
    torch.cuda.synchronize()
    want = k_pa.paged_decode_plain(q, kp, vp, table, pos, D ** -0.5)
    assert k_pa.launches == before + 1
    assert torch.isfinite(got.float()).all()
    _close(got, want, 2e-5)


# the forced-prefix replay's shapes: 8 rows, H=8, D=64, page_size 16,
# P=11 pages a row (1 + 128 + 32 positions); offsets 0, 1 and mid-page
WINDOW_OFFSETS = [1, 1, 0, 9, 1, 40, 0, 0]


def _window_inputs(S, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    B, H, D, ps, P = 8, 8, 64, 16, 11
    kp = torch.randn(1 + B * P, ps, H, D, generator=g)
    vp = torch.randn(1 + B * P, ps, H, D, generator=g)
    q = torch.randn(B, S, H, D, generator=g)
    table = (1 + torch.arange(B * P, dtype=torch.int32)).reshape(B, P)
    table[6] = 0  # a padding row: all-trash table, one live query
    off = torch.tensor(WINDOW_OFFSETS, dtype=torch.int32)
    vl = torch.tensor([S, max(S - 3, 0), S, max(S // 2, 1), 1, S, 1,
                       max(S - 1, 0)], dtype=torch.int32)
    return q, kp, vp, table, off, vl


@pytest.mark.parametrize("S", [1, 16, 128])
def test_paged_window_kernel(S):
    """B6 at the replay's shapes against its plain version on CPU
    copies; padding queries exactly 0, the same bits on a second call,
    one launch per call."""
    dev = _card()
    args = _window_inputs(S, S)
    cuda = [t.to(dev) for t in args]
    before = k_pa.launches_window
    got = k_pa.paged_window_attention(*cuda, 64 ** -0.5)
    torch.cuda.synchronize()
    assert k_pa.launches_window == before + 1
    want = k_pa.paged_window_plain(*args, 64 ** -0.5)
    assert torch.isfinite(got).all() and got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    for b, n in enumerate(args[-1].tolist()):
        assert (got[b, n:] == 0).all()
    again = k_pa.paged_window_attention(*cuda, 64 ** -0.5)
    assert torch.equal(again, got)


def test_paged_window_kernel_rejects_what_it_does_not_take():
    dev = _card()
    q, kp, vp, table, off, vl = (t.to(dev) for t in _window_inputs(4, 0))
    with pytest.raises(Exception, match="float32 with head dim 64"):
        k_pa.paged_window_attention(q.bfloat16(), kp.bfloat16(),
                                    vp.bfloat16(), table, off, vl, 0.125)
    with pytest.raises(Exception, match="float32 with head dim 64"):
        k_pa.paged_window_attention(q[..., :32].contiguous(),
                                    kp[..., :32].contiguous(),
                                    vp[..., :32].contiguous(), table, off,
                                    vl, 0.125)
    with pytest.raises(Exception, match="int32"):
        k_pa.paged_window_attention(q, kp, vp, table.long(), off, vl, 0.125)
    with pytest.raises(Exception, match="contiguous"):
        k_pa.paged_window_attention(q.transpose(1, 2).contiguous()
                                    .transpose(1, 2), kp, vp, table, off,
                                    vl, 0.125)


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
BWD_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _close_to_cpu(got, want, dtype):
    """``got`` (card) against ``want`` (plain version on the CPU, f32)."""
    got = got.float().cpu()
    assert torch.isfinite(got).all()
    if not want.numel():
        return
    diff = (got - want).abs()
    err = float(diff.max())
    scale = max(1.0, float(want.abs().max()))
    assert err <= BWD_TOL[dtype] * scale, (err, scale)
    dnorm = float(diff.double().norm())
    assert dnorm <= BWD_REL_L2[dtype] * float(want.double().norm()), \
        (dnorm, float(want.double().norm()))


def _cpu32(*tensors):
    return [None if t is None else
            (t.cpu().float() if t.is_floating_point() else t.cpu())
            for t in tensors]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,C", [(8192, 768), (1, 128), (257, 4096),
                                    (0, 256)])
def test_layer_norm_bwd_kernel(rows, C, dtype):
    """B2 against ``layer_norm_bwd_plain`` on the CPU; dgamma/dbeta come
    out the same bits on a second run (fixed-order partials, no
    atomics)."""
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(rows + C)
    x = (torch.randn(rows, C, generator=g) * 3 + 1).to(dev, dtype)
    gamma = (1 + 0.1 * torch.randn(C, generator=g)).to(dev, dtype)
    beta = torch.randn(C, generator=g).to(dev, dtype)
    dy = torch.randn(rows, C, generator=g).to(dev, dtype)
    _, mean, rstd = k_ln.layer_norm_fwd(x, gamma, beta, 1e-5)
    before = k_ln.launches_bwd
    got = k_ln.layer_norm_bwd(x, gamma, mean, rstd, dy)
    torch.cuda.synchronize()
    assert k_ln.launches_bwd == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    want = k_ln.layer_norm_bwd_plain(*_cpu32(x, gamma, mean, rstd, dy))
    for o, w in zip(got, want):
        _close_to_cpu(o, w, dtype)
    again = k_ln.layer_norm_bwd(x, gamma, mean, rstd, dy)
    assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,S,vl", [
    (16, 12, 512, [512, 0, 300, 1, 511, 64, 65, 200, 256, 384, 500, 17,
                   129, 450, 333, 77]),
    (2, 3, 77, None),
    (1, 2, 130, [129])])
def test_flash_attention_bwd_kernels(B, H, S, vl, causal, dtype):
    """B4a (dk, dv) and B4b (dq) against their plain versions on the CPU,
    from the same forward ``lse`` and ``delta``; each launch counter rises
    by one."""
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(B * S + H)
    q, k, v, do = (torch.randn(B, H, S, 64, generator=g).to(dev, dtype)
                   for _ in range(4))
    vlt = None if vl is None else torch.tensor(vl, dtype=torch.int32,
                                               device=dev)
    out, lse = k_fa.flash_attention_fwd(q, k, v, vlt, causal)
    delta = (do.float() * out.float()).sum(-1)
    before = (k_fa.launches_bwd_dkdv, k_fa.launches_bwd_dq)
    dk, dv = k_fa.flash_attention_bwd_dkdv(q, k, v, vlt, lse, delta, do,
                                           causal)
    dq = k_fa.flash_attention_bwd_dq(q, k, v, vlt, lse, delta, do, causal)
    torch.cuda.synchronize()
    assert (k_fa.launches_bwd_dkdv, k_fa.launches_bwd_dq) == \
        (before[0] + 1, before[1] + 1)
    args = _cpu32(q, k, v, vlt, lse, delta, do)
    want_dk, want_dv = k_fa.flash_attention_bwd_dkdv_plain(*args, causal)
    want_dq = k_fa.flash_attention_bwd_dq_plain(*args, causal)
    for o, w in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        _close_to_cpu(o, w, dtype)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bwd_repeats_its_bits(causal):
    """A race between the threads of B4a or B4b would show as bits that
    change from call to call: 20 calls on the training path's f32 inputs
    (where one run once read a dK/dV error 28x the others') give the
    bits of the first."""
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(7)
    q, k, v, do = (torch.randn(16, 12, 512, 64, generator=g).to(dev)
                   for _ in range(4))
    vl = torch.tensor([512, 0, 300, 1, 511, 64, 65, 200, 256, 384, 500, 17,
                       129, 450, 333, 77], dtype=torch.int32, device=dev)
    out, lse = k_fa.flash_attention_fwd(q, k, v, vl, causal)
    delta = (do.float() * out.float()).sum(-1)
    first = k_fa.flash_attention_bwd_dkdv(q, k, v, vl, lse, delta, do,
                                          causal) + \
        (k_fa.flash_attention_bwd_dq(q, k, v, vl, lse, delta, do, causal),)
    for _ in range(19):
        again = k_fa.flash_attention_bwd_dkdv(q, k, v, vl, lse, delta, do,
                                              causal) + \
            (k_fa.flash_attention_bwd_dq(q, k, v, vl, lse, delta, do,
                                         causal),)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


# (M, C) of ResNet-50's BatchNorms at B=64, 224x224 (53 a step)
BN_PATH_SHAPES = [(802816, 64), (200704, 64), (200704, 256), (50176, 128),
                  (50176, 512), (12544, 256), (12544, 1024), (3136, 512),
                  (3136, 2048)]


def _bn_inputs(M, C, dtype, seed, mean=0.0, std=1.0, offset=0):
    """x, dy (M, C) on the card; ``offset`` starts x one element into its
    storage, so that it is not 16-byte aligned."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    base = (torch.randn(M * C + offset, generator=g) * std + mean)
    x = base[offset:].reshape(M, C).to("cuda", dtype)
    if offset:
        flat = torch.empty(M * C + offset, dtype=dtype, device="cuda")
        flat[offset:] = x.reshape(-1)
        x = flat[offset:].view(M, C)
    dy = torch.randn(M, C, generator=g).to("cuda", dtype)
    return x, dy


def _check_bn_kernels(x, dy):
    before = (k_bn.launches_stats, k_bn.launches_bwd)
    mean, var = k_bn.bn_stats(x)
    inv = torch.rsqrt(var + 1e-5)
    sd, sdx = k_bn.bn_bwd_reduce(x, dy, mean, inv)
    torch.cuda.synchronize()
    assert (k_bn.launches_stats, k_bn.launches_bwd) == \
        (before[0] + 1, before[1] + 1)
    want_m, want_v = k_bn.bn_stats_plain(*_cpu32(x))
    want_sd, want_sdx = k_bn.bn_bwd_reduce_plain(*_cpu32(x, dy, mean, inv))
    # the mean is s + S1 / M with s one sample: its error scales with the
    # data (an ulp of max|x|), not with the mean, which can be near 0
    assert mean.dtype == torch.float32 and mean.shape == want_m.shape
    err = float((mean.cpu() - want_m).abs().max())
    assert err <= 1e-5 * max(1.0, float(x.abs().max())), err
    for o, w in ((var, want_v), (sd, want_sd), (sdx, want_sdx)):
        assert o.dtype == torch.float32 and o.shape == w.shape
        _close_to_cpu(o, w, torch.float32)
    again = k_bn.bn_stats(x) + k_bn.bn_bwd_reduce(x, dy, mean, inv)
    assert all(torch.equal(a, b) for a, b in zip(again,
                                                 (mean, var, sd, sdx)))
    return var


@pytest.mark.parametrize("M,C", BN_PATH_SHAPES)
def test_bn_kernels_at_the_path_shapes(M, C):
    """B7 and B8 in bf16 at every shape of the ResNet-50 step: within
    tolerance of the plain versions, and the same bits on a second
    call (fixed-order partials, no atomics)."""
    _card()
    _check_bn_kernels(*_bn_inputs(M, C, torch.bfloat16, M + C, mean=0.5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,C,offset", [(100003, 320, 0), (4099, 7, 0),
                                        (1, 8, 0), (2, 2048, 0),
                                        (5000, 64, 1)])
def test_bn_kernels_ragged_and_unaligned(M, C, offset, dtype):
    """An M that no chunk length divides, C off the 16-byte vector, one
    row, and an operand that starts off a 16-byte boundary (the scalar
    load path)."""
    _card()
    _check_bn_kernels(*_bn_inputs(M, C, dtype, M * 7 + C, offset=offset))


def test_bn_stats_cancellation_input():
    """mean 1000, std 0.5: the shifted sums keep the variance within
    1e-4 relative of the float64 one."""
    _card()
    x, dy = _bn_inputs(50176, 64, torch.float32, 11, mean=1000.0, std=0.5)
    var = _check_bn_kernels(x, dy)
    ref = x.double().var(dim=0, unbiased=False).cpu()
    torch.testing.assert_close(var.double().cpu(), ref, rtol=1e-4, atol=0)


def test_bn_kernels_reject_what_they_do_not_take():
    dev = _card()
    x = torch.zeros(4, 8, device=dev, dtype=torch.float16)
    with pytest.raises(Exception, match="float32 or bfloat16"):
        k_bn.bn_stats(x)
    with pytest.raises(Exception, match="contiguous"):
        k_bn.bn_stats(torch.zeros(8, 4, device=dev).t())
    with pytest.raises(Exception, match="non-empty"):
        k_bn.bn_stats(torch.zeros(0, 4, device=dev))
