"""Card smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc`` with
``nvcc`` for ``sm_90a`` and drives the port's four paths: serving,
forced-prefix replay, the BERT training step and the ResNet-50 training
step.

Serving: checks each serving kernel against its plain PyTorch version at
the serving path's shapes and times it (CUDA-graph replay timed with CUDA
events) beside its plain version, a PyTorch library call computing the
same function where one exists, and its bound (inputs cycle through
copies larger than the L2 cache, so each call reads them from device
memory); serves 16 requests of Transformer-base at full width (random
weights from a seed) through ``ContinuousBatcher`` and checks that every
serving kernel launched on that path; cross-checks two of the served
requests against the same weights on the CPU.

Forced prefix: checks the paged window kernel (B6) at the replay's
shapes (windows of 1, 16 and 128 queries, offsets and padding) against
its plain version on CPU copies and times it beside its plain version and
``F.scaled_dot_product_attention`` over K/V gathered beforehand; replays
four histories through ``InferStep.prefill_suffix_paged`` wide (B6) and
sequential (K3) on copies of one state and compares their logits and
written K/V, and the wide replay with a CPU copy of the model; serves 12
requests with forced histories (``submit(prefix_ids=...)``, up to 128
tokens) through a ``ContinuousBatcher`` with ``suffix_wide=True`` and
through one without, checks B6's launches against the replay dispatches
and the transcripts against each other wherever the logits decide them.

Training: checks the backward kernels (LayerNorm backward; the dK/dV and
dQ kernels of the flash-attention backward), and the forward kernels
whose outputs they take, at the training path's shapes in float32 and
bfloat16 against their plain versions run on CPU copies of the inputs in
float32, and times the backward kernels the same way; trains a 2-layer
BERT at full width for two AdamW steps on the card and on the CPU from
the same weights and compares losses and parameters; trains BERT-base
(bf16 compute, dropout 0.1, B=16, S=512, ragged valid lengths) for 2
warm-up and 10 timed steps through ``TrainStep`` and checks the losses,
every kernel's launch count against the model's structure, and one
profiled step.

ResNet: checks the BatchNorm kernels (B7 statistics, B8 backward sums)
at all nine shapes of the ResNet-50 step in float32 and bfloat16, on a
cancellation input (mean 1000, std 0.5) and at an M that no chunk
divides, against their plain versions on CPU float32 copies, and times
them at the stem and stage 4 beside ``torch.batch_norm_stats`` and
``torch.batch_norm_backward_reduce``; trains a narrow channel-last
ResNet v1 for two SGD steps on the card and on the CPU from the same
weights and compares losses, parameters and running statistics; trains
ResNet-50 v1 (channel-last, SGD momentum 0.9, bf16 compute, B=64,
224x224, ``bench_resnet50.py``'s configuration) for 2 warm-up and 10
timed steps and checks the losses, the launch counts (one B7 and one B8
per BatchNorm per step) and one profiled step.

It prints one ``{"kernels": [...]}`` line, the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as its last line. Any failed
check exits non-zero; without a card it exits non-zero before doing
anything. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# the serving configuration of the port's first slice
VOCAB = 32768
BUCKETS = (128, 512)
SLOTS = 8
PAGE_SIZE = 16
MAX_NEW = 64
ITER_TOKENS = 4
# the training configuration of the port's second slice: bench.py:42-70
# (BERT-base, tied-embedding masked-LM loss, AdamW 1e-4, bf16 compute and
# moments) at BERT's phase-2 sequence length, 8192 tokens a step
TRAIN_VOCAB = 30522
TRAIN_B, TRAIN_S = 16, 512
# ragged rows: full length, one token, lengths off the 64-key tiles
TRAIN_VL = [512, 1, 300, 511, 448, 384, 200, 512, 65, 257, 129, 500, 333,
            77, 450, 512]
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# valid lengths of the backward kernel checks (a row with none, too)
KCHECK_VL = [512, 0, 300, 1, 511, 64, 65, 200, 256, 384, 500, 17, 129,
             450, 333, 77]
# the vision configuration of the port's third slice:
# benchmarks/bench_resnet50.py:19-45 (ResNet-50 v1, SGD lr 0.1 momentum
# 0.9, bf16 compute and state) in the channel-last layout, B=64 at 224x224
RESNET_B, RESNET_HW, RESNET_CLASSES = 64, 224, 1000
RESNET_WARMUP, RESNET_STEPS = 2, 10
# no loss of that run may pass this multiple of the first (about ln 1000
# at Xavier init): the momentum overshoot stays well under it, a bf16 run
# that diverges does not
RESNET_LOSS_CAP = 1.5
# (M, C) of its 53 BatchNorms (launches per step): the kernels' shapes
BN_PATH_SHAPES = [(802816, 64, 1), (200704, 64, 6), (200704, 256, 4),
                  (50176, 128, 8), (50176, 512, 5), (12544, 256, 12),
                  (12544, 1024, 7), (3136, 512, 6), (3136, 2048, 4)]
# the forced-prefix replay of the port's fourth slice: slice 1's model
# and batcher with a 128-token history budget (suffix menu 1, 2, ..., 128;
# pages_for(1 + 128 + 32, 16) = 11 pages a slot), replayed in one window
# pass through kernel B6 (suffix_wide) and, for comparison, position by
# position on K3
PREFIX_MAX, PREFIX_MAX_NEW = 128, 32
PREFIX_PAGES = math.ceil((1 + PREFIX_MAX + PREFIX_MAX_NEW) / PAGE_SIZE)
# 12 requests: histories crossing page and menu edges, one without
PREFIX_LENS = [1, 2, 15, 16, 17, 63, 64, 65, 100, 127, 128, 0]
ENGINE_PREFIX_LENS = [1, 17, 64, 128]
# B6 against its plain version on CPU f32 copies: max-abs and relative L2
WINDOW_TOL = 1e-5
# the wide replay against the sequential one (last logits; the written
# K/V), and against a CPU copy of the model (last logits)
PREFIX_LOGIT_TOL = 1e-3
PREFIX_KV_TOL = 1e-4
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# operations/s outside the tensor cores, and the dense bf16 tensor-core
# rate. The kernels compute bf16 inputs in f32; a bound states the least
# time for the work, so bf16 work is held to the bf16 rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
L2_BYTES = 50 * 2 ** 20
# tolerances of the kernel checks: float32 kernels sum in another order
# than their plain versions; bfloat16 outputs within 2 bf16 ulps of O(1)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the CPU cross-check: fp32 logits of 6+6 layers at width 512 summed in
# other orders on the card and the CPU (expected about 1e-5)
XCHECK_TOL = 1e-3
# the training path's kernels against their plain versions on CPU copies
# in f32: max_abs_err <= tol * max(1, max|ref|); f32 sums in another
# order, bf16 outputs rounded to bf16
CPU_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# and ||got - ref||_2 / ||ref||_2 <= rel: max|ref| comes from outlier rows
# (a one-key row gathers every query's gradient), so the bound above alone
# would pass a kernel wrong on most rows; bf16 rounding alone is 2^-9
CPU_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# the training cross-check (2 layers, f32, two AdamW steps, card vs CPU)
XTRAIN_LOSS_RTOL = 1e-4
XTRAIN_PARAM_ATOL = 2e-5
# the BatchNorm kernels' outputs are f32 sums of the same (bf16-exact)
# inputs as the CPU oracle's, in another order: the f32 bounds of
# CPU_TOL / CPU_REL_L2 hold for both input dtypes; the cancellation
# input's variance is held to the float64 one within 1e-4 relative (the
# bound the JAX package's kernel meets)
BN_CANCEL_RTOL = 1e-4
# the narrow ResNet cross-check (f32, TF32 off, two SGD steps at lr 0.1,
# card vs CPU): each step amplifies the sums' round-off about tenfold
# (the CPU parity test with the JAX package reads 3e-7 then 1.2e-6 on
# the losses), so losses within 1e-4 relative; parameters and running
# statistics within 1e-4 of max(1, their largest entry)
XRESNET_LOSS_RTOL = 1e-4
XRESNET_PARAM_TOL = 1e-4


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, arg_sets, reps=32, iters=10):
    """Device time of one ``fn(*args)`` call: ``reps`` calls, cycling
    through ``arg_sets``, captured in a CUDA graph and replayed ``iters``
    times between two CUDA events."""
    calls = [arg_sets[i % len(arg_sets)] for i in range(reps)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*calls[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in calls:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def cold_copies(args, nbytes):
    """Copies of a call's tensors for ``time_ms`` to cycle through, enough
    that each call's inputs have left the 50 MB L2 cache since their last
    use (at most 16: a small call stays L2-resident and launch-bound)."""
    n = max(1, min(16, math.ceil(2 * L2_BYTES / nbytes)))
    return [args] + [tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args) for _ in range(n - 1)]


def bound_ms(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def check_close(name, got, want, tol):
    err = max_err(got, want)
    ok = bool(torch.isfinite(got.float()).all()) and err <= tol
    print(f"check {name}: max_abs_err={err:.3e} tol={tol:.0e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def cpu_f32(*tensors):
    """CPU copies, float tensors in float32: the oracles' inputs."""
    return [None if t is None else
            (t.cpu().float() if t.is_floating_point() else t.cpu())
            for t in tensors]


def check_vs_cpu(name, got, want, dt, launched, may_match=False):
    """A kernel's output (on the card) against its plain version run on
    the CPU in float32. Fails unless the kernel launched once for this
    call, the output is finite, within ``CPU_TOL`` and within
    ``CPU_REL_L2``; an f32 output equal to the oracle bit for bit means
    the kernel was compared with itself, and fails too, unless
    ``may_match`` (f32 statistics of bf16 inputs, whose sums can be exact
    in any order)."""
    diff = (got.float().cpu() - want).abs()
    err = float(diff.max())
    tol = CPU_TOL[dt] * max(1.0, float(want.abs().max()))
    ref = float(want.double().norm())
    rel = float(diff.double().norm()) / ref if ref else \
        (0.0 if err == 0.0 else math.inf)
    ndiff = int((diff > 0).sum())
    ok = bool(torch.isfinite(got.float()).all()) and err <= tol \
        and rel <= CPU_REL_L2[dt] and launched == 1 \
        and not (dt == torch.float32 and err == 0.0 and not may_match)
    print(f"check {name}: max_abs_err={err:.3e} tol={tol:.3e} rel_l2="
          f"{rel:.3e} tol={CPU_REL_L2[dt]:.0e} differing {ndiff} of "
          f"{diff.numel()} launches {launched} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version on the CPU, or the "
             "kernel did not launch")
    return err


# --------------------------------------------------------------- kernels
def check_layer_norm(dev, gen):
    from mxnet_tpu_torch.ops.kernels import layer_norm as K

    C, errs, rows_out = 512, [], {}
    for rows in (8, 4096):
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(rows, C, generator=gen) * 3 + 1).to(dev, dt)
            g = torch.randn(C, generator=gen).to(dev, dt)
            b = torch.randn(C, generator=gen).to(dev, dt)
            out = K.layer_norm_fwd(x, g, b, 1e-5)
            torch.cuda.synchronize()
            want = K.layer_norm_plain(x, g, b, 1e-5)
            err = check_close(f"layer_norm rows={rows} {dt}", out[0],
                              want[0], TOL[dt])
            check_close(f"layer_norm mean rows={rows} {dt}", out[1],
                        want[1], 1e-5)
            if dt == torch.float32:
                errs.append(err)
                rows_out[rows] = (x, g, b)
    timings = {}
    for rows, (x, g, b) in rows_out.items():
        nbytes = 2 * x.numel() * 4 + 2 * C * 4 + 2 * rows * 4
        bnd, by = bound_ms(nbytes, 8 * x.numel())
        sets = cold_copies((x, g, b), nbytes)
        timings[rows] = dict(
            ms=time_ms(lambda x, g, b: K.layer_norm_fwd(x, g, b, 1e-5),
                       sets),
            plain_ms=time_ms(
                lambda x, g, b: K.layer_norm_plain(x, g, b, 1e-5), sets),
            library_ms=time_ms(
                lambda x, g, b: torch.nn.functional.layer_norm(
                    x, (C,), g, b, 1e-5), sets),
            bound_ms=bnd, bound_by=by)
        print(f"timing layer_norm rows={rows} C={C} f32: "
              f"{json.dumps(timings[rows])}")
    return dict(name="layer_norm_fwd", route="cuda",
                source="mxnet_tpu_torch/csrc/layer_norm.cu",
                replaces="mxnet_tpu/ops/pallas/layer_norm.py:38",
                max_abs_err=max(errs), **timings[4096])


def check_flash_attention(dev, gen):
    from mxnet_tpu_torch.ops.kernels import flash_attention as K

    B, H, S, D = 8, 8, 512, 64
    vl_list = [512, 0, 300, 1, 511, 64, 65, 200]
    vl = torch.tensor(vl_list, dtype=torch.int32, device=dev)
    errs, timed = [], None
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(B, H, S, D, generator=gen).to(dev, dt)
                   for _ in range(3))
        for causal in (False, True):
            out, lse = K.flash_attention_fwd(q, k, v, vl, causal)
            torch.cuda.synchronize()
            want, want_lse = K.flash_attention_plain(q, k, v, vl, causal)
            err = check_close(f"flash_attention causal={causal} {dt}", out,
                              want, TOL[dt])
            check_close(f"flash_attention lse causal={causal} {dt}", lse,
                        want_lse, 1e-4)
            if not bool((out[1] == 0).all()):
                fail("flash_attention: a row with valid_length 0 must "
                     "output 0")
            if dt == torch.float32:
                errs.append(err)
                if not causal:
                    timed = (q, k, v)
    q, k, v = timed
    # this run's data: row b attends its first vl[b] keys
    keys = sum(min(n, S) for n in vl_list)
    nbytes = (B * H * S * D + 2 * H * D * keys) * 4 \
        + B * H * S * D * 4 + B * H * S * 4 + B * 4  # q, k/v; out, lse
    flops = 4 * H * S * D * keys
    bnd, by = bound_ms(nbytes, flops)
    mask = (torch.arange(S, device=dev)[None, :] < vl[:, None]).view(
        B, 1, 1, S)
    sets = cold_copies((q, k, v, vl, mask), nbytes)
    res = dict(
        ms=time_ms(lambda q, k, v, vl, _: K.flash_attention_fwd(
            q, k, v, vl, False), sets),
        plain_ms=time_ms(lambda q, k, v, vl, _: K.flash_attention_plain(
            q, k, v, vl, False), sets),
        library_ms=time_ms(
            lambda q, k, v, _, mask:
            torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), sets),
        bound_ms=bnd, bound_by=by)
    print(f"timing flash_attention B={B} H={H} S={S} D={D} f32 "
          f"vl={vl_list}: {json.dumps(res)}")
    return dict(name="flash_attention_fwd", route="cuda",
                source="mxnet_tpu_torch/csrc/flash_attention.cu",
                replaces="mxnet_tpu/ops/pallas/flash_attention.py:51",
                max_abs_err=max(errs), **res)


def check_paged_attention(dev, gen):
    from mxnet_tpu_torch.ops.kernels import paged_attention as K

    slots, H, D, P = SLOTS, 8, 64, 5
    num_pages = 1 + slots * P
    table = (1 + torch.arange(slots * P, dtype=torch.int32)).reshape(
        slots, P)
    table[3] = 0  # an inactive row: every entry on the trash page
    pos_list = [0, 15, 16, 0, 40, 64, 95, 7]  # 95 is past P * 16
    table = table.to(dev)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    # the serving path's cache is float32, the only dtype K3 takes
    kp, vp = (torch.randn(num_pages, PAGE_SIZE, H, D, generator=gen).to(dev)
              for _ in range(2))
    q = torch.randn(slots, H, D, generator=gen).to(dev)
    out = K.paged_decode_attention(q, kp, vp, table, pos, D ** -0.5)
    torch.cuda.synchronize()
    want = K.paged_decode_plain(q, kp, vp, table, pos, D ** -0.5)
    err = check_close("paged_decode_attention torch.float32", out, want,
                      TOL[torch.float32])
    keys = sum(min(p + 1, P * PAGE_SIZE) for p in pos_list)
    nbytes = 2 * keys * H * D * 4 + 2 * slots * H * D * 4 \
        + slots * (P + 1) * 4
    bnd, by = bound_ms(nbytes, 4 * H * D * keys)
    sets = cold_copies((q, kp, vp, table, pos, D ** -0.5), nbytes)
    q_abs = pos.view(slots, 1, 1)  # the one query's position
    lib_sets = cold_copies(gathered_sdpa_args(q[:, None], kp, vp, table,
                                              q_abs), nbytes)
    res = dict(ms=time_ms(K.paged_decode_attention, sets),
               plain_ms=time_ms(K.paged_decode_plain, sets),
               library_ms=time_ms(sdpa, lib_sets), bound_ms=bnd,
               bound_by=by)
    print(f"timing paged_decode_attention slots={slots} H={H} D={D} "
          f"page_size={PAGE_SIZE} P={P} f32 pos={pos_list} (library: "
          f"F.scaled_dot_product_attention over K/V gathered beforehand, "
          f"bool mask; the gather not timed): {json.dumps(res)}")
    return dict(name="paged_decode_attention", route="cuda",
                source="mxnet_tpu_torch/csrc/paged_attention.cu",
                replaces="mxnet_tpu/ops/pallas/paged_flash_attention.py:89",
                max_abs_err=err, **res)


def gathered_sdpa_args(q, kp, vp, table, q_abs):
    """Operands of the library yardstick of the paged kernels: q (B, S,
    H, D) as (B, H, S, D), the (B, H, P*page_size, D) K/V views gathered
    through the table, and the boolean mask of the keys at positions <=
    each query's ``q_abs`` (B, S, 1)."""
    B, S, H, D = q.shape
    L = table.shape[1] * kp.shape[1]
    idx = table.long()
    kg, vg = (p[idx].reshape(B, L, H, D).transpose(1, 2).contiguous()
              for p in (kp, vp))
    keys = torch.arange(L, device=q.device).view(1, 1, L)
    mask = (keys <= q_abs).view(B, 1, S, L)
    return q.transpose(1, 2).contiguous(), kg, vg, mask


def sdpa(q, k, v, mask):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                            attn_mask=mask)


def check_paged_window(dev, gen):
    """B6 at the forced-prefix replay's shapes (8 rows, H=8, D=64,
    page_size 16, P=11) for windows of 1, 16 and 128 queries, offsets 0,
    1 and mid-page, padding queries and an all-trash padding row, against
    its plain version on CPU f32 copies: max-abs and relative L2 within
    ``WINDOW_TOL``, padding queries exactly 0, one launch per call, the
    same bits on a second call. Timed at S=16 and S=128 beside its plain
    version and ``F.scaled_dot_product_attention`` over K/V gathered
    beforehand (the gather not timed)."""
    from mxnet_tpu_torch.ops.kernels import paged_attention as K

    # one row per slot: offsets 0, 1 (after the BOS prime) and mid-page;
    # row 6 is a padding row of the replay call (all-trash table, offset 0)
    off_list = [1, 1, 0, 9, 1, 40, 0, 1]
    B, H, D, P = len(off_list), 8, 64, PREFIX_PAGES
    L = P * PAGE_SIZE
    scale = D ** -0.5
    table = (1 + torch.arange(B * P, dtype=torch.int32)).reshape(B, P)
    table[6] = 0
    kp, vp = (torch.randn(1 + B * P, PAGE_SIZE, H, D,
                          generator=gen).to(dev) for _ in range(2))
    table = table.to(dev)
    errs, timings = [], {}
    for S in (1, 16, 128):
        vl_list = [S, max(S - 3, 0), S, max(S // 2, 1), 1, S, 1,
                   max(S - 1, 0)]
        off = torch.tensor(off_list, dtype=torch.int32, device=dev)
        vl = torch.tensor(vl_list, dtype=torch.int32, device=dev)
        q = torch.randn(B, S, H, D, generator=gen).to(dev)
        n0 = K.launches_window
        out = K.paged_window_attention(q, kp, vp, table, off, vl, scale)
        torch.cuda.synchronize()
        launched = K.launches_window - n0
        want = K.paged_window_plain(*cpu_f32(q, kp, vp, table, off, vl),
                                    scale)
        diff = (out.cpu() - want).abs()
        err = float(diff.max())
        rel = float(diff.double().norm() / want.double().norm())
        pad_zero = all(bool((out[b, n:] == 0).all())
                       for b, n in enumerate(vl_list))
        again = K.paged_window_attention(q, kp, vp, table, off, vl, scale)
        same = torch.equal(again, out)
        ok = bool(torch.isfinite(out).all()) and err <= WINDOW_TOL \
            and rel <= WINDOW_TOL and launched == 1 and pad_zero and same
        print(f"check paged_window_attention B={B} S={S} H={H} offsets "
              f"{off_list} window_vl {vl_list}: max_abs_err={err:.3e} "
              f"rel_l2={rel:.3e} tol={WINDOW_TOL:.0e} padding zero "
              f"{pad_zero} same bits {same} launches {launched} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("paged_window_attention disagrees with its plain version "
                 "on the CPU, or did not launch once")
        errs.append(err)
        if S == 1:
            continue
        # this run's data: row b's live queries see keys up to their own
        # position; each input read once (q of live queries, the keys up
        # to the last live query), the output written once
        keys = [min(L, o + n) if n else 0 for o, n in zip(off_list, vl_list)]
        pairs = sum(min(L, o + i + 1) for o, n in zip(off_list, vl_list)
                    for i in range(n))
        live_q = sum(vl_list)
        nbytes = (live_q * H * D + 2 * sum(keys) * H * D + B * S * H * D
                  + B * (P + 2)) * 4
        bnd, by = bound_ms(nbytes, 4 * D * H * pairs)
        sets = cold_copies((q, kp, vp, table, off, vl, scale), nbytes)
        q_abs = (off.view(B, 1) + torch.arange(S, device=dev)).view(
            B, S, 1)
        lib_sets = cold_copies(gathered_sdpa_args(q, kp, vp, table, q_abs),
                               nbytes)
        timings[S] = dict(
            ms=time_ms(K.paged_window_attention, sets),
            plain_ms=time_ms(K.paged_window_plain, sets),
            library_ms=time_ms(sdpa, lib_sets), bound_ms=bnd, bound_by=by)
        print(f"timing paged_window_attention B={B} S={S} H={H} D={D} "
              f"page_size={PAGE_SIZE} P={P} f32 offsets {off_list} "
              f"window_vl {vl_list} (library: F.scaled_dot_product_attention"
              f" over K/V gathered beforehand, bool mask; the gather not "
              f"timed): {json.dumps(timings[S])}")
    s16 = {f"s16_{k}": v for k, v in timings[16].items()}
    return dict(name="paged_window_attention", route="cuda",
                source="mxnet_tpu_torch/csrc/paged_window_attention.cu",
                replaces="mxnet_tpu/ops/pallas/paged_flash_attention.py:181",
                max_abs_err=max(errs), **timings[128], **s16)


def check_layer_norm_bwd(dev, gen):
    """K1 and B2 at the training path's shape (8192 x 768), f32 and bf16;
    B2 timed in bf16, the path's dtype. Returns B2's entry and K1's
    errors at this shape."""
    from mxnet_tpu_torch.ops.kernels import layer_norm as K

    rows, C = TRAIN_B * TRAIN_S, 768
    errs, fwd_errs = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn(rows, C, generator=gen) * 3 + 1).to(dev, dt)
        g = (1 + 0.1 * torch.randn(C, generator=gen)).to(dev, dt)
        b = (0.1 * torch.randn(C, generator=gen)).to(dev, dt)
        dy = torch.randn(rows, C, generator=gen).to(dev, dt)
        n0 = K.launches
        out, mean, rstd = K.layer_norm_fwd(x, g, b, 1e-5)
        torch.cuda.synchronize()
        launched = K.launches - n0
        want = K.layer_norm_plain(*cpu_f32(x, g, b), 1e-5)
        tag = f"{rows}x{C} {dt}"
        fwd_errs[dt] = check_vs_cpu(f"layer_norm_fwd out {tag}", out,
                                    want[0], dt, launched)
        for n, o, w in (("mean", mean, want[1]), ("rstd", rstd, want[2])):
            check_vs_cpu(f"layer_norm_fwd {n} {tag}", o, w, torch.float32,
                         launched, may_match=dt != torch.float32)
        n0 = K.launches_bwd
        got = K.layer_norm_bwd(x, g, mean, rstd, dy)
        torch.cuda.synchronize()
        launched = K.launches_bwd - n0
        want = K.layer_norm_bwd_plain(*cpu_f32(x, g, mean, rstd, dy))
        errs[dt] = max(
            check_vs_cpu(f"layer_norm_bwd {n} {rows}x{C} {dt}", o, w, dt,
                         launched)
            for n, o, w in zip(("dx", "dgamma", "dbeta"), got, want))
        again = K.layer_norm_bwd(x, g, mean, rstd, dy)
        if not (torch.equal(again[1], got[1])
                and torch.equal(again[2], got[2])):
            fail("layer_norm_bwd: dgamma/dbeta differ between two runs")
    # x, dy read and dx written in bf16; gamma; f32 mean, rstd, dg, db
    nbytes = 3 * rows * C * 2 + C * 2 + 2 * rows * 4 + 2 * C * 4
    bnd, by = bound_ms(nbytes, 13 * rows * C, BF16_FLOP_PER_S)
    # the library call gets its own forward statistics
    _, lm, lr = torch.ops.aten.native_layer_norm(x, [C], g, b, 1e-5)
    sets = cold_copies((x, g, b, mean, rstd, dy, lm, lr), nbytes)
    res = dict(
        ms=time_ms(lambda x, g, b, m, r, dy, lm, lr:
                   K.layer_norm_bwd(x, g, m, r, dy), sets),
        plain_ms=time_ms(lambda x, g, b, m, r, dy, lm, lr:
                         K.layer_norm_bwd_plain(x, g, m, r, dy), sets),
        library_ms=time_ms(
            lambda x, g, b, m, r, dy, lm, lr:
            torch.ops.aten.native_layer_norm_backward(
                dy, x, [C], lm, lr, g, b, [True, True, True]), sets),
        bound_ms=bnd, bound_by=by)
    print(f"timing layer_norm_bwd rows={rows} C={C} bf16: {json.dumps(res)}")
    return dict(name="layer_norm_bwd", route="cuda",
                source="mxnet_tpu_torch/csrc/layer_norm_bwd.cu",
                replaces="mxnet_tpu/ops/pallas/layer_norm.py:51",
                max_abs_err=errs[torch.float32],
                max_abs_err_bf16=errs[torch.bfloat16], **res), \
        dict(max_abs_err_train=fwd_errs[torch.float32],
             max_abs_err_train_bf16=fwd_errs[torch.bfloat16])


def time_sdpa_bwd_ms(sets, iters=10):
    """Device time of one backward of ``F.scaled_dot_product_attention``
    with the boolean key mask: the forward once per input set (not
    timed), then ``iters`` rounds of ``torch.autograd.grad`` over the
    sets between two CUDA events (eager: the autograd call is not
    captured in a graph)."""
    ready = []
    for q, k, v, do, _, _, _, _, mask in sets:
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(
            *ins, attn_mask=mask)
        ready.append((out, ins, do))

    def run():
        for out, ins, do in ready:
            torch.autograd.grad(out, ins, do, retain_graph=True)

    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * len(ready))


def check_flash_attention_bwd(dev, gen):
    """K2, B4a and B4b at the training path's shape (B16 H12 S512 D64),
    f32 and bf16, causal and not; B4 timed in bf16 without the causal
    mask, as the path runs them. Returns B4's entries and K2's errors at
    this shape."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as K

    B, H, S, D = TRAIN_B, 12, TRAIN_S, 64
    vl = torch.tensor(KCHECK_VL, dtype=torch.int32, device=dev)
    empty = KCHECK_VL.index(0)
    seen = torch.tensor(KCHECK_VL) > 0  # rows whose queries see a key
    errs = {(n, dt): 0.0 for n in ("fwd", "dkdv", "dq")
            for dt in (torch.float32, torch.bfloat16)}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(B, H, S, D, generator=gen).to(dev, dt)
                       for _ in range(4))
        for causal in (False, True):
            tag = f"B={B} H={H} S={S} causal={causal} {dt}"
            n0 = K.launches
            out, lse = K.flash_attention_fwd(q, k, v, vl, causal)
            torch.cuda.synchronize()
            lf = K.launches - n0
            want_out, want_lse = K.flash_attention_plain(
                *cpu_f32(q, k, v, vl), causal)
            e_out = check_vs_cpu(f"flash_attention_fwd out {tag}", out,
                                 want_out, dt, lf)
            # lse is f32 in both dtypes; a row without a key holds the
            # -1e30 sentinel, compared apart
            check_vs_cpu(f"flash_attention_fwd lse {tag}", lse.cpu()[seen],
                         want_lse[seen], torch.float32, lf,
                         may_match=dt != torch.float32)
            if not (bool((lse[empty] <= -1e29).all())
                    and bool((want_lse[empty] <= -1e29).all())):
                fail("flash_attention_fwd: a row with valid_length 0 must "
                     "keep the masked lse")
            errs["fwd", dt] = max(errs["fwd", dt], e_out)
            delta = (do.float() * out.float()).sum(-1)
            n0 = (K.launches_bwd_dkdv, K.launches_bwd_dq)
            dk, dv = K.flash_attention_bwd_dkdv(q, k, v, vl, lse, delta, do,
                                                causal)
            dq = K.flash_attention_bwd_dq(q, k, v, vl, lse, delta, do,
                                          causal)
            torch.cuda.synchronize()
            la = K.launches_bwd_dkdv - n0[0]
            lb = K.launches_bwd_dq - n0[1]
            args = cpu_f32(q, k, v, vl, lse, delta, do)
            want_dk, want_dv = K.flash_attention_bwd_dkdv_plain(*args,
                                                                causal)
            want_dq = K.flash_attention_bwd_dq_plain(*args, causal)
            e_dk = check_vs_cpu(f"flash_attention_bwd_dkdv dk {tag}", dk,
                                want_dk, dt, la)
            e_dv = check_vs_cpu(f"flash_attention_bwd_dkdv dv {tag}", dv,
                                want_dv, dt, la)
            e_dq = check_vs_cpu(f"flash_attention_bwd_dq dq {tag}", dq,
                                want_dq, dt, lb)
            errs["dkdv", dt] = max(errs["dkdv", dt], e_dk, e_dv)
            errs["dq", dt] = max(errs["dq", dt], e_dq)
            if any(bool(t[empty].any()) for t in (dq, dk, dv)):
                fail("flash_attention_bwd: a row with valid_length 0 must "
                     "get zero gradients")
            again = K.flash_attention_bwd_dkdv(q, k, v, vl, lse, delta, do,
                                               causal) + \
                (K.flash_attention_bwd_dq(q, k, v, vl, lse, delta, do,
                                          causal),)
            if not all(torch.equal(a, b) for a, b in zip(again,
                                                         (dk, dv, dq))):
                fail("flash_attention_bwd: a second call gave other bits")
    # timing: the last (bf16) operands, without the causal mask
    out, lse = K.flash_attention_fwd(q, k, v, vl, False)
    delta = (do.float() * out.float()).sum(-1)
    keys = [min(n, S) for n in KCHECK_VL]
    pairs = H * S * sum(keys)  # visible (query, key) pairs
    row = D * 2  # one bf16 row
    q_rows = sum(n > 0 for n in keys) * H * S  # queries that see a key
    k_rows = H * sum(keys)  # keys below valid_length
    stats = 2 * q_rows * 4  # lse, delta
    grads = B * H * S * row  # one gradient tensor written
    nbytes = {"dkdv": 2 * q_rows * row + 2 * k_rows * row + stats + 2 * grads,
              "dq": 2 * q_rows * row + 2 * k_rows * row + stats + grads,
              # q, do, out (for delta), k, v read; dq, dk, dv written
              "pair": 3 * q_rows * row + 2 * k_rows * row + stats + 3 * grads}
    flops = {"dkdv": 8 * D * pairs, "dq": 6 * D * pairs, "pair": 10 * D * pairs}
    mask = (torch.arange(S, device=dev)[None, :] < vl[:, None]).view(
        B, 1, 1, S)
    sets = cold_copies((q, k, v, do, lse, delta, out, vl, mask),
                       nbytes["pair"])
    fns = {
        "dkdv": (lambda q, k, v, do, lse, delta, out, vl, m:
                 K.flash_attention_bwd_dkdv(q, k, v, vl, lse, delta, do),
                 lambda q, k, v, do, lse, delta, out, vl, m:
                 K.flash_attention_bwd_dkdv_plain(q, k, v, vl, lse, delta,
                                                  do)),
        "dq": (lambda q, k, v, do, lse, delta, out, vl, m:
               K.flash_attention_bwd_dq(q, k, v, vl, lse, delta, do),
               lambda q, k, v, do, lse, delta, out, vl, m:
               K.flash_attention_bwd_dq_plain(q, k, v, vl, lse, delta, do)),
        "pair": (lambda q, k, v, do, lse, delta, out, vl, m:
                 K.flash_attention_bwd(q, k, v, vl, out, lse, do),
                 lambda q, k, v, do, lse, delta, out, vl, m:
                 K.flash_attention_bwd_plain(q, k, v, vl, out, lse, do))}
    res = {}
    for part, (fn, plain) in fns.items():
        bnd, by = bound_ms(nbytes[part], flops[part], BF16_FLOP_PER_S)
        res[part] = dict(ms=time_ms(fn, sets), plain_ms=time_ms(plain, sets),
                         library_ms=None, bound_ms=bnd, bound_by=by)
    res["pair"]["library_ms"] = time_sdpa_bwd_ms(sets)
    print(f"timing flash_attention_bwd B={B} H={H} S={S} D={D} bf16 "
          f"vl={KCHECK_VL} (pair = delta + both kernels; library = the "
          f"backward of F.scaled_dot_product_attention, bool mask): "
          f"{json.dumps(res)}")
    pair = {f"pair_{k}": v for k, v in res["pair"].items()
            if k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return [dict(name="flash_attention_bwd_dkdv", route="cuda",
                 source="mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
                 replaces="mxnet_tpu/ops/pallas/flash_attention.py:223",
                 max_abs_err=errs["dkdv", torch.float32],
                 max_abs_err_bf16=errs["dkdv", torch.bfloat16],
                 **res["dkdv"], **pair),
            dict(name="flash_attention_bwd_dq", route="cuda",
                 source="mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
                 replaces="mxnet_tpu/ops/pallas/flash_attention.py:273",
                 max_abs_err=errs["dq", torch.float32],
                 max_abs_err_bf16=errs["dq", torch.bfloat16],
                 **res["dq"], **pair)], \
        dict(max_abs_err_train=errs["fwd", torch.float32],
             max_abs_err_train_bf16=errs["fwd", torch.bfloat16])


def check_batch_norm(dev, gen):
    """B7 and B8 at the nine shapes of the ResNet-50 step in f32 and
    bf16, on the cancellation input and at an M no chunk divides, against
    their plain versions on CPU f32 copies (launch counter, finite,
    max-abs and relative-L2 bounds, the same bits on a second call);
    timed in bf16 at the stem and at stage 4. Returns both entries."""
    from mxnet_tpu_torch.ops.kernels import batch_norm as K

    errs = {("stats", dt): 0.0 for dt in (torch.float32, torch.bfloat16)}
    errs.update({("bwd", dt): 0.0 for dt in (torch.float32, torch.bfloat16)})
    cases = [(M, C, dt, 0.5, 1.0) for M, C, _ in BN_PATH_SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(50176, 64, torch.float32, 1000.0, 0.5),  # cancellation
              (100003, 320, torch.bfloat16, 0.5, 1.0),  # ragged M
              (4099, 7, torch.float32, 0.5, 1.0)]  # C off the vector
    for M, C, dt, mu, sd in cases:
        tag = f"M={M} C={C} {dt} mean={mu} std={sd}"
        x = (torch.randn(M, C, generator=gen) * sd + mu).to(dev, dt)
        dy = torch.randn(M, C, generator=gen).to(dev, dt)
        n0 = K.launches_stats
        mean, var = K.bn_stats(x)
        torch.cuda.synchronize()
        launched = K.launches_stats - n0
        want_m, want_v = K.bn_stats_plain(*cpu_f32(x))
        e = max(check_vs_cpu(f"bn_stats mean {tag}", mean, want_m,
                             torch.float32, launched, may_match=True),
                check_vs_cpu(f"bn_stats var {tag}", var, want_v,
                             torch.float32, launched, may_match=True))
        errs["stats", dt] = max(errs["stats", dt], e)
        if mu == 1000.0:
            ref = x.double().var(dim=0, unbiased=False).cpu()
            rel = float(((var.double().cpu() - ref) / ref).abs().max())
            ok = rel <= BN_CANCEL_RTOL
            print(f"check bn_stats var vs float64 {tag}: max rel {rel:.3e} "
                  f"tol {BN_CANCEL_RTOL:.0e} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail("bn_stats loses the variance to cancellation")
        inv = torch.rsqrt(var + 1e-5)
        n0 = K.launches_bwd
        sd_, sdx = K.bn_bwd_reduce(x, dy, mean, inv)
        torch.cuda.synchronize()
        launched = K.launches_bwd - n0
        want_sd, want_sdx = K.bn_bwd_reduce_plain(*cpu_f32(x, dy, mean,
                                                          inv))
        e = max(check_vs_cpu(f"bn_bwd_reduce sum_dy {tag}", sd_, want_sd,
                             torch.float32, launched, may_match=True),
                check_vs_cpu(f"bn_bwd_reduce sum_dy_xhat {tag}", sdx,
                             want_sdx, torch.float32, launched,
                             may_match=True))
        errs["bwd", dt] = max(errs["bwd", dt], e)
        again = K.bn_stats(x) + K.bn_bwd_reduce(x, dy, mean, inv)
        if not all(torch.equal(a, b) for a, b in zip(again,
                                                     (mean, var, sd_, sdx))):
            fail(f"bn kernels: a second call gave other bits ({tag})")
    timings = {}
    for (N, H, C) in ((RESNET_B, 112, 64), (RESNET_B, 7, 2048)):
        M = N * H * H
        x = (torch.randn(M, C, generator=gen) + 0.5).to(dev, torch.bfloat16)
        dy = torch.randn(M, C, generator=gen).to(dev, torch.bfloat16)
        mean, var = K.bn_stats(x)
        inv = torch.rsqrt(var + 1e-5)
        w = torch.ones(C, device=dev)

        def nchw(t):  # the NHWC tensor as PyTorch's channels_last NCHW
            return t.view(N, H, H, C).permute(0, 3, 1, 2)

        res = {}
        for part, nbytes, fn, plain, lib in (
                ("stats", M * C * 2 + 2 * C * 4,
                 lambda x, dy, m, i: K.bn_stats(x),
                 lambda x, dy, m, i: K.bn_stats_plain(x),
                 lambda x, dy, m, i: torch.batch_norm_stats(nchw(x), 1e-5)),
                ("bwd", 2 * M * C * 2 + 4 * C * 4,
                 lambda x, dy, m, i: K.bn_bwd_reduce(x, dy, m, i),
                 lambda x, dy, m, i: K.bn_bwd_reduce_plain(x, dy, m, i),
                 lambda x, dy, m, i: torch.batch_norm_backward_reduce(
                     nchw(dy), nchw(x), m, i, w, True, False, False))):
            flops = (3 if part == "stats" else 5) * M * C
            bnd, by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
            sets = cold_copies((x, dy, mean, inv), nbytes)
            res[part] = dict(ms=time_ms(fn, sets),
                             plain_ms=time_ms(plain, sets),
                             library_ms=time_ms(lib, sets), bound_ms=bnd,
                             bound_by=by)
        timings[M, C] = res
        print(f"timing bn M={M} C={C} (N={N} H=W={H}) bf16 (library: "
              f"batch_norm_stats / batch_norm_backward_reduce on the "
              f"channels_last view): {json.dumps(res)}")
    stem = timings[RESNET_B * 112 * 112, 64]
    s4 = {f"stage4_{k}": v for k, v in
          timings[RESNET_B * 49, 2048]["stats"].items() if k != "bound_by"}
    s4b = {f"stage4_{k}": v for k, v in
           timings[RESNET_B * 49, 2048]["bwd"].items() if k != "bound_by"}
    return [dict(name="bn_stats", route="cuda",
                 source="mxnet_tpu_torch/csrc/batch_norm.cu",
                 replaces="mxnet_tpu/ops/pallas/batch_norm.py:80",
                 max_abs_err=errs["stats", torch.float32],
                 max_abs_err_bf16=errs["stats", torch.bfloat16],
                 **stem["stats"], **s4),
            dict(name="bn_bwd_reduce", route="cuda",
                 source="mxnet_tpu_torch/csrc/batch_norm.cu",
                 replaces="mxnet_tpu/ops/pallas/batch_norm.py:160",
                 max_abs_err=errs["bwd", torch.float32],
                 max_abs_err_bf16=errs["bwd", torch.bfloat16],
                 **stem["bwd"], **s4b)]


def counters():
    """Every kernel's launch counter: name -> (wrapper module, attr)."""
    from mxnet_tpu_torch.ops.kernels import batch_norm as k_bn
    from mxnet_tpu_torch.ops.kernels import flash_attention as k_fa
    from mxnet_tpu_torch.ops.kernels import layer_norm as k_ln
    from mxnet_tpu_torch.ops.kernels import paged_attention as k_pa

    return {"layer_norm_fwd": (k_ln, "launches"),
            "flash_attention_fwd": (k_fa, "launches"),
            "paged_decode_attention": (k_pa, "launches"),
            "paged_window_attention": (k_pa, "launches_window"),
            "layer_norm_bwd": (k_ln, "launches_bwd"),
            "flash_attention_bwd_dkdv": (k_fa, "launches_bwd_dkdv"),
            "flash_attention_bwd_dq": (k_fa, "launches_bwd_dq"),
            "bn_stats": (k_bn, "launches_stats"),
            "bn_bwd_reduce": (k_bn, "launches_bwd")}


def reset_counts():
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts():
    return {name: getattr(mod, attr)
            for name, (mod, attr) in counters().items()}


# --------------------------------------------------------------- serving
@torch.no_grad()
def draw_weights(net, seed):
    """Random weights from ``seed``, drawn on the CPU: std ``1/sqrt(fan_in)``
    on every matrix, source embeddings at ``2/sqrt(units)``, the tied
    target embedding at ``0.2/sqrt(units)``, position embeddings at 1,
    LayerNorm gamma ``1 + 0.1 z``, biases and beta ``0.1 z``. Under the
    Xavier init of ``initialize`` the tied embedding dominates the
    residual stream and greedy decoding only repeats BOS, so the served
    tokens could not show a wrong slot or page; with these weights the
    transcripts vary within a request and between prompts (a larger
    target embedding brings the repetition back; the larger source
    embedding makes the prompt, not only the position, decide them)."""
    gen = torch.Generator().manual_seed(seed)
    units = net.tgt_embed.weight.shape[1]
    for name, p in net.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        z = torch.randn(p.shape, generator=gen)
        if leaf == "gamma":
            z = 1.0 + 0.1 * z
        elif leaf in ("bias", "beta"):
            z = 0.1 * z
        elif name.startswith("pos_embed"):
            pass
        elif name.startswith("src_embed"):
            z = z * (2.0 / math.sqrt(units))
        elif name.startswith("tgt_embed"):
            z = z * (0.2 / math.sqrt(units))
        else:
            z = z / math.sqrt(p.shape[1])
        p.copy_(z)
    return net


def make_requests():
    """16 prompts, seeded: the first eight mixed up to 512 tokens (their
    admission pads to the 512 bucket, so encoder self-attention runs on
    the flash kernel), the last eight short (128 bucket)."""
    rng = np.random.RandomState(SEED)
    lens = list(rng.randint(16, 513, size=6)) + [500, 40] \
        + list(rng.randint(16, 129, size=8))
    max_new = [int(m) for m in rng.randint(24, MAX_NEW + 1, size=16)]
    max_new[0] = MAX_NEW
    prompts = [rng.randint(3, VOCAB, size=int(n)).astype(np.int32)
               for n in lens]
    return prompts, max_new


def serve(net, prompts, max_new, prefixes=None, **batcher_kwargs):
    """The requests (with forced histories ``prefixes``, if given) at
    once through one ``ContinuousBatcher``; fails unless every page
    returns. Returns the transcripts, the wall time, each request's TTFT
    (ms), the batcher, and the shapes of the engine's replay dispatches
    (a counting wrapper around ``prefill_suffix_paged``)."""
    from mxnet_tpu_torch.parallel import InferStep
    from mxnet_tpu_torch.serving import ContinuousBatcher

    eng = InferStep(net)
    dispatches = []
    replay = eng.prefill_suffix_paged

    def counted(*args, **kwargs):
        dispatches.append(np.asarray(args[1]).shape)
        return replay(*args, **kwargs)

    eng.prefill_suffix_paged = counted
    kw = dict(slots=SLOTS, page_size=PAGE_SIZE, max_new_tokens=MAX_NEW,
              iter_tokens=ITER_TOKENS)
    kw.update(batcher_kwargs)
    bat = ContinuousBatcher(eng, BUCKETS, **kw)
    prefixes = prefixes or [None] * len(prompts)
    try:
        t0 = time.perf_counter()
        futs = [bat.submit(p, max_new_tokens=m, prefix_ids=h)
                for p, m, h in zip(prompts, max_new, prefixes)]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        bat.stop()
    if bat.pool.free_pages != bat.pool.num_pages:
        fail(f"pages leaked: {bat.pool.free_pages} of "
             f"{bat.pool.num_pages} free after the drain")
    bat.pool.check_invariants(set())
    ttft = [(f.first_token_at - f.enqueued_at) * 1e3 for f in futs]
    return outs, wall, ttft, bat, dispatches


def teacher_forced_logits(net, prompt, tokens, device):
    """Per-step logits of one request, teacher-forced on ``tokens``:
    the admission prefill, then one decode step per token but the last."""
    pages = math.ceil((1 + len(tokens)) / PAGE_SIZE)
    with torch.inference_mode():
        state = net.init_paged_state(1, 1 + pages, PAGE_SIZE, BUCKETS[-1])
        src = torch.as_tensor(prompt, device=device).long()[None]
        vl = torch.tensor([len(prompt)], dtype=torch.int32, device=device)
        one = torch.ones((1,), dtype=torch.bool, device=device)
        logits, state = net.prefill_paged(
            src, torch.ones((1, 1), dtype=torch.long, device=device), vl,
            state, torch.zeros((1,), dtype=torch.long, device=device),
            torch.ones((1,), dtype=torch.long, device=device), one)
        steps = [logits[0].float().cpu()]
        table = torch.arange(1, 1 + pages, dtype=torch.int32,
                             device=device)[None]
        for j, tok in enumerate(tokens[:-1]):
            lg, state = net.decode_step_paged(
                torch.tensor([tok], dtype=torch.int32, device=device),
                torch.tensor([1 + j], dtype=torch.int32, device=device),
                state, table, one)
            steps.append(lg[0].float().cpu())
    return torch.stack(steps)


# ------------------------------------------------------- forced prefix
def copy_state(state):
    return {k: v.clone() if torch.is_tensor(v) else [t.clone() for t in v]
            for k, v in state.items()}


def prefix_engine_check(net, cpu_net, dev):
    """After one BOS ``prefill_paged`` of 4 rows, their histories of 1,
    17, 64 and 128 tokens replayed at width 128 on copies of the same
    state: wide (B6) against sequential (K3) by last logits and by the
    K/V written at every history position of every layer, both engines'
    first tokens against the argmax of those logits, and the wide replay
    against the same calls on the CPU copy of the model (full depth,
    6+6 layers). Returns the printed errors."""
    from mxnet_tpu_torch.parallel import InferStep

    rng = np.random.RandomState(SEED + 3)
    B, P, mem = len(ENGINE_PREFIX_LENS), PREFIX_PAGES, BUCKETS[0]
    src = np.zeros((B, mem), np.int32)
    vl = rng.randint(16, mem + 1, size=B).astype(np.int32)
    for r, n in enumerate(vl):
        src[r, :n] = rng.randint(3, VOCAB, size=n)
    toks = np.zeros((B, PREFIX_MAX), np.int32)
    for r, n in enumerate(ENGINE_PREFIX_LENS):
        toks[r, :n] = rng.randint(3, VOCAB, size=n)
    tvl = np.array(ENGINE_PREFIX_LENS, np.int32)
    tables = (1 + np.arange(B * P, dtype=np.int32)).reshape(B, P)
    rows = np.arange(B, dtype=np.int32)
    ones = np.ones((B,), bool)

    def replay(model, device, wide):
        """Logits and state of the model-level replay, and the engine's
        first tokens from a second copy of the primed state."""
        eng = InferStep(model, device=device)
        state = eng.init_paged_state(B, B * P, PAGE_SIZE, mem)
        _, state = eng.prefill_paged(state, src, vl, rows, tables[:, 0],
                                     ones)
        args = [torch.as_tensor(a, device=device) for a in
                (toks, tvl, np.ones((B,), np.int32))]
        tok, _ = eng.prefill_suffix_paged(copy_state(state), toks, tvl,
                                          np.ones((B,), np.int32), tables,
                                          rows, ones, wide=wide)
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, state = model.prefill_suffix_paged(
                *args, state, torch.as_tensor(tables, device=device),
                torch.as_tensor(rows, device=device).long(),
                torch.as_tensor(ones, device=device), wide=wide)
        logits = logits.float().cpu()
        secs = time.perf_counter() - t0
        return logits, tok.cpu(), state, secs

    lw, tw, sw, _ = replay(net, dev, True)
    ls, ts, ss, _ = replay(net, dev, False)
    lc, tc, _, cpu_s = replay(cpu_net, torch.device("cpu"), True)
    err_seq = float((lw - ls).abs().max())
    err_cpu = float((lw - lc).abs().max())
    kv_err = 0.0
    for r, n in enumerate(ENGINE_PREFIX_LENS):
        pos = torch.arange(1, 1 + n)
        page = torch.as_tensor(tables[r])[pos // PAGE_SIZE].long()
        for name in ("k_pools", "v_pools"):
            for a, b in zip(sw[name], ss[name]):
                kv_err = max(kv_err, float(
                    (a[page, pos % PAGE_SIZE] - b[page, pos % PAGE_SIZE])
                    .abs().max()))
    top2 = ls.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > PREFIX_LOGIT_TOL
    tok_ok = torch.equal(tw, lw.argmax(-1).int()) \
        and torch.equal(ts, ls.argmax(-1).int()) \
        and torch.equal(tc, lc.argmax(-1).int()) \
        and torch.equal(tw[decided], ts[decided])
    ok = err_seq <= PREFIX_LOGIT_TOL and kv_err <= PREFIX_KV_TOL \
        and err_cpu <= PREFIX_LOGIT_TOL and tok_ok \
        and bool(torch.isfinite(lw).all())
    print(f"prefix engine check (histories {ENGINE_PREFIX_LENS} at width "
          f"{PREFIX_MAX}, prompts {vl.tolist()}): wide vs sequential last "
          f"logits max_abs_err={err_seq:.3e} tol={PREFIX_LOGIT_TOL:.0e}, "
          f"written K/V max_abs_err={kv_err:.3e} tol={PREFIX_KV_TOL:.0e}; "
          f"card vs CPU copy (6+6 layers, {cpu_s:.2f} s there) wide "
          f"logits max_abs_err={err_cpu:.3e} tol={PREFIX_LOGIT_TOL:.0e}; "
          f"first tokens wide {tw.tolist()} sequential {ts.tolist()} cpu "
          f"{tc.tolist()} (top-2 margins {[round(float(m), 4) for m in margin]}"
          f") {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the wide replay disagrees with the sequential one or with "
             "the CPU")
    return dict(wide_vs_sequential=err_seq, kv=kv_err, card_vs_cpu=err_cpu)


def make_prefix_requests():
    """12 requests, seeded: prompts of 16-512 tokens (so that 512-bucket
    admissions run K2), forced histories of ``PREFIX_LENS`` tokens (one
    request without), asked lengths 8-32."""
    rng = np.random.RandomState(SEED)
    n = len(PREFIX_LENS)
    lens = rng.randint(16, 513, size=n)
    asked = [int(m) for m in rng.randint(8, PREFIX_MAX_NEW + 1, size=n)]
    prompts = [rng.randint(3, VOCAB, size=int(k)).astype(np.int32)
               for k in lens]
    prefixes = [rng.randint(3, VOCAB, size=k).astype(np.int32) if k else
                None for k in PREFIX_LENS]
    return prompts, prefixes, asked


def prefix_phase(net, cpu_net, dev, kernel_entry, tag):
    """The forced-prefix path: the engine check, then the 12 requests
    through the wide batcher (B6) and the sequential one (K3): exact B6
    launch counts, pages, lengths, and equal transcripts wherever the
    sequential logits' top-2 margin is above ``PREFIX_LOGIT_TOL``.
    Returns the wide run's launch counts."""
    errs = prefix_engine_check(net, cpu_net, dev)
    prompts, prefixes, asked = make_prefix_requests()
    kw = dict(max_new_tokens=PREFIX_MAX_NEW, max_prefix_tokens=PREFIX_MAX)
    serve(net, prompts[:1], [4], prefixes[-2:-1], suffix_wide=True, **kw)
    runs = {}
    for wide in (True, False):
        reset_counts()
        outs, wall, ttft, bat, disp = serve(net, prompts, asked, prefixes,
                                            suffix_wide=wide, **kw)
        runs[wide] = (outs, wall, sorted(t for t, h in zip(ttft, prefixes)
                                         if h is not None), disp,
                      read_counts())
    menu = [1 << i for i in range((PREFIX_MAX - 1).bit_length())]
    if bat.pages_per_slot != PREFIX_PAGES or \
            bat._suffix_menu != menu + [PREFIX_MAX]:
        fail(f"prefix batcher geometry: {bat.pages_per_slot} pages a slot, "
             f"menu {bat._suffix_menu}")
    n_dec = net.decoder._n
    outs, wall, ttft, disp, counts = runs[True]
    seq_outs, seq_wall, seq_ttft, seq_disp, seq_counts = runs[False]
    n_b6 = counts["paged_window_attention"]
    if n_b6 != n_dec * len(disp) or not disp \
            or seq_counts["paged_window_attention"] != 0 or not seq_disp \
            or min(counts[k] for k in ("layer_norm_fwd", "flash_attention_fwd",
                                       "paged_decode_attention")) < 1:
        fail(f"prefix launches: B6 {n_b6} for {len(disp)} wide replay "
             f"dispatches of {n_dec} decoder layers; sequential run "
             f"{seq_counts}; wide run {counts}")
    for r, (toks, m) in enumerate(zip(outs + seq_outs, asked + asked)):
        ok_len = len(toks) == m or (toks and toks[-1] == 2
                                    and len(toks) <= m)
        if not ok_len or min(toks) < 0 or max(toks) >= VOCAB:
            fail(f"prefix request {r % len(asked)}: bad transcript "
                 f"{toks[:8]}... (len {len(toks)}, asked {m})")
    differ = []
    for r, (a, b) in enumerate(zip(outs, seq_outs)):
        if a == b:
            continue
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        hist = list(prefixes[r] if prefixes[r] is not None else []) + b[:k]
        # the logits after the sequential replay of hist (its last
        # token, a placeholder, is not fed)
        lg = teacher_forced_logits(net, prompts[r], hist + [0], dev)[-1]
        top2 = lg.topk(2).values
        margin = float(top2[0] - top2[1])
        print(f"prefix request {r}: wide and sequential transcripts first "
              f"differ at token {k} ({a[k:k + 1]} vs {b[k:k + 1]}); "
              f"sequential top-2 "
              f"margin there {margin:.3e} (tol {PREFIX_LOGIT_TOL:.0e})")
        differ.append(r)
        if margin >= PREFIX_LOGIT_TOL:
            fail(f"prefix request {r}: the wide replay changed a token "
                 "the sequential logits decide")
    n_tok = sum(len(t) for t in outs)
    seq_tok = sum(len(t) for t in seq_outs)
    print(f"prefix [{tag}]: {len(outs)} requests (histories {PREFIX_LENS}, "
          f"asked {asked}), wide replay: {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tokens/s, TTFT of the prefixed requests p50 "
          f"{ttft[len(ttft) // 2]:.1f} ms max {ttft[-1]:.1f} ms, "
          f"{len(disp)} replay dispatches (shapes {disp}), B6 launches "
          f"{n_b6}, launches {json.dumps(counts)}; sequential replay: "
          f"{seq_tok} tokens in {seq_wall:.3f} s = {seq_tok / seq_wall:.1f} "
          f"tokens/s, TTFT p50 {seq_ttft[len(seq_ttft) // 2]:.1f} ms max "
          f"{seq_ttft[-1]:.1f} ms, {len(seq_disp)} dispatches, launches "
          f"{json.dumps(seq_counts)}; transcripts equal in "
          f"{len(outs) - len(differ)} of {len(outs)}; B6 S=16 "
          f"{kernel_entry['s16_ms']:.5f} ms (bound "
          f"{kernel_entry['s16_bound_ms']:.5f}), S=128 "
          f"{kernel_entry['ms']:.5f} ms (bound "
          f"{kernel_entry['bound_ms']:.5f}); engine check {json.dumps(errs)}")
    return counts


# -------------------------------------------------------------- training
def make_train_batch(B, S, valid_length, seed):
    """Seeded ``(token_ids, token_types, valid_length, labels)``: random
    ids and labels over the vocabulary, the second half of each row's
    valid tokens in segment 1."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TRAIN_VOCAB, size=(B, S)).astype(np.int32)
    vl = np.asarray(valid_length, np.int32)
    pos = np.arange(S)[None, :]
    types = ((pos >= vl[:, None] // 2) & (pos < vl[:, None])).astype(
        np.int32)
    labels = rng.randint(0, TRAIN_VOCAB, size=(B, S)).astype(np.int32)
    return ids, types, vl, labels


def train_cross_check(dev):
    """A 2-layer BERT at full width trained for two AdamW steps on the
    card and on the CPU from the same weights, f32, dropout 0, TF32 off,
    B=2, S=512: both runs take the kernel routes (LayerNorm C=768, flash
    attention at S > 256), the card's through the CUDA kernels."""
    from mxnet_tpu_torch.gluon.model_zoo import BERTModel, PretrainLoss
    from mxnet_tpu_torch.optimizer import AdamW
    from mxnet_tpu_torch.parallel import TrainStep

    cfg = dict(vocab_size=TRAIN_VOCAB, units=768, hidden_size=3072,
               num_layers=2, num_heads=12, max_length=TRAIN_S, dropout=0.0)
    vl = [512, 301]
    batch = make_train_batch(2, TRAIN_S, vl, SEED + 1)
    cpu_net = BERTModel(device="cpu", **cfg).initialize(SEED)
    init = {n: p.detach().clone() for n, p in cpu_net.named_parameters()}
    card_net = BERTModel(**cfg)
    card_net.load_state_dict(cpu_net.state_dict())
    losses, launched = {}, {}
    for name, net in (("card", card_net), ("cpu", cpu_net)):
        step = TrainStep(net, PretrainLoss(net), AdamW(learning_rate=1e-4),
                         device=net.word_embed.weight.device)
        reset_counts()
        losses[name] = [float(step(*batch)) for _ in range(2)]
        launched[name] = read_counts()
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(losses["card"], losses["cpu"]))
    perr, moved = 0.0, 0.0
    for (n, a), (_, b) in zip(card_net.named_parameters(),
                              cpu_net.named_parameters()):
        perr = max(perr, float((a.detach().cpu() - b.detach()).abs().max()))
        moved = max(moved, float((b.detach() - init[n]).abs().max()))
    card_k = launched["card"]
    print(f"train cross-check card vs cpu (f32, 2 layers, B=2 S={TRAIN_S} "
          f"vl {vl}, 2 AdamW steps): losses card {losses['card']} cpu "
          f"{losses['cpu']} max rel {rel:.3e} tol {XTRAIN_LOSS_RTOL:.0e}; "
          f"parameters max_abs_err {perr:.3e} tol {XTRAIN_PARAM_ATOL:.0e} "
          f"(largest move {moved:.3e}); card launches {json.dumps(card_k)}")
    if rel > XTRAIN_LOSS_RTOL or perr > XTRAIN_PARAM_ATOL:
        fail("the card's training steps disagree with the CPU's")
    if min(card_k[n] for n in ("layer_norm_fwd", "layer_norm_bwd",
                               "flash_attention_fwd",
                               "flash_attention_bwd_dkdv",
                               "flash_attention_bwd_dq")) < 1 \
            or any(launched["cpu"].values()):
        fail("the cross-check did not run the card's kernels (or the CPU "
             "run launched one)")


def profile_step(step, batch):
    """One training step under ``torch.profiler``: device kernel time by
    group and the device's busy share of the step's wall time. Returns
    None where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    groups = (("B4a flash_attention_bwd_dkdv", "flash_bwd_dkdv"),
              ("B4b flash_attention_bwd_dq", "flash_bwd_dq"),
              ("K2 flash_attention_fwd", "flash_fwd_kernel"),
              ("B2 layer_norm_bwd", "ln_bwd_"),
              ("K1 layer_norm_fwd", "layer_norm_fwd_kernel"),
              ("matmul", ("gemm", "cutlass", "nvjet", "xmma", "cublas")))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(*batch))
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_group = {}
    for ev in prof.key_averages():
        if "cuda" not in str(getattr(ev, "device_type", "")).lower():
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        name = ev.key
        group = next((g for g, pat in groups
                      if any(p in name for p in
                             (pat if isinstance(pat, tuple) else (pat,)))),
                     "other")
        by_group[group] = by_group.get(group, 0.0) + us / 1e3
    busy = sum(by_group.values())
    if busy <= 0:
        return None
    return dict(wall_ms=round(wall_ms, 3), device_ms=round(busy, 3),
                busy_share=round(busy / wall_ms, 3),
                by_group_ms={g: round(t, 4) for g, t in
                             sorted(by_group.items(), key=lambda x: -x[1])})


def train(dev, tag):
    """BERT-base, bf16 compute, dropout 0.1, B=16, S=512, ragged valid
    lengths: 2 warm-up and 10 timed steps on one batch through
    ``TrainStep``. Checks the losses and every kernel's launches against
    the model's structure; returns the launch counts of the timed
    steps."""
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.gluon.model_zoo import PretrainLoss, bert_base
    from mxnet_tpu_torch.gluon.nn import LayerNorm, MultiHeadAttention
    from mxnet_tpu_torch.optimizer import AdamW
    from mxnet_tpu_torch.parallel import TrainStep

    mx_random.seed(SEED)
    net = bert_base(vocab_size=TRAIN_VOCAB, max_length=TRAIN_S,
                    dropout=0.1).initialize(SEED)
    step = TrainStep(net, PretrainLoss(net), AdamW(learning_rate=1e-4),
                     compute_dtype="bfloat16", state_dtype="bfloat16")
    batch = [torch.as_tensor(a, device=dev) for a in
             make_train_batch(TRAIN_B, TRAIN_S, TRAIN_VL, SEED)]
    losses = [float(step(*batch)) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))  # float() waits for the step
        times.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_ln = sum(isinstance(m, LayerNorm) for m in net.modules())
    n_attn = sum(isinstance(m, MultiHeadAttention) for m in net.modules())
    want = {"layer_norm_fwd": n_ln, "layer_norm_bwd": n_ln,
            "flash_attention_fwd": n_attn,
            "flash_attention_bwd_dkdv": n_attn,
            "flash_attention_bwd_dq": n_attn, "paged_decode_attention": 0,
            "paged_window_attention": 0, "bn_stats": 0, "bn_bwd_reduce": 0}
    want = {k: n * TRAIN_STEPS for k, n in want.items()}
    tokens = TRAIN_B * TRAIN_S
    ms = sorted(t * 1e3 for t in times)
    print(f"train [{tag}]: BERT-base bf16 B={TRAIN_B} S={TRAIN_S} vl "
          f"{TRAIN_VL} ({sum(TRAIN_VL)} valid tokens a step), "
          f"{TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up: "
          f"{TRAIN_STEPS * tokens / sum(times):.1f} tokens/s "
          f"({TRAIN_STEPS * tokens} tokens in {sum(times):.6f} s); step p50 "
          f"{statistics.median(ms):.3f} ms, min {ms[0]:.3f}, max "
          f"{ms[-1]:.3f}; max_memory_allocated {peak} bytes; losses "
          f"{[round(x, 5) for x in losses]}; launches {json.dumps(counts)} "
          f"(per step: {n_ln} LayerNorms, {n_attn} attention layers)")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"training losses are not finite or do not fall: {losses}")
    if counts != want:
        fail(f"launches {counts} differ from the model's structure {want}")
    prof = profile_step(step, batch)
    if prof:
        # the profiler slows the host, not the device: the profiled
        # step's wall overstates the idle share
        prof["device_ms_over_step_p50"] = round(
            prof["device_ms"] / statistics.median(ms), 3)
    print(f"train profile (one step under torch.profiler): "
          f"{json.dumps(prof) if prof else 'no device time recorded'}")
    return counts


# ------------------------------------------------------------- ResNet
def resnet_batch(B, hw, classes, seed):
    """Seeded channel-last images in [0, 1) and float32 labels, as
    ``bench_resnet50.py`` draws them (``rand``, ``randint``)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(B, hw, hw, 3).astype(np.float32)
    y = rng.randint(0, classes, B).astype(np.float32)
    return x, y


def resnet_cross_check(dev):
    """A narrow channel-last ResNet v1 trained for two SGD steps (lr 0.1,
    momentum 0.9) on the card and on the CPU from the same weights, f32,
    TF32 off (set in ``main``), 8x64x64x3: losses, parameters and running
    statistics; B7 and B8 launch once per BatchNorm per step on the card,
    never on the CPU."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                         ResNetV1)
    from mxnet_tpu_torch.gluon.nn import BatchNorm
    from mxnet_tpu_torch.optimizer import SGD
    from mxnet_tpu_torch.parallel import TrainStep

    # cuDNN's default algorithms are not deterministic: two card runs of
    # these steps differ, and in 2 of 5 a ReLU or max-pool kink falls the
    # other way and moves the stem's weight by 3.0e-4. Deterministic
    # algorithms give the same bits in every run (2.2e-6 from the CPU).
    arch = (BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256])
    batch = resnet_batch(8, 64, 10, SEED + 2)
    cpu_net = ResNetV1(*arch, classes=10, layout="NHWC",
                       device="cpu").initialize(SEED)
    card_net = ResNetV1(*arch, classes=10, layout="NHWC")
    card_net.load_state_dict(cpu_net.state_dict())
    n_bn = sum(isinstance(m, BatchNorm) for m in cpu_net.modules())
    losses, launched = {}, {}
    was_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, net in (("card", card_net), ("cpu", cpu_net)):
            step = TrainStep(net, SoftmaxCrossEntropyLoss(),
                             SGD(learning_rate=0.1, momentum=0.9),
                             device=net.output.weight.device)
            reset_counts()
            losses[name] = [float(step(*batch)) for _ in range(2)]
            launched[name] = read_counts()
    finally:
        torch.backends.cudnn.deterministic = was_deterministic
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(losses["card"], losses["cpu"]))
    worst, worst_name = 0.0, None
    card_sd = card_net.state_dict()
    for n, b in cpu_net.state_dict().items():
        err = float((card_sd[n].cpu() - b).abs().max()) \
            / max(1.0, float(b.abs().max()))
        if err > worst:
            worst, worst_name = err, n
    card_k = launched["card"]
    print(f"resnet cross-check card vs cpu (narrow ResNet v1 NHWC, f32, "
          f"8x64x64x3, 2 SGD steps): losses card {losses['card']} cpu "
          f"{losses['cpu']} max rel {rel:.3e} tol {XRESNET_LOSS_RTOL:.0e}; "
          f"parameters and running statistics max err {worst:.3e} "
          f"({worst_name}) tol {XRESNET_PARAM_TOL:.0e}; card launches "
          f"{json.dumps(card_k)} ({n_bn} BatchNorms; cuDNN deterministic, "
          f"TF32 {torch.backends.cudnn.allow_tf32})")
    if rel > XRESNET_LOSS_RTOL or worst > XRESNET_PARAM_TOL:
        fail("the card's ResNet steps disagree with the CPU's")
    if card_k["bn_stats"] != 2 * n_bn or card_k["bn_bwd_reduce"] != 2 * n_bn \
            or any(launched["cpu"].values()):
        fail("the ResNet cross-check did not launch B7/B8 once per "
             "BatchNorm per step on the card (or the CPU run launched one)")


def profile_resnet_step(step, batch):
    """One ResNet training step under ``torch.profiler``: device time by
    group, the device's busy share of the step's wall time, and the SGD
    loop's span between two CUDA events around the update."""
    from torch.profiler import ProfilerActivity, profile

    def group(name):
        if "bn_partial_kernel" in name:
            return "B7 bn_stats" if ", false>" in name else \
                "B8 bn_bwd_reduce"
        if "bn_reduce_kernel" in name:
            return "B7 bn_stats" if ", true>" in name else \
                "B8 bn_bwd_reduce"
        if any(p in name.lower() for p in (
                "conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad",
                "fprop", "gemm", "cutlass", "nvjet", "sm90")):
            return "convolutions and products (cuDNN/cuBLAS)"
        return "other (elementwise, casts, pooling, loss, SGD)"

    span = {}
    update = step._update

    def timed_update(grads):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        update(grads)
        b.record()
        span["events"] = (a, b)

    torch.cuda.synchronize()
    step._update = timed_update
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(step(*batch))
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        step._update = update
    torch.cuda.synchronize()
    sgd_ms = span["events"][0].elapsed_time(span["events"][1])
    by_group = {}
    for ev in prof.key_averages():
        if "cuda" not in str(getattr(ev, "device_type", "")).lower():
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        g = group(ev.key)
        by_group[g] = by_group.get(g, 0.0) + us / 1e3
    busy = sum(by_group.values())
    if busy <= 0:
        return None
    return dict(wall_ms=round(wall_ms, 3), device_ms=round(busy, 3),
                busy_share=round(busy / wall_ms, 3),
                sgd_loop_span_ms=round(sgd_ms, 3),
                by_group_ms={g: round(t, 4) for g, t in
                             sorted(by_group.items(), key=lambda x: -x[1])})


def resnet(dev, tag):
    """ResNet-50 v1, channel-last, SGD momentum 0.9, bf16 compute and
    state, B=64 at 224x224 (``bench_resnet50.py`` with
    ``steps_per_call=1``): 2 warm-up and 10 timed steps on one batch.
    Checks the losses and B7/B8's launches (one each per BatchNorm per
    step); returns the launch counts of the timed steps."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.gluon.nn import BatchNorm
    from mxnet_tpu_torch.optimizer import SGD
    from mxnet_tpu_torch.parallel import TrainStep

    net = get_model("resnet50_v1", layout="NHWC").initialize(SEED)
    n_bn = sum(isinstance(m, BatchNorm) for m in net.modules())
    n_par = sum(v.numel() for v in net.state_dict().values())
    step = TrainStep(net, SoftmaxCrossEntropyLoss(),
                     SGD(learning_rate=0.1, momentum=0.9),
                     compute_dtype="bfloat16", state_dtype="bfloat16")
    x, y = resnet_batch(RESNET_B, RESNET_HW, RESNET_CLASSES, SEED)
    batch = (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
    losses = [float(step(*batch)) for _ in range(RESNET_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))  # float() waits for the step
        times.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    want["bn_stats"] = want["bn_bwd_reduce"] = n_bn * RESNET_STEPS
    ms = sorted(t * 1e3 for t in times)
    rm = net.features[1].running_mean
    print(f"resnet [{tag}]: ResNet-50 v1 NHWC bf16 SGD(0.1, momentum 0.9) "
          f"B={RESNET_B} {RESNET_HW}x{RESNET_HW}, {n_par} values (parameters "
          f"and running statistics), "
          f"{n_bn} BatchNorms, {RESNET_STEPS} steps after {RESNET_WARMUP} "
          f"warm-up: {RESNET_STEPS * RESNET_B / sum(times):.2f} images/s "
          f"({RESNET_STEPS * RESNET_B} images in {sum(times):.6f} s); step "
          f"p50 {statistics.median(ms):.3f} ms, min {ms[0]:.3f}, max "
          f"{ms[-1]:.3f}; max_memory_allocated {peak} bytes; losses "
          f"{[round(v, 5) for v in losses]}; running stats {rm.dtype}; "
          f"launches {json.dumps(counts)}")
    # lr 0.1 with momentum 0.9 and no warm-up overshoots on the fixed
    # batch (heavy-ball oscillation), so the losses need not fall at every
    # step. The first step and the last loss must fall below the first
    # loss, and no loss may pass RESNET_LOSS_CAP times it: a run that
    # diverges mid-way and happens to end low still fails.
    if not all(math.isfinite(v) for v in losses) or \
            not losses[1] < losses[0] or not losses[-1] < losses[0] or \
            max(losses) > RESNET_LOSS_CAP * losses[0]:
        fail(f"ResNet losses are not finite, do not fall or overshoot "
             f"{RESNET_LOSS_CAP}x the first: {losses}")
    if counts != want:
        fail(f"launches {counts} differ from the model's structure {want}")
    if n_bn != 53 or n_par != 25_629_032:
        fail(f"not ResNet-50 v1: {n_bn} BatchNorms, {n_par} values")
    prof = profile_resnet_step(step, batch)
    if prof:
        prof["device_ms_over_step_p50"] = round(
            prof["device_ms"] / statistics.median(ms), 3)
    print(f"resnet profile (one step under torch.profiler): "
          f"{json.dumps(prof) if prof else 'no device time recorded'}")
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.gluon.model_zoo import transformer_base
    from mxnet_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"device: {kind} (count {count}); torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(smi)  # name, power limit

    t0 = time.perf_counter()
    lib = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s -> {lib.name}")

    # ------------------------------------------------------- serving phase
    gen = torch.Generator().manual_seed(SEED)
    kernels = [check_layer_norm(dev, gen), check_flash_attention(dev, gen),
               check_paged_attention(dev, gen)]

    net = draw_weights(transformer_base(src_vocab=VOCAB, tgt_vocab=VOCAB,
                                        max_length=1024, dropout=0.0), SEED)
    prompts, max_new = make_requests()
    serve(net, prompts[:1], [4])  # warm-up: cuBLAS handles, allocator
    reset_counts()
    outs, wall, ttft, bat, _ = serve(net, prompts, max_new)
    served = read_counts()
    ttft, stats = sorted(ttft), bat.stats
    if min(served[k] for k in ("layer_norm_fwd", "flash_attention_fwd",
                               "paged_decode_attention")) < 1:
        fail(f"a kernel of the serving path never launched: {served}")
    for r, (toks, m) in enumerate(zip(outs, max_new)):
        ok_len = len(toks) == m or (toks and toks[-1] == 2
                                    and len(toks) <= m)
        if not ok_len or min(toks) < 0 or max(toks) >= VOCAB:
            fail(f"request {r}: bad transcript {toks[:8]}... "
                 f"(len {len(toks)}, asked {m})")
    n_tok = sum(len(t) for t in outs)
    print(f"serve [{kind}, {smi}]: {len(outs)} requests, {n_tok} tokens in "
          f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s; TTFT p50 "
          f"{ttft[len(ttft) // 2]:.1f} ms, max {ttft[-1]:.1f} ms; "
          f"iterations {stats['iterations']}, mean occupancy "
          f"{stats['occupancy_sum'] / max(stats['iterations'], 1):.3f}; "
          f"launches {json.dumps(served)}")

    cpu_net = transformer_base(src_vocab=VOCAB, tgt_vocab=VOCAB,
                               max_length=1024, dropout=0.0, device="cpu")
    cpu_net.load_state_dict(net.state_dict())
    cpu_net.eval()
    distinct = [len(set(t)) for t in outs]
    print(f"distinct tokens per transcript: {distinct}")
    # the comparison below has power only if the transcripts depend on
    # the prompt and do not repeat one token
    if outs[0][:len(outs[8])] == outs[8][:len(outs[0])] \
            or min(distinct[0], distinct[8]) < 8:
        fail("served transcripts are degenerate; the CPU cross-check "
             "could not tell a wrong slot or page")
    for r in (0, 8):  # one 512-bucket and one 128-bucket request
        gpu_lg = teacher_forced_logits(net, prompts[r], outs[r], dev)
        cpu_lg = teacher_forced_logits(cpu_net, prompts[r], outs[r],
                                       torch.device("cpu"))
        err = float((gpu_lg - cpu_lg).abs().max())
        top2 = cpu_lg.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > XCHECK_TOL
        served_toks = torch.tensor(outs[r])
        wrong = int(((cpu_lg.argmax(-1) != served_toks) & decided).sum())
        print(f"cpu cross-check request {r}: {len(outs[r])} steps, "
              f"logits max_abs_err={err:.3e} tol={XCHECK_TOL:.0e}, "
              f"served tokens != cpu greedy at {wrong} of "
              f"{int(decided.sum())} decided steps, "
              f"transcripts equal: "
              f"{bool((cpu_lg.argmax(-1) == served_toks).all())}")
        if err > XCHECK_TOL or wrong:
            fail(f"request {r} disagrees with the CPU run")

    # ------------------------------------------------ forced-prefix phase
    window = check_paged_window(dev, gen)
    kernels.append(window)
    prefixed = prefix_phase(net, cpu_net, dev, window, f"{kind}, {smi}")
    del net, cpu_net

    # ------------------------------------------------------ training phase
    # the forward kernels again at the training path's shapes, beside
    # the backward kernels that take their outputs
    by_name = {e["name"]: e for e in kernels}
    entry, fwd = check_layer_norm_bwd(dev, gen)
    kernels.append(entry)
    by_name["layer_norm_fwd"].update(fwd)
    entries, fwd = check_flash_attention_bwd(dev, gen)
    kernels.extend(entries)
    by_name["flash_attention_fwd"].update(fwd)
    train_cross_check(dev)
    trained = train(dev, f"{kind}, {smi}")

    # -------------------------------------------------------- ResNet phase
    kernels.extend(check_batch_norm(dev, gen))
    resnet_cross_check(dev)
    resnet_counts = resnet(dev, f"{kind}, {smi}")

    for entry in kernels:
        name = entry["name"]
        paths = {"serve": served[name], "prefix": prefixed[name],
                 "train": trained[name], "resnet": resnet_counts[name]}
        entry["launches"] = sum(paths.values())
        entry["launches_by_path"] = paths
    print(json.dumps({"kernels": kernels}))
    print(smi)  # name, power limit
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
