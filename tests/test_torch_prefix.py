"""Forced-prefix replay (``prefill_suffix_paged``, ``decode_window_paged``,
``InferStep.prefill_suffix_paged`` and ``ContinuousBatcher.submit(
prefix_ids=...)``) of the port against the JAX package, on the CPU.

The tiny Transformer of ``test_torch_serving.py`` (units 128, 2+2 layers,
2 heads, vocab 61; weights redrawn with numpy so that greedy transcripts
vary) is built by the JAX package and carried into the port through
``save_parameters``. Three requests are BOS-primed into slots 0-2 of a
4-slot state; slot 3 stays empty. Their forced histories (3, 10 and 7
tokens) are replayed in one call of 4 rows, the last a padding row as the
batcher pads it: slot id ``slots`` (its clamped cross-memory gather
lands on the empty slot, whose ``mem_vl`` of 0 is raised to 1), an
all-trash table. The JAX side runs its dense fallback (the Pallas kernels
are off on the CPU); the port's wide form runs B6's plain version.

Tolerance: float32 on both sides, two layers deep, summed in other
orders: logits and the written K/V pages agree to about 1e-6 and are held
at 1e-4 absolute and relative, on live rows and on every page but the
trash page (padding writes land there in either order). Greedy tokens and
transcripts are compared exactly, which is fair only where the top-2
logit margin exceeds that tolerance: each comparison asserts a margin of
at least 10x it at every compared step (the rule of
``test_torch_serving.py``). The wide replay rounds in another order than
the sequential one (the JAX docstring calls it equal argmax in practice,
not bit-exact), so inside the port the two are compared by transcript
under the same rule.

The batcher comparison serves four requests (one without a prefix)
through two slots with ``max_prefix_tokens=16``, so that the replay runs
at menu widths 4, 8 and 16 and a prefixed row shares its admission with
a plain one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.gluon.model_zoo.transformer import TransformerModel as JaxTM
from mxnet_tpu.parallel import InferStep as JaxInferStep
from mxnet_tpu.serving import ContinuousBatcher as JaxBatcher
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon.model_zoo import TransformerModel
from mxnet_tpu_torch.parallel import InferStep
from mxnet_tpu_torch.serving import ContinuousBatcher

TOL = 1e-4
CFG = dict(units=128, hidden_size=256, num_layers=2, num_heads=2,
           max_length=64, dropout=0.0)
V = 61
SLOTS, PS, P, BUCKET, S = 4, 4, 6, 16, 16
PROMPT_LENS = (5, 11, 8)
PREFIX_LENS = (3, 10, 7)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    mx.random.seed(0)
    np.random.seed(0)
    jnet = JaxTM(src_vocab=V, tgt_vocab=V, **CFG)
    jnet.initialize(mx.initializer.Xavier())
    jnet._probe_shapes(nd.zeros((2, 8), dtype="int32"),
                       nd.zeros((2, 8), dtype="int32"))
    rng = np.random.RandomState(0)
    for name, p in jnet._collect_params_with_prefix().items():
        shape = p.data().shape
        if name.endswith("gamma"):
            arr = 1.0 + 0.1 * rng.randn(*shape)
        elif name.endswith(("bias", "beta")):
            arr = 0.1 * rng.randn(*shape)
        else:
            scale = 1.0 if name.startswith("pos_embed") \
                else 0.2 / np.sqrt(CFG["units"]) if "embed" in name \
                else 1.0 / np.sqrt(shape[1])
            arr = scale * rng.randn(*shape)
        p.set_data(nd.array(arr.astype(np.float32)))
    path = str(tmp_path_factory.mktemp("params") / "tiny.npz")
    jnet.save_parameters(path)
    tnet = TransformerModel(V, V, device="cpu", **CFG).eval()
    load_mxnet_tpu_params(path, tnet)
    return jnet, tnet


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else
                      getattr(x, "data", x))


def _case():
    """The BOS-prime admission of 3 rows and the 4-row replay call."""
    rng = np.random.RandomState(11)
    prompts = [rng.randint(3, V, size=n) for n in PROMPT_LENS]
    prefixes = [rng.randint(3, V, size=n) for n in PREFIX_LENS]
    src = np.zeros((3, BUCKET), np.int32)
    for r, p in enumerate(prompts):
        src[r, :len(p)] = p
    tables = np.zeros((SLOTS, P), np.int32)
    for r in range(3):
        tables[r] = 1 + r * P + np.arange(P)
    prime = dict(src=src, vl=np.array(PROMPT_LENS, np.int32),
                 slot_ids=np.arange(3, dtype=np.int32),
                 first_pages=tables[:3, 0].copy(),
                 active=np.ones((3,), bool))
    toks = np.zeros((SLOTS, S), np.int32)
    tvl = np.ones((SLOTS,), np.int32)
    q_off = np.zeros((SLOTS,), np.int32)
    for r, h in enumerate(prefixes):
        toks[r, :len(h)] = h
        tvl[r] = len(h)
        q_off[r] = 1
    replay = dict(tokens=toks, token_vl=tvl, q_offset=q_off, tables=tables,
                  slot_ids=np.array([0, 1, 2, SLOTS], np.int32),
                  active=np.array([True, True, True, False]))
    return prime, replay


def _jax_primed(jnet, prime):
    state = jnet.init_paged_state(SLOTS, 1 + SLOTS * P, PS, BUCKET)
    _, state = jnet.prefill_paged(
        nd.array(prime["src"], dtype="int32"),
        nd.array(np.ones((3, 1), np.int32), dtype="int32"),
        nd.array(prime["vl"], dtype="int32"), state,
        jnp.asarray(prime["slot_ids"]), jnp.asarray(prime["first_pages"]),
        jnp.asarray(prime["active"]))
    return state


def _port_primed(tnet, prime):
    t = torch.from_numpy
    state = tnet.init_paged_state(SLOTS, 1 + SLOTS * P, PS, BUCKET)
    _, state = tnet.prefill_paged(
        t(prime["src"]).long(), torch.ones((3, 1), dtype=torch.long),
        t(prime["vl"]), state, t(prime["slot_ids"]).long(),
        t(prime["first_pages"]).long(), t(prime["active"]))
    return state


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _margins(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


# ------------------------------------------------------------------ model
def test_decode_window_paged_matches_jax(models):
    """One window pass over the primed state, rows 0-2 at offset 1 with
    padding tails, the empty slot 3 inactive: logits at every live
    position."""
    jnet, tnet = models
    prime, rp = _case()
    jstate = _jax_primed(jnet, prime)
    want, _ = jnet.decode_window_paged(
        jnp.asarray(rp["tokens"]), jnp.asarray(rp["q_offset"]), jstate,
        jnp.asarray(rp["tables"]), jnp.asarray(rp["active"]),
        window_vl=jnp.asarray(rp["token_vl"]))
    t = torch.from_numpy
    with torch.inference_mode():
        tstate = _port_primed(tnet, prime)
        got, _ = tnet.decode_window_paged(
            t(rp["tokens"]), t(rp["q_offset"]), tstate, t(rp["tables"]),
            t(rp["active"]), window_vl=t(rp["token_vl"]))
    assert got.shape == (SLOTS, S, V)
    for r, n in enumerate(PREFIX_LENS):
        _close(_np(got)[r, :n], _np(want)[r, :n])


@pytest.mark.parametrize("wide", [False, True], ids=["sequential", "wide"])
def test_prefill_suffix_paged_matches_jax(models, wide):
    """Last logits of the live rows and every written K/V page, both
    forms."""
    jnet, tnet = models
    prime, rp = _case()
    jstate = _jax_primed(jnet, prime)
    want, jstate = jnet.prefill_suffix_paged(
        jnp.asarray(rp["tokens"]), jnp.asarray(rp["token_vl"]),
        jnp.asarray(rp["q_offset"]), jstate, jnp.asarray(rp["tables"]),
        jnp.asarray(rp["slot_ids"]), jnp.asarray(rp["active"]), wide=wide)
    t = torch.from_numpy
    with torch.inference_mode():
        tstate = _port_primed(tnet, prime)
        got, tstate = tnet.prefill_suffix_paged(
            t(rp["tokens"]), t(rp["token_vl"]), t(rp["q_offset"]), tstate,
            t(rp["tables"]), t(rp["slot_ids"]), t(rp["active"]), wide=wide)
    assert got.shape == (SLOTS, V) and np.isfinite(_np(got)).all()
    _close(_np(got)[:3], _np(want)[:3])
    for i in range(CFG["num_layers"]):
        for name in ("k_pools", "v_pools"):
            _close(_np(tstate[name][i])[1:], np.asarray(jstate[name][i])[1:])
    # the replay wrote each row's history at positions 1..len(prefix)
    k0 = _np(tstate["k_pools"][0])
    for r, n in enumerate(PREFIX_LENS):
        pos = n  # the last forced token
        page = rp["tables"][r, pos // PS]
        assert np.abs(k0[page, pos % PS]).sum() > 0


@pytest.mark.parametrize("wide", [False, True], ids=["sequential", "wide"])
def test_infer_step_prefill_suffix_paged_matches_jax(models, wide):
    """The engines' first new tokens, from the same admission and replay
    calls; compared exactly where the margin allows (asserted)."""
    jnet, tnet = models
    prime, rp = _case()
    jeng = JaxInferStep(jnet, eos_id=-1, max_len=64)
    jstate = jeng.init_paged_state(SLOTS, SLOTS * P, PS, BUCKET)
    _, jstate = jeng.prefill_paged(jstate, prime["src"], prime["vl"],
                                   prime["slot_ids"], prime["first_pages"],
                                   prime["active"])
    want, _ = jeng.prefill_suffix_paged(
        jstate, rp["tokens"], rp["token_vl"], rp["q_offset"], rp["tables"],
        rp["slot_ids"], rp["active"], wide=wide)
    eng = InferStep(tnet, eos_id=-1, device="cpu")
    state = eng.init_paged_state(SLOTS, SLOTS * P, PS, BUCKET)
    _, state = eng.prefill_paged(state, prime["src"], prime["vl"],
                                 prime["slot_ids"], prime["first_pages"],
                                 prime["active"])
    got, state = eng.prefill_suffix_paged(
        state, rp["tokens"], rp["token_vl"], rp["q_offset"], rp["tables"],
        rp["slot_ids"], rp["active"], wide=wide)
    assert got.dtype == torch.int32 and got.shape == (SLOTS,)
    # the margins of the port's logits for the same replay
    with torch.inference_mode():
        t = torch.from_numpy
        logits, _ = tnet.prefill_suffix_paged(
            t(rp["tokens"]), t(rp["token_vl"]), t(rp["q_offset"]),
            _port_primed(tnet, prime), t(rp["tables"]), t(rp["slot_ids"]),
            t(rp["active"]), wide=wide)
    assert _margins(_np(logits)[:3]).min() > 10 * TOL
    np.testing.assert_array_equal(_np(got)[:3], np.asarray(want.asnumpy())[:3])
    np.testing.assert_array_equal(_np(got)[:3], _np(logits)[:3].argmax(-1))


# ---------------------------------------------------------------- batcher
MAX_NEW = 6
REQ_PROMPTS = (6, 9, 4, 12)
REQ_PREFIX = (2, 0, 16, 5)  # 0: no prefix
REQ_ASKED = (6, 5, 6, 4)


def _requests():
    rng = np.random.RandomState(21)
    prompts = [rng.randint(3, V, size=n).astype(np.int32)
               for n in REQ_PROMPTS]
    prefixes = [rng.randint(3, V, size=n).astype(np.int32) if n else None
                for n in REQ_PREFIX]
    return prompts, prefixes


def _port_serve(tnet, wide):
    prompts, prefixes = _requests()
    eng = InferStep(tnet, eos_id=-1, device="cpu")
    bat = ContinuousBatcher(eng, (8, BUCKET), slots=2,
                            max_new_tokens=MAX_NEW, page_size=PS,
                            iter_tokens=3, max_prefix_tokens=16,
                            suffix_wide=wide)
    try:
        futs = [bat.submit(p, max_new_tokens=m, prefix_ids=h)
                for p, h, m in zip(prompts, prefixes, REQ_ASKED)]
        got = [f.result(timeout=120) for f in futs]
    finally:
        bat.stop()
    assert bat.pool.free_pages == bat.pool.num_pages
    bat.pool.check_invariants(set())
    assert bat.pages_per_slot == -(-(1 + 16 + MAX_NEW) // PS)
    assert bat._suffix_menu == [1, 2, 4, 8, 16]
    return got


def _jax_forced_logits(jnet, prompt, prefix, tokens):
    """JAX logits of each generated step of one request, teacher-forced:
    the BOS prime, the sequential replay of its prefix, then one decode
    step per token but the last."""
    n = 0 if prefix is None else len(prefix)
    pages = -(-(1 + n + len(tokens)) // PS)
    state = jnet.init_paged_state(1, 1 + pages, PS, BUCKET)
    src = np.zeros((1, BUCKET), np.int32)
    src[0, :len(prompt)] = prompt
    one = jnp.ones((1,), bool)
    table = jnp.arange(1, 1 + pages, dtype=jnp.int32)[None]
    logits, state = jnet.prefill_paged(
        nd.array(src, dtype="int32"), nd.array(np.ones((1, 1), np.int32),
                                               dtype="int32"),
        nd.array(np.array([len(prompt)], np.int32), dtype="int32"), state,
        jnp.zeros((1,), jnp.int32), jnp.ones((1,), jnp.int32), one)
    if n:
        logits, state = jnet.prefill_suffix_paged(
            jnp.asarray(prefix[None]), jnp.asarray([n], jnp.int32),
            jnp.ones((1,), jnp.int32), state, table,
            jnp.zeros((1,), jnp.int32), one)
    steps = [_np(logits)[0]]
    for j, tok in enumerate(tokens[:-1]):
        lg, state = jnet.decode_step_paged(
            nd.array(np.array([tok], np.int32), dtype="int32"),
            jnp.asarray([1 + n + j], jnp.int32), state, table, one)
        steps.append(_np(lg)[0])
    return np.stack(steps)


@pytest.fixture(scope="module")
def jax_transcripts(models):
    """The JAX batcher's transcripts, sequential and wide replay, without
    the prefix cache."""
    jnet, _ = models
    prompts, prefixes = _requests()
    eng = JaxInferStep(jnet, eos_id=-1, max_len=64)
    out = {}
    for wide in (False, True):
        bat = JaxBatcher(eng, (8, BUCKET), slots=2, max_new_tokens=MAX_NEW,
                         page_size=PS, iter_tokens=3, max_prefix_tokens=16,
                         prefix_cache=False, suffix_wide=wide,
                         name=f"torch-prefix-{wide}")
        try:
            futs = [bat.submit(p, max_new_tokens=m, prefix_ids=h)
                    for p, h, m in zip(prompts, prefixes, REQ_ASKED)]
            out[wide] = [list(f.result(timeout=300)) for f in futs]
        finally:
            bat.stop()
    return out


@pytest.mark.parametrize("wide", [False, True], ids=["sequential", "wide"])
def test_batcher_transcripts_match_jax(models, jax_transcripts, wide):
    jnet, tnet = models
    got = _port_serve(tnet, wide)
    want = jax_transcripts[wide]
    prompts, prefixes = _requests()
    for r in range(len(prompts)):
        assert len(got[r]) == REQ_ASKED[r]
        logits = _jax_forced_logits(jnet, prompts[r], prefixes[r], want[r])
        assert _margins(logits).min() > 10 * TOL, r
    assert got == want


def test_wide_replay_equals_sequential_inside_port(models):
    """``suffix_wide=True`` serves the transcripts of the sequential
    replay (the JAX claim at ``tests/test_prefix.py:382``)."""
    _, tnet = models
    assert _port_serve(tnet, True) == _port_serve(tnet, False)


def test_prefix_errors(models):
    """A prefix past ``max_prefix_tokens`` raises (a batcher built
    without a budget takes none); an empty prefix is no prefix."""
    _, tnet = models
    eng = InferStep(tnet, eos_id=-1, device="cpu")
    plain = ContinuousBatcher(eng, (8,), slots=1, max_new_tokens=2)
    try:
        with pytest.raises(MXNetError, match="max_prefix_tokens"):
            plain.submit([3, 4], prefix_ids=[5])
    finally:
        plain.stop()
    bat = ContinuousBatcher(eng, (8,), slots=1, max_new_tokens=3,
                            page_size=PS, max_prefix_tokens=4)
    try:
        with pytest.raises(MXNetError, match="max_prefix_tokens"):
            bat.submit([3, 4], prefix_ids=np.arange(3, 8))
        empty = bat.submit([3, 4, 5], prefix_ids=[]).result(timeout=60)
        none = bat.submit([3, 4, 5]).result(timeout=60)
    finally:
        bat.stop()
    assert empty == none and len(none) == 3
