"""Continuous batching over a paged KV cache.

Counterpart of ``ContinuousBatcher`` in ``mxnet_tpu/serving/batcher.py``
(``:725``), its scheduling core: ``submit``, the scheduler thread,
``_admit`` (``:1412``), ``_dispatch`` (``:1741``), ``_collect``
(``:1780``), ``_retire`` (``:1079``), slot reuse, per-request
``max_new_tokens``, EOS, page release and ``stop()``, and the forced
target prefix (``submit(prefix_ids=...)``, ``max_prefix_tokens``,
``suffix_wide``). The decode batch is a fixed menu of ``slots``; every
iteration retires finished rows and frees their pages, admits queued
requests into the vacated slots through one padded prefill-into-pages
call (rows with a forced prefix then replay it through one
``InferStep.prefill_suffix_paged`` call), then runs one
``InferStep.decode_iter`` burst of ``iter_tokens`` tokens. The pool
always provisions every slot in full (``slots * pages_per_slot`` pages).
The prefix cache, speculation,
disaggregation, undersized pools with preemption, deadlines,
backpressure, token streaming, fault injection, tracing and telemetry of
the JAX package are not ported yet.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np

from ..base import MXNetError
from . import pages as _pages

__all__ = ["ContinuousBatcher", "GenerationResult"]


class GenerationResult:
    """Future for one submitted request. ``result(timeout)`` blocks until
    it finished and returns the generated tokens (trimmed at EOS and at
    the request's ``max_new_tokens``). ``enqueued_at`` and
    ``first_token_at`` are ``perf_counter`` instants (TTFT is their
    difference)."""

    __slots__ = ("_event", "_tokens", "_error", "enqueued_at",
                 "first_token_at")

    def __init__(self):
        self._event = threading.Event()
        self._tokens = None
        self._error = None
        self.enqueued_at = time.perf_counter()
        self.first_token_at = None

    def _first_token(self):
        if self.first_token_at is None:
            self.first_token_at = time.perf_counter()

    def _resolve(self, tokens):
        self._tokens = tokens
        self._event.set()

    def _fail(self, err):
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def exception(self):
        return self._error

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("generation result not ready")
        if self._error is not None:
            raise self._error
        return self._tokens


class _Request:
    __slots__ = ("prompt", "max_new", "future", "prefix")

    def __init__(self, prompt, max_new, future, prefix=None):
        self.prompt = prompt
        self.max_new = max_new
        self.future = future
        self.prefix = prefix  # forced target history, or None

    @property
    def target_len(self) -> int:
        """Cached target positions once admitted: BOS and the prefix."""
        return 1 + (0 if self.prefix is None else self.prefix.shape[0])


class _Slot:
    """Host-side record of one occupied decode slot."""

    __slots__ = ("req", "carry", "length", "emitted", "finished")

    def __init__(self, req, first_tok):
        self.req = req
        self.carry = first_tok  # last chosen token, not yet KV-cached
        self.length = req.target_len  # KV entries cached: BOS and prefix
        self.emitted = [first_tok]
        self.finished = False


class ContinuousBatcher:
    """Iteration-level scheduler over a paged KV cache.

    Parameters
    ----------
    engine : ``parallel.InferStep`` over a paged-protocol model.
    bucket_keys : ascending prompt-length menu; prompts pad to the
        smallest key that holds the longest admitted prompt, and the
        largest key is the cross-attention memory width of every slot.
    slots : decode-batch rows.
    max_new_tokens : per-request generation cap (requests may ask less).
    page_size : tokens per KV page (``MXTPU_PAGE_SIZE``, default 16).
    iter_tokens : decode tokens per iteration (dispatch granularity).
    max_prefix_tokens : forced target-prefix budget per request (re-sent
        history, ``submit(prefix_ids=...)``); each slot is provisioned for
        ``1 + max_prefix_tokens + max_new_tokens`` cached positions. 0
        (default) rejects prefix requests.
    suffix_wide : replay forced prefixes through the one-pass window
        program (kernel B6 on the card) instead of the sequential
        per-position stream.
    """

    def __init__(self, engine, bucket_keys: Sequence[int], slots: int = 8,
                 max_new_tokens: int = 32, page_size: Optional[int] = None,
                 iter_tokens: int = 4, max_prefix_tokens: int = 0,
                 suffix_wide: bool = False):
        self._engine = engine
        self.bucket_keys = sorted(int(k) for k in bucket_keys)
        if not self.bucket_keys:
            raise MXNetError("bucket_keys must be non-empty")
        self.slots = int(slots)
        self.max_new = int(max_new_tokens)
        self._pad = engine._pad
        self._eos = engine._eos
        self.page_size = int(page_size) if page_size is not None \
            else _pages.page_size_default()
        self.max_prefix = int(max_prefix_tokens)
        self.suffix_wide = bool(suffix_wide)
        self.pages_per_slot = _pages.pages_for(
            1 + self.max_prefix + self.max_new, self.page_size)
        # replay widths: powers of two below max_prefix, then max_prefix
        self._suffix_menu = []
        if self.max_prefix > 0:
            w = 1
            while w < self.max_prefix:
                self._suffix_menu.append(w)
                w *= 2
            self._suffix_menu.append(self.max_prefix)
        self.num_pages = self.slots * self.pages_per_slot
        self.iter_tokens = max(int(iter_tokens), 1)
        self.mem_len = self.bucket_keys[-1]
        self.pool = _pages.PagePool(self.num_pages, self.page_size,
                                    self.slots, self.pages_per_slot)
        self._state = engine.init_paged_state(
            self.slots, self.num_pages, self.page_size, self.mem_len)
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._slots = [None] * self.slots
        self._pending = collections.deque()
        # written by the scheduler thread only
        self.stats = {"iterations": 0, "occupancy_sum": 0.0, "admitted": 0,
                      "retired": 0, "tokens": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="mxtt-batcher", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ lifecycle
    def stop(self, drain: bool = True, timeout: float = 30.0):
        """Stop the scheduler; with ``drain`` (default) outstanding
        requests are served first. Whatever is still queued or in a slot
        afterwards is failed, and every page returns to the pool."""
        if drain and self.healthy:
            deadline = time.perf_counter() + timeout
            while not self._drained() and time.perf_counter() < deadline:
                time.sleep(0.005)
        self._stop.set()
        self._thread.join(timeout=timeout)
        err = RuntimeError("ContinuousBatcher stopped with this request "
                           "in flight")
        self._cancel_pending(err)
        self._fail_inflight(err)

    def _drained(self) -> bool:
        return self._queue.empty() and not self._pending and \
            not any(self._slots)

    @property
    def healthy(self) -> bool:
        """True while the scheduler thread is alive and accepting."""
        return self._thread.is_alive() and not self._stop.is_set()

    def _cancel_pending(self, error: BaseException):
        """Fail every queued request's future."""
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                return
            r.future._fail(error)

    def _fail_inflight(self, error):
        for i, s in enumerate(self._slots):
            if s is not None and not s.req.future.done():
                s.req.future._fail(error)
            self._slots[i] = None
        for r in self._pending:
            if not r.future.done():
                r.future._fail(error)
        self._pending.clear()
        self.pool.reset()

    # ------------------------------------------------------------- requests
    def submit(self, prompt_ids, max_new_tokens: Optional[int] = None,
               prefix_ids=None) -> GenerationResult:
        """Enqueue one prompt (1-D int sequence). ``prefix_ids`` is the
        target-side history of earlier turns, re-sent by the client: it
        is forced verbatim before new tokens are chosen, and only the new
        tokens are returned (an empty prefix is none; one longer than
        ``max_prefix_tokens`` raises). Submitting to a stopped batcher
        returns an already-failed future."""
        prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
        if prompt.shape[0] > self.bucket_keys[-1]:
            raise MXNetError(
                f"prompt length {prompt.shape[0]} exceeds the largest "
                f"bucket key {self.bucket_keys[-1]}")
        max_new = self.max_new if max_new_tokens is None \
            else int(max_new_tokens)
        if not 1 <= max_new <= self.max_new:
            raise MXNetError(f"request max_new_tokens {max_new} outside "
                             f"[1, {self.max_new}]")
        prefix = None
        if prefix_ids is not None:
            prefix = np.asarray(prefix_ids, dtype=np.int32).reshape(-1)
            if prefix.shape[0] == 0:
                prefix = None
            elif prefix.shape[0] > self.max_prefix:
                raise MXNetError(
                    f"prefix length {prefix.shape[0]} > batcher "
                    f"max_prefix_tokens {self.max_prefix}")
        fut = GenerationResult()
        if not self.healthy:
            fut._fail(RuntimeError("ContinuousBatcher is not accepting "
                                   "requests (stopped, or its scheduler "
                                   "thread died)"))
            return fut
        self._queue.put(_Request(prompt, max_new, fut, prefix))
        return fut

    def _bucket_for(self, length):
        for k in self.bucket_keys:
            if length <= k:
                return k
        raise MXNetError(f"prompt length {length} > largest bucket key "
                         f"{self.bucket_keys[-1]}")

    # ------------------------------------------------------------ scheduler
    def _run(self):
        try:
            self._run_loop()
        except BaseException:
            err = RuntimeError("ContinuousBatcher scheduler thread died")
            self._fail_inflight(err)
            self._cancel_pending(err)
            raise

    def _run_loop(self):
        while not self._stop.is_set():
            if not self._step_once():
                try:  # idle: block briefly for an arrival
                    self._pending.append(self._queue.get(timeout=0.05))
                except queue.Empty:
                    continue

    def _step_once(self) -> bool:
        """One iteration: retire -> admit -> decode -> collect. Returns
        False when there was nothing to do."""
        while True:
            try:
                self._pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        try:
            self._retire()
            admitted = self._admit()
            live = [i for i, s in enumerate(self._slots)
                    if s is not None and not s.finished]
            if not live:
                return admitted > 0
            self._ensure_capacity(live)
            self._collect(live, self._dispatch(live))
        except Exception as e:  # noqa: BLE001 - fail the slots, not the thread
            self._poison(e)
        return True

    def _retire(self):
        """Resolve finished slots and free their pages."""
        for i, s in enumerate(self._slots):
            if s is None or not s.finished:
                continue
            self.pool.release(i)
            self._slots[i] = None
            if not s.req.future.done():
                s.req.future._resolve(list(s.emitted))
            self.stats["retired"] += 1

    def _rows_for(self, n):
        """Call row count: the smallest power of two covering ``n`` rows,
        at most ``slots``."""
        rows = 1
        while rows < n:
            rows *= 2
        return min(rows, self.slots)

    def _admit(self) -> int:
        """Fill vacated slots from the waiting line with ONE padded
        prefill-into-pages call; each admitted row's first token comes
        from it, except a row with a forced prefix: it is BOS-primed in
        the same call, then every such row replays its prefix through
        ONE ``prefill_suffix_paged`` call, which gives its first token
        (``:1481-1486``, ``:1581-1630``)."""
        free = [i for i, s in enumerate(self._slots) if s is None]
        picked = []
        while free and self._pending:
            slot = free.pop(0)
            # pages for BOS and the whole prefix before the replay
            # (_stage_slot, :1348-1349)
            if not (self.pool.alloc(slot, 1) and self.pool.ensure(
                    slot, self._pending[0].target_len)):
                self.pool.release(slot)
                break
            picked.append((slot, self._pending.popleft()))
        if not picked:
            return 0
        bucket = self._bucket_for(max(r.prompt.shape[0]
                                      for _, r in picked))
        rows = self._rows_for(len(picked))
        src = np.full((rows, bucket), self._pad, np.int32)
        vl = np.full((rows,), bucket, np.int32)
        slot_ids = np.full((rows,), self.slots, np.int32)  # out of range
        first_pages = np.zeros((rows,), np.int32)
        active = np.zeros((rows,), bool)
        for i, (slot, r) in enumerate(picked):
            n = r.prompt.shape[0]
            src[i, :n] = r.prompt
            vl[i] = n
            slot_ids[i] = slot
            first_pages[i] = self.pool.table[slot, 0]
            active[i] = True
        try:
            tok0, self._state = self._engine.prefill_paged(
                self._state, src, vl, slot_ids, first_pages, active)
            tok0 = tok0.cpu().numpy()
        except Exception as e:
            for _, r in picked:  # not in a slot yet: _poison cannot see them
                r.future._fail(e)
            raise
        forced = []
        for i, (slot, r) in enumerate(picked):
            if r.prefix is not None:
                forced.append((slot, r))  # the BOS sample is not used
            else:
                self._activate(slot, r, int(tok0[i]))
        if forced:
            try:
                first = self._replay(forced)
            except Exception as e:
                for _, r in forced:
                    r.future._fail(e)
                raise
            for (slot, r), tok in zip(forced, first):
                self._activate(slot, r, int(tok))
        self.stats["admitted"] += len(picked)
        return len(picked)

    def _replay(self, forced):
        """One ``prefill_suffix_paged`` call over the BOS-primed rows with
        a forced prefix (``:1588-1617``): each row's prefix at positions
        1.., the width the smallest menu entry that holds the longest;
        padding rows carry slot id ``slots`` and all-trash tables. Returns
        each row's first new token."""
        rows = self._rows_for(len(forced))
        need = max(r.prefix.shape[0] for _, r in forced)
        width = next(w for w in self._suffix_menu if w >= need)
        toks = np.zeros((rows, width), np.int32)
        vl = np.ones((rows,), np.int32)
        q_off = np.zeros((rows,), np.int32)
        tables = np.zeros((rows, self.pages_per_slot), np.int32)
        slot_ids = np.full((rows,), self.slots, np.int32)  # out of range
        active = np.zeros((rows,), bool)
        for i, (slot, r) in enumerate(forced):
            n = r.prefix.shape[0]
            toks[i, :n] = r.prefix
            vl[i] = n
            q_off[i] = 1  # after the BOS prime
            tables[i] = self.pool.table[slot]
            slot_ids[i] = slot
            active[i] = True
        tok, self._state = self._engine.prefill_suffix_paged(
            self._state, toks, vl, q_off, tables, slot_ids, active,
            wide=self.suffix_wide)
        return tok.cpu().numpy()[:len(forced)]

    def _activate(self, slot, r, first_tok):
        """Install an admitted request in its slot with its first token
        (``_activate``, ``:1642-1654``)."""
        s = _Slot(r, first_tok)
        s.finished = s.carry == self._eos or r.max_new == 1
        self._slots[slot] = s
        r.future._first_token()

    def _ensure_capacity(self, live):
        """Grow each live row's pages so it can cache the next burst. A
        row near its ``max_new_tokens`` needs less than a full burst: its
        surplus burst steps fall past its pages onto trash-page entries
        (the cap is BOS, the prefix and ``max_new``, ``:1693-1701``). The
        pool provisions every slot in full, so this cannot fail."""
        for i in live:
            s = self._slots[i]
            upto = min(s.length + self.iter_tokens,
                       s.req.target_len + s.req.max_new)
            if not self.pool.ensure(i, upto):
                raise MXNetError(f"page pool exhausted growing slot {i} to "
                                 f"{upto} tokens")

    def _dispatch(self, live):
        """One decode-iteration call over the slot batch."""
        tokens = np.zeros((self.slots,), np.int32)
        lengths = np.zeros((self.slots,), np.int32)
        active = np.zeros((self.slots,), bool)
        for i in live:
            s = self._slots[i]
            tokens[i] = s.carry
            lengths[i] = s.length
            active[i] = True
        buf, self._state = self._engine.decode_iter(
            self._state, self.pool.table, tokens, lengths, active,
            steps=self.iter_tokens)
        return buf

    def _collect(self, live, buf):
        """Read the iteration's token block (the scheduler's one sync
        point), account lengths and mark retirements."""
        toks = buf.cpu().numpy()
        emitted = 0
        for i in live:
            s = self._slots[i]
            for j in range(self.iter_tokens):
                tok = int(toks[i, j])
                s.length += 1  # this step cached the previous carry
                s.carry = tok
                s.emitted.append(tok)
                emitted += 1
                if tok == self._eos or len(s.emitted) >= s.req.max_new:
                    s.finished = True
                    break
        self.stats["iterations"] += 1
        self.stats["occupancy_sum"] += len(live) / self.slots
        self.stats["tokens"] += emitted

    def _poison(self, err):
        """An iteration failed: fail every in-flight request, rebuild the
        pool and state, keep the thread alive for fresh work."""
        for i, s in enumerate(self._slots):
            if s is not None:
                if not s.req.future.done():
                    s.req.future._fail(err)
                self._slots[i] = None
        self.pool.reset()
        self._state = self._engine.init_paged_state(
            self.slots, self.num_pages, self.page_size, self.mem_len)
