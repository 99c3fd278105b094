"""Token-level continuous batching: the generative engine.

Port of ``simple_tensorflow_tpu/serving/generative.py``:
``GenerativeEngine`` with its slot path (``_admit_batch`` :542-598,
``_step`` :725-762, ``_finish_single_step`` :764-800), its speculative
path (``_step_speculative`` :857-929, the draft/target checks :301-333),
its paged path (``_admit_paged``, ``_step_paged``), ``_retire``,
``statusz_info`` and ``close``, plus ``CacheSlotPool``,
``GenerateFuture``, ``GenerateRequest`` and ``_Sequence``. One engine
owns one model and one scheduler thread:

- requests enqueue on a bounded admission queue (backpressure, deadlines,
  close semantics);
- a slot model (e.g. :class:`..models.transformer.
  TransformerGenerativeModel`): a joining request takes a cache slot from
  the free-list, pays one prefill (the encoder and the cross K/V written
  into its slot) and rides the next decode step from EOS at position 0;
  each step pads the live set to the policy's bucket with rows aimed at
  the model's scratch slot;
- a paged model (e.g. :class:`..models.causal_lm.CausalLMGenerativeModel`):
  admission walks the prefix trie (serving/prefix_cache.py): matched
  prompt chunks reuse refcounted shared pages with zero prefill, missing
  chunks prefill page by page, batched by chunk position across joiners,
  and a partial tail that a resident chunk extends is built by
  copy-on-write;
- speculative decoding (``draft=``, slot models only): each step the draft
  proposes ``draft_steps`` greedy tokens in one program (``decode_k``),
  the target re-scores the ``spec_k``-token block in one pass
  (``verify``) and each sequence commits the longest prefix of proposals
  equal to the target's own picks plus one bonus target token: every
  emitted token is the target's, so the stream equals plain greedy decode;
- a sequence retires when it emits EOS, exhausts its budget or blows its
  deadline (checked every token); its slot returns to the free-list (a
  paged sequence also releases its trie chain and private pages).

Model interface (duck-typed, the JAX engine's): ``decode``, ``close``,
``eos_id``, ``pad_id``, ``num_slots``, ``max_decode_len``,
``decode_buckets``; slot models ``prefill``, ``src_len``,
``scratch_slot`` (and ``verify``/``spec_k`` or ``decode_k``/
``draft_steps``); paged models ``prefill_chunk``, ``copy_page``,
``page_len``, ``num_pages``, ``pages_per_seq``, ``scratch_page``,
``max_seq_len``.

Decode tensor parallelism belongs to a later slice of the port and raises
``NotImplementedError`` here.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..framework import errors
from ._metrics import EngineMetrics
from ._queue import DONE, AdmissionQueue
from .prefix_cache import PagesExhaustedError, PrefixCache


class CacheSlotPool:
    """Free-list over the live-sequence slots. Single-threaded (the
    engine thread owns it)."""

    def __init__(self, num_slots: int):
        self._free: List[int] = list(range(num_slots))[::-1]
        self.num_slots = num_slots

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.num_slots - len(self._free)

    def acquire(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def release(self, slot: int) -> None:
        self._free.append(slot)


class GenerateFuture:
    """Async handle for one request. ``result()`` blocks for
    ``{"tokens", "logprobs", "outcome"}``; streaming consumers pass
    ``on_token`` to :meth:`GenerativeEngine.generate` instead."""

    __slots__ = ("_event", "_result", "_exc", "_model")

    def __init__(self, model: str):
        self._event = threading.Event()
        self._result: Optional[Dict[str, Any]] = None
        self._exc: Optional[BaseException] = None
        self._model = model

    def _set_result(self, result: Dict[str, Any]):
        self._result = result
        self._event.set()

    def _set_exception(self, exc: BaseException):
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def exception(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise errors.DeadlineExceededError(
                None, None,
                f"generation for model {self._model!r} not done within "
                f"{timeout}s")
        return self._exc

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        exc = self.exception(timeout)
        if exc is not None:
            raise exc
        return self._result

    def __repr__(self):
        state = ("pending" if not self.done()
                 else "failed" if self._exc is not None else "done")
        return f"<GenerateFuture {self._model} {state}>"


class GenerateRequest:
    __slots__ = ("src", "max_new_tokens", "future", "deadline",
                 "on_token", "t_enqueue")

    def __init__(self, src, max_new_tokens, future,
                 deadline: Optional[float] = None,
                 on_token: Optional[Callable[[int, float], None]] = None):
        self.src = src
        self.max_new_tokens = max_new_tokens
        self.future = future
        self.deadline = deadline
        self.on_token = on_token
        self.t_enqueue = time.perf_counter()

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (now if now is not None else time.perf_counter()) > self.deadline


class _Sequence:
    """One live sequence: its slot, emission state and budget, its page
    table, its deepest trie node (released at retirement) and the
    private pages it owns (freed at retirement)."""

    __slots__ = ("req", "slot", "tokens", "logps", "pos", "last_tok",
                 "budget", "t_start", "pages", "node", "private",
                 "cow_blk")

    def __init__(self, req: GenerateRequest, slot: int, first_tok: int,
                 budget: int):
        self.req = req
        self.slot = slot
        self.tokens: List[int] = []
        self.logps: List[float] = []
        self.pos = 0
        self.last_tok = first_tok
        self.budget = budget
        self.t_start = time.perf_counter()
        self.pages: Optional[np.ndarray] = None
        self.node = None
        self.private: List[int] = []
        # page-table block holding the trie-resident (shared) tail page:
        # the first decode append into it copies-on-write
        self.cow_blk: Optional[int] = None


class GenerativeEngine:
    """Scheduler thread + slot pool (+ the prefix cache of a paged model,
    the draft of speculative decoding) for one generative model (module
    docstring)."""

    def __init__(self, name: str, model, policy, draft=None):
        if int(getattr(model, "tp_degree", 1) or 1) > 1:
            raise NotImplementedError(
                "decode tensor parallelism comes in a later slice of the "
                "PyTorch port")
        self._draft = draft
        self._spec_enabled = (draft is not None
                              and getattr(policy, "speculative", True))
        # paged models (page_len attr) route through the shared-prefix
        # prompt cache; slot models through per-sequence cache rows
        self._paged = getattr(model, "page_len", None) is not None
        if self._paged and not getattr(policy, "use_prefix_cache", True):
            raise ValueError(
                "paged models require the prefix cache "
                "(DecodePolicy.use_prefix_cache=False unsupported)")
        if self._spec_enabled:
            self._check_draft(model, draft, policy)
        if policy.num_slots > model.num_slots:
            raise ValueError(
                f"policy.num_slots={policy.num_slots} exceeds the "
                f"model's {model.num_slots} cache slots")
        model_buckets = getattr(model, "decode_buckets", None)
        self._scratch_slot = getattr(model, "scratch_slot", None)
        if model_buckets is not None:
            missing = [b for b in policy.bucket_sizes
                       if b not in model_buckets]
            if missing:
                raise ValueError(
                    f"DecodePolicy.bucket_sizes {policy.bucket_sizes} "
                    f"include buckets the model has no decode program for "
                    f"({missing}; model built {model_buckets}); align "
                    "decode_bucket_sizes at model build with the policy")
        self.name = name
        self._model = model
        self._policy = policy
        self._prefix = (PrefixCache(model.num_pages, model.page_len)
                        if self._paged else None)
        self._holdback: List[GenerateRequest] = []
        self.metrics = EngineMetrics()
        self._pool = CacheSlotPool(policy.num_slots)
        self._queue = AdmissionQueue(policy.max_queue_depth,
                                     metrics=self.metrics)
        self._active: List[_Sequence] = []
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name=f"stf_serving_decode_{name}",
            daemon=True)
        self._thread.start()

    @staticmethod
    def _check_draft(model, draft, policy):
        """The draft/target geometry speculative decoding needs (JAX
        :302-332)."""
        if getattr(model, "page_len", None) is not None:
            raise ValueError(
                "speculative decoding is not supported on the "
                "paged (prefix-cache) path")
        spec_k = getattr(model, "spec_k", 0)
        kd = getattr(draft, "draft_steps", 0)
        if spec_k < 2 or kd < 1:
            raise ValueError(
                f"speculative decoding needs a target built with "
                f"speculative_k >= 2 (got {spec_k}) and a draft "
                f"built with draft_steps >= 1 (got {kd})")
        if spec_k != kd + 1:
            raise ValueError(
                f"target speculative_k={spec_k} must equal draft "
                f"draft_steps+1={kd + 1} (one bonus target token "
                "per verified block)")
        for attr in ("src_len", "eos_id", "pad_id"):
            if getattr(draft, attr) != getattr(model, attr):
                raise ValueError(
                    f"draft/target {attr} mismatch: "
                    f"{getattr(draft, attr)} != {getattr(model, attr)}")
        if draft.num_slots < policy.num_slots:
            raise ValueError(
                f"draft has {draft.num_slots} slots < "
                f"policy.num_slots={policy.num_slots}")
        if draft.max_decode_len < model.max_decode_len:
            raise ValueError(
                f"draft max_decode_len={draft.max_decode_len} < "
                f"target's {model.max_decode_len}")

    # -- submission ----------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def queue_depth(self) -> int:
        return len(self._queue)

    def _fail(self, fut, outcome: str, exc: BaseException):
        self.metrics.sequence(outcome)
        fut._set_exception(exc)
        return fut

    def generate(self, src, max_new_tokens: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 on_token: Optional[Callable[[int, float], None]] = None
                 ) -> GenerateFuture:
        """Submit one prompt ``src`` (1-D token ids; a slot model pads it
        to its ``src_len`` with the pad id). ``on_token(token, logprob)``
        streams from the engine thread. Returns a
        :class:`GenerateFuture`."""
        fut = GenerateFuture(self.name)
        src = np.asarray(src, np.int32).reshape(-1)
        if self._paged:
            # the prompt rides unpadded (the page program is sized per
            # request); it must leave at least one decode position
            max_seq_len = self._model.max_seq_len
            limit = max_seq_len - 1
            if not 1 <= len(src) <= limit:
                return self._fail(fut, "rejected",
                                  errors.InvalidArgumentError(
                                      None, None,
                                      f"prompt length {len(src)} outside "
                                      f"[1, {limit}] (max_seq_len "
                                      f"{max_seq_len} minus one decode "
                                      "position)"))
        else:
            src_len = self._model.src_len
            if len(src) > src_len:
                return self._fail(fut, "rejected",
                                  errors.InvalidArgumentError(
                                      None, None,
                                      f"prompt length {len(src)} exceeds "
                                      f"the model's src_len {src_len}"))
            row = np.full((src_len,), self._model.pad_id, np.int32)
            row[:len(src)] = src
            src = row
        if timeout_ms is None and self._policy.default_timeout_ms > 0:
            timeout_ms = self._policy.default_timeout_ms
        deadline = (time.perf_counter() + float(timeout_ms) / 1000.0
                    if timeout_ms else None)
        if max_new_tokens is None:
            max_new_tokens = self._policy.max_new_tokens
        if int(max_new_tokens) < 0:
            return self._fail(fut, "rejected", errors.InvalidArgumentError(
                None, None,
                f"max_new_tokens must be >= 0, got {max_new_tokens}"))
        budget = min(int(max_new_tokens), self._model.max_decode_len)
        if self._paged:
            # emitted tokens occupy positions len(src)..max_seq_len-1
            budget = min(budget, self._model.max_seq_len - len(src))
        if budget == 0:
            fut._set_result({"tokens": np.zeros(0, np.int32),
                             "logprobs": np.zeros(0, np.float32),
                             "outcome": "length"})
            self.metrics.sequence("length")
            return fut
        req = GenerateRequest(src, budget, fut, deadline, on_token=on_token)
        if self._closed:
            return self._fail(fut, "cancelled", errors.UnavailableError(
                None, None, f"model {self.name!r}: engine is shut down"))
        timeout = None
        if deadline is not None:
            timeout = max(deadline - time.perf_counter(), 0.0)
        if not self._queue.put(req, timeout=timeout):
            if self._queue.closed:
                self._fail(fut, "cancelled", errors.UnavailableError(
                    None, None, f"model {self.name!r}: engine is shut down"))
            else:
                self._fail(fut, "rejected", errors.DeadlineExceededError(
                    None, None,
                    f"model {self.name!r}: deadline expired waiting for "
                    "admission (queue full — backpressure)"))
        return fut

    def _reject(self, req: GenerateRequest, outcome: str,
                exc: BaseException):
        self._fail(req.future, outcome, exc)

    # -- scheduler loop ------------------------------------------------------
    def _loop(self):
        while True:
            if self._holdback:
                # page-starved admissions retry once per engine step
                hb, self._holdback = self._holdback, []
                self._admit_batch(hb)
            if not self._active:
                item = self._queue.get()
                if item is DONE:
                    return
                self._admit_batch([item])
            if self._pool.free_count:
                joiners = self._queue.get_available(self._pool.free_count)
                if joiners:
                    self._admit_batch(joiners)
            if self._active:
                try:
                    self._step()
                except Exception as e:  # noqa: BLE001 — deliver, never die
                    for s in self._active:
                        self._retire(s, "error", exc=e)
                    self._active = []
                    self.metrics.slots_active = 0

    def _admit_batch(self, items):
        now = time.perf_counter()
        live: List[GenerateRequest] = []
        for req in items:
            if req is DONE:
                continue
            if req.expired(now):
                self._reject(req, "deadline_exceeded",
                             errors.DeadlineExceededError(
                                 None, None,
                                 f"model {self.name!r}: deadline expired "
                                 f"after {now - req.t_enqueue:.3f}s in the "
                                 "admission queue"))
                continue
            live.append(req)
        if not live:
            return
        if self._paged:
            self._admit_paged(live)
            return
        slots = []
        for req in live:
            slot = self._pool.acquire()
            assert slot is not None, "admission exceeded free slots"
            slots.append(slot)
        rows = np.stack([r.src for r in live])
        slot_ids = np.asarray(slots, np.int32)
        t0 = time.perf_counter()
        try:
            self._model.prefill(rows, slot_ids)
            if self._spec_enabled:
                # the draft keeps its own caches: it needs the same
                # prompts resident to propose from
                self._draft.prefill(rows, slot_ids)
        except Exception as e:  # noqa: BLE001 — fail these requests, keep serving
            for req, slot in zip(live, slots):
                self._pool.release(slot)
                self._reject(req, "error", e)
            return
        self.metrics.prefill_seconds.append(time.perf_counter() - t0)
        eos = self._model.eos_id
        for req, slot in zip(live, slots):
            # the decoder starts from EOS at position 0, as beam search
            self._active.append(_Sequence(req, slot, eos,
                                          req.max_new_tokens))
        self.metrics.slots_active = len(self._active)

    def _sync_prefix_metrics(self):
        pc = self._prefix
        self.metrics.prefix_hits = pc.hit_pages + pc.cow_hits
        self.metrics.prefix_evictions = pc.evictions
        self.metrics.prefix_shared_pages = pc.shared_pages

    def _admit_paged(self, live):
        """Resolve each prompt's page program (trie hits reuse shared
        pages, misses prefill fresh ones, a partial tail copies-on-write
        when a resident page extends it), then batch the chunk prefills
        position by position so every page a chunk reads is filled
        before it runs, while different sequences share prefill
        launches."""
        admitted = []          # (req, slot, plan)
        for req in live:
            slot = self._pool.acquire()
            if slot is None:
                self._holdback.append(req)
                continue
            try:
                plan = self._prefix.acquire(req.src[:-1])
            except PagesExhaustedError as e:
                self._pool.release(slot)
                if self._active or admitted:
                    # something live will retire and free pages: retry
                    self._holdback.append(req)
                else:
                    self._reject(req, "rejected",
                                 errors.ResourceExhaustedError(
                                     None, None,
                                     f"model {self.name!r}: prompt needs "
                                     f"more cache pages than exist ({e})"))
                continue
            admitted.append((req, slot, plan))
        if not admitted:
            self._sync_prefix_metrics()
            return
        pl = self._model.page_len
        pps = self._model.pages_per_seq
        scratch = self._model.scratch_page
        t0 = time.perf_counter()
        try:
            # Work is ordered by chunk POSITION, not by each sequence's
            # own list: a joiner may hit a trie page that an earlier
            # joiner of this same batch is still to prefill, so every
            # chunk at base b runs after every chunk below b, and a
            # copy-on-write of a page at base b after b's prefill. (The
            # JAX engine batches by per-sequence depth and copies first,
            # so such a joiner there reads an unfilled page.)
            tables = {}
            levels = {}        # base -> ([(slot, page, row)], [(dst, src)])
            for req, slot, plan in admitted:
                table = np.full((pps,), scratch, np.int32)
                pages = plan.pages
                table[:len(pages)] = pages
                tables[slot] = table
                for pg, row, base in plan.fill:
                    levels.setdefault(base, ([], []))[0].append(
                        (slot, pg, row))
                if not len(plan.tail) or plan.tail_ready:
                    continue
                tail_base = plan.cached_len - len(plan.tail)
                fills, cows = levels.setdefault(tail_base, ([], []))
                if plan.cow_src is not None:
                    cows.append((plan.tail_page, plan.cow_src))
                else:
                    row = np.full((pl,), self._model.pad_id, np.int32)
                    row[:len(plan.tail)] = plan.tail
                    fills.append((slot, plan.tail_page, row))
            for base in sorted(levels):
                fills, cows = levels[base]
                if fills:
                    self._model.prefill_chunk(
                        np.stack([row for _, _, row in fills]),
                        np.full((len(fills),), base, np.int32),
                        np.stack([tables[slot] for slot, _, _ in fills]),
                        np.asarray([pg for _, pg, _ in fills], np.int32))
                for dst, src in cows:
                    self._model.copy_page(dst, src)
        except Exception as e:  # noqa: BLE001 — fail these requests, keep serving
            for req, slot, plan in admitted:
                self._prefix.release(plan.node)
                self._pool.release(slot)
                self._reject(req, "error", e)
            self._sync_prefix_metrics()
            return
        self.metrics.prefill_seconds.append(time.perf_counter() - t0)
        for req, slot, plan in admitted:
            # the first decode step feeds the LAST prompt token at
            # position plen-1 — its output is the first emitted token
            s = _Sequence(req, slot, int(req.src[-1]), req.max_new_tokens)
            s.pos = len(req.src) - 1
            s.pages = tables[slot]
            s.node = plan.node
            if len(plan.tail):
                s.cow_blk = plan.cached_len // pl
            self._active.append(s)
        self._sync_prefix_metrics()
        self.metrics.slots_active = len(self._active)

    def _step(self):
        # per-token deadline check: an expired sequence retires now
        now = time.perf_counter()
        still = []
        for s in self._active:
            if s.req.expired(now):
                self._retire(s, "deadline_exceeded")
            else:
                still.append(s)
        self._active = still
        if not self._active:
            self.metrics.slots_active = 0
            return
        if self._spec_enabled:
            self._step_speculative()
            return
        if self._paged:
            self._step_paged()
            return
        n = len(self._active)
        tokens = [s.last_tok for s in self._active]
        positions = [s.pos for s in self._active]
        slots = [s.slot for s in self._active]
        if self._scratch_slot is not None:
            # the policy's bucket, padded with rows aimed at the model's
            # scratch slot (a live slot id here would corrupt that
            # sequence's cache)
            pad = self._policy.bucket_for(n) - n
            tokens += [self._model.pad_id] * pad
            positions += [0] * pad
            slots += [self._scratch_slot] * pad
        t0 = time.perf_counter()
        next_tok, logp, bucket = self._model.decode(tokens, positions,
                                                    slots)
        self._finish_single_step(next_tok, logp, bucket, n, t0)

    def _out_of_pages(self, s: _Sequence, e: PagesExhaustedError):
        self._retire(s, "error", exc=errors.ResourceExhaustedError(
            None, None,
            f"model {self.name!r}: out of cache pages mid-decode ({e})"))

    def _step_paged(self):
        """One decode position: make sure every sequence's write page
        exists (private decode pages are allocated lazily, and the first
        append into a shared tail page copies it out), then run the
        page-table decode."""
        pl = self._model.page_len
        scratch = self._model.scratch_page
        still = []
        for s in self._active:
            blk = s.pos // pl
            if s.pages[blk] == scratch:
                try:
                    pg = self._prefix.alloc_page()
                except PagesExhaustedError as e:
                    self._out_of_pages(s, e)
                    continue
                s.pages[blk] = pg
                s.private.append(pg)
            elif s.cow_blk is not None and blk == s.cow_blk:
                shared = int(s.pages[blk])
                try:
                    pg = self._prefix.alloc_page({shared})
                except PagesExhaustedError as e:
                    self._out_of_pages(s, e)
                    continue
                self._model.copy_page(pg, shared)
                s.pages[blk] = pg
                s.private.append(pg)
                s.cow_blk = None
            still.append(s)
        self._active = still
        if not self._active:
            self.metrics.slots_active = 0
            return
        n = len(self._active)
        t0 = time.perf_counter()
        next_tok, logp, bucket = self._model.decode(
            [s.last_tok for s in self._active],
            [s.pos for s in self._active],
            np.stack([s.pages for s in self._active]))
        self._finish_single_step(next_tok, logp, bucket, n, t0)

    def _emit(self, s: _Sequence, tok: int, lp: float) -> None:
        s.tokens.append(tok)
        s.logps.append(lp)
        s.pos += 1
        s.last_tok = tok
        if s.req.on_token is not None:
            try:
                s.req.on_token(tok, lp)
            except Exception:  # noqa: BLE001 — a client callback must not kill the engine
                pass

    def _finish_single_step(self, next_tok, logp, bucket, n, t0):
        """The one-token-a-sequence commit the slot and paged steps share:
        metrics, streaming, EOS and budget retirement."""
        self.metrics.step(time.perf_counter() - t0, n, bucket)
        eos = self._model.eos_id
        max_pos = self._model.max_decode_len - 1
        still = []
        for i, s in enumerate(self._active):
            tok = int(next_tok[i])
            self._emit(s, tok, float(logp[i]))
            if tok == eos:
                self._retire(s, "eos")
            elif len(s.tokens) >= s.budget or s.pos > max_pos:
                self._retire(s, "length")
            else:
                still.append(s)
        self._active = still
        self.metrics.slots_active = len(still)

    def _step_speculative(self):
        """One speculative cycle: the draft proposes ``draft_steps``
        greedy tokens in one program, the target verifies the
        ``spec_k``-token block in one pass, and each sequence commits the
        longest matching prefix plus one bonus target token. Rows of
        rejected proposals are dead (length-masked) until the next cycle
        overwrites them."""
        n = len(self._active)
        tokens = [s.last_tok for s in self._active]
        positions = [s.pos for s in self._active]
        slots = [s.slot for s in self._active]
        kd = self._draft.draft_steps
        t0 = time.perf_counter()
        props, _ = self._draft.decode_k(tokens, positions, slots)
        blk = np.concatenate(
            [np.asarray(tokens, np.int32).reshape(n, 1), props], axis=1)
        tgt, lps, bucket = self._model.verify(blk, positions, slots)
        dur = time.perf_counter() - t0
        eos = self._model.eos_id
        max_pos = self._model.max_decode_len - 1
        emitted = accepted = 0
        still = []
        for i, s in enumerate(self._active):
            a = 0
            while a < kd and int(props[i, a]) == int(tgt[i, a]):
                a += 1
            accepted += a
            outcome = None
            for j in range(a + 1):
                tok = int(tgt[i, j])
                self._emit(s, tok, float(lps[i, j]))
                emitted += 1
                if tok == eos:
                    outcome = "eos"
                    break
                if len(s.tokens) >= s.budget or s.pos > max_pos:
                    outcome = "length"
                    break
            if outcome is not None:
                self._retire(s, outcome)
            else:
                still.append(s)
        self._active = still
        self.metrics.slots_active = len(still)
        self.metrics.step(dur, n, bucket, tokens=emitted)
        self.metrics.speculative(kd * n, accepted)

    def _retire(self, s: _Sequence, outcome: str,
                exc: Optional[BaseException] = None):
        if s.pages is not None:
            # decref the shared trie chain (pages stay cached at refs 0
            # for future prefix hits) and free the private pages
            if s.node is not None:
                self._prefix.release(s.node)
            for pg in s.private:
                self._prefix.free_page(pg)
            s.private = []
            s.node = None
            s.pages = None
            self._sync_prefix_metrics()
        self._pool.release(s.slot)
        self.metrics.sequence(outcome)
        if s.tokens:
            self.metrics.per_token_seconds.append(
                (time.perf_counter() - s.t_start) / len(s.tokens))
        if outcome in ("eos", "length"):
            s.req.future._set_result({
                "tokens": np.asarray(s.tokens, np.int32),
                "logprobs": np.asarray(s.logps, np.float32),
                "outcome": outcome,
            })
        elif exc is not None:
            s.req.future._set_exception(exc)
        else:
            s.req.future._set_exception(errors.DeadlineExceededError(
                None, None,
                f"model {self.name!r}: per-token deadline expired after "
                f"{len(s.tokens)} emitted tokens"))

    # -- introspection / lifecycle -------------------------------------------
    def statusz_info(self) -> Dict[str, Any]:
        info = {"model": self.name, "kind": "generative",
                "num_slots": self._pool.num_slots,
                "slots_active": self._pool.active_count,
                "queue_depth": self.queue_depth(),
                "tokens_per_sec": int(self.metrics.rate.rate())}
        model_info = getattr(self._model, "statusz_info", None)
        if callable(model_info):
            info.update(model_info())
        if self._prefix is not None:
            info["prefix_cache"] = self._prefix.statusz_info()
            info["holdback"] = len(self._holdback)
        if self._spec_enabled:
            prop, acc = self.metrics.spec_proposed, self.metrics.spec_accepted
            info["speculative"] = {
                "spec_k": self._model.spec_k,
                "draft_steps": self._draft.draft_steps,
                "proposed_tokens": prop, "accepted_tokens": acc,
                "acceptance_rate": (acc / prop) if prop else 0.0}
        info["metrics"] = self.metrics.snapshot()
        return info

    def close(self, timeout: float = 30.0):
        """Close admission and drain: new submits fail Unavailable;
        queued requests and active sequences run to completion; then the
        model (and the draft) close."""
        self._closed = True
        self._queue.close()
        if self._thread.is_alive() and \
                threading.current_thread() is not self._thread:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"GenerativeEngine.close({self.name}): the engine "
                    f"thread did not finish within {timeout}s")
        self._model.close()
        if self._draft is not None:
            self._draft.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
