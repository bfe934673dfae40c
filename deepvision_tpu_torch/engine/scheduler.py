"""Continuous-batching scheduler with two priority classes.

A copy of the JAX package's ``engine/scheduler.py`` without its pipelined
decode chains.  One scheduler owns one ModelRunner.  The step loop:

1. **Admit**: pop HIGH requests first (deadline-ordered), then LOW only when
   no HIGH is waiting; each request takes KV pages (with a chunked runner,
   first the pages the prefix cache shares with its prompt) and a decode
   slot.  Fresh prompts prefill together in one padded batch; a
   prefix-cache hit resumes chunked prefill at the first page it does not
   share; a prompt with more than ``interleave_min_tokens`` fresh tokens
   becomes a prefill job.
2. **Advance prefills**: prefill jobs run chunk by chunk, interleaved with
   decode.
3. **Decode**: one fixed-shape decode call over all slots (inactive slots
   aim at the trash page), sampling on the device; K=1 while a prompt is
   mid-prefill.
4. **Retire**: EOS / max_tokens / page-exhaustion; pages freed, waiters
   signalled.

The loop runs on a daemon thread from :meth:`start` until :meth:`shutdown`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from deepvision_tpu_torch.engine.kv_cache import PageAllocator, pages_needed
from deepvision_tpu_torch.engine.prefix_cache import PrefixCache
from deepvision_tpu_torch.engine.runner import ModelRunner

HIGH = 0
LOW = 1


class EngineOverloadedError(RuntimeError):
    """Pending queue full — the app maps this to 429 + Retry-After."""

    def __init__(self, msg: str, retry_after_s: float = 2.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class GenerationResult:
    request_id: str
    token_ids: List[int]
    finish_reason: str  # "stop" | "length" | "timeout" | "error" | "cancelled"
    queue_wait_ms: float
    prefill_ms: float
    decode_ms: float
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.finish_reason in ("stop", "length")


class GenerationRequest:
    _counter = 0
    _counter_lock = threading.Lock()

    def __init__(
        self,
        prompt_tokens: Sequence[int],
        *,
        max_tokens: int = 256,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        stop_token_ids: Optional[Sequence[int]] = None,
        priority: int = HIGH,
        deadline_s: Optional[float] = None,
        request_id: Optional[str] = None,
        prefix_key: Optional[str] = None,
        json_mode: bool = False,
    ):
        self.prefix_key = prefix_key
        self.json_mode = json_mode
        if request_id is None:
            with GenerationRequest._counter_lock:
                GenerationRequest._counter += 1
                request_id = f"req-{GenerationRequest._counter}"
        self.request_id = request_id
        self.prompt_tokens = list(prompt_tokens)
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.stop_token_ids = set(stop_token_ids or [])
        self.priority = priority
        self.submitted_at = time.monotonic()
        self.deadline = (
            self.submitted_at + deadline_s if deadline_s else None
        )
        self.cancelled = threading.Event()
        self._done = threading.Event()
        self._result: Optional[GenerationResult] = None

    # -- waiter side ----------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> Optional[GenerationResult]:
        if self._done.wait(timeout):
            return self._result
        return None

    def cancel(self) -> None:
        self.cancelled.set()

    # -- scheduler side -------------------------------------------------
    def finish(self, result: GenerationResult) -> None:
        self._result = result
        self._done.set()


class _PrefillJob:
    """A prompt mid-prefill (chunked mode): advances chunk by chunk between
    decode steps, so a long prompt never stalls the decode batch."""

    __slots__ = ("req", "pages", "pos", "queue_wait_ms", "t0", "last_tok")

    def __init__(self, req, pages, start_pos, queue_wait_ms):
        self.req = req
        self.pages = pages
        self.pos = start_pos
        self.queue_wait_ms = queue_wait_ms
        self.t0 = time.monotonic()
        self.last_tok = 0


class _ActiveSeq:
    __slots__ = (
        "req", "slot", "tokens", "pages", "generated", "prefill_ms",
        "queue_wait_ms", "decode_start", "dfa_state",
    )

    def __init__(self, req, slot, tokens, pages, queue_wait_ms, prefill_ms):
        self.req = req
        self.slot = slot
        self.tokens = tokens          # prompt + generated so far
        self.pages = pages            # page ids owned by this sequence
        self.generated: List[int] = []
        self.queue_wait_ms = queue_wait_ms
        self.prefill_ms = prefill_ms
        self.decode_start = time.monotonic()
        self.dfa_state = 0            # 0 = FREE (unconstrained)


class ContinuousBatchingScheduler:
    def __init__(
        self,
        runner: ModelRunner,
        allocator: PageAllocator,
        *,
        max_slots: Optional[int] = None,
        max_pending: int = 64,
        prefills_per_step: int = 1,
        strict_priority: bool = True,
        decode_steps_per_call: int = 1,
        interleave_min_tokens: int = 4096,
        dfa=None,
        prefill_batch_max: int = 4,
    ):
        self.prefill_batch_max = max(1, prefill_batch_max)
        # Grammar DFA (engine/constrained.JsonTokenDfa) for json_mode
        # requests; None disables constrained decoding.
        self.dfa = dfa
        # Prompts with fewer fresh (uncached) tokens than this prefill in
        # one blocking call; longer ones become prefill jobs whose chunks
        # interleave with decode.
        self.interleave_min_tokens = interleave_min_tokens
        self.runner = runner
        self.alloc = allocator
        self.max_slots = max_slots or runner.max_slots
        self.max_pending = max_pending
        self.prefills_per_step = prefills_per_step
        self.strict_priority = strict_priority
        self.decode_steps_per_call = max(1, decode_steps_per_call)

        self._queues = {HIGH: deque(), LOW: deque()}
        self._prefilling: deque = deque()
        self._active: Dict[int, _ActiveSeq] = {}
        self._free_slots = list(range(self.max_slots - 1, -1, -1))
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        # stats
        self.tokens_generated = 0
        self.steps = 0
        self.requests_finished = 0
        self.rejected_overload = 0
        # wall time spent inside decode calls (dispatch + readback)
        self.decode_time_s = 0.0

        cache_cfg = runner.cache_cfg
        self._page_size = cache_cfg.page_size
        self._max_pages_per_seq = cache_cfg.max_pages_per_seq
        # only the chunked path can resume a prompt past shared pages
        self.prefix_cache = (PrefixCache(allocator, cache_cfg.page_size)
                             if runner.chunked_prefill else None)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def submit(self, req: GenerationRequest) -> GenerationRequest:
        """Enqueue; raises EngineOverloadedError when the queue is full."""
        with self._lock:
            depth = len(self._queues[HIGH]) + len(self._queues[LOW])
            if depth >= self.max_pending:
                self.rejected_overload += 1
                raise EngineOverloadedError(
                    "engine overloaded: pending queue full"
                )
            self._queues[req.priority].append(req)
        self._work.set()
        return req

    def queue_depths(self):
        with self._lock:
            return {
                "high": len(self._queues[HIGH]),
                "low": len(self._queues[LOW]),
                "prefilling": len(self._prefilling),
                "active": len(self._active),
                "free_slots": len(self._free_slots),
                "free_pages": self.alloc.available(),
            }

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="dv-engine-scheduler", daemon=True
        )
        self._thread.start()

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the loop and join its thread (a decode call in flight
        finishes first)."""
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"scheduler thread did not stop within {timeout}s")
            self._thread = None

    # ------------------------------------------------------------------
    # Engine loop
    # ------------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            did_work = self.step()
            if not did_work:
                self._work.wait(timeout=0.02)
                self._work.clear()

    def _pop_next(self) -> Optional[GenerationRequest]:
        with self._lock:
            hq, lq = self._queues[HIGH], self._queues[LOW]
            now = time.monotonic()
            while hq or lq:
                if hq:
                    req = hq.popleft()
                elif self.strict_priority and self._any_high_running():
                    return None
                else:
                    req = lq.popleft()
                if req.cancelled.is_set():
                    req.finish(self._mk_result(req, [], "cancelled", 0, 0, 0))
                    continue
                if req.deadline and now > req.deadline:
                    req.finish(self._mk_result(req, [], "timeout", 0, 0, 0))
                    continue
                return req
        return None

    def _any_high_running(self) -> bool:
        return any(s.req.priority == HIGH for s in self._active.values())

    def _mk_result(self, req, tokens, reason, qw, pf, dc, error=None):
        return GenerationResult(
            request_id=req.request_id,
            token_ids=tokens,
            finish_reason=reason,
            queue_wait_ms=qw,
            prefill_ms=pf,
            decode_ms=dc,
            error=error,
        )

    def step(self) -> bool:
        """One admit + prefill-chunk + decode cycle."""
        admitted = self._admit()
        prefilled = self._advance_prefills()
        decoded = self._decode_step()
        return admitted or prefilled or decoded

    # -- admission ------------------------------------------------------

    def _admit(self) -> bool:
        """Admit waiting requests.

        Fresh prompts prefill together in one padded batch
        (runner.prefill_batch): one dispatch for N prompts.  Prefix-cache
        resumes (start_from > 0) and long prompts take the chunked paths.
        """
        admitted = False
        chunked = self.runner.chunked_prefill
        batch: List[tuple] = []  # (req, pages, queue_wait_ms)
        max_batch = max(self.prefill_batch_max, self.prefills_per_step)
        while len(batch) < max_batch:
            # count the slots already promised to in-flight prefills
            if len(self._free_slots) <= len(self._prefilling) + len(batch):
                break
            req = self._pop_next()
            if req is None:
                break
            n_prompt = len(req.prompt_tokens)
            need = pages_needed(
                min(n_prompt + req.max_tokens,
                    self._max_pages_per_seq * self._page_size),
                self._page_size,
            )
            shared_n, shared_pages = 0, []
            if self.prefix_cache is not None:
                shared_n, shared_pages = self.prefix_cache.lookup(
                    req.prefix_key, req.prompt_tokens)
            fresh = self.alloc.try_alloc(need - len(shared_pages))
            if fresh is None and self.prefix_cache is not None:
                # live requests outrank cold cache entries: drop LRU
                # prefixes and retry before giving up
                self.prefix_cache.evict_lru(need - len(shared_pages))
                fresh = self.alloc.try_alloc(need - len(shared_pages))
            if fresh is None:
                # Not enough KV memory — push back and wait for retirements.
                self.alloc.free(shared_pages)
                with self._lock:
                    self._queues[req.priority].appendleft(req)
                break
            pages = shared_pages + fresh
            queue_wait_ms = (time.monotonic() - req.submitted_at) * 1e3
            if chunked and n_prompt - shared_n > self.interleave_min_tokens:
                # long prompt: its chunks advance alongside decode
                self._prefilling.append(
                    _PrefillJob(req, pages, shared_n, queue_wait_ms))
                admitted = True
                continue
            if shared_n > 0:
                # prefix resume: only the chunked path starts mid-prompt
                t0 = time.monotonic()
                try:
                    first = self.runner.prefill(
                        req.prompt_tokens, pages,
                        temperature=req.temperature, top_k=req.top_k,
                        top_p=req.top_p, start_from=shared_n,
                        dfa_state=self._start_state(req),
                        budget=req.max_tokens)
                except Exception as e:  # noqa: BLE001 — engine must not die
                    self.alloc.free(pages)
                    req.finish(self._mk_result(
                        req, [], "error", queue_wait_ms, 0, 0,
                        error=f"{type(e).__name__}: {e}"))
                    continue
                prefill_ms = (time.monotonic() - t0) * 1e3
                self._activate(req, pages, first, queue_wait_ms, prefill_ms)
                admitted = True
                continue
            batch.append((req, pages, queue_wait_ms))

        if not batch:
            return admitted
        t0 = time.monotonic()
        try:
            firsts = self.runner.prefill_batch(
                [r.prompt_tokens for r, _, _ in batch],
                [p for _, p, _ in batch],
                temperatures=[r.temperature for r, _, _ in batch],
                top_ks=[r.top_k for r, _, _ in batch],
                top_ps=[r.top_p for r, _, _ in batch],
                dfa_states=[self._start_state(r) for r, _, _ in batch],
                budgets=[r.max_tokens for r, _, _ in batch],
            )
        except Exception as e:  # noqa: BLE001 — engine must not die
            for req, pages, qw in batch:
                self.alloc.free(pages)
                req.finish(self._mk_result(
                    req, [], "error", qw, 0, 0,
                    error=f"{type(e).__name__}: {e}"))
            return True
        prefill_ms = (time.monotonic() - t0) * 1e3
        for (req, pages, qw), first in zip(batch, firsts):
            self._activate(req, pages, first, qw, prefill_ms)
        return True

    def _start_state(self, req) -> int:
        if req.json_mode and self.dfa is not None:
            return self.dfa.start
        return 0

    def _activate(self, req, pages, first_tok, queue_wait_ms,
                  prefill_ms) -> None:
        if self.prefix_cache is not None and req.prefix_key:
            self.prefix_cache.store(req.prefix_key, req.prompt_tokens, pages)
        slot = self._free_slots.pop()
        seq = _ActiveSeq(
            req, slot, list(req.prompt_tokens) + [first_tok], pages,
            queue_wait_ms, prefill_ms,
        )
        start = self._start_state(req)
        if start != 0:
            seq.dfa_state = self.dfa.next_state(start, first_tok)
        seq.generated.append(first_tok)
        self._active[slot] = seq
        if self._seq_finished(seq, first_tok):
            self._retire(seq, self._finish_reason(seq, first_tok))

    def _advance_prefills(self) -> bool:
        """Advance the oldest prefill job (chunked mode).

        With no decode running it drains completely (the same TTFT as a
        blocking prefill); while decode runs, a bounded number of chunks
        run per step and decode drops to single-token steps, so the two
        interleave finely.
        """
        if not self._prefilling:
            return False
        job = self._prefilling[0]
        req = job.req
        if req.cancelled.is_set() or (
                req.deadline and time.monotonic() > req.deadline):
            self._prefilling.popleft()
            self.alloc.free(job.pages)
            reason = "cancelled" if req.cancelled.is_set() else "timeout"
            req.finish(self._mk_result(req, [], reason,
                                       job.queue_wait_ms, 0, 0))
            return True
        if not self._free_slots:
            return False  # wait for a retirement before finishing prefill
        n = len(req.prompt_tokens)
        C = self.runner.prefill_chunk_size
        chunks_left = -(-(n - job.pos) // C)
        budget = (chunks_left if not self._active
                  else max(1, self.prefills_per_step * 2))
        try:
            while budget > 0 and job.pos < n:
                # only the last chunk's token is read back: earlier chunks
                # are enqueued without a host sync
                job.last_tok = self.runner.prefill_chunk_step(
                    req.prompt_tokens, job.pages, job.pos,
                    temperature=req.temperature, top_k=req.top_k,
                    top_p=req.top_p, dfa_state=self._start_state(req),
                    budget=req.max_tokens, sync=job.pos + C >= n)
                job.pos += C
                budget -= 1
        except Exception as e:  # noqa: BLE001 — engine must not die
            self._prefilling.popleft()
            self.alloc.free(job.pages)
            req.finish(self._mk_result(
                req, [], "error", job.queue_wait_ms, 0, 0,
                error=f"{type(e).__name__}: {e}"))
            return True
        if job.pos >= n:
            self._prefilling.popleft()
            prefill_ms = (time.monotonic() - job.t0) * 1e3
            self._activate(req, job.pages, job.last_tok,
                           job.queue_wait_ms, prefill_ms)
        return True

    # -- decode ---------------------------------------------------------

    def _gather_decode_batch(self, K: int):
        """Build one decode call's host inputs; sequences that cannot take
        K more tokens (context or KV pages exhausted) are returned to be
        retired at length."""
        B = self.max_slots
        MP = self._max_pages_per_seq
        max_len = MP * self._page_size
        tokens = np.zeros(B, np.int32)
        lens = np.ones(B, np.int32)
        bt = np.zeros((B, MP), np.int32)
        temps = np.zeros(B, np.float32)
        topk = np.zeros(B, np.int32)
        topp = np.ones(B, np.float32)
        dstates = np.zeros(B, np.int32)
        budgets = np.full(B, 1 << 20, np.int32)

        retire_now: List[_ActiveSeq] = []
        for slot, seq in self._active.items():
            # seq.tokens already includes the token being fed this step, so
            # its position is len-1 and seq_len (inclusive) is len.
            new_len = len(seq.tokens)
            # K steps write up to new_len + K - 1 positions; every write
            # must land in an owned page.
            need = pages_needed(new_len + K - 1, self._page_size)
            if new_len + K - 1 > max_len:
                retire_now.append(seq)
                continue
            if need > len(seq.pages):
                extra = self.alloc.try_alloc(need - len(seq.pages))
                if extra is None:
                    retire_now.append(seq)  # KV exhausted: finish at length
                    continue
                seq.pages.extend(extra)
            tokens[slot] = seq.tokens[-1]
            lens[slot] = new_len
            bt[slot, : len(seq.pages)] = seq.pages
            temps[slot] = seq.req.temperature
            topk[slot] = seq.req.top_k
            topp[slot] = seq.req.top_p
            dstates[slot] = max(seq.dfa_state, 0)
            # output-token budget incl. the next sampled token; drives
            # grammar force-close so json_mode parses even at max_tokens
            budgets[slot] = max(seq.req.max_tokens - len(seq.generated), 1)
        return (tokens, lens, bt, temps, topk, topp, dstates,
                budgets), retire_now

    def _fail_active(self, e: Exception) -> None:
        """A device error fails the ACTIVE requests but keeps the
        scheduler thread alive for future work."""
        for seq in list(self._active.values()):
            self._active.pop(seq.slot, None)
            self._free_slots.append(seq.slot)
            self.alloc.free(seq.pages)
            seq.req.finish(self._mk_result(
                seq.req, list(seq.generated), "error",
                seq.queue_wait_ms, seq.prefill_ms, 0,
                error=f"decode failed: {type(e).__name__}: {e}"))

    def _consume_decode_out(self, out, K: int) -> List[tuple]:
        """Append one call's tokens to the active sequences; returns the
        newly finished (seq, reason) pairs."""
        finished: List[tuple] = []
        for slot, seq in self._active.items():
            last_tok = None
            done = False
            for j in range(K):
                tok = int(out[j, slot])
                seq.tokens.append(tok)
                seq.generated.append(tok)
                self.tokens_generated += 1
                last_tok = tok
                if seq.dfa_state > 0 and self.dfa is not None:
                    # host mirrors the on-device DFA walk (same table)
                    seq.dfa_state = self.dfa.next_state(seq.dfa_state, tok)
                if self._seq_finished(seq, tok) or seq.req.cancelled.is_set():
                    done = True
                    break
            if done and last_tok is not None:
                finished.append((seq, self._finish_reason(seq, last_tok)))
        self.steps += K
        return finished

    def _decode_step(self) -> bool:
        if not self._active:
            return False
        K = self.decode_steps_per_call
        if self._prefilling:
            # single-token steps while prompts are mid-prefill, so waiting
            # prompts advance about every step
            K = 1
        batch, retired = self._gather_decode_batch(K)
        for seq in retired:
            self._retire(seq, "length")
        if not self._active:
            return bool(retired)
        tokens, lens, bt, temps, topk, topp, dstates, budgets = batch
        t_dec = time.monotonic()
        try:
            out = self.runner.decode(
                tokens, lens, bt, temps, topk, topp, n_steps=K,
                dfa_states=dstates, budgets=budgets,
            )  # [K, B]
        except Exception as e:  # noqa: BLE001 — engine must not die
            self._fail_active(e)
            return True
        finally:
            self.decode_time_s += time.monotonic() - t_dec
        for seq, reason in self._consume_decode_out(out, K):
            self._retire(seq, reason)
        return True

    def _seq_finished(self, seq: _ActiveSeq, tok: int) -> bool:
        req = seq.req
        if tok in req.stop_token_ids:
            return True
        if len(seq.generated) >= req.max_tokens:
            return True
        if req.deadline and time.monotonic() > req.deadline:
            return True
        return False

    def _finish_reason(self, seq: _ActiveSeq, tok: int) -> str:
        req = seq.req
        if req.cancelled.is_set():
            return "cancelled"
        if tok in req.stop_token_ids:
            return "stop"
        if len(seq.generated) >= req.max_tokens:
            return "length"
        if req.deadline and time.monotonic() > req.deadline:
            return "timeout"
        return "length"

    def _retire(self, seq: _ActiveSeq, reason: str) -> None:
        self._active.pop(seq.slot, None)
        self._free_slots.append(seq.slot)
        self.alloc.free(seq.pages)
        self.requests_finished += 1
        decode_ms = (time.monotonic() - seq.decode_start) * 1e3
        gen = seq.generated
        if reason == "stop" and gen and gen[-1] in seq.req.stop_token_ids:
            gen = gen[:-1]
        seq.req.finish(
            self._mk_result(
                seq.req, gen, reason, seq.queue_wait_ms, seq.prefill_ms,
                decode_ms,
            )
        )
        self._work.set()
