"""Continuous-batching MoE serving engine over a PAGED KV cache
(counterpart of ``repro/serve/engine.py`` and of the engine steps in
``repro/train/loop.py``).

Request lifecycle:

  submit -> queue -> admit (page-table rows + shared-prefix reuse)
         -> prefill (one-shot, or fixed-size CHUNKS interleaved with
            decode rounds)
         -> decode rounds (continuous batch over the whole row pool)
         -> finish (EOS / token budget) -> release pages -> detokenize

and, around it, the JAX engine's robustness: a request whose worst case
(prompt + budget) exceeds the whole arena is shed at admission, a queued
request that waited past ``queue_slo`` for blocks is shed, a running one
past its ``deadline`` (or a fault's tick budget) is expired mid-flight,
and the decode watchdog evicts a row that made no progress for
``watchdog_rounds`` rounds.  Each comes back as a ``Completion`` with a
``status`` and a ``reason``, its pages back in the arena.  The serve
fault keys of ``runtime.faults`` (``req_timeout``, ``req_delay``,
``alloc_starve``) key on request ids and ticks, never on the clock, and a
delayed row sits its rounds out with a null page table, so every other
request's stream is bitwise the fault-free one.

Each ``step()`` either advances prefill for the waiting group (one
``Model.paged_step`` over its next chunk) or runs one decode round over all
``max_batch`` rows at per-row positions; with ``prefill_chunk > 0`` the two
alternate.  Idle rows ride along with all-null page tables, so the decode
step's shapes stay fixed.  Prefill chunks are padded to the JAX engine's
power-of-two buckets: prefill pools take the training capacity
(``infer=False``), so the padding rows compete for expert capacity and
must be the same rows the JAX engine pads.  Decode rounds run ``infer=True``
(drop-free capacity), which keeps a row's output independent of its batch
mates.

Telemetry: the lifecycle events of the JAX engine (``req_queued``,
``req_admitted``, ``req_prefilled``, ``req_shed``, ``req_cancelled``,
``decode_round``, ``req_finished`` and the run's ``serve_rollup``) go
through ``repro_torch.obs`` when a sink is installed, each made of values
the host already holds.  Expert-placement rebalancing comes with a later
slice.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import obs
from repro_torch.obs.registry import Registry, quantile
from repro_torch.runtime.faults import StarveState
from repro_torch.serve.kvcache import KVCachePool
from repro_torch.serve.sampler import SamplerConfig, sample


@dataclass(frozen=True)
class Request:
    """One generation request: prompt token ids + budget + sampling.

    ``deadline`` > 0 is a per-request wall-clock budget in seconds
    (measured from submit/arrival); a request still running past it is
    cancelled mid-flight, its KV pages go back to the arena and the
    partial generation comes back with ``status="expired"``.
    """

    rid: int
    prompt: tuple                      # token ids, len >= 1
    max_new_tokens: int = 16
    sampler: SamplerConfig = SamplerConfig()
    arrival: float = 0.0               # seconds after run start
    deadline: float = 0.0              # seconds; 0 = none


@dataclass
class Completion:
    """A finished request: generated ids, text, and latency breakdown.

    ``status``: ``"ok"`` (normal finish), ``"shed"`` (rejected at
    admission, see ``reason``), ``"expired"`` (deadline blown
    mid-flight) or ``"evicted"`` (decode watchdog).  Non-ok completions
    carry whatever tokens were generated before cancellation.
    """

    rid: int
    prompt: tuple
    tokens: list
    text: str
    timing: dict = field(default_factory=dict)   # ttft / latency seconds
    status: str = "ok"
    reason: str = ""


class _State:
    __slots__ = ("req", "slot", "pos", "fill_pos", "last_tok", "generated",
                 "t_submit", "t_admit", "t_first", "t_done", "t_deadline",
                 "stall_rounds", "delay_left", "ticks_active")

    def __init__(self, req, slot, fill_pos, t_submit, t_admit):
        self.req, self.slot = req, slot
        self.pos = len(req.prompt)     # next absolute position to decode
        self.fill_pos = fill_pos       # next prompt position to prefill
        self.last_tok = None
        self.generated = []
        self.t_submit, self.t_admit = t_submit, t_admit
        self.t_first = self.t_done = None
        self.t_deadline = (t_submit + req.deadline) if req.deadline else None
        self.stall_rounds = 0          # decode rounds without advancing
        self.delay_left = 0            # fault: rounds to sit out of decode
        self.ticks_active = 0          # engine ticks since admission


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def prefill_bucket(c_lens, max_len: int) -> int:
    """Padded length of a prefill chunk: the JAX engine's bucket."""
    return min(max(_pow2(max(c_lens)), 8), max_len)


class Engine:
    """Continuous-batching serving engine over a paged KV-block pool.

    ``max_batch`` is the decode batch (= concurrent rows); ``max_len`` the
    per-request KV length (prompt + generation budget must fit).
    ``block_size`` sets the KV page granularity and ``n_blocks`` the arena
    size (default: ``max_batch * max_len / block_size``); ``prefix_cache``
    enables shared-prefix reuse and ``prefill_chunk`` > 0 splits prompts
    into chunks of that many tokens, alternating with decode rounds.
    ``prefill_batch`` caps how many admissions share one prefill call.
    ``schedule`` forces one MoE schedule (any name of ``SCHEDULES``).
    Tensors live on the model's device.

    Robustness knobs, all off by default: ``queue_slo`` (seconds a queued
    request may wait for blocks before it is shed), ``watchdog_rounds``
    (evict a decode row after this many rounds without progress) and
    ``faults`` (a :class:`repro_torch.runtime.faults.FaultPlan`); per
    request, ``submit(deadline=)``.
    """

    def __init__(self, model, *, max_batch: int = 8, max_len: int = 256,
                 schedule=None, prefill_batch: int = 1, eos_token=None,
                 detokenize=None, block_size: int = 16, n_blocks=None,
                 prefix_cache: bool = True, prefill_chunk: int = 0,
                 queue_slo: float = 0.0, watchdog_rounds: int = 0,
                 faults=None):
        cfg = model.cfg
        if cfg.attn_window is not None and cfg.attn_window < max_len:
            raise NotImplementedError(
                "Engine needs full-length KV rows (attn_window "
                f"{cfg.attn_window} < max_len {max_len})")
        self.model = model
        self.device = model.device
        self.max_batch, self.max_len = int(max_batch), int(max_len)
        self.prefill_batch = max(int(prefill_batch), 1)
        self.prefill_chunk = max(int(prefill_chunk), 0)
        self.eos_token = eos_token
        self.detokenize = detokenize or (
            lambda ids: " ".join(str(t) for t in ids))
        self.pool = KVCachePool(model, self.max_batch, self.max_len,
                                block_size=block_size, n_blocks=n_blocks,
                                prefix_cache=prefix_cache)
        self.block_size = self.pool.block_size
        self._schedule = schedule
        self.queue: deque = deque()
        self._run_t0 = None             # run() wall-clock origin
        self.filling: list = []         # admitted, prefill in progress
        self.active: dict = {}          # slot -> _State (decoding)
        self._fill_turn = True          # chunked prefill <-> decode fairness
        self.stats = {"prefill_calls": 0, "decode_calls": 0,
                      "prefill_tokens": 0, "decode_tokens": 0,
                      "max_active": 0, "admitted": 0,
                      "prefix_hits": 0, "prefix_tokens": 0,
                      "peak_blocks": 0, "shed": 0, "shed_blocks": 0,
                      "shed_queue": 0, "expired": 0, "evicted": 0}
        self._rid = 0
        # request-latency rollup instruments (the one quantile codepath)
        self.registry = Registry()
        self.queue_slo = float(queue_slo)        # max queue wait, seconds
        self.watchdog_rounds = int(watchdog_rounds)
        self.faults = faults                     # runtime.faults.FaultPlan
        sv = faults.alloc_starve() if faults is not None else None
        self._starve = StarveState(*sv) if sv is not None else None
        self._tick = 0                           # engine ticks (step calls)
        self._cancelled: list = []               # Completions pending return

    # --- request intake -----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               sampler: SamplerConfig = SamplerConfig(),
               arrival: float = 0.0, rid=None, deadline: float = 0.0) -> int:
        """Queue one request (prompt + budget must fit ``max_len``).
        Returns the request id."""
        prompt = tuple(int(t) for t in prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len {self.max_len}")
        if rid is None:
            rid, self._rid = self._rid, self._rid + 1
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens), sampler=sampler,
                      arrival=float(arrival), deadline=float(deadline))
        self.queue.append((req, time.perf_counter()))
        obs.emit("req_queued", rid=rid, prompt_len=len(prompt),
                 max_new_tokens=int(max_new_tokens))
        return rid

    # --- load shedding / cancellation ---------------------------------------
    def _shed(self, req, t_submit, reason: str) -> None:
        """Reject a queued request at admission with a reason (counted in
        ``stats``, returned as a ``status="shed"`` completion)."""
        self.stats["shed"] += 1
        self.stats["shed_blocks" if reason.startswith("blocks")
                   else "shed_queue"] += 1
        t = time.perf_counter()
        self._cancelled.append(Completion(
            rid=req.rid, prompt=req.prompt, tokens=[], text="",
            timing={"queued": t - t_submit}, status="shed", reason=reason))
        obs.emit("req_shed", rid=req.rid, reason=reason,
                 queued_s=t - t_submit)

    def _cancel(self, s, status: str, reason: str = "") -> None:
        """Cancel an in-flight request mid-prefill or mid-decode: its pages
        go back to the arena (their ``pos`` maps are reset before the next
        gather, as for a finished request) and the partial generation is
        returned with the given status."""
        self.filling = [f for f in self.filling if f is not s]
        self.active.pop(s.slot, None)
        self.pool.release(s.req.rid)
        s.t_done = time.perf_counter()
        self.stats[status] += 1
        timing = {"latency": s.t_done - s.t_submit,
                  "queued": s.t_admit - s.t_submit}
        if s.t_first is not None:
            timing["ttft"] = s.t_first - s.t_submit
        self._cancelled.append(Completion(
            rid=s.req.rid, prompt=s.req.prompt, tokens=list(s.generated),
            text=self.detokenize(s.generated), timing=timing,
            status=status, reason=reason))
        obs.emit("req_cancelled", rid=s.req.rid, status=status,
                 reason=reason, tokens=len(s.generated),
                 latency_s=timing["latency"])

    def _infeasible_blocks(self, req) -> bool:
        """True when the request's worst-case page demand exceeds the
        whole arena: it could never be admitted, even alone (best-case
        prefix sharing ignored: a shed is deterministic, a maybe-hit is
        not)."""
        need = -(-(len(req.prompt) + req.max_new_tokens)
                 // self.pool.block_size)
        return need > self.pool.n_blocks

    def _enforce_slos(self) -> None:
        """Expire blown deadlines (wall-clock and fault-injected tick
        timeouts) and let the watchdog evict stalled decode rows."""
        t = time.perf_counter()
        for s in list(self.active.values()) + list(self.filling):
            ft = (self.faults.req_timeout_ticks(s.req.rid)
                  if self.faults is not None else 0)
            if ft and s.ticks_active >= ft:
                self._cancel(s, "expired",
                             f"fault req_timeout after {s.ticks_active} "
                             f"ticks")
            elif s.t_deadline is not None and t > s.t_deadline:
                self._cancel(s, "expired",
                             f"deadline {s.req.deadline:.3f}s exceeded")
            elif self.watchdog_rounds and \
                    s.stall_rounds >= self.watchdog_rounds:
                self._cancel(s, "evicted",
                             f"watchdog: no progress in {s.stall_rounds} "
                             f"decode rounds")

    # --- one scheduler tick -------------------------------------------------
    def step(self, params, now=None) -> list:
        """One tick, in the JAX engine's order: fault bookkeeping, the
        SLOs, admission by block budget (shedding what can never fit or
        waited past the queue SLO), then prefill for the waiting group or
        one decode round (alternating under chunked prefill).  Returns the
        requests that finished, were shed or were cancelled this tick."""
        self._tick += 1
        if self._starve is not None:
            # fault: hold arena blocks hostage through the reservation
            # ledger (exactly the accounting a real leak would consume)
            self._starve.tick(self.pool.alloc_blocks, self._tick)
        for s in list(self.active.values()) + list(self.filling):
            s.ticks_active += 1
        self._enforce_slos()
        while self.queue and len(self.filling) < self.prefill_batch:
            req, t_submit = self.queue[0]
            if now is not None and req.arrival > now:
                break
            if self._infeasible_blocks(req):
                self.queue.popleft()
                self._shed(req, t_submit, "blocks: worst-case "
                           "prompt+budget exceeds the whole arena")
                continue
            if not self.pool.can_admit(len(req.prompt), req.max_new_tokens):
                # backpressure, not rejection, unless the queue SLO says
                # this request has already waited too long
                if self.queue_slo and \
                        time.perf_counter() - t_submit > self.queue_slo:
                    self.queue.popleft()
                    self._shed(req, t_submit,
                               f"queue: waited past SLO {self.queue_slo}s "
                               f"for blocks")
                    continue
                break
            self.queue.popleft()
            row, shared_toks = self.pool.alloc(req.rid, req.prompt,
                                               req.max_new_tokens)
            if shared_toks:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens"] += shared_toks
            if self._run_t0 is not None and req.arrival > 0:
                t_submit = max(t_submit, self._run_t0 + req.arrival)
            st = _State(req, row, shared_toks, t_submit, time.perf_counter())
            if self.faults is not None:
                st.delay_left = self.faults.req_delay_rounds(req.rid)
            self.filling.append(st)
            self.stats["admitted"] += 1
            obs.emit("req_admitted", rid=req.rid,
                     queued_s=st.t_admit - st.t_submit,
                     prefix_hit_tokens=shared_toks)
        if self.filling and (self._fill_turn or not self.active):
            self._prefill_chunk_round(params)
            self._fill_turn = False
        elif self.active:
            self._decode_round(params)
            self._fill_turn = True
        self.stats["max_active"] = max(self.stats["max_active"],
                                       len(self.active))
        self.stats["peak_blocks"] = max(self.stats["peak_blocks"],
                                        self.pool.alloc_blocks.n_live)
        done = self._collect_finished()
        if self._cancelled:
            done.extend(self._cancelled)
            self._cancelled = []
        return done

    def run(self, params, requests=None, *, progress=False) -> list:
        """Drive until every queued request completes (finished, shed or
        cancelled).  ``requests`` is an optional iterable of (prompt,
        max_new_tokens, sampler, arrival) tuples / dicts to submit first;
        arrivals are honoured against a wall clock started here.  With a
        sink installed the run ends with a ``serve_rollup`` event."""
        for r in (requests or ()):
            if isinstance(r, dict):
                self.submit(**r)
            else:
                self.submit(*r)
        done = []
        t0 = self._run_t0 = time.perf_counter()
        while self.queue or self.filling or self.active:
            finished = self.step(params, now=time.perf_counter() - t0)
            done.extend(finished)
            if progress and finished:
                print(f"[serve] {len(done)} done, {len(self.active)} "
                      f"active, {len(self.queue)} queued", flush=True)
            if not finished and not self.active and not self.filling \
                    and self.queue:
                time.sleep(0.001)       # all arrivals in the future
        if obs.enabled():
            self.emit_rollup()
        return sorted(done, key=lambda c: c.rid)

    # --- internals ----------------------------------------------------------
    def _keys(self, states):
        """Per-row (seed, position) key data: the position is that of the
        token being SAMPLED, so a request's stream never depends on its
        batch mates."""
        return np.array(
            [[s.req.sampler.seed & 0xFFFFFFFF,
              len(s.req.prompt) + len(s.generated)] for s in states],
            np.uint32)

    def _tables(self, states, n_rows):
        """(n_rows, max_blocks) int32 page tables; unlisted rows stay
        all-null (their writes land in the masked null page)."""
        t = np.zeros((n_rows, self.pool.max_blocks), np.int32)
        for i, s in enumerate(states):
            row = i if n_rows == len(states) else s.slot
            ids = self.pool.table_of(s.req.rid)
            t[row, :len(ids)] = ids
        return t

    def _flush_freed(self):
        """Reset the ``pos`` maps of pages freed since the last step: a
        reused page must not leak its previous occupant's positions."""
        freed = self.pool.drain_freed()
        if not freed:
            return
        idx = torch.as_tensor(freed, dtype=torch.long, device=self.device)
        for r in self.pool.cache:
            self.pool.cache[r]["attn"]["pos"][:, idx] = -1

    def _to_dev(self, a):
        return torch.from_numpy(a).to(self.device)

    def _step(self, params, tokens, starts, lens, tables, keys, temps,
              topks, infer):
        """One ``paged_step`` + sampling; returns the sampled ids on the
        host (the copy waits for the device)."""
        batch = {"tokens": self._to_dev(tokens), "starts": self._to_dev(starts),
                 "lens": self._to_dev(lens), "tables": self._to_dev(tables)}
        with torch.no_grad():
            logits, _ = self.model.paged_step(
                params, self.pool.cache, batch,
                schedule=self._schedule, infer=infer)
            tok = sample(logits, keys, temps, topks)
        return tok.cpu().numpy()

    def _prefill_chunk_round(self, params):
        """One prefill call over the filling group's next spans: the whole
        remaining prompt when ``prefill_chunk`` is 0, else at most
        ``prefill_chunk`` tokens per row.  Rows whose prompt completes
        sample their first token and join the decode batch."""
        group = self.filling[:self.prefill_batch]
        cap = self.prefill_chunk or self.max_len
        c_lens = [min(len(s.req.prompt) - s.fill_pos, cap) for s in group]
        lb = prefill_bucket(c_lens, self.max_len)
        G = len(group)
        tokens = np.zeros((G, lb), np.int32)
        starts = np.zeros((G,), np.int32)
        lens = np.array(c_lens, np.int32)
        for i, s in enumerate(group):
            tokens[i, :c_lens[i]] = \
                s.req.prompt[s.fill_pos:s.fill_pos + c_lens[i]]
            starts[i] = s.fill_pos
            self.pool.ensure(s.req.rid, s.fill_pos + c_lens[i] - 1)
        tables = self._tables(group, G)
        temps = np.array([s.req.sampler.temperature for s in group],
                         np.float32)
        topks = np.array([s.req.sampler.top_k for s in group], np.int32)
        self._flush_freed()
        tok = self._step(params, tokens, starts, lens, tables,
                         self._keys(group), temps, topks, infer=False)
        t = time.perf_counter()
        finished_fill = set()
        for i, s in enumerate(group):
            s.fill_pos += c_lens[i]
            if s.fill_pos < len(s.req.prompt):
                continue                 # more chunks to go
            s.last_tok = int(tok[i])
            s.generated.append(s.last_tok)
            s.t_first = t
            self.pool.commit_prefix(s.req.rid, s.req.prompt)
            self.active[s.slot] = s
            finished_fill.add(id(s))
            obs.emit("req_prefilled", rid=s.req.rid,
                     prompt_len=len(s.req.prompt),
                     ttft_s=s.t_first - s.t_submit)
        self.filling = [s for s in self.filling
                        if id(s) not in finished_fill]
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += int(sum(c_lens))

    def _decode_round(self, params):
        B = self.max_batch
        tokens = np.zeros((B, 1), np.int32)
        steps = np.zeros((B,), np.int32)
        temps = np.zeros((B,), np.float32)      # idle rows: greedy, ignored
        topks = np.zeros((B,), np.int32)
        keys = np.zeros((B, 2), np.uint32)
        states = []
        for s in sorted(self.active.values(), key=lambda s: s.slot):
            if s.delay_left > 0:
                # fault: this row sits the round out (its slot rides along
                # with an all-null table, so its batch mates are bitwise
                # unaffected); the watchdog counts the stall
                s.delay_left -= 1
                s.stall_rounds += 1
                continue
            states.append(s)
        if not states:
            return
        for s in states:
            tokens[s.slot, 0] = s.last_tok
            steps[s.slot] = s.pos
            temps[s.slot] = s.req.sampler.temperature
            topks[s.slot] = s.req.sampler.top_k
            self.pool.ensure(s.req.rid, s.pos)
        keys[[s.slot for s in states]] = self._keys(states)
        tables = self._tables(states, B)
        self._flush_freed()
        tok = self._step(params, tokens, steps, np.ones((B,), np.int32),
                         tables, keys, temps, topks, infer=True)
        for s in states:
            s.last_tok = int(tok[s.slot])
            s.generated.append(s.last_tok)
            s.pos += 1
            s.stall_rounds = 0
        self.stats["decode_calls"] += 1
        self.stats["decode_tokens"] += len(states)
        if obs.enabled():
            obs.emit("decode_round", tick=self._tick, rows=len(states),
                     active=len(self.active),
                     block_occupancy=self.pool.alloc_blocks.n_live
                     / max(self.pool.n_blocks, 1))

    def _collect_finished(self) -> list:
        done = []
        for slot, s in list(self.active.items()):
            full = len(s.generated) >= s.req.max_new_tokens
            eos = (self.eos_token is not None
                   and s.generated and s.generated[-1] == self.eos_token)
            capped = s.pos >= self.max_len
            if not (full or eos or capped):
                continue
            s.t_done = time.perf_counter()
            del self.active[slot]
            self.pool.release(s.req.rid)            # pages back to the arena
            timing = {"ttft": s.t_first - s.t_submit,
                      "latency": s.t_done - s.t_submit,
                      "queued": s.t_admit - s.t_submit}
            self.registry.histogram("latency_s").add(timing["latency"])
            self.registry.histogram("ttft_s").add(timing["ttft"])
            obs.emit("req_finished", rid=s.req.rid,
                     tokens=len(s.generated), ttft_s=timing["ttft"],
                     latency_s=timing["latency"])
            done.append(Completion(
                rid=s.req.rid, prompt=s.req.prompt,
                tokens=list(s.generated),
                text=self.detokenize(s.generated), timing=timing))
        return done

    def emit_rollup(self) -> dict:
        """Snapshot the engine's rolling latency instruments and counters
        into one ``serve_rollup`` event (written when a sink is installed)
        and return the snapshot."""
        admitted = max(self.stats["admitted"], 1)
        snap = self.registry.snapshot()
        snap.update(self.stats)
        snap["prefix_hit_rate"] = self.stats["prefix_hits"] / admitted
        snap["block_occupancy"] = (self.pool.alloc_blocks.n_live
                                   / max(self.pool.n_blocks, 1))
        obs.emit("serve_rollup", **snap)
        return snap


def latency_stats(completions) -> dict:
    """Throughput + p50/p95/p99 latency summary for a finished run (the
    JAX package's function).

    Total on any input: empty runs, single samples and mixed-status
    completion lists all produce the full key set (zeros where there is
    nothing to measure).  Percentiles are computed over the ``status ==
    "ok"`` completions through ``obs.registry.quantile``; shed, expired
    and evicted requests are counted (``n_shed`` / ``n_cancelled``) but
    never enter the latency distribution.
    """
    completions = list(completions)
    ok = [c for c in completions
          if getattr(c, "status", "ok") == "ok" and "latency" in c.timing]
    out = {
        "n_requests": len(ok), "n_tokens": 0, "tok_per_s": 0.0,
        "p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
        "ttft_p50_ms": 0.0, "ttft_p99_ms": 0.0,
        "n_shed": sum(1 for c in completions
                      if getattr(c, "status", "ok") == "shed"),
        "n_cancelled": sum(1 for c in completions
                           if getattr(c, "status", "ok")
                           in ("expired", "evicted")),
    }
    if not ok:
        return out
    lat = sorted(c.timing["latency"] for c in ok)
    ttft = sorted(c.timing["ttft"] for c in ok if "ttft" in c.timing)

    def pct(xs, p):
        return quantile(xs, p) if xs else 0.0

    n_tok = sum(len(c.tokens) for c in ok)
    span = max(max(lat), 1e-9)
    out.update({
        "n_tokens": n_tok, "tok_per_s": n_tok / span,
        "p50_ms": 1e3 * pct(lat, 50), "p95_ms": 1e3 * pct(lat, 95),
        "p99_ms": 1e3 * pct(lat, 99),
        "ttft_p50_ms": 1e3 * pct(ttft, 50),
        "ttft_p99_ms": 1e3 * pct(ttft, 99),
    })
    return out


def suggest_max_batch(cfg, *, n_ep: int = 1, n_esp: int = 1, n_mp: int = 1,
                      candidates=(1, 2, 4, 8, 16, 32), perf_model=None,
                      n_blocks=None, block_size: int = 16,
                      mean_len=None):
    """Decode batch-bucket sizing from the perf model (``t_decode``), a
    copy of the JAX engine's with the card's model as the default.

    Picks the candidate maximizing predicted decode throughput
    ``B / t_decode(B)``: decode steps are alpha-dominated, so per-token
    latency falls with batch until the bandwidth/compute terms take
    over.  The paged-KV budget enters twice: ``t_decode`` charges each
    row's KV read at HBM bandwidth (``kv_bytes``), and a finite arena
    (``n_blocks`` pages of ``block_size`` tokens) caps the batch at the
    rows it can actually hold at ``mean_len`` tokens each — the budget
    is BLOCKS, not slots.  Dense archs (no MoE layer to model) just
    take the largest block-feasible candidate.
    """
    from repro_torch.core.perfmodel import MoELayerShape, h100_model

    def blocks_ok(b):
        if n_blocks is None or not mean_len:
            return True
        per_row = -(-int(mean_len) // int(block_size))   # ceil
        return b * per_row <= int(n_blocks)

    feasible = [b for b in candidates if blocks_ok(b)] or [min(candidates)]
    if cfg.moe is None:
        return max(feasible)
    pm = perf_model or h100_model(n_ep, n_esp, n_mp)
    kv_row_bytes = 0.0
    if mean_len:
        # per-row paged-KV read per decode step: every layer's K+V pages
        # up to the row's length (bf16, as the reference prices it)
        kv_row_bytes = (2.0 * cfg.n_layers * cfg.n_kv_heads * cfg.hd
                        * float(mean_len) * 2.0)

    def throughput(b):
        shape = MoELayerShape(
            B=b, L=1, M=cfg.moe.d_model, H=cfg.moe.d_ff,
            E=cfg.moe.n_experts, k=cfg.moe.top_k,
            f=cfg.moe.capacity_factor, n_mp=n_mp, n_esp=n_esp,
            n_ep=n_ep, infer=True)
        return b / pm.t_decode(shape, kv_bytes=b * kv_row_bytes)

    return max(feasible, key=throughput)
