"""Continuous-batching MoE serving engine over a PAGED KV cache
(counterpart of ``repro/serve/engine.py`` and of the engine steps in
``repro/train/loop.py``).

Request lifecycle:

  submit -> queue -> admit (page-table rows + shared-prefix reuse)
         -> prefill (one-shot, or fixed-size CHUNKS interleaved with
            decode rounds)
         -> decode rounds (continuous batch over the whole row pool)
         -> finish (EOS / token budget) -> release pages -> detokenize

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

Later slices add what the JAX engine also has: fault injection,
deadlines and queue-SLO shedding, the decode watchdog, expert-placement
rebalancing and telemetry.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.serve.kvcache import KVCachePool
from repro_torch.serve.sampler import SamplerConfig, sample


@dataclass(frozen=True)
class Request:
    """One generation request: prompt token ids + budget + sampling."""

    rid: int
    prompt: tuple                      # token ids, len >= 1
    max_new_tokens: int = 16
    sampler: SamplerConfig = SamplerConfig()
    arrival: float = 0.0               # seconds after run start


@dataclass
class Completion:
    """A finished request: generated ids, text, and latency breakdown."""

    rid: int
    prompt: tuple
    tokens: list
    text: str
    timing: dict = field(default_factory=dict)   # ttft / latency seconds


class _State:
    __slots__ = ("req", "slot", "pos", "fill_pos", "last_tok", "generated",
                 "t_submit", "t_admit", "t_first", "t_done")

    def __init__(self, req, slot, fill_pos, t_submit, t_admit):
        self.req, self.slot = req, slot
        self.pos = len(req.prompt)     # next absolute position to decode
        self.fill_pos = fill_pos       # next prompt position to prefill
        self.last_tok = None
        self.generated = []
        self.t_submit, self.t_admit = t_submit, t_admit
        self.t_first = self.t_done = None


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
    """

    def __init__(self, model, *, max_batch: int = 8, max_len: int = 256,
                 schedule=None, prefill_batch: int = 1, eos_token=None,
                 detokenize=None, block_size: int = 16, n_blocks=None,
                 prefix_cache: bool = True, prefill_chunk: int = 0):
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
                      "peak_blocks": 0}
        self._rid = 0

    # --- request intake -----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               sampler: SamplerConfig = SamplerConfig(),
               arrival: float = 0.0, rid=None) -> int:
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
        self.queue.append((Request(rid=rid, prompt=prompt,
                                   max_new_tokens=int(max_new_tokens),
                                   sampler=sampler, arrival=float(arrival)),
                           time.perf_counter()))
        return rid

    # --- one scheduler tick -------------------------------------------------
    def step(self, params, now=None) -> list:
        """Admit by block budget, then advance prefill for the waiting
        group or run one decode round (alternating under chunked
        prefill).  Returns the requests that finished this tick."""
        while self.queue and len(self.filling) < self.prefill_batch:
            req, t_submit = self.queue[0]
            if now is not None and req.arrival > now:
                break
            if not self.pool.can_admit(len(req.prompt), req.max_new_tokens):
                break                    # backpressure
            self.queue.popleft()
            row, shared_toks = self.pool.alloc(req.rid, req.prompt,
                                               req.max_new_tokens)
            if shared_toks:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens"] += shared_toks
            if self._run_t0 is not None and req.arrival > 0:
                t_submit = max(t_submit, self._run_t0 + req.arrival)
            self.filling.append(_State(req, row, shared_toks, t_submit,
                                       time.perf_counter()))
            self.stats["admitted"] += 1
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
        return self._collect_finished()

    def run(self, params, requests=None) -> list:
        """Drive until every queued request completes.  ``requests`` is an
        optional iterable of (prompt, max_new_tokens, sampler, arrival)
        tuples / dicts to submit first; arrivals are honoured against a
        wall clock started here."""
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
            if not finished and not self.active and not self.filling \
                    and self.queue:
                time.sleep(0.001)       # all arrivals in the future
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
        states = sorted(self.active.values(), key=lambda s: s.slot)
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
        self.stats["decode_calls"] += 1
        self.stats["decode_tokens"] += len(states)

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
            done.append(Completion(
                rid=s.req.rid, prompt=s.req.prompt,
                tokens=list(s.generated),
                text=self.detokenize(s.generated), timing=timing))
        return done


def quantile(xs, p: float) -> float:
    """Nearest-rank quantile of an already sorted, non-empty sample (the
    JAX package's ``obs.registry.quantile``); ``p`` in percent."""
    n = len(xs)
    if n == 0:
        raise ValueError("quantile of empty sample")
    if p <= 0.0:
        return float(xs[0])
    return float(xs[min(int(p / 100.0 * n), n - 1)])


def latency_stats(completions) -> dict:
    """Throughput + p50/p95/p99 latency summary for a finished run (the
    JAX package's function; zeros where there is nothing to measure)."""
    ok = [c for c in completions if "latency" in c.timing]
    out = {
        "n_requests": len(ok), "n_tokens": 0, "tok_per_s": 0.0,
        "p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
        "ttft_p50_ms": 0.0, "ttft_p99_ms": 0.0,
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
