"""Deterministic fault injection: one seeded spec drives every failure
path the runtime layer must survive (a copy of ``repro/runtime/faults.py``,
which is framework-free).

The guard rails / rollback / serve-SLO machinery (``runtime`` +
``serve.engine``) would be untestable folklore without a way to *cause*
the failures on demand.  A :class:`FaultPlan` is a parsed, seeded,
read-only description of which faults fire when; the train loop, the
fp8 encode path, the checkpoint store, and the serving engine each ask
it cheap questions (``grad_fault(step)``, ``fp8_sat_factor()``, ...)
and inject accordingly.  With no plan (or an empty one) every hook is a
no-op that costs one ``is None`` check — production paths carry zero
fault-injection overhead.

Spec grammar (``launch/train.py --faults`` / ``launch/serve.py
--faults``): semicolon-separated atoms, each ``kind@key=val,key=val``:

  ``nan_grad@step=5``            poison gradients with NaN at step 5
  ``nan_grad@step=5-8,value=inf``  ... a step range, with +inf instead
  ``fp8_sat@factor=64``          shrink fp8 wire-encode scales by 64x so
                                 payloads saturate (overflow detection)
  ``ckpt_bitflip@save=2``        flip one seeded bit in the 2nd
                                 checkpoint file written by the store
  ``req_delay@rid=1,rounds=6``   serve: request 1's row stops advancing
                                 for 6 decode rounds (watchdog bait)
  ``req_timeout@rid=2,ticks=4``  serve: request 2 is force-expired after
                                 4 engine ticks (deadline path, wall-
                                 clock free so CI is deterministic)
  ``alloc_starve@tick=1,hold=8,rounds=5``  serve: hold up to 8 arena
                                 blocks hostage from tick 1 for 5 ticks

Everything is deterministic under (spec, seed): parsing is order-
preserving, the bit flipped by ``ckpt_bitflip`` comes from a seeded
RNG, and the serve faults key on request ids / tick counts, never wall
time.
"""

from __future__ import annotations

from dataclasses import dataclass, field

KINDS = ("nan_grad", "fp8_sat", "ckpt_bitflip", "req_delay",
         "req_timeout", "alloc_starve")


@dataclass(frozen=True)
class FaultSpec:
    """One parsed fault atom: its kind plus integer/float args."""

    kind: str
    args: tuple = ()            # sorted (key, value) pairs — hashable

    def get(self, key, default=None):
        return dict(self.args).get(key, default)


def _parse_val(key: str, raw: str):
    """``step=5-8`` becomes an inclusive (lo, hi) range; numbers parse
    as int when possible, else float."""
    if "-" in raw and not raw.startswith("-"):
        lo, hi = raw.split("-", 1)
        return (int(lo), int(hi))
    try:
        return int(raw)
    except ValueError:
        return float(raw)


@dataclass(frozen=True)
class FaultPlan:
    """A parsed, immutable set of faults plus the injection seed."""

    specs: tuple = ()
    seed: int = 0

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Parse the ``--faults`` grammar (empty/None -> empty plan)."""
        specs = []
        for atom in (text or "").split(";"):
            atom = atom.strip()
            if not atom:
                continue
            kind, _, rest = atom.partition("@")
            kind = kind.strip()
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} (want one of {KINDS})")
            args = []
            for kv in rest.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                if "=" not in kv:
                    raise ValueError(
                        f"bad fault arg {kv!r} in {atom!r} (want key=val)")
                k, v = kv.split("=", 1)
                args.append((k.strip(), _parse_val(k.strip(), v.strip())))
            specs.append(FaultSpec(kind=kind, args=tuple(sorted(args))))
        return cls(specs=tuple(specs), seed=int(seed))

    def __bool__(self) -> bool:
        return bool(self.specs)

    def _of(self, kind: str):
        return [s for s in self.specs if s.kind == kind]

    # --- train-loop hooks ----------------------------------------------------
    def grad_fault(self, step: int) -> float:
        """Multiplier-offset for the guarded train step: grads become
        ``g * (1 + fault)``.  0.0 (exact identity) when no ``nan_grad``
        fault covers ``step``; NaN / +inf when one does."""
        for s in self._of("nan_grad"):
            at = s.get("step", 0)
            lo, hi = at if isinstance(at, tuple) else (at, at)
            if lo <= step <= hi:
                return float("inf") if s.get("value") == "inf" \
                    or s.get("value") == float("inf") else float("nan")
        return 0.0

    # --- wire-encode hook ----------------------------------------------------
    def fp8_sat_factor(self) -> float:
        """Scale-shrink factor for fp8 wire encodes (0.0 = no fault)."""
        for s in self._of("fp8_sat"):
            return float(s.get("factor", 64))
        return 0.0

    # --- checkpoint hook -----------------------------------------------------
    def ckpt_corrupts(self, save_index: int) -> bool:
        """True when the ``save_index``-th (1-based) store save should be
        bit-flipped after writing."""
        return any(s.get("save", 1) == save_index
                   for s in self._of("ckpt_bitflip"))

    def flip_bit(self, path: str) -> int:
        """Flip one seeded bit of the file at ``path`` in place, aimed at
        the middle of the file where the leaf *data* lives (the zip
        headers at the front and the central directory at the tail give
        unreadable-file errors instead; those are a separate restore
        path).  Returns the flipped byte offset."""
        import os
        import random
        size = os.path.getsize(path)
        rng = random.Random(self.seed * 1000003 + size)
        lo = min(512, max(size // 4, 1))
        hi = max(size - 1024, size // 2, lo + 1)
        off = rng.randrange(lo, hi)
        with open(path, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ (1 << rng.randrange(8))]))
        return off

    # --- serve hooks ---------------------------------------------------------
    def req_delay_rounds(self, rid) -> int:
        """Decode rounds request ``rid``'s row should refuse to advance
        (0 = no fault).  The watchdog is what should catch this."""
        for s in self._of("req_delay"):
            if s.get("rid") == rid:
                return int(s.get("rounds", 4))
        return 0

    def req_timeout_ticks(self, rid) -> int:
        """Engine ticks after which request ``rid`` is force-expired
        (0 = no fault).  Wall-clock-free stand-in for a blown deadline."""
        for s in self._of("req_timeout"):
            if s.get("rid") == rid:
                return int(s.get("ticks", 4))
        return 0

    def alloc_starve(self):
        """``(start_tick, hold, rounds)`` for the block-allocator
        starvation fault, or None."""
        for s in self._of("alloc_starve"):
            return (int(s.get("tick", 1)), int(s.get("hold", 1 << 30)),
                    int(s.get("rounds", 4)))
        return None

    def summary(self) -> str:
        return "; ".join(
            s.kind + ("@" + ",".join(f"{k}={v}" for k, v in s.args)
                      if s.args else "")
            for s in self.specs) or "(no faults)"


@dataclass
class StarveState:
    """Engine-side countdown for one ``alloc_starve`` fault: blocks are
    reserved (never allocated — the ledger is exactly the mechanism a
    buggy leak would use) at ``start`` and given back ``rounds`` ticks
    later."""

    start: int
    hold: int
    rounds: int
    held: int = 0
    active: bool = False
    done: bool = False
    ticks: int = field(default=0)

    def tick(self, allocator, tick: int) -> None:
        """Advance one engine tick against the live allocator."""
        if self.done:
            return
        if not self.active and tick >= self.start:
            self.held = min(self.hold, allocator.available)
            allocator.reserve(self.held)
            self.active = True
        elif self.active:
            self.ticks += 1
            if self.ticks >= self.rounds:
                allocator.unreserve(self.held)
                self.active, self.done = False, True
