"""Deterministic fault injection for the serving resilience layer (port
of ``repro/serve/faults.py`` in torch).

Each failure the engine's policies answer (numeric quarantine, deadlines,
backpressure, the watchdog) becomes a seeded, replayable event, so the
policies are exercised by ordinary tests instead of luck:

* :class:`FaultClock` — a deterministic engine clock. Each read returns
  the current time and advances it by ``tick``, so lifecycle stamps stay
  strictly ordered without wall time; :meth:`FaultClock.advance` jumps it.
* :class:`Fault` — one scheduled event, keyed by the engine's
  ``decode_steps``:

  - ``kv_nan``: overwrite a slot's KV **scale plane** (or an fp cache's
    ``k``/``v``) with ``value`` at every position below its write head;
    an int8 code plane cannot hold a NaN, and a degenerate scale is how
    quantized-cache corruption presents;
  - ``clock_skip`` / ``stall``: advance the plan's clock by ``dt`` (a
    deadline expiry; a stalled step for the watchdog);
  - ``cancel`` / ``preempt``: call ``engine.cancel(rid)`` /
    ``engine.preempt(rid)`` at the top of the step.

* :class:`FaultPlan` — the ordered schedule plus the clock. Pass it as
  ``ServeEngine(faults=...)``: the engine calls :meth:`before_decode` at
  the top of every decode step and, without an explicit ``clock``, adopts
  ``plan.clock``.
* :func:`burst` — a seeded batch of uniform requests that overruns
  ``max_queue``.

Two runs of one plan give the same engine behaviour, step for step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

__all__ = ["FaultClock", "Fault", "FaultPlan", "inject_kv_nan", "burst"]


class FaultClock:
    """Deterministic time source for the engine's ``clock=``: every read
    returns the current time, then advances it by ``tick`` (1 ms by
    default); :meth:`advance` jumps it by ``dt`` seconds."""

    def __init__(self, t0: float = 0.0, tick: float = 1e-3):
        self.t = float(t0)
        self.tick = float(tick)

    def __call__(self) -> float:
        now = self.t
        self.t += self.tick
        return now

    def advance(self, dt: float) -> None:
        self.t += float(dt)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault. It fires at the first decode step whose
    ``decode_steps`` is >= ``step``, so a fault scheduled for a step the
    engine skipped still fires at the next one."""

    kind: str  # "kv_nan" | "clock_skip" | "stall" | "cancel" | "preempt"
    step: int
    slot: int = 0            # kv_nan: the cache slot to poison
    plane: str = "k_scale"   # kv_nan: "k_scale"/"v_scale" (q8 cache),
    #   "k"/"v" (fp cache)
    value: float = math.nan  # kv_nan: the poison (nan or +/-inf)
    dt: float = 0.0          # clock_skip/stall: seconds to jump the clock
    rid: Optional[int] = None  # cancel/preempt: the target request

    _KINDS = ("kv_nan", "clock_skip", "stall", "cancel", "preempt")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"options {self._KINDS}")
        if self.kind in ("cancel", "preempt") and self.rid is None:
            raise ValueError(f"{self.kind} fault needs a target rid")


class FaultPlan:
    """An ordered, replayable fault schedule. Each fault fires once, at
    the first step that reaches it; ``log`` records ``(decode_steps,
    kind)`` per firing."""

    def __init__(self, faults=(), *, seed: int = 0,
                 clock: Optional[FaultClock] = None):
        self.faults = tuple(faults)
        self.seed = int(seed)
        self.clock = clock if clock is not None else FaultClock()
        self.log: list[tuple[int, str]] = []
        self._fired: set[int] = set()  # indices into self.faults

    def before_decode(self, engine) -> None:
        for i, f in enumerate(self.faults):
            if i in self._fired or engine.decode_steps < f.step:
                continue
            self._fired.add(i)
            self.log.append((engine.decode_steps, f.kind))
            if f.kind == "kv_nan":
                inject_kv_nan(engine, slot=f.slot, plane=f.plane,
                              value=f.value)
            elif f.kind == "cancel":
                engine.cancel(f.rid)
            elif f.kind == "preempt":
                engine.preempt(f.rid)
            else:  # clock_skip / stall: a deterministic time jump
                self.clock.advance(f.dt)


def inject_kv_nan(engine, *, slot: int = 0, plane: str = "k_scale",
                  value: float = math.nan) -> None:
    """Poison slot ``slot``'s KV ``plane`` with ``value`` in place, in
    every layer and head, at every position it has written (``<
    pos[slot]``, at least one). A paged engine's poison goes through the
    slot's block table to the same logical positions. Raises ``KeyError``
    for a plane the cache lacks and ``TypeError`` for an integer plane."""
    attn = engine.cache.get("attn")
    if not attn or plane not in attn:
        raise KeyError(
            f"cache has no attn plane {plane!r}; have "
            f"{sorted(attn) if attn else 'no attn cache'}")
    leaf = attn[plane]
    if not leaf.is_floating_point():
        raise TypeError(
            f"plane {plane!r} is {leaf.dtype}: integer code planes cannot "
            f"hold {value!r}; poison a float scale plane instead")
    upto = max(int(engine.pos[slot]), 1)
    if getattr(engine, "paged", False):
        # pool leaves are (L, NB, KV, BS, X)
        bs = engine.block_size
        p = np.arange(upto)
        blk = torch.as_tensor(np.asarray(engine._table[slot])[p // bs],
                              device=leaf.device)
        off = torch.as_tensor(p % bs, device=leaf.device)
        leaf[:, blk, :, off] = value
    else:
        # dense leaves are (L, B, KV, T, X)
        leaf[:, slot, :, :upto] = value


def burst(n: int, vocab: int, *, seed: int = 0, plen: int = 8,
          max_new: int = 8, rid0: int = 0, priority: int = 0,
          **req_kw) -> list:
    """A seeded batch of ``n`` uniform requests: the traffic spike that
    overruns ``max_queue``."""
    from repro_torch.serve.engine import Request  # avoids a module cycle

    rng = np.random.default_rng(seed)
    return [Request(rid=rid0 + i,
                    prompt=rng.integers(0, vocab, size=plen).astype(np.int32),
                    max_new=max_new, priority=priority, **req_kw)
            for i in range(n)]
