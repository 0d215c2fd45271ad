"""Pluggable admission scheduling for the serving engine (a copy of
``repro/serve/scheduler.py``: pure Python).

A :class:`Scheduler` owns the waiting queue: the engine asks it for the
next admission wave whenever slots free up, and never looks inside. That
separation keeps policy (who goes next) out of the engine mechanics (how a
wave is prefilled in one compiled call), so new policies are a class, not
an engine fork.

Built-ins:

* ``fifo``     — strict arrival order (the pre-lifecycle behavior).
* ``priority`` — highest ``Request.priority`` first, FIFO within a
  priority level; an SLA tier knob.
* ``sjf``      — shortest-prompt-first: minimizes mean queue wait when
  prompt length predicts prefill cost (classic shortest-job-first), FIFO
  among equal lengths.

All built-ins break ties by arrival sequence, so scheduling is
deterministic for a fixed submission order.

Resilience hooks (optional — the engine probes with ``getattr``, so a
custom Scheduler that implements only the core protocol still works):

* ``shed(below=None)`` — drop and return the least-valuable waiting
  request (lowest ``priority``, youngest on ties), for the engine's
  ``shed_lowest`` backpressure policy. ``below`` sheds only a victim with
  priority strictly below it — on a tie the incumbent wins and the
  newcomer is rejected instead (no churn).
* ``should_preempt(active)`` — given the live requests, return the rid of
  one worth evicting mid-flight in favor of the waiting queue's head, or
  None. :class:`PriorityScheduler` preempts the lowest-priority live
  request when a strictly higher-priority request is waiting; the engine
  swaps the victim's cache rows to host and resumes it later without
  re-prefill.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Iterable, Optional, Protocol, runtime_checkable

from repro_torch.serve.sampling import FINISH_CANCELLED

__all__ = [
    "Scheduler", "FIFOScheduler", "PriorityScheduler",
    "ShortestPromptFirstScheduler", "SCHEDULERS", "get_scheduler",
]


@runtime_checkable
class Scheduler(Protocol):
    """What the engine needs from an admission policy."""

    def add(self, req) -> None:
        """Enqueue a request (called at submission time)."""

    def pop(self, n: int) -> list:
        """Dequeue up to ``n`` requests for the next admission wave, in
        admission order."""

    def cancel(self, rid: int):
        """Remove a waiting request by id; returns it (marked cancelled)
        or None if unknown/already admitted."""

    def __len__(self) -> int:
        """Number of waiting requests."""


class _QueueBase:
    """Shared cancel/shed/len bookkeeping over lazily-compacted entries.

    Cancellation is keyed by the ENTRY's sequence number, not the rid: a
    client may cancel a queued request and resubmit the same rid, and the
    new entry must survive while only the stale one is dropped at pop
    time (regression-tested in tests/test_serving_api.py)."""

    def __init__(self):
        self._seq = 0
        self._cancelled: set[int] = set()  # cancelled entry seqs
        self._live = 0

    def __len__(self) -> int:
        return self._live

    def _on_add(self) -> int:
        self._seq += 1
        self._live += 1
        return self._seq

    def _claim(self, seq: int, req) -> Optional[object]:
        """Filter popped entries against lazy cancellations."""
        if seq in self._cancelled:
            self._cancelled.discard(seq)
            return None
        self._live -= 1
        return req

    def _entries(self) -> Iterable:
        """All queue entries as (seq, req) pairs, arrival-ordered.
        May include lazily-cancelled entries — callers filter."""
        raise NotImplementedError  # pragma: no cover - abstract

    def _cancel_common(self, rid: int, waiting: Iterable):
        """``waiting`` yields (seq, req) in arrival order; the OLDEST live
        entry for ``rid`` is cancelled."""
        for seq, req in waiting:
            if req.rid == rid and seq not in self._cancelled:
                self._cancelled.add(seq)
                self._live -= 1
                req.done = True
                req.finish_reason = FINISH_CANCELLED
                return req
        return None

    def cancel(self, rid: int):
        return self._cancel_common(rid, self._entries())

    def shed(self, below: Optional[int] = None):
        """Drop and return the least-valuable waiting request: lowest
        ``Request.priority``, youngest entry on ties (LIFO within a level —
        seniority is preserved under sustained overload). ``below`` only
        sheds a victim with priority STRICTLY below it, so a newcomer never
        displaces an equal-priority incumbent. Returns None when nothing
        sheddable. The entry is removed via the same lazy-cancellation
        bookkeeping as :meth:`cancel`, but the request is NOT marked — the
        engine stamps the terminal reason (``rejected``)."""
        best = None
        for seq, req in self._entries():
            if seq in self._cancelled:
                continue
            key = (int(getattr(req, "priority", 0)), -seq)
            if best is None or key < best[0]:
                best = (key, seq, req)
        if best is None:
            return None
        if below is not None and best[0][0] >= below:
            return None
        _, seq, req = best
        self._cancelled.add(seq)
        self._live -= 1
        return req


class FIFOScheduler(_QueueBase):
    name = "fifo"

    def __init__(self):
        super().__init__()
        self._q: deque = deque()  # (seq, req)

    def add(self, req) -> None:
        self._q.append((self._on_add(), req))

    def pop(self, n: int) -> list:
        out = []
        while self._q and len(out) < n:
            req = self._claim(*self._q.popleft())
            if req is not None:
                out.append(req)
        return out

    def _entries(self):
        return iter(self._q)


class _HeapScheduler(_QueueBase):
    """Priority-queue scheduling over a per-request sort key."""

    def __init__(self):
        super().__init__()
        self._heap: list = []  # (key, seq, req)

    def _key(self, req):  # pragma: no cover - abstract
        raise NotImplementedError

    def add(self, req) -> None:
        seq = self._on_add()
        heapq.heappush(self._heap, (self._key(req), seq, req))

    def pop(self, n: int) -> list:
        out = []
        while self._heap and len(out) < n:
            _, seq, req = heapq.heappop(self._heap)
            req = self._claim(seq, req)
            if req is not None:
                out.append(req)
        return out

    def _entries(self):
        return sorted((e[1], e[2]) for e in self._heap)

    def _peek(self):
        """The next request :meth:`pop` would return, without removing it
        (lazily compacts cancelled entries off the heap top)."""
        while self._heap and self._heap[0][1] in self._cancelled:
            _, seq, _ = heapq.heappop(self._heap)
            self._cancelled.discard(seq)
        return self._heap[0][2] if self._heap else None


class PriorityScheduler(_HeapScheduler):
    """Highest ``Request.priority`` admitted first; FIFO within a level."""

    name = "priority"

    def _key(self, req):
        return -int(getattr(req, "priority", 0))

    def should_preempt(self, active: list) -> Optional[int]:
        """Evict a live request when a STRICTLY higher-priority request is
        waiting. The victim is the lowest-priority live request, youngest
        admission on ties (least progress lost). Ties between waiting and
        live go to the live request — no same-priority churn."""
        head = self._peek()
        if head is None or not active:
            return None
        best = int(getattr(head, "priority", 0))
        victim = min(active, key=lambda r: (int(getattr(r, "priority", 0)),
                                            -(r.t_admit or 0.0)))
        if int(getattr(victim, "priority", 0)) < best:
            return victim.rid
        return None


class ShortestPromptFirstScheduler(_HeapScheduler):
    """Shortest job admitted first; FIFO on ties.

    The default job-size estimate is prompt length (prefill-cost SJF, the
    pre-speculative behavior). An engine can install a richer cost model
    via :meth:`set_cost` — ``ServeEngine`` does, pricing a request at
    ``prefill + expected decode steps``, where a speculative request's
    decode is amortized by its window size (a draft-enabled request
    commits up to K+1 tokens per step, so it occupies its slot for fewer
    steps than an equal-budget non-speculative one). The cost is sampled
    at ``add`` time, so installing a model only affects requests enqueued
    afterwards."""

    name = "sjf"

    def __init__(self, cost=None):
        super().__init__()
        self._cost = cost

    def set_cost(self, fn) -> None:
        """Install a ``req -> float`` admission cost model (None resets to
        prompt length)."""
        self._cost = fn

    def _key(self, req):
        if self._cost is not None:
            return float(self._cost(req))
        return len(req.prompt)


SCHEDULERS = {
    "fifo": FIFOScheduler,
    "priority": PriorityScheduler,
    "sjf": ShortestPromptFirstScheduler,
}


def get_scheduler(spec: "str | Scheduler | None") -> Scheduler:
    """Resolve a scheduler name or pass through an instance (None -> fifo)."""
    if spec is None:
        return FIFOScheduler()
    if isinstance(spec, str):
        try:
            return SCHEDULERS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown scheduler {spec!r}; options {sorted(SCHEDULERS)}")
    if not isinstance(spec, Scheduler):
        raise TypeError(f"not a Scheduler: {spec!r}")
    return spec
