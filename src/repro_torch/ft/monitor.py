"""Heartbeats, stall detection and elastic re-mesh (port of
``repro/ft/monitor.py``: pure Python).

A :class:`HeartbeatMonitor` tracks, per host, the time of its last beat
and its recent step latencies. ``failed(now)`` names the hosts with no
beat for ``timeout_s``; ``stragglers()`` those whose median step time is
over ``straggler_factor`` times the fleet's. The serving engine's
watchdog is one such monitor over one "host", its decode loop: each step
beats it, and a step whose gap since the last beat exceeds the timeout is
counted as stalled. The clock is injectable, so the policy is tested with
a deterministic clock instead of wall time.

After a failure, :func:`plan_remesh` gives the largest mesh the survivors
can form with the ``model`` (TP) axis kept: TP is baked into the weight
layouts, so the data axis (and the pods) shrink. The training launcher
then resumes from the latest checkpoint on that mesh (``checkpoint/
ckpt.py`` places each leaf for the new mesh as it loads).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

__all__ = ["HostState", "HeartbeatMonitor", "ElasticPlan", "plan_remesh"]


@dataclasses.dataclass
class HostState:
    last_beat: float
    last_step: int = -1
    step_times: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=16))


class HeartbeatMonitor:
    """Tracks per-host liveness and step latency."""

    def __init__(self, num_hosts: int, *, timeout_s: float = 60.0,
                 straggler_factor: float = 2.0, clock=time.monotonic):
        self.num_hosts = num_hosts
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.clock = clock
        now = clock()
        self.hosts = {h: HostState(last_beat=now) for h in range(num_hosts)}
        self.excluded: set[int] = set()

    def beat(self, host: int, step: int, now: Optional[float] = None):
        now = self.clock() if now is None else now
        st = self.hosts.get(host)
        if st is None:
            # a host never seen before (one that rejoins, or a dynamic
            # member set) registers as of this beat, and a stale exclusion
            # is cleared: a host that beats is alive
            st = self.hosts[host] = HostState(last_beat=now)
            self.num_hosts = max(self.num_hosts, len(self.hosts))
            self.excluded.discard(host)
        if st.last_step >= 0 and step > st.last_step:
            st.step_times.append((now - st.last_beat)
                                 / max(1, step - st.last_step))
        st.last_beat = now
        st.last_step = step

    def _median_step_time(self) -> Optional[float]:
        times = sorted(
            t for h, st in self.hosts.items() if h not in self.excluded
            for t in st.step_times)
        return times[len(times) // 2] if times else None

    def stragglers(self) -> list[int]:
        med = self._median_step_time()
        if med is None:
            return []
        out = []
        for h, st in self.hosts.items():
            if h in self.excluded or not st.step_times:
                continue
            mine = sorted(st.step_times)[len(st.step_times) // 2]
            if mine > self.straggler_factor * med:
                out.append(h)
        return out

    def failed(self, now: Optional[float] = None) -> list[int]:
        now = self.clock() if now is None else now
        return [h for h, st in self.hosts.items()
                if h not in self.excluded
                and now - st.last_beat > self.timeout_s]

    def exclude(self, hosts):
        self.excluded.update(hosts)

    def alive(self) -> list[int]:
        return [h for h in self.hosts if h not in self.excluded]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """A re-mesh decision after failures or exclusions."""

    data: int
    model: int
    pod: int = 1
    dropped_hosts: tuple = ()

    @property
    def devices(self) -> int:
        return self.pod * self.data * self.model


def plan_remesh(alive_devices: int, *, model: int, prefer_pods: int = 1,
                min_data: int = 1) -> Optional[ElasticPlan]:
    """The largest mesh from ``alive_devices`` survivors with the TP
    degree ``model`` kept: the data axis shrinks (uniform across pods),
    and so do the pods when a whole pod is unusable. None when the
    survivors cannot host even ``min_data x model``."""
    if alive_devices < min_data * model:
        return None
    for pods in range(prefer_pods, 0, -1):
        data = alive_devices // pods // model
        if data >= min_data:
            return ElasticPlan(data=data, model=model, pod=pods)
    return None
