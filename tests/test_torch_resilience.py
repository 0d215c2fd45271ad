"""The port's resilience layer against the live JAX reference, on the CPU.

Every scenario of the reference's fault-injection suite (numeric
quarantine, deadlines, backpressure, malformed requests, the watchdog,
preemption, chaos) runs twice from one script: on the reference's
``ServeEngine`` under its ``FaultPlan`` and on the port's under the port's
copy of the same plan. Finish reasons, token streams, the stream of
events and the counters must be equal; under a ``FaultClock`` the
lifecycle stats on the terminal events too, which holds the port to the
reference's clock reads one for one. Reduced smollm-135m with the
reference's seeded fp weights carried over through numpy, as the
reference's suite serves them (fp cache, and the rotated-int8 cache).
"""
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_config, reduced
from repro.ft import monitor as jmonitor
from repro.models import lm as jlm
from repro.models.layers import Runtime as JRuntime
from repro.serve import faults as jfaults
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.ft import monitor as tmonitor
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve import faults as tfaults
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampling import (
    FINISH_DEADLINE, FINISH_ERROR, FINISH_LENGTH, FINISH_REASONS,
    FINISH_REJECTED,
)
from test_torch_bridge import to_numpy_tree

# counters of stats() that both engines keep
COUNTERS = ("host_syncs", "tokens_decoded", "decode_steps", "waiting",
            "requests_rejected", "requests_shed", "requests_invalid",
            "deadline_expired", "quarantined", "preemptions", "resumes",
            "stalled_steps", "swapped", "max_queue", "shed_policy",
            "max_concurrent", "scheduler")
TIMES = ("queue_wait_s", "ttft_s", "decode_tok_s")


@functools.lru_cache(maxsize=None)
def _jax_model():
    cfg = reduced(get_config("smollm-135m"))
    return cfg, jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)


@functools.lru_cache(maxsize=None)
def _port_params():
    return params_from_numpy(to_numpy_tree(_jax_model()[1]), device="cpu")


def _jax_engine(kv_quant=False, **kw):
    cfg, params = _jax_model()
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 48)
    return JServeEngine(params, cfg, rt=JRuntime(
        compute_dtype=jnp.float32, kv_quant=kv_quant, backend="ref"), **kw)


def _port_engine(kv_quant=False, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 48)
    cfg = tconfigs.reduced(tconfigs.get_config("smollm-135m"))
    return ServeEngine(_port_params(), cfg, rt=TRuntime(kv_quant=kv_quant),
                       device="cpu", **kw)


JAX = types.SimpleNamespace(
    engine=_jax_engine, Request=JRequest, Fault=jfaults.Fault,
    FaultPlan=jfaults.FaultPlan, FaultClock=jfaults.FaultClock,
    burst=jfaults.burst, inject_kv_nan=jfaults.inject_kv_nan)
PORT = types.SimpleNamespace(
    engine=_port_engine, Request=Request, Fault=tfaults.Fault,
    FaultPlan=tfaults.FaultPlan, FaultClock=tfaults.FaultClock,
    burst=tfaults.burst, inject_kv_nan=tfaults.inject_kv_nan)
VOCAB = 512  # reduced smollm-135m


def _reqs(m, n=2, max_new=8, **kw):
    return [m.Request(rid=i, prompt=(np.arange(4 + i) % VOCAB).astype(
        np.int32), max_new=max_new, **kw) for i in range(n)]


def _events(events, timed: bool):
    out = []
    for e in events:
        st = dict(e.stats or {})
        if not timed:
            for k in TIMES:
                st.pop(k, None)
        out.append((e.rid, e.token, e.index, e.finished, e.finish_reason,
                    st))
    return out


def _both(scenario, *, timed=False):
    """Run ``scenario(m) -> (engine, requests, events)`` on the reference
    and on the port; hold the port's finish reasons, streams, events and
    counters to the reference's. Returns the port's run."""
    j_eng, j_reqs, j_events = scenario(JAX)
    t_eng, t_reqs, t_events = scenario(PORT)
    assert [(r.rid, r.finish_reason, r.out) for r in t_reqs] == \
        [(r.rid, r.finish_reason, r.out) for r in j_reqs]
    assert _events(t_events, timed) == _events(j_events, timed)
    js, ts = j_eng.stats(), t_eng.stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    return t_eng, t_reqs, t_events


# ---------------------------------------------------------------------------
# Numeric quarantine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", [math.nan, math.inf])
def test_kv_scale_poison_quarantines_slot_healthy_stream_bit_identical(value):
    def run(m):
        plan = m.FaultPlan([m.Fault("kv_nan", step=2, slot=0,
                                    plane="k_scale", value=value)])
        eng = m.engine(kv_quant=True, faults=plan)
        reqs = _reqs(m)
        events = list(eng.generate(reqs))
        assert plan.log and plan.log[0][1] == "kv_nan"
        # the poisoned slot's rows were re-zeroed: a new tenant decodes as
        # in a fresh engine
        again = [m.Request(rid=10, prompt=np.arange(4, dtype=np.int32),
                           max_new=4)]
        events += list(eng.generate(again))
        return eng, reqs + again, events

    eng, (poisoned, healthy, again), events = _both(run, timed=True)
    clean = _reqs(PORT)
    _port_engine(kv_quant=True).run(clean)
    assert poisoned.finish_reason == FINISH_ERROR
    assert 1 <= len(poisoned.out) < poisoned.max_new
    assert healthy.finish_reason == FINISH_LENGTH
    assert healthy.out == clean[1].out
    assert eng.quarantined == 1
    fresh = [Request(rid=10, prompt=np.arange(4, dtype=np.int32), max_new=4)]
    _port_engine(kv_quant=True).run(fresh)
    assert again.out == fresh[0].out
    term = [e for e in events if e.finished and e.rid == poisoned.rid]
    assert len(term) == 1 and term[0].token is None


def test_fp_cache_poison_quarantines_too():
    def run(m):
        plan = m.FaultPlan([m.Fault("kv_nan", step=1, slot=1, plane="k")])
        eng = m.engine(faults=plan)
        reqs = _reqs(m)
        return eng, reqs, list(eng.generate(reqs))

    eng, reqs, _ = _both(run, timed=True)
    assert reqs[1].finish_reason == FINISH_ERROR
    assert reqs[0].finish_reason == FINISH_LENGTH
    assert eng.quarantined == 1


@pytest.mark.parametrize("paged", [False, True])
def test_inject_kv_nan_planes_and_layouts(paged):
    """Integer and unknown planes refuse as the reference's do; a scale
    plane is poisoned at the same logical positions, dense and paged."""
    kw = dict(paged=True, block_size=4) if paged else {}
    engines = []
    for m in (JAX, PORT):
        eng = m.engine(kv_quant=True, **kw)
        it = eng.generate(_reqs(m, n=1, max_new=20))
        for _ in range(6):
            next(it)
        with pytest.raises(TypeError, match="int"):
            m.inject_kv_nan(eng, plane="k")  # int8 codes hold no NaN
        with pytest.raises(KeyError, match="no attn plane"):
            m.inject_kv_nan(eng, plane="bogus")
        m.inject_kv_nan(eng, slot=0, plane="v_scale", value=math.inf)
        engines.append(np.isinf(np.asarray(eng.cache["attn"]["v_scale"],
                                           np.float32)))
    jmask, tmask = engines
    assert tmask.any() and (tmask == jmask).all()


def test_quarantine_on_host_sampling_path():
    def run(m):
        plan = m.FaultPlan([m.Fault("kv_nan", step=1, slot=0)])
        eng = m.engine(kv_quant=True, sample_on_host=True, faults=plan)
        reqs = _reqs(m)
        return eng, reqs, list(eng.generate(reqs))

    eng, reqs, _ = _both(run, timed=True)
    assert reqs[0].finish_reason == FINISH_ERROR
    assert reqs[1].finish_reason == FINISH_LENGTH
    assert eng.quarantined == 1


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------

def test_live_deadline_expires_midstream():
    def run(m):
        clk = m.FaultClock()
        eng = m.engine(slots=1, clock=clk)
        req = m.Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                        max_new=50, deadline_ms=100.0)
        it = eng.generate([req])
        events = [next(it) for _ in range(3)]
        clk.advance(1.0)  # far past the 100 ms budget
        return eng, [req], events + list(it)

    eng, (req,), events = _both(run, timed=True)
    assert req.finish_reason == FINISH_DEADLINE
    assert 1 <= len(req.out) < 50
    assert eng.deadline_expired == 1
    assert events[-1].finished and events[-1].token is None


def test_queued_deadline_sheds_at_pop_no_prefill():
    def run(m):
        plan = m.FaultPlan([m.Fault("clock_skip", step=2, dt=1.0)])
        eng = m.engine(slots=1, faults=plan)
        a = m.Request(rid=0, prompt=np.arange(4, dtype=np.int32), max_new=6)
        b = m.Request(rid=1, prompt=np.arange(5, dtype=np.int32), max_new=6,
                      deadline_ms=50.0)
        return eng, [a, b], list(eng.generate([a, b]))

    eng, (a, b), _ = _both(run, timed=True)
    assert a.finish_reason == FINISH_LENGTH
    assert b.finish_reason == FINISH_DEADLINE
    assert b.t_admit is None and b.out == []  # never prefilled
    assert eng.deadline_expired == 1 and eng.prefill_waves == 1


def test_decode_timeout_expires_after_first_token():
    def run(m):
        plan = m.FaultPlan([m.Fault("clock_skip", step=2, dt=1.0)])
        eng = m.engine(slots=1, faults=plan)
        req = m.Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                        max_new=50, decode_timeout_ms=50.0)
        return eng, [req], list(eng.generate([req]))

    eng, (req,), _ = _both(run, timed=True)
    assert req.finish_reason == FINISH_DEADLINE
    assert req.t_first is not None and len(req.out) >= 1
    assert eng.deadline_expired == 1


# ---------------------------------------------------------------------------
# Backpressure
# ---------------------------------------------------------------------------

def test_max_queue_reject_policy():
    def run(m):
        eng = m.engine(slots=1, max_queue=2)
        reqs = m.burst(5, VOCAB, max_new=3)
        accepted = [eng.submit_request(r) for r in reqs]
        assert accepted == [True, True, False, False, False]
        return eng, reqs, list(eng.generate())

    eng, reqs, events = _both(run)
    assert [r.finish_reason for r in reqs] == [
        FINISH_LENGTH, FINISH_LENGTH,
        FINISH_REJECTED, FINISH_REJECTED, FINISH_REJECTED]
    assert eng.requests_rejected == 3
    assert {e.rid for e in events if e.finished} == {0, 1, 2, 3, 4}


def test_shed_lowest_evicts_waiting_victim_not_equal_priority():
    def run(m):
        eng = m.engine(slots=1, max_queue=1, shed_policy="shed_lowest",
                       scheduler="priority")
        low = m.Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                        max_new=3, priority=0)
        high = m.Request(rid=1, prompt=np.arange(4, dtype=np.int32),
                         max_new=3, priority=5)
        peer = m.Request(rid=2, prompt=np.arange(4, dtype=np.int32),
                         max_new=3, priority=5)
        assert eng.submit_request(low)
        assert eng.submit_request(high)  # displaces the waiting low one
        assert not eng.submit_request(peer)  # an equal never displaces
        return eng, [low, high, peer], list(eng.generate())

    eng, (low, high, peer), _ = _both(run)
    assert low.finish_reason == peer.finish_reason == FINISH_REJECTED
    assert high.finish_reason == FINISH_LENGTH
    assert eng.requests_shed == 1 and eng.requests_rejected == 1


@pytest.mark.parametrize("kw,match", [({"max_queue": 0}, "max_queue"),
                                      ({"shed_policy": "drop_newest"},
                                       "shed_policy")])
def test_engine_validates_backpressure_knobs(kw, match):
    for m in (JAX, PORT):
        with pytest.raises(ValueError, match=match):
            m.engine(**kw)


# ---------------------------------------------------------------------------
# Malformed requests
# ---------------------------------------------------------------------------

def test_empty_prompt_rejected_alone_not_whole_wave():
    def run(m):
        eng = m.engine()
        good = m.Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                         max_new=3)
        bad = m.Request(rid=1, prompt=np.zeros(0, dtype=np.int32), max_new=3)
        assert eng.admit([good, bad]) == 1
        assert eng.active[0] is good
        return eng, [good, bad], list(eng.generate())

    eng, (good, bad), _ = _both(run)
    assert bad.finish_reason == FINISH_ERROR and bad.done
    assert good.finish_reason == FINISH_LENGTH
    assert eng.requests_invalid == 1


def test_empty_prompt_screened_at_submit():
    def run(m):
        eng = m.engine()
        bad = m.Request(rid=0, prompt=np.zeros(0, dtype=np.int32), max_new=3)
        assert not eng.submit_request(bad)
        assert len(eng.scheduler) == 0
        return eng, [bad], list(eng.generate())

    eng, (bad,), events = _both(run)
    assert bad.finish_reason == FINISH_ERROR and eng.requests_invalid == 1
    assert len(events) == 1 and events[0].finish_reason == FINISH_ERROR


# ---------------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------------

def test_watchdog_counts_stalled_steps():
    def run(m):
        plan = m.FaultPlan([m.Fault("stall", step=2, dt=2.0)])
        eng = m.engine(slots=1, watchdog_timeout_s=0.5, faults=plan)
        req = m.Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                        max_new=6)
        return eng, [req], list(eng.generate([req]))

    eng, (req,), _ = _both(run, timed=True)
    assert req.finish_reason == FINISH_LENGTH  # slow, not fatal
    assert eng.stalled_steps >= 1
    assert eng.stats()["stalled_steps"] == eng.stalled_steps


def _monitor_script(mod):
    t = [0.0]
    mon = mod.HeartbeatMonitor(3, timeout_s=5.0, straggler_factor=2.0,
                               clock=lambda: t[0])
    out = []
    for step in range(1, 6):
        for host in range(3):
            # hosts 0 and 1 take 1 s a step, host 2 takes 3 s
            mon.beat(host, step, now=step * (3.0 if host == 2 else 1.0))
        t[0] = float(step)
        out.append((mon.stragglers(), mon.failed()))
    t[0] = 12.0
    mon.beat(0, 6)
    out.append((mon.failed(), mon.alive()))
    mon.exclude([1])
    out.append((mon.failed(), mon.alive(), mon.stragglers()))
    mon.beat(7, 7)  # never seen: registers as alive
    out.append((mon.alive(), mon.num_hosts, mon.failed(t[0] + 100.0)))
    return out, {h: (s.last_beat, s.last_step, list(s.step_times))
                 for h, s in mon.hosts.items()}


def test_heartbeat_monitor_equals_reference():
    """Liveness, stragglers, exclusion and a late joiner under a scripted
    clock, beat for beat."""
    out, hosts = _monitor_script(tmonitor)
    assert (out, hosts) == _monitor_script(jmonitor)
    assert out[4] == ([2], [])  # the slow host is the straggler
    assert out[5] == ([1], [0, 1, 2])  # host 1 last beat 5 s ago, at 7 s
    assert out[6][:2] == ([], [0, 2])  # excluded: not counted as failed
    assert out[7][:2] == ([0, 2, 7], 4)


def test_heartbeat_monitor_timeout_edges():
    t = [10.0]
    mon = tmonitor.HeartbeatMonitor(1, timeout_s=0.5, clock=lambda: t[0])
    assert mon.failed() == [] and mon.stragglers() == []
    t[0] += 0.5
    assert mon.failed() == []  # exactly the timeout is not late
    assert mon.failed(t[0] + 1e-9) == [0]
    mon.beat(0, 1, now=t[0] + 1.0)
    assert mon.failed(t[0] + 1.0) == []
    assert list(mon.hosts[0].step_times) == []  # the first beat sets a base


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------

def test_manual_preempt_resume_bit_identical_no_reprefill():
    def run(m):
        eng = m.engine()
        reqs = _reqs(m, max_new=8)
        it = eng.generate(reqs)
        events = [next(it) for _ in range(4)]
        assert eng.preempt(0) and eng.stats()["swapped"] == 1
        return eng, reqs, events + list(it)

    eng, reqs, _ = _both(run)
    clean = _reqs(PORT, max_new=8)
    _port_engine().run(clean)
    assert [r.out for r in reqs] == [r.out for r in clean]
    assert reqs[0].preemptions == 1
    assert eng.preemptions == 1 and eng.resumes == 1
    assert eng.prefill_waves == 1  # resume re-prefills nothing
    assert eng.stats()["swapped"] == 0


def test_priority_scheduler_auto_preempts_for_higher_priority():
    def run(m):
        eng = m.engine(slots=1, scheduler="priority")
        low = m.Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                        max_new=10, priority=0)
        it = eng.generate([low])
        events = [next(it) for _ in range(2)]
        high = m.Request(rid=1, prompt=np.arange(5, dtype=np.int32),
                         max_new=4, priority=5)
        eng.submit_request(high)
        return eng, [low, high], events + list(it)

    eng, (low, high), events = _both(run)
    alone = Request(rid=0, prompt=np.arange(4, dtype=np.int32), max_new=10)
    _port_engine(slots=1).run([alone])
    assert low.finish_reason == high.finish_reason == FINISH_LENGTH
    assert low.preemptions == 1 and eng.resumes == 1
    assert [e.rid for e in events if e.finished] == [1, 0]
    assert low.out == alone.out


def test_preempt_unknown_rid_and_cancel_swapped():
    def run(m):
        eng = m.engine()
        assert not eng.preempt(99)
        reqs = _reqs(m, max_new=8)
        it = eng.generate(reqs)
        events = [next(it)]
        assert eng.preempt(1)
        assert eng.cancel(1)  # cancelled while swapped out
        assert eng.stats()["swapped"] == 0
        return eng, reqs, events + list(it)

    _, reqs, _ = _both(run)
    assert reqs[0].finish_reason == FINISH_LENGTH
    assert reqs[1].finish_reason == "cancelled"


@pytest.mark.parametrize("kind", ["cancel", "preempt"])
def test_cancel_and_preempt_faults(kind):
    def run(m):
        plan = m.FaultPlan([m.Fault(kind, step=3, rid=1)])
        eng = m.engine(faults=plan)
        reqs = _reqs(m, max_new=8)
        return eng, reqs, list(eng.generate(reqs))

    _, reqs, _ = _both(run, timed=True)
    assert reqs[1].finish_reason == ("cancelled" if kind == "cancel"
                                     else FINISH_LENGTH)


# ---------------------------------------------------------------------------
# Chaos
# ---------------------------------------------------------------------------

def _chaos(seed):
    def run(m):
        plan = m.FaultPlan([
            m.Fault("kv_nan", step=3, slot=0),
            m.Fault("clock_skip", step=5, dt=1.0),
            m.Fault("stall", step=5, dt=2.0),  # same step: compound failure
        ], seed=seed)
        eng = m.engine(kv_quant=True, slots=2, max_queue=3,
                       shed_policy="shed_lowest", scheduler="priority",
                       watchdog_timeout_s=0.5, faults=plan)
        reqs = m.burst(8, VOCAB, seed=seed, max_new=6)
        for i, r in enumerate(reqs):
            r.priority = i % 3
            if i % 2:
                r.deadline_ms = 400.0
        for r in reqs:
            eng.submit_request(r)
        events = list(eng.generate())
        assert len(plan.log) == 3
        return eng, reqs, events
    return run


@pytest.mark.parametrize("seed", [0, 7])
def test_chaos_everything_terminates_with_closed_vocabulary(seed):
    eng, reqs, events = _both(_chaos(seed), timed=True)
    assert all(r.done and r.finish_reason in FINISH_REASONS for r in reqs)
    term = [e for e in events if e.finished]
    assert sorted(e.rid for e in term) == sorted(r.rid for r in reqs)
    assert all(r is None for r in eng.active)
    assert len(eng.scheduler) == 0 and eng.stats()["swapped"] == 0


def test_chaos_is_deterministic_under_a_seed():
    runs = [_chaos(7)(PORT) for _ in range(2)]
    (ea, ra, va), (eb, rb, vb) = runs
    assert [(r.finish_reason, r.out) for r in ra] == \
        [(r.finish_reason, r.out) for r in rb]
    assert _events(va, True) == _events(vb, True)
    assert {k: ea.stats()[k] for k in COUNTERS} == \
        {k: eb.stats()[k] for k in COUNTERS}


def test_cli_chaos_closed_vocabulary_and_deterministic(capsys):
    from repro_torch.launch import serve as tserve
    argv = ["--reduced", "--kv-quant", "--device", "cpu", "--chaos",
            "--stream", "--scheduler", "priority", "--max-queue", "4",
            "--shed-policy", "shed_lowest", "--requests", "8",
            "--max-new", "8"]
    outs = []
    for _ in range(2):
        tserve.main(argv)
        outs.append(capsys.readouterr().out)
    finished = [ln for ln in outs[0].splitlines() if "finished [" in ln]
    assert len(finished) == 8
    reasons = {ln.split("[")[1].split("]")[0] for ln in finished}
    assert reasons <= FINISH_REASONS and "error" in reasons
    assert "fault log: [(3, 'kv_nan'), (6, 'clock_skip'), (6, 'stall')]" \
        in outs[0]

    def stable(out):  # wall-clock lines aside
        return [ln for ln in out.splitlines()
                if not ln.startswith(("served", "quantized"))]
    assert stable(outs[0]) == stable(outs[1])
