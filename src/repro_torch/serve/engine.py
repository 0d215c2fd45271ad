"""Serving engine core (port of ``repro/serve/engine.py``): continuous
batching over a fixed slot-batched KV cache, greedy decoding.

``ServeEngine`` owns a (slots x max_len) cache and admits requests
continuously: whenever slots free up, the scheduler's next wave is
prefilled in one padded-bucket call while the other slots keep decoding.

Hot-path discipline, as in the reference:

* **One device->host transfer per step.** Greedy argmax and a per-slot
  finiteness check run on the device; ``_step_events`` fetches one
  (slots,) int32 vector. ``host_syncs`` counts every transfer (one per
  admission wave, one per decode step).
* **In-place cache.** The cache is allocated once; decode writes one
  token slice per layer into it (the reference's donated buffers).
* **One call per admission wave.** All free slots are admitted together:
  prompts are padded to one shared ``prompt_pad`` bucket, prefilled into a
  zeroed sub-cache that is copied into the admitted slots, and each
  prompt's first token comes from its true last-prompt-token logits.
* **Numeric quarantine.** A slot whose logits row is not finite reports
  the in-band ``-1`` sentinel instead of a token (riding the same
  transfer); it finishes with ``finish_reason="error"`` and its cache rows
  are re-zeroed.

This slice serves greedy requests on the dense layout. Sampled decoding,
the paged cache, speculative decoding, tensor-parallel meshes, fault
injection, deadlines and preemption land with later slices and raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.layers import Runtime
from repro_torch.serve.sampling import (
    FINISH_CANCELLED, FINISH_ERROR, FINISH_LENGTH, FINISH_STOP,
    SamplingParams, StreamEvent,
)
from repro_torch.serve.scheduler import Scheduler, get_scheduler

__all__ = ["Request", "ServeEngine", "SamplingParams", "StreamEvent"]

# In-band numeric-health sentinel (token ids are always >= 0).
_POISONED = -1

_LATER = {
    "paged": "the paged KV-cache slice (ROADMAP Queue 1 item 10)",
    "draft_params": "the speculative-decoding slice (Queue 1 item 12)",
    "mesh": "the tensor-parallel slice (Queue 1 item 14)",
    "faults": "the resilience slice (Queue 1 item 11)",
}
_SAMPLED = "sampled decoding lands with Queue 1 item 9; this slice is greedy"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (L,) int32
    max_new: int = 32  # output budget (SamplingParams.max_new overrides)
    sampling: Optional[SamplingParams] = None  # None -> engine default
    priority: int = 0  # PriorityScheduler: higher admits first
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None
    # --- lifecycle stamps (perf_counter seconds, filled by the engine) ---
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None

    def stats(self) -> dict:
        """Lifecycle stats (present on the terminal StreamEvent)."""
        n = len(self.out)
        out: dict = {"tokens": n, "finish_reason": self.finish_reason}
        if self.t_submit is not None and self.t_admit is not None:
            out["queue_wait_s"] = self.t_admit - self.t_submit
        if self.t_submit is not None and self.t_first is not None:
            out["ttft_s"] = self.t_first - self.t_submit
        if self.t_first is not None and self.t_done is not None and n > 1:
            dt = self.t_done - self.t_first
            out["decode_tok_s"] = (n - 1) / dt if dt > 0 else float("inf")
        return out


class ServeEngine:
    def __init__(self, params, cfg, *, slots: int = 4, max_len: int = 256,
                 rt: Optional[Runtime] = None, prompt_pad: int = 64,
                 temperature: float = 0.0,
                 sampling: Optional[SamplingParams] = None,
                 scheduler: "str | Scheduler | None" = None,
                 eos_id: Optional[int] = None, device="cuda",
                 paged: bool = False, draft_params=None, mesh=None,
                 faults=None):
        for name, value in (("paged", paged), ("draft_params", draft_params),
                            ("mesh", mesh), ("faults", faults)):
            if value:
                raise NotImplementedError(f"{name}: lands with {_LATER[name]}")
        self.default_sampling = sampling or SamplingParams(
            temperature=float(temperature))
        if not self.default_sampling.greedy:
            raise NotImplementedError(_SAMPLED)
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: this slice serves the dense family")
        # Full f32 products: the port is held to the reference within f32
        # tolerances, which TF32's ~3 significant digits would break.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.rt = rt or Runtime()
        self.slots = slots
        self.max_len = max_len
        self.prompt_pad = prompt_pad
        self.scheduler: Scheduler = get_scheduler(scheduler)
        self.eos_id = eos_id if eos_id is not None else cfg.eos_token_id
        self.cache = lm.init_cache(cfg, slots, max_len,
                                   kv_quant=self.rt.kv_quant,
                                   device=self.device)
        self.pos = np.zeros(slots, dtype=np.int32)  # next write index per slot
        self.active: list[Optional[Request]] = [None] * slots
        self._next_tok = np.zeros(slots, dtype=np.int32)
        self._slot_stop: list[frozenset[int]] = [frozenset()] * slots
        self._slot_max_new: list[int] = [0] * slots
        self._pending_events: list[StreamEvent] = []
        # --- counters (read by stats(), tests and chip_smoke.py) ---
        self.host_syncs = 0       # device->host transfers
        self.tokens_decoded = 0   # tokens emitted by decode steps
        self.decode_steps = 0
        self.prefill_waves = 0
        self.decode_seconds = 0.0   # host wall per step, ending in its sync
        self.prefill_seconds = 0.0  # host wall per wave, ending in its sync
        self.requests_invalid = 0
        self.quarantined = 0

    # --- request lifecycle ------------------------------------------------
    def _resolve(self, req: Request) -> SamplingParams:
        sp = req.sampling or self.default_sampling
        if sp.max_new is None:
            sp = dataclasses.replace(sp, max_new=req.max_new)
        return sp

    def _terminal(self, req: Request, reason: str) -> StreamEvent:
        """Stamp a request done off-slot and queue its terminal event."""
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        req.done = True
        req.finish_reason = reason
        req.t_done = time.perf_counter()
        ev = StreamEvent(req.rid, None, len(req.out), finished=True,
                         finish_reason=reason, stats=req.stats())
        self._pending_events.append(ev)
        return ev

    def submit_request(self, req: Request) -> bool:
        """Enqueue a request with the scheduler. A malformed (empty-prompt)
        request is turned away with a terminal ``error`` event instead."""
        if not self._resolve(req).greedy:
            raise NotImplementedError(_SAMPLED)
        if len(req.prompt) == 0:
            self.requests_invalid += 1
            self._terminal(req, FINISH_ERROR)
            return False
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        self.scheduler.add(req)
        return True

    def cancel(self, rid: int) -> bool:
        """Evict a live slot or drop a queued request; the terminal
        ``cancelled`` event comes on the next ``generate`` tick."""
        req = self.scheduler.cancel(rid)
        if req is not None:
            req.t_done = time.perf_counter()
            self._pending_events.append(StreamEvent(
                rid, None, len(req.out), finished=True,
                finish_reason=FINISH_CANCELLED, stats=req.stats()))
            return True
        for s, r in enumerate(self.active):
            if r is not None and r.rid == rid:
                self._finish_slot(s, r, FINISH_CANCELLED, token=None)
                return True
        return False

    def preempt(self, rid: int) -> bool:
        raise NotImplementedError(f"preemption lands with {_LATER['faults']}")

    def generate(self, requests: Iterable[Request] = ()
                 ) -> Iterator[StreamEvent]:
        """Stream tokens for ``requests`` (plus anything queued or live)
        until everything finishes: one :class:`StreamEvent` per emitted
        token, terminal events carrying the finish reason and stats."""
        for r in requests:
            self.submit_request(r)
        while (self._pending_events or len(self.scheduler)
               or any(r is not None for r in self.active)):
            yield from self._tick()

    def run(self, requests: list[Request]) -> list[Request]:
        """Drive all requests to completion (closed-batch shim over
        :meth:`generate`)."""
        for _ in self.generate(requests):
            pass
        return requests

    def _tick(self) -> list[StreamEvent]:
        events = self._pending_events
        self._pending_events = []
        free = sum(r is None for r in self.active)
        if free and len(self.scheduler):
            wave = self.scheduler.pop(free)
            if wave:
                events += self._admit_bucketed(wave)
        if any(r is not None for r in self.active):
            events += self._step_events()
        return events

    # --- admission --------------------------------------------------------
    def _bucket(self, max_plen: int) -> int:
        pad = (-max_plen) % self.prompt_pad
        # cap padding so the padded prompt always fits the cache
        return max_plen + min(pad, max(0, self.max_len - 1 - max_plen))

    def _admit_bucketed(self, group: list[Request]) -> list[StreamEvent]:
        """Every free slot in ONE padded-bucket prefill: zeroed slot state,
        prefill, first token from the true last-prompt logits."""
        t0 = time.perf_counter()
        free = [s for s in range(self.slots) if self.active[s] is None]
        free = free[:len(group)]
        plens = [int(len(r.prompt)) for r in group]
        bucket = self._bucket(max(plens))
        toks = np.stack([np.pad(np.asarray(r.prompt, np.int32),
                                (0, bucket - p))
                         for r, p in zip(group, plens)])
        sub = lm.init_cache(self.cfg, len(group), self.max_len,
                            kv_quant=self.rt.kv_quant, device=self.device)
        logits, sub = lm.forward(self.params, toks, self.rt, self.cfg,
                                 cache=sub, pos=0,
                                 last_idx=np.asarray(plens) - 1)
        idx = torch.as_tensor(free, device=self.device)
        for k, v in self.cache["attn"].items():
            v.index_copy_(1, idx, sub["attn"][k])
        firsts = lm.sample_tokens(logits[:, 0]).cpu().numpy()  # one transfer
        self.host_syncs += 1
        self.prefill_waves += 1
        now = time.perf_counter()
        self.prefill_seconds += now - t0
        events = []
        for g, (req, s) in enumerate(zip(group, free)):
            first = int(firsts[g])
            sp = self._resolve(req)
            self.pos[s] = plens[g]
            self.active[s] = req
            self._slot_stop[s] = sp.stop_set(self.eos_id)
            self._slot_max_new[s] = int(sp.max_new)
            self._next_tok[s] = first
            req.t_admit = t0
            req.out.append(first)
            req.t_first = now
            events.append(self._emit(s, req, first))
        return events

    # --- decode -----------------------------------------------------------
    def _step_events(self) -> list[StreamEvent]:
        """One greedy decode step for every slot -> one StreamEvent per
        emitted token."""
        t0 = time.perf_counter()
        toks = torch.as_tensor(self._next_tok[:, None], device=self.device)
        positions = torch.as_tensor(self.pos, device=self.device)
        logits, _ = lm.decode_step(self.params, toks, self.cache, positions,
                                   self.rt, self.cfg)
        last = logits[:, 0]
        tok = torch.where(lm.finite_rows(last), lm.sample_tokens(last),
                          torch.full_like(last[:, 0], _POISONED,
                                          dtype=torch.int32))
        tok_np = tok.cpu().numpy()  # THE step's one transfer
        self.host_syncs += 1
        self.decode_steps += 1
        self.decode_seconds += time.perf_counter() - t0
        events = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            tok_s = int(tok_np[s])
            if tok_s == _POISONED:
                # numeric quarantine: finish loudly, re-zero the slot's rows
                self.quarantined += 1
                events.append(self._finish_slot(s, req, FINISH_ERROR,
                                                token=None))
                self._zero_slot(s)
                continue
            req.out.append(tok_s)
            self._next_tok[s] = tok_s
            self.pos[s] += 1
            self.tokens_decoded += 1
            events.append(self._emit(s, req, tok_s))
        return events

    def _zero_slot(self, s: int) -> None:
        for v in self.cache["attn"].values():
            v[:, s].zero_()
        self.pos[s] = 0
        self._next_tok[s] = 0

    def _emit(self, s: int, req: Request, tok: int) -> StreamEvent:
        """Record one emitted token; finishes the slot on stop/length."""
        idx = len(req.out) - 1
        if tok in self._slot_stop[s]:
            return self._finish_slot(s, req, FINISH_STOP, token=tok)
        if (len(req.out) >= self._slot_max_new[s]
                or self.pos[s] >= self.max_len - 1):
            return self._finish_slot(s, req, FINISH_LENGTH, token=tok)
        return StreamEvent(req.rid, tok, idx)

    def _finish_slot(self, s: int, req: Request, reason: str,
                     token: Optional[int]) -> StreamEvent:
        req.done = True
        req.finish_reason = reason
        req.t_done = time.perf_counter()
        self.active[s] = None
        self._slot_stop[s] = frozenset()
        # tokenless terminal events index one past the stream
        idx = len(req.out) - 1 if token is not None else len(req.out)
        ev = StreamEvent(req.rid, token, idx, finished=True,
                         finish_reason=reason, stats=req.stats())
        if reason == FINISH_CANCELLED:
            self._pending_events.append(ev)
        return ev

    # --- accounting -------------------------------------------------------
    @property
    def cache_bytes(self) -> int:
        return int(sum(a.numel() * a.element_size()
                       for a in self.cache["attn"].values()))

    def stats(self) -> dict:
        """Counters for tests and ``chip_smoke.py``. Times are host wall
        seconds around work that ends in the step's device->host transfer,
        so they include the device time."""
        n_pos = self.cache["attn"]["k"].shape[3]
        return {
            "host_syncs": self.host_syncs,
            "tokens_decoded": self.tokens_decoded,
            "syncs_per_token": (self.host_syncs / self.tokens_decoded
                                if self.tokens_decoded else float("nan")),
            "decode_steps": self.decode_steps,
            "decode_seconds": self.decode_seconds,
            "prefill_waves": self.prefill_waves,
            "prefill_seconds": self.prefill_seconds,
            "cache_bytes": self.cache_bytes,
            "cache_bytes_per_token": self.cache_bytes / (self.slots * n_pos),
            "scheduler": getattr(self.scheduler, "name",
                                 type(self.scheduler).__name__),
            "waiting": len(self.scheduler),
            "requests_invalid": self.requests_invalid,
            "quarantined": self.quarantined,
            "backend": self.rt.backend,
            "kv_quant": self.rt.kv_quant,
            "act_quant": self.rt.act_quant,
        }
