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
  zeroed sub-cache that is copied into the admitted slots (paged: straight
  into the pool through the admitted slots' block-table rows), and each
  prompt's first token comes from its true last-prompt-token logits.
* **Numeric quarantine.** A slot whose logits row is not finite reports
  the in-band ``-1`` sentinel instead of a token (riding the same
  transfer); it finishes with ``finish_reason="error"`` and its cache rows
  are re-zeroed (paged: the blocks it held alone).
* **Paged KV cache** (``paged=True``, ``serve/paged.py``). Cache positions
  come from a shared ref-counted block pool instead of a per-slot
  ``max_len`` reservation. Admission allocates each prompt's block chain
  (full prefix blocks shared by chain hash), requeues a prompt the pool
  cannot hold now and error-finishes one it can never hold; each decode
  step first grows the chains whose next write crosses a block boundary,
  preempting a victim when the pool runs dry.
* **Preemption.** :meth:`preempt` (or the scheduler's ``should_preempt``
  hook, when every slot is busy) swaps a live slot's cache rows (paged:
  its blocks) to host in one device->host copy, not counted as a step
  sync, frees the slot and requeues the request; re-admission scatters the
  rows back and decoding continues bit-identically, with no re-prefill.

This slice serves greedy requests. Sampled decoding, speculative decoding,
tensor-parallel meshes, fault injection and deadlines land with later
slices and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.layers import Runtime
from repro_torch.serve import paged as paged_mod
from repro_torch.serve.sampling import (
    FINISH_CANCELLED, FINISH_ERROR, FINISH_LENGTH, FINISH_STOP,
    SamplingParams, StreamEvent,
)
from repro_torch.serve.scheduler import Scheduler, get_scheduler

__all__ = ["Request", "ServeEngine", "SamplingParams", "StreamEvent"]

# In-band numeric-health sentinel (token ids are always >= 0).
_POISONED = -1

_LATER = {
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
    preemptions: int = 0  # times this request was swapped out mid-flight
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
        if self.preemptions:
            out["preemptions"] = self.preemptions
        return out


class ServeEngine:
    def __init__(self, params, cfg, *, slots: int = 4, max_len: int = 256,
                 rt: Optional[Runtime] = None, prompt_pad: int = 64,
                 temperature: float = 0.0,
                 sampling: Optional[SamplingParams] = None,
                 scheduler: "str | Scheduler | None" = None,
                 eos_id: Optional[int] = None, device="cuda",
                 paged: bool = False, num_blocks: Optional[int] = None,
                 block_size: int = 16, draft_params=None, mesh=None,
                 faults=None):
        for name, value in (("draft_params", draft_params), ("mesh", mesh),
                            ("faults", faults)):
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
        self.paged = bool(paged)
        if self.paged:
            if not self.rt.kv_quant:
                raise ValueError(
                    "paged=True requires Runtime(kv_quant=True): the block "
                    "pool is laid out over the rotated-int8 codes and scale "
                    "planes")
            self.block_size = int(block_size)
            # table width: entries for every position a slot can reach
            self._maxb = -(-max_len // self.block_size)
            if num_blocks is None:
                # dense-equivalent capacity plus the null block
                num_blocks = slots * self._maxb + 1
            self.num_blocks = int(num_blocks)
            self.pool = paged_mod.BlockPool(self.num_blocks, self.block_size)
            self._table = np.zeros((slots, self._maxb), np.int32)
            self._slot_blocks: list[list[int]] = [[] for _ in range(slots)]
            self.cache = paged_mod.init_paged_cache(
                cfg, self.num_blocks, self.block_size, device=self.device)
        else:
            self.block_size = self.num_blocks = self.pool = None
            self.cache = lm.init_cache(cfg, slots, max_len,
                                       kv_quant=self.rt.kv_quant,
                                       device=self.device)
        # rid -> swap entry of a request preempted mid-flight
        self._swapped: dict[int, dict] = {}
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
        self.preemptions = 0      # live slots swapped out mid-flight
        self.resumes = 0          # swapped requests scattered back in
        self.max_concurrent = 0   # peak simultaneously decoding requests
        self.blocks_swapped = 0   # paged: blocks host-swapped by preemption
        self.pool_exhausted = 0   # paged: requests error-finished, pool dry

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
            self._swapped.pop(rid, None)  # preempted and requeued, now dead
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
        """Swap a LIVE request out mid-flight: its cache rows (paged: its
        blocks) go to host in one copy with its stream state, the slot is
        freed without a terminal event, and the request goes back to the
        scheduler. Re-admission scatters the rows back and decoding
        continues bit-identically, with no re-prefill. False for a rid
        that is not live."""
        for s, req in enumerate(self.active):
            if req is not None and req.rid == rid:
                break
        else:
            return False
        entry = {"pos": int(self.pos[s]), "next_tok": int(self._next_tok[s])}
        if self.paged:
            # the entry is self-contained, so the blocks can be reused at
            # once; resume scatters into fresh blocks
            blocks = list(self._slot_blocks[s])
            entry.update(cache=_take_slots(self.cache["attn"], blocks),
                         nblocks=len(blocks))
            self.blocks_swapped += len(blocks)
            self._release_blocks(s, zero=False)
        else:
            entry["cache"] = _take_slots(self.cache["attn"], [s])
        self._swapped[rid] = entry
        self.active[s] = None
        self._slot_stop[s] = frozenset()
        req.preemptions += 1
        self.preemptions += 1
        self.scheduler.add(req)
        return True

    def _release_blocks(self, s: int, *, zero: bool) -> None:
        """Drop slot ``s``'s block references and clear its table row.
        ``zero`` (quarantine) first zeroes the blocks the slot holds alone:
        NaN is the one garbage the kv_len mask cannot neutralize, and a
        shared block holds clean prompt codes another holder still reads."""
        blocks = self._slot_blocks[s]
        if zero:
            paged_mod.zero_blocks(
                self.cache, [b for b in blocks if self.pool.ref[b] == 1])
        for b in blocks:
            self.pool.decref(b)
        self._slot_blocks[s] = []
        self._table[s, :] = paged_mod.NULL_BLOCK

    def _resume_slot(self, req: Request, s: int) -> bool:
        """Scatter a swapped request's rows back into slot ``s`` and rebind
        its stream state (lifecycle stamps are kept). True when the slot
        was consumed; a paged engine returns False when the pool cannot
        supply the blocks now (requeued, swap entry kept) or ever
        (error-finished)."""
        sw = self._swapped[req.rid]
        if self.paged:
            n = sw["nblocks"]
            if n > self.pool.capacity:
                self._swapped.pop(req.rid)
                self.pool_exhausted += 1
                self._terminal(req, FINISH_ERROR)
                return False
            blocks: list[int] = []
            try:
                for _ in range(n):
                    blocks.append(self.pool.alloc())
            except paged_mod.PoolExhausted:
                for b in blocks:
                    self.pool.decref(b)
                self.scheduler.add(req)  # retry when blocks free up
                return False
            self._swapped.pop(req.rid)
            _put_slots(self.cache["attn"], sw["cache"], blocks)
            self._slot_blocks[s] = blocks
            self._table[s, :] = paged_mod.NULL_BLOCK
            self._table[s, :n] = blocks
        else:
            self._swapped.pop(req.rid)
            _put_slots(self.cache["attn"], sw["cache"], [s])
        self._install_slot(s, req, self._resolve(req), pos=sw["pos"],
                           next_tok=sw["next_tok"])
        self.resumes += 1
        return True

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
        self._maybe_preempt()
        free = sum(r is None for r in self.active)
        if free and len(self.scheduler):
            wave = self.scheduler.pop(free)
            if wave:
                events += self._admit_group(wave)
        if any(r is not None for r in self.active):
            events += self._step_events()
        return events

    def _maybe_preempt(self) -> None:
        """Let the scheduler evict live work for higher-priority waiting
        work, only when every slot is busy."""
        hook = getattr(self.scheduler, "should_preempt", None)
        if hook is None or not len(self.scheduler):
            return
        for _ in range(self.slots):
            if any(r is None for r in self.active):
                return
            rid = hook([r for r in self.active if r is not None])
            if rid is None or not self.preempt(rid):
                return

    # --- admission --------------------------------------------------------
    def _bucket(self, max_plen: int) -> int:
        pad = (-max_plen) % self.prompt_pad
        # cap padding so the padded prompt always fits the cache
        return max_plen + min(pad, max(0, self.max_len - 1 - max_plen))

    def _admit_group(self, group: list[Request]) -> list[StreamEvent]:
        """Resume swapped requests, allocate fresh prompts' block chains
        (paged), then prefill the fresh ones in one wave."""
        free = [s for s in range(self.slots) if self.active[s] is None]
        events: list[StreamEvent] = []
        fresh: list[Request] = []
        for r in group:
            if r.rid in self._swapped:
                if self._resume_slot(r, free[0]):
                    free.pop(0)
            else:
                fresh.append(r)
        if self.paged and fresh:
            admitted: list[Request] = []
            for r in fresh:
                s = free[len(admitted)]
                try:
                    blocks = self.pool.alloc_prompt(r.prompt)
                except paged_mod.PoolExhausted:
                    if -(-len(r.prompt) // self.block_size) > \
                            self.pool.capacity:
                        self.pool_exhausted += 1  # can never fit
                        events.append(self._terminal(r, FINISH_ERROR))
                        self._pending_events.pop()  # delivered now
                    else:
                        self.scheduler.add(r)  # retry when blocks free
                    continue
                self._slot_blocks[s] = blocks
                self._table[s, :] = paged_mod.NULL_BLOCK
                self._table[s, :len(blocks)] = blocks
                admitted.append(r)
            fresh = admitted
        if not fresh:
            return events
        return events + self._admit_bucketed(fresh, free[:len(fresh)])

    def _admit_bucketed(self, group: list[Request],
                        free: list[int]) -> list[StreamEvent]:
        """The slots ``free`` in ONE padded-bucket prefill: zeroed slot
        state (dense) or the slots' fresh blocks (paged), prefill, first
        token from the true last-prompt logits."""
        t0 = time.perf_counter()
        plens = [int(len(r.prompt)) for r in group]
        bucket = self._bucket(max(plens))
        toks = np.stack([np.pad(np.asarray(r.prompt, np.int32),
                                (0, bucket - p))
                         for r, p in zip(group, plens)])
        last_idx = np.asarray(plens) - 1
        if self.paged:
            # writes scatter through the admitted slots' table rows: fresh
            # blocks may hold a finished request's finite codes, which the
            # kv_len mask weighs by exactly 0
            table = torch.as_tensor(self._table[free], device=self.device)
            logits, _ = lm.forward(self.params, toks, self.rt, self.cfg,
                                   cache={"attn": self.cache["attn"],
                                          "table": table},
                                   pos=0, last_idx=last_idx)
        else:
            sub = lm.init_cache(self.cfg, len(group), self.max_len,
                                kv_quant=self.rt.kv_quant, device=self.device)
            logits, sub = lm.forward(self.params, toks, self.rt, self.cfg,
                                     cache=sub, pos=0, last_idx=last_idx)
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
            self._install_slot(s, req, self._resolve(req), pos=plens[g],
                               next_tok=first)
            req.t_admit = t0
            req.out.append(first)
            req.t_first = now
            events.append(self._emit(s, req, first))
        return events

    def _install_slot(self, s: int, req: Request, sp: SamplingParams, *,
                      pos: int, next_tok: int) -> None:
        """Bind a request to a slot (fresh admission and resume)."""
        self.pos[s] = pos
        self.active[s] = req
        self._slot_stop[s] = sp.stop_set(self.eos_id)
        self._slot_max_new[s] = int(sp.max_new)
        self._next_tok[s] = next_tok

    # --- decode -----------------------------------------------------------
    def _step_events(self) -> list[StreamEvent]:
        """One greedy decode step for every slot -> one StreamEvent per
        emitted token."""
        t0 = time.perf_counter()
        events: list[StreamEvent] = []
        cache = self.cache
        if self.paged:
            # grow chains whose next write crosses a block boundary; a dry
            # pool can finish slots, so check liveness again
            events = self._ensure_decode_blocks()
            if not any(r is not None for r in self.active):
                return events
            cache = {"attn": self.cache["attn"],
                     "table": torch.as_tensor(self._table, device=self.device)}
        self.max_concurrent = max(self.max_concurrent,
                                  sum(r is not None for r in self.active))
        toks = torch.as_tensor(self._next_tok[:, None], device=self.device)
        positions = torch.as_tensor(self.pos, device=self.device)
        logits, _ = lm.decode_step(self.params, toks, cache, positions,
                                   self.rt, self.cfg)
        last = logits[:, 0]
        tok = torch.where(lm.finite_rows(last), lm.sample_tokens(last),
                          torch.full_like(last[:, 0], _POISONED,
                                          dtype=torch.int32))
        tok_np = tok.cpu().numpy()  # THE step's one transfer
        self.host_syncs += 1
        self.decode_steps += 1
        self.decode_seconds += time.perf_counter() - t0
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

    def _ensure_decode_blocks(self) -> list[StreamEvent]:
        """Before a paged step every live slot must own the block its next
        write lands in. On a dry pool, preempt a victim (lowest priority,
        newest admission); with no victim the slot itself error-finishes."""
        events: list[StreamEvent] = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            need = paged_mod.blocks_needed(self.pos[s], self.block_size)
            while len(self._slot_blocks[s]) < need:
                try:
                    blk = self.pool.alloc()
                except paged_mod.PoolExhausted:
                    victim = self._pick_victim(exclude=s)
                    if victim is not None and self.preempt(victim):
                        continue  # the victim's blocks are free now
                    self.pool_exhausted += 1
                    events.append(self._finish_slot(s, req, FINISH_ERROR,
                                                    token=None))
                    break  # _finish_slot released this slot's blocks
                self._slot_blocks[s].append(blk)
                self._table[s, len(self._slot_blocks[s]) - 1] = blk
        return events

    def _pick_victim(self, *, exclude: int) -> Optional[int]:
        """rid to preempt on a dry pool: lowest priority first, newest
        admission on ties (the least sunk prefill work)."""
        best = None
        for s, r in enumerate(self.active):
            if r is None or s == exclude:
                continue
            key = (int(r.priority), -(r.t_admit or 0.0))
            if best is None or key < best[0]:
                best = (key, r.rid)
        return best[1] if best else None

    def _zero_slot(self, s: int) -> None:
        """Quarantine cleanup of a dense slot's rows; a paged slot's
        blocks were zeroed and freed by ``_finish_slot``."""
        if not self.paged:
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
        if self.paged:
            # blocks return to the pool when the stream ends; quarantine
            # zeroes the exclusively held ones first
            self._release_blocks(s, zero=(reason == FINISH_ERROR))
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
        so they include the device time. ``cache_bytes_reserved`` is what
        requests claim (the whole dense cache; a pool's allocated blocks),
        ``cache_bytes_live`` the bytes of the live slots' positions."""
        if self.paged:
            n_tokens_cap = self.num_blocks * self.block_size
        else:
            n_tokens_cap = self.slots * self.cache["attn"]["k"].shape[3]
        bytes_per_token = self.cache_bytes / n_tokens_cap
        live_tokens = sum(int(self.pos[s]) for s, r in enumerate(self.active)
                          if r is not None)
        reserved = (bytes_per_token * self.pool.used() * self.block_size
                    if self.paged else self.cache_bytes)
        out = {
            "host_syncs": self.host_syncs,
            "tokens_decoded": self.tokens_decoded,
            "syncs_per_token": (self.host_syncs / self.tokens_decoded
                                if self.tokens_decoded else float("nan")),
            "decode_steps": self.decode_steps,
            "decode_seconds": self.decode_seconds,
            "prefill_waves": self.prefill_waves,
            "prefill_seconds": self.prefill_seconds,
            "cache_bytes": self.cache_bytes,
            "cache_bytes_reserved": int(reserved),
            "cache_bytes_live": int(bytes_per_token * live_tokens),
            "cache_bytes_per_token": bytes_per_token,
            "scheduler": getattr(self.scheduler, "name",
                                 type(self.scheduler).__name__),
            "waiting": len(self.scheduler),
            "requests_invalid": self.requests_invalid,
            "quarantined": self.quarantined,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "max_concurrent": self.max_concurrent,
            "backend": self.rt.backend,
            "kv_quant": self.rt.kv_quant,
            "act_quant": self.rt.act_quant,
        }
        if self.paged:
            out.update(
                paged=True,
                block_size=self.block_size,
                pool_blocks=self.pool.capacity,
                pool_blocks_used=self.pool.used(),
                pool_utilization=round(self.pool.utilization(), 4),
                blocks_swapped=self.blocks_swapped,
                pool_exhausted=self.pool_exhausted,
                prefix_hits=self.pool.prefix_hits,
            )
        return out


# --- slot swap: gather to host, scatter back ---------------------------------

def _take_slots(attn: dict, idx: list[int]):
    """Rows ``idx`` of axis 1 (slots, or pool blocks) of every cache leaf,
    gathered on the device and moved to host memory in ONE copy: a flat
    uint8 buffer and each leaf's (key, dtype, shape). The int8 codes and
    fp16 scales round-trip bit for bit."""
    keys = sorted(attn)
    index = torch.as_tensor(idx, dtype=torch.int64,
                            device=attn[keys[0]].device)
    parts = [attn[k].index_select(1, index) for k in keys]
    flat = torch.cat([p.reshape(-1).view(torch.uint8) for p in parts]).cpu()
    return flat, [(k, p.dtype, tuple(p.shape)) for k, p in zip(keys, parts)]


def _put_slots(attn: dict, swap, idx: list[int]) -> None:
    """Scatter a :func:`_take_slots` entry into rows ``idx`` of axis 1 of
    every leaf, in place (one host->device copy)."""
    flat, layout = swap
    dev = attn[layout[0][0]].device
    flat = flat.to(dev)
    index = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    off = 0
    for key, dtype, shape in layout:
        n = math.prod(shape) * dtype.itemsize
        attn[key].index_copy_(1, index,
                              flat[off:off + n].view(dtype).reshape(shape))
        off += n
