"""Serving engine core (port of ``repro/serve/engine.py``): continuous
batching over a fixed slot-batched KV cache, greedy and sampled decoding,
and the resilience layer.

``ServeEngine`` owns a (slots x max_len) cache and admits requests
continuously: whenever slots free up, the scheduler's next wave is
prefilled in one padded-bucket call while the other slots keep decoding.

Hot-path discipline, as in the reference:

* **One device->host transfer per step.** Sampling and a per-slot
  finiteness check run on the device; ``_step_events`` fetches one
  (slots,) int32 vector. ``host_syncs`` counts every transfer (one per
  admission wave, one per decode step). Each slot samples under its own
  temperature / top-k / top-p and its request's own threefry key
  (``SamplingParams.key_data``), folded on the host with the request-local
  token index (0 for the prefill's first token, ``len(out)`` on decode):
  a request's stream depends only on its params, prompt, sampling knobs
  and seed, never on its slot or its batchmates, and equals the
  reference's (``core/prng.py`` is JAX's threefry). A step or wave with no
  sampled row runs a bare argmax with no PRNG op. ``sample_on_host=True``
  is the reference's measured baseline: logits rows fetched one per live
  slot and argmaxed on the host.
* **In-place cache.** The cache is allocated once; decode writes one
  token slice per layer into it (the reference's donated buffers). No
  path reallocates it, so after the first step ``cache_donated`` is True
  and ``cache_bytes_moved`` stays 0 (the tests hold every cache leaf's
  ``data_ptr()`` across waves and steps).
* **One call per admission wave.** All free slots are admitted together:
  prompts are padded to one shared ``prompt_pad`` bucket, prefilled into a
  zeroed sub-cache that is copied into the admitted slots (paged: straight
  into the pool through the admitted slots' block-table rows), and each
  prompt's first token comes from its true last-prompt-token logits.
* **The chunk ladder for recurrent families** (``ssm``, ``hybrid``).
  Recurrent state integrates every fed token, so pad tokens would pollute
  it: each admitted request is fed at its exact length in power-of-two
  chunks (``prompt_chunk``, then halves), straight into its slot's rows.
  The first chunk starts from a zeroed slot (state and KV rows), the
  later ones continue from its state; the head runs on the last chunk
  only, and its first token costs one host sync per request.
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
  hook, when every slot is busy) swaps a live slot's rows of every cache
  leaf, recurrent state included (paged: its blocks), to host in one
  device->host copy, not counted as a step sync, frees the slot and
  requeues the request; re-admission scatters the rows back and decoding
  continues bit-identically, with no re-prefill.

Resilience, as in the reference (every failure ends in a terminal
StreamEvent with its finish reason):

* **Deadlines.** ``Request.deadline_ms`` (submit to done) and
  ``decode_timeout_ms`` (first token to done), on the injectable ``clock``:
  a queued request past its deadline is shed when popped, with no
  prefill; a live one finishes with ``deadline`` before its next token.
* **Backpressure.** ``max_queue`` bounds the waiting queue; on overflow
  ``shed_policy="reject"`` turns the newcomer away and ``"shed_lowest"``
  drops the lowest-priority waiting request instead (the newcomer is
  rejected when it ranks lowest), both as ``rejected``.
* **Watchdog.** ``watchdog_timeout_s`` arms a ``ft/monitor.py``
  heartbeat that each decode step beats; a step later than the timeout
  counts in ``stalled_steps``.
* **Fault injection.** ``faults=`` takes a ``serve/faults.py``
  ``FaultPlan``: its ``before_decode`` runs at the top of each decode step
  and, without an explicit ``clock``, the engine reads the plan's.

Speculative decoding (``draft_params``, ``draft_cfg``,
``num_draft_tokens``; ``serve/spec.py``): the decode tick becomes a
propose / verify / commit window. The draft (often a layer prefix of the
target, ``spec.draft_from_params``) proposes K candidates per slot from its
own dense cache; one ``lm.score_tokens`` pass runs the target over the K+1
window positions (under ``kv_quant`` one ``prefill_attn_q8`` per layer,
dense or paged); ``spec.verify_commit`` picks each slot's accepted prefix
and one window-end token on the device, and the whole (S, K+1) window and
the (S,) counts come back in one transfer. The caches are ``max_len + K``
positions long (paged: the table that wide), so a verify span never
clamps; paged slots grow their chains by their window before it. Greedy
streams equal the non-speculative engine's; a slot with ``draft=False``
or ``draft_tokens=0`` rides the window with no proposal and commits the
non-speculative stream, sampled ones included. Deadlines, cancellation,
preemption (the draft's rows ride the swap entry) and quarantine land at
window boundaries.

The frontend families are served as the reference serves them: requests
carry tokens only. A vlm serves text with its longer cache (``max_len +
frontend_len`` positions; the paged table is that wide), and ``stats()``
prices a position by the cache's real length. An audio model is built
like any other, and its first admission raises the model's "seamless
needs encoder frames" (``lm.forward`` without frames), where the
reference's does.

Tensor-parallel serving (``mesh``, ``serve/tp.py``; one process per rank
on ``torch.distributed``, every rank running this engine on the same
requests): the params are placed column-sharded (and the MoE stacks
expert-parallel), the caches head-sharded from their allocation (the
per-wave prefill sub-cache and the draft's too), and ``rt`` carries the
serving rules, so each projection and attention runs the card's kernels
on this rank's shard and gathers the result. Logits come out whole and
identical on every rank, so every rank samples the same tokens and keeps
the same slot state. The engine's clock is rank 0's
(:class:`~repro_torch.serve.tp.LockstepClock`): it is read once per tick
and broadcast, so deadlines, the watchdog, queue shedding and faults are
decided on the same time, in the same order, on every rank; with no mesh
the engine reads its clock as before. ``from_checkpoint(mesh=...)``
restores each leaf straight into this rank's shard.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.ft.monitor import HeartbeatMonitor
from repro_torch.models import lm
from repro_torch.models.layers import Runtime
from repro_torch.serve import paged as paged_mod
from repro_torch.serve import spec as spec_mod
from repro_torch.serve.sampling import (
    FINISH_CANCELLED, FINISH_DEADLINE, FINISH_ERROR, FINISH_LENGTH,
    FINISH_REJECTED, FINISH_STOP, SamplingParams, StreamEvent,
)
from repro_torch.serve.scheduler import Scheduler, get_scheduler

__all__ = ["Request", "ServeEngine", "SamplingParams", "StreamEvent"]

# In-band numeric-health sentinel (token ids are always >= 0).
_POISONED = -1

_RECURRENT = ("ssm", "hybrid")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (L,) int32
    max_new: int = 32  # output budget (SamplingParams.max_new overrides)
    sampling: Optional[SamplingParams] = None  # None -> engine default
    priority: int = 0  # PriorityScheduler: higher admits first
    # --- SLO budgets on the engine clock (None disables) ---
    deadline_ms: Optional[float] = None  # submit -> done
    decode_timeout_ms: Optional[float] = None  # first token -> done (time
    #   swapped out by preemption counts: the caller's clock, not the slot's)
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None
    preemptions: int = 0  # times this request was swapped out mid-flight
    # --- speculative accounting (filled by the engine) ---
    drafted: int = 0       # draft tokens proposed for this request
    accepted: int = 0      # of those, tokens the verifier committed
    spec_windows: int = 0  # propose / verify / commit windows executed
    # --- lifecycle stamps (engine clock seconds, filled by the engine) ---
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
        if self.drafted:
            out["draft_proposed"] = self.drafted
            out["draft_accepted"] = self.accepted
            out["acceptance_rate"] = self.accepted / self.drafted
        return out


class ServeEngine:
    def __init__(self, params, cfg, *, slots: int = 4, max_len: int = 256,
                 rt: Optional[Runtime] = None, prompt_pad: int = 64,
                 prompt_chunk: int = 16, temperature: float = 0.0,
                 seed: int = 0,
                 sample_on_host: bool = False,
                 sampling: Optional[SamplingParams] = None,
                 scheduler: "str | Scheduler | None" = None,
                 eos_id: Optional[int] = None, device="cuda",
                 clock=None, max_queue: Optional[int] = None,
                 shed_policy: str = "reject",
                 watchdog_timeout_s: Optional[float] = None, faults=None,
                 paged: bool = False, num_blocks: Optional[int] = None,
                 block_size: int = 16, draft_params=None, draft_cfg=None,
                 draft_rt: Optional[Runtime] = None,
                 num_draft_tokens: int = 4, mesh=None,
                 tp_shard_map: Optional[bool] = None,
                 params_placed: bool = False):
        # --- speculative decoding (serve/spec.py), refused as the
        # reference refuses it ---
        self.spec = draft_params is not None
        if self.spec:
            if draft_cfg is None:
                raise ValueError("draft_params needs a draft_cfg")
            if sample_on_host:
                raise ValueError(
                    "sample_on_host is the measured baseline; speculative "
                    "decoding needs on-device sampling (the accept/commit "
                    "decision rides the window's one token transfer)")
            if num_draft_tokens < 1:
                raise ValueError(
                    f"num_draft_tokens must be >= 1, got {num_draft_tokens}")
            for c, role in ((cfg, "target"), (draft_cfg, "draft")):
                if c.family not in ("dense", "vlm", "moe"):
                    raise ValueError(
                        f"speculative decoding needs pure-attention "
                        f"families (dense/vlm/moe); the {role} is "
                        f"{c.family!r} — recurrent state cannot roll back "
                        f"a rejected window (positional cache indexing is "
                        f"what makes rejection free)")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}: acceptance compares distributions "
                    f"over the same token ids")
        # Full f32 products: the port is held to the reference within f32
        # tolerances, which TF32's ~3 significant digits would break.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.rt = rt or Runtime()
        self.mesh = mesh
        if mesh is not None:
            # tensor-parallel serving (serve/tp.py): the serving rules in
            # the Runtime, this rank's shards of the params (unless a
            # restore-to-sharding already placed them) on the mesh device
            from repro_torch.launch.mesh import check_serving_mesh
            from repro_torch.serve import tp as tp_mod
            check_serving_mesh(mesh)
            if tp_shard_map is False:
                raise ValueError(
                    "tp_shard_map=False is the reference's GSPMD form, "
                    "which PyTorch has no counterpart of: the port runs "
                    "the kernels on explicit shards")
            device = mesh.device
            rules = tp_mod.serve_rules(mesh, cfg)
            self.rt = dataclasses.replace(self.rt, rules=rules)
            if not params_placed:
                params = tp_mod.shard_params(params, cfg, rules)
            if self.spec:
                draft_params, draft_rt = tp_mod.place_draft(
                    draft_params, draft_cfg, mesh,
                    draft_rt or dataclasses.replace(self.rt, rules=None),
                    placed=params_placed)
        self.device = torch.device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self._spec_k = int(num_draft_tokens) if self.spec else 0
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params if self.spec else None
        self.draft_rt = (draft_rt or self.rt) if self.spec else None
        # the write horizon: a verify span starting at pos <= max_len - 2
        # writes K+1 positions, so every cache reaches max_len + K
        self._cache_len = max_len + self._spec_k
        self.slots = slots
        self.max_len = max_len
        self.prompt_pad = prompt_pad
        self.prompt_chunk = int(prompt_chunk)
        self.seed = int(seed)
        self.sample_on_host = bool(sample_on_host)
        # the engine default for requests without their own; the legacy
        # temperature knob folds into it (and stays live as a property)
        self.default_sampling = sampling or SamplingParams(
            temperature=float(temperature))
        self.scheduler: Scheduler = get_scheduler(scheduler)
        self.eos_id = eos_id if eos_id is not None else cfg.eos_token_id
        # --- resilience layer ---
        self.faults = faults
        if clock is None and faults is not None:
            clock = getattr(faults, "clock", None)  # deterministic test time
        self._clock = clock or time.perf_counter
        if mesh is not None:
            self._clock = tp_mod.LockstepClock(self._clock, mesh)
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if shed_policy not in ("reject", "shed_lowest"):
            raise ValueError(
                f"shed_policy must be 'reject' or 'shed_lowest', "
                f"got {shed_policy!r}")
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.watchdog = None
        if watchdog_timeout_s is not None:
            self.watchdog = HeartbeatMonitor(
                1, timeout_s=float(watchdog_timeout_s), clock=self._clock)
        self.paged = bool(paged)
        if self.paged:
            if not self.rt.kv_quant:
                raise ValueError(
                    "paged=True requires Runtime(kv_quant=True): the block "
                    "pool is laid out over the rotated-int8 codes and scale "
                    "planes")
            self.block_size = int(block_size)
            # table width: entries for every position a slot can reach (a
            # vlm's cache also holds its frontend_len prefix positions, as
            # the reference counts them, though text-only serving never
            # writes them)
            n_pos = self._cache_len + (cfg.frontend_len if cfg.frontend
                                       else 0)
            self._maxb = -(-n_pos // self.block_size)
            if num_blocks is None:
                # dense-equivalent capacity plus the null block
                num_blocks = slots * self._maxb + 1
            self.num_blocks = int(num_blocks)
            self.pool = paged_mod.BlockPool(self.num_blocks, self.block_size)
            self._table = np.zeros((slots, self._maxb), np.int32)
            self._slot_blocks: list[list[int]] = [[] for _ in range(slots)]
            self.cache = self._placed(lambda dev: paged_mod.init_paged_cache(
                cfg, self.num_blocks, self.block_size, device=dev), cfg,
                self.rt)
        else:
            self.block_size = self.num_blocks = self.pool = None
            self.cache = self._new_cache(cfg, slots, self.rt)
        # the draft's own cache: always dense (the draft is small), with the
        # same horizon, so a fully accepted window's last proposal is cached
        self.draft_cache = (self._new_cache(draft_cfg, slots, self.draft_rt)
                            if self.spec else None)
        # rid -> swap entry of a request preempted mid-flight
        self._swapped: dict[int, dict] = {}
        self.pos = np.zeros(slots, dtype=np.int32)  # next write index per slot
        self.active: list[Optional[Request]] = [None] * slots
        self._next_tok = np.zeros(slots, dtype=np.int32)
        # --- per-slot sampling state, sent up with each step's tokens ---
        self._temp = np.zeros(slots, np.float32)
        self._top_k = np.zeros(slots, np.int32)
        self._top_p = np.ones(slots, np.float32)
        self._keys = np.zeros((slots, 2), np.uint32)
        self._slot_stop: list[frozenset[int]] = [frozenset()] * slots
        self._slot_max_new: list[int] = [0] * slots
        # per-slot window size (0: one token; always 0 without a draft)
        self._slot_draft_k = np.zeros(slots, np.int32)
        self._pending_events: list[StreamEvent] = []
        # --- counters (read by stats(), tests and chip_smoke.py) ---
        self.host_syncs = 0       # device->host transfers
        self.tokens_decoded = 0   # tokens emitted by decode steps
        self.decode_steps = 0
        self.prefill_waves = 0
        self.decode_seconds = 0.0   # host wall per step, ending in its sync
        self.prefill_seconds = 0.0  # host wall per wave, ending in its sync
        self.prefill_chunks = 0     # ladder calls (recurrent families)
        self.requests_rejected = 0  # backpressure: newcomer turned away
        self.requests_shed = 0      # backpressure: waiting victim dropped
        self.requests_invalid = 0
        self.deadline_expired = 0   # queued or live deadline expiries
        self.quarantined = 0
        self.preemptions = 0      # live slots swapped out mid-flight
        self.resumes = 0          # swapped requests scattered back in
        self.stalled_steps = 0    # decode steps later than the watchdog
        self.max_concurrent = 0   # peak simultaneously decoding requests
        self.blocks_swapped = 0   # paged: blocks host-swapped by preemption
        self.pool_exhausted = 0   # paged: requests error-finished, pool dry
        self.cache_donated = False  # True from the first step: in place
        self.cache_bytes_moved = 0  # no step copies the cache
        self.spec_steps = 0       # propose / verify / commit windows
        self.draft_proposed = 0   # draft tokens offered for verification
        self.draft_accepted = 0   # of those, tokens committed
        if self.spec:
            # SJF prices a request by its expected slot occupancy: a draft
            # window commits up to K+1 tokens per step
            set_cost = getattr(self.scheduler, "set_cost", None)
            if set_cost is not None:
                set_cost(self._admission_cost)

    def _placed(self, build, cfg, rt: Runtime) -> dict:
        """A zeroed cache from ``build(device)``: on this engine's device,
        or, under a mesh, only this rank's slices of it (built whole on
        the ``meta`` device first, so nothing whole is allocated)."""
        if rt.rules is None:
            return build(self.device)
        from repro_torch.serve import tp as tp_mod
        return tp_mod.init_cache(build("meta"), cfg, rt.rules)

    def _new_cache(self, cfg, batch: int, rt: Runtime) -> dict:
        """A zeroed dense cache of ``batch`` slots over the engine's
        horizon, for ``cfg`` under ``rt``."""
        return self._placed(lambda dev: lm.init_cache(
            cfg, batch, self._cache_len, kv_quant=rt.kv_quant, device=dev),
            cfg, rt)

    @property
    def temperature(self) -> float:
        """The engine-default temperature; setting it changes the default
        for requests admitted later."""
        return self.default_sampling.temperature

    @temperature.setter
    def temperature(self, value: float) -> None:
        self.default_sampling = dataclasses.replace(
            self.default_sampling, temperature=float(value))

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, cfg, *, step: Optional[int] = None,
                        mesh=None, draft_depth: int = 0, device="cuda",
                        **kw) -> "ServeEngine":
        """Boot an engine from a bare checkpoint directory (the reference's
        layout). A policy-quantized tree's QTensors are rebuilt from their
        packed planes and metas, with no template and no second run of
        Algorithm 1. With ``draft_depth`` > 0 the engine speculates, its
        draft the ``draft_depth``-layer prefix of the restored tree
        (:func:`serve.spec.draft_from_params`; the launcher's
        ``--draft-depth``).

        With ``mesh``, each leaf goes into this rank's serving shard AS IT
        LOADS (restore-to-sharding, :func:`serve.tp.restore_shardings`):
        each packed plane's local rows are read off a memory-mapped file
        and sent to ``mesh.device``, so the whole plane set is never one
        tensor anywhere."""
        from repro_torch.checkpoint import ckpt as ckpt_mod

        shardings = None
        if mesh is not None:
            from repro_torch.launch.mesh import check_serving_mesh
            from repro_torch.serve import tp as tp_mod
            check_serving_mesh(mesh)
            shardings = tp_mod.restore_shardings(cfg, mesh)
            device = mesh.device
            kw["params_placed"] = True
        params, _ = ckpt_mod.restore_params(ckpt_dir, step=step,
                                            device=device,
                                            shardings=shardings)
        if draft_depth:
            kw["draft_params"], kw["draft_cfg"] = spec_mod.draft_from_params(
                params, cfg, draft_depth)
        return cls(params, cfg, device=device, mesh=mesh, **kw)

    # --- request lifecycle ------------------------------------------------
    def _spec_k_for(self, req: Request) -> int:
        """This request's window size: the engine's ``num_draft_tokens``,
        capped (never raised) by ``SamplingParams.draft_tokens``, 0 with
        ``draft=False`` or without a draft model."""
        if not self.spec:
            return 0
        sp = req.sampling or self.default_sampling
        if sp.draft is False:
            return 0
        if sp.draft_tokens is not None:
            return max(0, min(int(sp.draft_tokens), self._spec_k))
        return self._spec_k

    def _admission_cost(self, req: Request) -> float:
        """SJF job size under speculation: the prompt length plus the
        expected decode windows, the output budget over the window's
        tokens."""
        sp = req.sampling or self.default_sampling
        new = sp.max_new if sp.max_new is not None else req.max_new
        return float(len(req.prompt)) + float(new) / (
            1 + self._spec_k_for(req))

    def _resolve(self, req: Request) -> SamplingParams:
        sp = req.sampling or self.default_sampling
        over: dict = {}
        if sp.max_new is None:
            over["max_new"] = req.max_new
        if sp.greedy and (sp.top_k > 0 or sp.top_p < 1.0):
            # argmax ignores the filters: normalized to the inert values so
            # a greedy row never brings top_mask's sort into a mixed batch
            over.update(top_k=0, top_p=1.0)
        return dataclasses.replace(sp, **over) if over else sp

    def _terminal(self, req: Request, reason: str) -> StreamEvent:
        """Stamp a request done off-slot (rejected, shed, expired while
        queued, invalid) and queue its terminal event."""
        if req.t_submit is None:
            req.t_submit = self._clock()
        req.done = True
        req.finish_reason = reason
        req.t_done = self._clock()
        ev = StreamEvent(req.rid, None, len(req.out), finished=True,
                         finish_reason=reason, stats=req.stats())
        self._pending_events.append(ev)
        return ev

    def submit_request(self, req: Request) -> bool:
        """Enqueue a request with the scheduler. False, with a terminal
        event queued, when it is turned away instead: malformed (empty
        prompt: ``error``) or by backpressure (``rejected``)."""
        if len(req.prompt) == 0 and req.rid not in self._swapped:
            self.requests_invalid += 1
            self._terminal(req, FINISH_ERROR)
            return False
        if self.max_queue is not None and \
                len(self.scheduler) >= self.max_queue:
            victim = None
            if self.shed_policy == "shed_lowest":
                shed = getattr(self.scheduler, "shed", None)
                if shed is not None:
                    victim = shed(below=int(req.priority))
            if victim is None:
                # reject policy, or the newcomer outranks no one waiting
                self.requests_rejected += 1
                self._terminal(req, FINISH_REJECTED)
                return False
            self._swapped.pop(victim.rid, None)
            self.requests_shed += 1
            self._terminal(victim, FINISH_REJECTED)
        if req.t_submit is None:
            req.t_submit = self._clock()
        self.scheduler.add(req)
        return True

    def submit(self, req: Request) -> bool:
        """Admit one request straight into a free slot (True) or not."""
        return self.admit([req]) == 1

    def admit(self, reqs: list[Request]) -> int:
        """Admit as many of ``reqs`` (in order) as there are free slots,
        bypassing the scheduler; returns how many were admitted (a
        malformed request finishes with ``error`` and is not counted)."""
        group = reqs[:sum(r is None for r in self.active)]
        if not group:
            return 0
        inv0 = self.requests_invalid
        self._admit_group(group)
        return len(group) - (self.requests_invalid - inv0)

    def cancel(self, rid: int) -> bool:
        """Evict a live slot or drop a queued request; the terminal
        ``cancelled`` event comes on the next ``generate`` tick."""
        req = self.scheduler.cancel(rid)
        if req is not None:
            self._swapped.pop(rid, None)  # preempted and requeued, now dead
            req.t_done = self._clock()
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
            entry.update(cache=_take_slots(self.cache, blocks),
                         nblocks=len(blocks))
            self.blocks_swapped += len(blocks)
            self._release_blocks(s, zero=False)
        else:
            entry["cache"] = _take_slots(self.cache, [s])
        if self.spec:
            # the draft's rows ride the same entry: resume restores both
            # models' state with no draft re-prefill
            entry["draft"] = _take_slots(self.draft_cache, [s])
        self._swapped[rid] = entry
        self._free_slot(s)  # no terminal event: the stream pauses
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
            _put_slots(self.cache, sw["cache"], blocks)
            self._slot_blocks[s] = blocks
            self._table[s, :] = paged_mod.NULL_BLOCK
            self._table[s, :n] = blocks
        else:
            self._swapped.pop(req.rid)
            _put_slots(self.cache, sw["cache"], [s])
        if "draft" in sw:
            _put_slots(self.draft_cache, sw["draft"], [s])
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
        if self.mesh is None:
            return self._tick_body()
        self._clock.begin_tick()  # rank 0's time, one broadcast per tick
        try:
            return self._tick_body()
        finally:
            self._clock.end_tick()

    def _tick_body(self) -> list[StreamEvent]:
        events = self._pending_events
        self._pending_events = []
        events += self._expire_live()
        self._maybe_preempt()
        events += self._pending_events  # a custom preemption hook may
        self._pending_events = []       # cancel
        free = sum(r is None for r in self.active)
        if free and len(self.scheduler):
            wave = self._pop_wave(free, events)
            if wave:
                events += self._admit_group(wave)
        if any(r is not None for r in self.active):
            events += self._step_events()
        return events

    def _expired(self, req: Request, now: float) -> bool:
        if (req.deadline_ms is not None and req.t_submit is not None
                and (now - req.t_submit) * 1e3 > req.deadline_ms):
            return True
        return (req.decode_timeout_ms is not None and req.t_first is not None
                and (now - req.t_first) * 1e3 > req.decode_timeout_ms)

    def _expire_live(self) -> list[StreamEvent]:
        """Finish live slots past their deadline or decode timeout, before
        another token is decoded for them."""
        now = self._clock()
        events = []
        for s, req in enumerate(self.active):
            if req is not None and self._expired(req, now):
                self.deadline_expired += 1
                events.append(self._finish_slot(s, req, FINISH_DEADLINE,
                                                token=None))
        return events

    def _pop_wave(self, free: int, events: list[StreamEvent]) -> list:
        """The next admission wave; queued requests already past their
        deadline are shed here with a terminal event and no prefill."""
        now = self._clock()
        wave: list = []
        while len(wave) < free and len(self.scheduler):
            for req in self.scheduler.pop(free - len(wave)):
                if self._expired(req, now):
                    self._swapped.pop(req.rid, None)
                    self.deadline_expired += 1
                    self._terminal(req, FINISH_DEADLINE)
                    events.append(self._pending_events.pop())  # now
                else:
                    wave.append(req)
        return wave

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
        now = self._clock()
        events: list[StreamEvent] = []
        fresh: list[Request] = []
        for r in group:
            if r.rid in self._swapped:
                if self._resume_slot(r, free[0]):
                    free.pop(0)
            elif len(r.prompt) == 0:
                # malformed (the direct admit() path): finished alone, the
                # rest of the wave goes on
                self.requests_invalid += 1
                self._terminal(r, FINISH_ERROR)
                events.append(self._pending_events.pop())  # delivered now
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
        for r in fresh:
            if r.t_submit is None:
                r.t_submit = now  # direct admit(): no queue wait
            r.t_admit = now
        if self.cfg.family in _RECURRENT:
            # no pad buckets for recurrent state: one ladder per request
            for r, s in zip(fresh, free):
                events += self._admit_chunked(r, s)
            return events
        return events + self._admit_bucketed(fresh, free[:len(fresh)])

    def _group_sampling(self, group: list[Request]):
        """One wave's resolved params and its sampling vectors: (sps, keys
        (G, 2) uint32 | None, temp, top_k, top_p); keys is None when the
        whole wave is greedy (no PRNG op), a filter None when no row uses
        it."""
        sps = [self._resolve(r) for r in group]
        if all(sp.greedy for sp in sps):
            return sps, None, None, None, None
        keys = np.stack([sp.key_data(engine_seed=self.seed, rid=r.rid)
                         for sp, r in zip(sps, group)])
        temp = np.asarray([sp.temperature for sp in sps], np.float32)
        top_k, top_p = self._filter_vectors([sp.top_k for sp in sps],
                                            [sp.top_p for sp in sps])
        return sps, keys, temp, top_k, top_p

    @staticmethod
    def _filter_vectors(ks, ps):
        """Per-row top-k / top-p vectors, or None for a filter no row uses
        (its full-vocabulary sort stays out of the step). Freed slots hold
        the inert 0 / 1.0, so every slot's value can be passed."""
        top_k = np.asarray(ks, np.int64) if any(k > 0 for k in ks) else None
        top_p = (np.asarray(ps, np.float32) if any(p < 1.0 for p in ps)
                 else None)
        return top_k, top_p

    def _sampling_args(self, keys, gen, temp, top_k, top_p) -> tuple:
        """The device arguments of one wave's or step's draw: ``keys``
        (G, 2) are the requests' base keys, each folded on the host with
        its request-local token index ``gen`` (G,); the step keys and the
        vectors go up before the forward is queued (a blocking host-to-
        device copy waits for the queue to drain). ``keys=None``: () and
        the draw is an argmax."""
        if keys is None:
            return ()
        step_keys = prng.fold_in(keys.astype(np.int64),
                                 np.asarray(gen, np.int64))
        return tuple(None if a is None else torch.as_tensor(
            a, device=self.device) for a in (step_keys, temp, top_k, top_p))

    @staticmethod
    def _sample(last: torch.Tensor, args: tuple) -> torch.Tensor:
        """Tokens (G,) int32 from last-position logits (G, V) on the
        device, under :meth:`_sampling_args`'s arguments."""
        if not args:
            return lm.sample_tokens(last)
        keys, temp, top_k, top_p = args
        return lm.sample_tokens(last, keys, temp, top_k=top_k, top_p=top_p)

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
        sps, keys, temp, top_k, top_p = self._group_sampling(group)
        # the first token is each request's token index 0
        args = () if self.sample_on_host else self._sampling_args(
            keys, np.zeros(len(group)), temp, top_k, top_p)
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
            sub = self._new_cache(self.cfg, len(group), self.rt)
            logits, sub = lm.forward(self.params, toks, self.rt, self.cfg,
                                     cache=sub, pos=0, last_idx=last_idx)
            _copy_slots(self.cache, sub, free)
        if self.spec:
            # the draft takes the same padded bucket; its pad writes sit
            # behind the kv_len mask like the target's
            dsub = self._new_cache(self.draft_cfg, len(group),
                                   self.draft_rt)
            _copy_slots(self.draft_cache, lm.advance_cache(
                self.draft_params, toks, dsub, 0, self.draft_rt,
                self.draft_cfg), free)
        return self._finish_admission(group, free, plens, sps, logits[:, 0],
                                      args, t0)

    def _ladder(self, plen: int) -> list[int]:
        """Chunk sizes feeding a ``plen``-token prompt: ``prompt_chunk``,
        halved until it fits what is left, each time."""
        sizes, rem = [], plen
        while rem:
            c = self.prompt_chunk
            while c > rem:
                c //= 2
            sizes.append(c)
            rem -= c
        return sizes

    def _admit_chunked(self, req: Request, s: int) -> list[StreamEvent]:
        """Recurrent-family admission of one request into slot ``s``: its
        rows of every cache leaf zeroed (a finished request's state must
        not leak into the next), then the prompt fed in the chunk ladder
        straight into the slot's rows, the state threaded between calls;
        the head and the first token from the last chunk only."""
        t0 = time.perf_counter()
        prompt = np.asarray(req.prompt, np.int32)
        sps, keys, temp, top_k, top_p = self._group_sampling([req])
        args = () if self.sample_on_host else self._sampling_args(
            keys, np.zeros(1), temp, top_k, top_p)
        view = _slot_view(self.cache, s)
        _zero_tree(view)
        sizes = self._ladder(len(prompt))
        off = 0
        for c in sizes[:-1]:
            lm.advance_cache(self.params, prompt[None, off:off + c], view,
                             off, self.rt, self.cfg)
            off += c
        logits, _ = lm.forward(self.params, prompt[None, off:], self.rt,
                               self.cfg, cache=view, pos=off, last_only=True)
        self.prefill_chunks += len(sizes)
        return self._finish_admission([req], [s], [len(prompt)], sps,
                                      logits[:, 0], args, t0)

    def _finish_admission(self, group, free, plens, sps, last, args,
                          t0) -> list[StreamEvent]:
        """Each admitted request's first token from its last-prompt logits
        ``last`` (G, V), in one transfer, and its slot bound."""
        if self.sample_on_host:
            # the baseline: one transfer per admitted row
            firsts = [int(torch.argmax(last[g])) for g in range(len(group))]
            self.host_syncs += len(group)
        else:
            firsts = self._sample(last, args).cpu().numpy()  # one transfer
            self.host_syncs += 1
        self.prefill_waves += 1
        self.prefill_seconds += time.perf_counter() - t0
        now = self._clock()
        events = []
        for g, (req, s) in enumerate(zip(group, free)):
            first = int(firsts[g])
            self._install_slot(s, req, sps[g], pos=plens[g], next_tok=first)
            req.out.append(first)
            req.t_first = now
            events.append(self._emit(s, req, first))
        return events

    def _install_slot(self, s: int, req: Request, sp: SamplingParams, *,
                      pos: int, next_tok: int) -> None:
        """Bind a request to a slot: its position and its sampling state
        (fresh admission and resume)."""
        self.pos[s] = pos
        self.active[s] = req
        self._slot_stop[s] = sp.stop_set(self.eos_id)
        self._slot_max_new[s] = int(sp.max_new)
        self._temp[s] = sp.temperature
        self._top_k[s] = sp.top_k
        self._top_p[s] = sp.top_p
        self._keys[s] = sp.key_data(engine_seed=self.seed, rid=req.rid)
        self._slot_draft_k[s] = self._spec_k_for(req)
        self._next_tok[s] = next_tok

    def _free_slot(self, s: int) -> None:
        """Unbind slot ``s``; its sampling state returns to the inert
        greedy values."""
        self.active[s] = None
        self._slot_stop[s] = frozenset()
        self._temp[s] = 0.0
        self._top_k[s] = 0
        self._top_p[s] = 1.0
        self._slot_draft_k[s] = 0

    # --- decode -----------------------------------------------------------
    def _step_begin(self):
        """The head of a step or window: the fault hook, paged block
        growth (which can finish slots), the live slots. Returns (events,
        model cache, live slots, start of the step's wall); no live slot:
        (events, None, [], start)."""
        if self.faults is not None:
            self.faults.before_decode(self)
        t0 = time.perf_counter()
        events: list[StreamEvent] = []
        cache = self.cache
        if self.paged:
            # grow chains whose next write (or window) crosses a block
            # boundary; a dry pool can finish slots, so check liveness again
            events = self._ensure_decode_blocks()
            if not any(r is not None for r in self.active):
                return events, None, [], t0
            cache = {"attn": self.cache["attn"],
                     "table": torch.as_tensor(self._table, device=self.device)}
        live = [s for s, r in enumerate(self.active) if r is not None]
        self.max_concurrent = max(self.max_concurrent, len(live))
        return events, cache, live, t0

    def _step_end(self, t0: float) -> None:
        """The tail of a step or window, after its one transfer."""
        self.decode_steps += 1
        self.decode_seconds += time.perf_counter() - t0
        self.cache_donated = True
        if self.watchdog is not None:
            now = self._clock()
            self.stalled_steps += len(self.watchdog.failed(now))
            self.watchdog.beat(0, self.decode_steps, now=now)

    def _step_events(self) -> list[StreamEvent]:
        """One decode step for every slot -> one StreamEvent per emitted
        token. A speculative engine runs a propose / verify / commit
        window instead; both fold their tokens through
        :meth:`_commit_slot`."""
        if self.spec:
            return self._spec_step_events()
        events, cache, live, t0 = self._step_begin()
        if not live:
            return events
        toks = torch.as_tensor(self._next_tok[:, None], device=self.device)
        positions = torch.as_tensor(self.pos, device=self.device)
        args = ()  # an all-greedy step: argmax only, no PRNG op
        if not self.sample_on_host and any(self._temp[s] > 0 for s in live):
            gen = [len(r.out) if r is not None else 0 for r in self.active]
            args = self._sampling_args(
                self._keys, gen, self._temp,
                *self._filter_vectors(self._top_k, self._top_p))
        logits, _ = lm.decode_step(self.params, toks, cache, positions,
                                   self.rt, self.cfg)
        last = logits[:, 0]
        if self.sample_on_host:
            # the baseline: one transfer per live slot, argmax on the host
            picked = {}
            for s in live:
                row = last[s].cpu().numpy()
                self.host_syncs += 1
                picked[s] = (_POISONED if not np.isfinite(row).all()
                             else int(np.argmax(row)))
        else:
            tok = torch.where(lm.finite_rows(last), self._sample(last, args),
                              torch.full_like(last[:, 0], _POISONED,
                                              dtype=torch.int32))
            tok_np = tok.cpu().numpy()  # THE step's one transfer
            self.host_syncs += 1
            picked = {s: int(tok_np[s]) for s in live}
        self._step_end(t0)
        for s in live:
            events += self._commit_slot(s, self.active[s], [picked[s]])
        return events

    def _window_args(self, live: list[int]) -> tuple:
        """The device arguments of one window's draws, computed on the host
        from the keys and each request's token index and sent up before
        the window's forwards are queued: (draft keys (K, S, 2), (uniforms
        (S, K), window-end keys (S, K+1, 2)), temp, top_k, top_p); () when
        every live slot is greedy (argmax only, no PRNG op)."""
        if all(self._temp[s] <= 0 for s in live):
            return ()
        gen = np.asarray([len(r.out) if r is not None else 0
                          for r in self.active], np.int64)
        dkeys = np.stack([spec_mod.draft_keys(self._keys, gen, w)
                          for w in range(self._spec_k)])
        draws = spec_mod.window_draws(self._keys, gen, self._spec_k,
                                      self.device)
        top_k, top_p = self._filter_vectors(self._top_k, self._top_p)
        dev = self.device
        return (torch.as_tensor(dkeys, device=dev), draws,
                torch.as_tensor(self._temp, device=dev),
                None if top_k is None else torch.as_tensor(top_k, device=dev),
                None if top_p is None else torch.as_tensor(top_p, device=dev))

    def _propose(self, toks, positions, args):
        """K draft steps from the draft's cache, then one ``advance_cache``
        at ``pos + K`` (a fully accepted window leaves no hole). Returns
        (cand (S, K+1) = [anchor, d_1..d_K], qlog (S, K, V) the draft's
        scaled and masked logits, or None on an all-greedy window).
        Proposal ``w`` is the argmax, or drawn under the slot's DRAFT
        stream at index ``gen + w`` from exactly ``qlog[:, w]``."""
        cand, qlogs, cur = [toks[:, 0]], [], toks
        for w in range(self._spec_k):
            logits, _ = lm.decode_step(self.draft_params, cur,
                                       self.draft_cache, positions + w,
                                       self.draft_rt, self.draft_cfg)
            last = logits[:, 0].to(torch.float32)
            d = torch.argmax(last, dim=-1).to(torch.int32)
            if args:
                dkeys, _, temp, top_k, top_p = args
                scaled = last / torch.clamp_min(temp, 1e-6)[:, None]
                if top_k is not None or top_p is not None:
                    scaled = lm.top_mask(scaled, top_k, top_p)
                d = torch.where(temp > 0, prng.categorical(
                    dkeys[w], scaled).to(torch.int32), d)
                qlogs.append(scaled)
            cand.append(torch.clamp(d, 0, self.cfg.vocab_size - 1))
            cur = cand[-1][:, None]
        lm.advance_cache(self.draft_params, cur, self.draft_cache,
                         positions + self._spec_k, self.draft_rt,
                         self.draft_cfg)
        return (torch.stack(cand, dim=1),
                torch.stack(qlogs, dim=1) if qlogs else None)

    def _verify(self, cache, cand, positions, kvec, args, qlog):
        """One target pass over the K+1 window positions, then the accept
        and commit decision. A slot whose logits are non-finite at a
        position its window can use (<= kvec) reports a _POISONED row with
        n = 1 (later rows read lookahead positions past a paged slot's
        blocks, finite garbage in the null block)."""
        logits, _ = lm.score_tokens(self.params, cand, cache, positions,
                                    self.rt, self.cfg)
        if args:
            _, draws, temp, top_k, top_p = args
            out, n = spec_mod.verify_commit(
                logits, cand, kvec, temp=temp, top_k=top_k, top_p=top_p,
                qlog=qlog, draws=draws)
        else:
            out, n = spec_mod.verify_commit(logits, cand, kvec)
        used = (torch.arange(cand.shape[1], device=cand.device)[None, :]
                <= kvec[:, None])
        ok = (lm.finite_rows(logits) | ~used).all(dim=1)
        out = torch.where(ok[:, None], out, _POISONED)
        return out, torch.where(ok, n, 1)

    def _spec_step_events(self) -> list[StreamEvent]:
        """One speculative window for every slot: propose, verify, and
        each slot commits its accepted prefix and one window-end token.
        The (S, K+1) window and the (S,) counts come back in ONE transfer;
        a slot with kvec = 0 commits one token through the same path."""
        events, cache, live, t0 = self._step_begin()
        if not live:
            return events
        kvec_np = self._slot_draft_k.copy()
        dev = self.device
        toks = torch.as_tensor(self._next_tok[:, None], device=dev)
        positions = torch.as_tensor(self.pos, device=dev)
        kvec = torch.as_tensor(kvec_np, device=dev)
        args = self._window_args(live)
        cand, qlog = self._propose(toks, positions, args)
        out, n = self._verify(cache, cand, positions, kvec, args, qlog)
        both = torch.cat([out, n[:, None].to(out.dtype)], dim=1)
        both = both.cpu().numpy()  # THE window's one transfer
        self.host_syncs += 1
        self.spec_steps += 1
        self._step_end(t0)
        for s in live:
            req = self.active[s]
            n_s = int(both[s, -1])
            window = [int(t) for t in both[s, :n_s]]
            if window[0] != _POISONED:
                # n - 1 of the slot's kvec proposals were committed (the
                # window-end token is the target's), counted even when a
                # stop or length finish inside the window drops the tail
                kv = int(kvec_np[s])
                self.draft_proposed += kv
                self.draft_accepted += n_s - 1
                req.drafted += kv
                req.accepted += n_s - 1
                req.spec_windows += 1
            events += self._commit_slot(s, req, window)
        return events

    def _commit_slot(self, s: int, req: Request,
                     toks: list) -> list[StreamEvent]:
        """Fold committed tokens into one slot's stream (the one-token step
        is a window of one). Stops at the first terminal condition: a
        _POISONED sentinel quarantines the slot (``error``, its rows
        re-zeroed); a stop or length finish drops the rest of the window
        (the cache holds a few positions past the stream's end, never read:
        kv_len follows ``pos``, which stops)."""
        events: list[StreamEvent] = []
        for tok in toks:
            if tok == _POISONED:
                self.quarantined += 1
                events.append(self._finish_slot(s, req, FINISH_ERROR,
                                                token=None))
                self._zero_slot(s)
                break
            req.out.append(tok)
            self._next_tok[s] = tok
            self.pos[s] += 1
            self.tokens_decoded += 1
            ev = self._emit(s, req, tok)
            events.append(ev)
            if ev.finished:
                break
        return events

    def _ensure_decode_blocks(self) -> list[StreamEvent]:
        """Before a paged step every live slot must own the block its next
        write lands in. On a dry pool, preempt a victim (lowest priority,
        newest admission); with no victim the slot itself error-finishes."""
        events: list[StreamEvent] = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            # a window can commit, and later read, up to pos + kvec; its
            # verify writes past that land in the null block
            need = paged_mod.blocks_needed(
                self.pos[s], self.block_size,
                lookahead=int(self._slot_draft_k[s]))
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
        """Quarantine cleanup of a dense slot's rows and its draft rows (the
        draft cache is dense on every engine); a paged slot's blocks were
        zeroed and freed by ``_finish_slot``."""
        trees = ([] if self.paged else [self.cache]) + (
            [self.draft_cache] if self.spec else [])
        for tree in trees:
            _zero_tree(_slot_view(tree, s))
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
        req.t_done = self._clock()
        if self.paged:
            # blocks return to the pool when the stream ends; quarantine
            # zeroes the exclusively held ones first
            self._release_blocks(s, zero=(reason == FINISH_ERROR))
        self._free_slot(s)
        # tokenless terminal events index one past the stream
        idx = len(req.out) - 1 if token is not None else len(req.out)
        ev = StreamEvent(req.rid, token, idx, finished=True,
                         finish_reason=reason, stats=req.stats())
        if reason == FINISH_CANCELLED:
            self._pending_events.append(ev)
        return ev

    def step(self) -> list[tuple[int, int]]:
        """One decode step (a window on a speculative engine) for every
        live slot: ``[(rid, token)]`` of its emitted tokens, ``[]`` when no
        slot is live."""
        if not any(r is not None for r in self.active):
            return []
        return [(e.rid, e.token) for e in self._step_events()
                if e.token is not None]

    # --- accounting -------------------------------------------------------
    @property
    def cache_bytes(self) -> int:
        """Bytes of every cache leaf: the attention planes and the
        recurrent state (under a mesh, of the whole cache: every rank's
        heads)."""
        return self._whole_bytes(self.cache, self.cfg, self.rt)

    def _whole_bytes(self, tree: dict, cfg, rt: Runtime) -> int:
        """Bytes of ``tree`` (a cache of ``cfg`` under ``rt``) as one
        device would hold it: a head-sharded cache's attention planes
        count every rank's heads."""
        n = _tree_bytes(tree)
        if rt.rules is None:
            return n
        from repro_torch.serve import tp as tp_mod
        if tp_mod.head_slice(cfg.num_kv_heads, rt.rules) is None:
            return n
        planes = sum(_tree_bytes(tree[k]) for k in ("attn", "xattn")
                     if k in tree)
        return n + planes * (rt.rules.mesh.size - 1)

    def stats(self) -> dict:
        """Counters for tests and ``chip_smoke.py``. Times are host wall
        seconds around work that ends in the step's device->host transfer,
        so they include the device time. ``cache_bytes_reserved`` is what
        requests claim (the whole dense cache; a pool's allocated blocks),
        ``cache_bytes_live`` the bytes of the live slots' positions.
        ``cache_bytes_per_token`` counts the attention planes only: the
        recurrent state is O(1) in tokens (an attention-free model reports
        0), while ``cache_bytes`` holds every leaf. ``prefill_waves`` counts
        admission calls that end in a sync: one per wave, or one per
        request's ladder (recurrent families, whose ``prefill_chunks``
        counts the ladder's calls)."""
        attn = self.cache.get("attn", {})
        attn_bytes = (self._whole_bytes({"attn": attn}, self.cfg, self.rt)
                      if attn else 0)
        if self.paged:
            n_tokens_cap = self.num_blocks * self.block_size
        else:
            n_tokens_cap = self.slots * (attn["k"].shape[3] if attn else 1)
        bytes_per_token = attn_bytes / n_tokens_cap
        live_tokens = sum(int(self.pos[s]) for s, r in enumerate(self.active)
                          if r is not None)
        reserved = (bytes_per_token * self.pool.used() * self.block_size
                    if self.paged else attn_bytes)
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
            "cache_donated": self.cache_donated,
            "cache_bytes_moved": self.cache_bytes_moved,
            "scheduler": getattr(self.scheduler, "name",
                                 type(self.scheduler).__name__),
            "waiting": len(self.scheduler),
            "requests_rejected": self.requests_rejected,
            "requests_shed": self.requests_shed,
            "requests_invalid": self.requests_invalid,
            "deadline_expired": self.deadline_expired,
            "quarantined": self.quarantined,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "stalled_steps": self.stalled_steps,
            "swapped": len(self._swapped),
            "max_queue": self.max_queue,
            "shed_policy": self.shed_policy,
            "max_concurrent": self.max_concurrent,
            "backend": self.rt.backend,
            "kv_quant": self.rt.kv_quant,
            "act_quant": self.rt.act_quant,
        }
        if self.cfg.family in _RECURRENT:
            out["prefill_chunks"] = self.prefill_chunks
        if self.spec:
            out.update(
                speculative=True,
                num_draft_tokens=self._spec_k,
                spec_steps=self.spec_steps,
                draft_proposed=self.draft_proposed,
                draft_accepted=self.draft_accepted,
                acceptance_rate=(self.draft_accepted / self.draft_proposed
                                 if self.draft_proposed else float("nan")),
                tokens_per_step=(self.tokens_decoded / self.decode_steps
                                 if self.decode_steps else float("nan")),
                draft_cache_bytes=self._whole_bytes(
                    self.draft_cache, self.draft_cfg, self.draft_rt),
            )
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
        if self.mesh is not None:
            from repro_torch.serve import tp as tp_mod
            out["devices"] = self.mesh.size
            out["cache_bytes_per_device"] = tp_mod.cache_bytes_per_device(
                self.cache)
            out["tp_shard_map"] = True  # the one form: explicit shards
        return out


# --- slot swap: gather to host, scatter back ---------------------------------
# Every cache leaf, attention plane or recurrent state, is (L, B, ...) with
# its slots (paged: pool blocks) on axis 1.

def _tree_leaves(tree: dict, prefix: tuple = ()):
    """(path, tensor) of every leaf of a cache tree, in sorted key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _tree_leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _leaf(tree: dict, path: tuple) -> torch.Tensor:
    for k in path:
        tree = tree[k]
    return tree


def _tree_bytes(tree: dict) -> int:
    return int(sum(a.numel() * a.element_size()
                   for _, a in _tree_leaves(tree)))


def _slot_view(tree: dict, s: int) -> dict:
    """Slot ``s``'s rows of every leaf as a batch-of-one cache: views, so
    a forward on it writes the engine cache in place."""
    return {k: _slot_view(v, s) if isinstance(v, dict) else v[:, s:s + 1]
            for k, v in tree.items()}


def _zero_tree(tree: dict) -> None:
    for _, a in _tree_leaves(tree):
        a.zero_()


def _copy_slots(cache: dict, sub: dict, idx: list[int]) -> None:
    """Copy a (G,)-slot sub-cache into slots ``idx`` of ``cache``, in
    place."""
    for path, v in _tree_leaves(cache):
        index = torch.as_tensor(idx, device=v.device)
        v.index_copy_(1, index, _leaf(sub, path))


def _take_slots(cache: dict, idx: list[int]):
    """Rows ``idx`` of axis 1 (slots, or pool blocks) of every cache leaf,
    gathered on the device and moved to host memory in ONE copy: a flat
    uint8 buffer and each leaf's (path, dtype, shape). The int8 codes,
    fp16 scales and f32 states round-trip bit for bit."""
    leaves = list(_tree_leaves(cache))
    index = torch.as_tensor(idx, dtype=torch.int64, device=leaves[0][1].device)
    parts = [a.index_select(1, index) for _, a in leaves]
    flat = torch.cat([p.reshape(-1).view(torch.uint8) for p in parts]).cpu()
    return flat, [(path, p.dtype, tuple(p.shape))
                  for (path, _), p in zip(leaves, parts)]


def _put_slots(cache: dict, swap, idx: list[int]) -> None:
    """Scatter a :func:`_take_slots` entry into rows ``idx`` of axis 1 of
    every leaf, in place (one host->device copy)."""
    flat, layout = swap
    dev = _leaf(cache, layout[0][0]).device
    flat = flat.to(dev)
    index = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    off = 0
    for path, dtype, shape in layout:
        n = math.prod(shape) * dtype.itemsize
        _leaf(cache, path).index_copy_(
            1, index, flat[off:off + n].view(dtype).reshape(shape))
        off += n
