"""Per-request sampling controls and the streaming event vocabulary (a
copy of ``repro/serve/sampling.py``: numpy and pure Python).

:class:`SamplingParams` is the public knob set a request carries through
the serving lifecycle (vLLM-style): temperature, top-k, top-p, a private
PRNG seed, output budget, and stop conditions. The port's engine serves
greedy requests only in this slice; the key derivation is kept so the
sampled-decoding slice can reproduce the reference's per-request keys.

Determinism contract: a request's token stream depends only on (params,
prompt, its own SamplingParams/seed) — never on which slot it landed in or
what else is in the batch.

:class:`StreamEvent` is what ``ServeEngine.generate`` yields: one event per
emitted token, with the terminal event carrying the finish reason and the
request's lifecycle stats (queue wait, TTFT, decode tok/s).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "SamplingParams", "StreamEvent",
    "FINISH_STOP", "FINISH_LENGTH", "FINISH_CANCELLED",
    "FINISH_DEADLINE", "FINISH_ERROR", "FINISH_REJECTED",
    "FINISH_REASONS",
]

# Finish reasons (string constants, JSON-friendly)
FINISH_STOP = "stop"            # emitted a stop/EOS token
FINISH_LENGTH = "length"        # hit max_new or the slot's cache horizon
FINISH_CANCELLED = "cancelled"  # evicted by ServeEngine.cancel()
FINISH_DEADLINE = "deadline"    # deadline_ms / decode_timeout_ms expired
FINISH_ERROR = "error"          # numeric quarantine or malformed request
FINISH_REJECTED = "rejected"    # backpressure: queue full (reject/shed)

# The closed vocabulary: EVERY request the engine ever sees terminates with
# exactly one of these on its terminal StreamEvent — the resilience-layer
# contract (no hang, no crash, no silent drop).
FINISH_REASONS = frozenset({
    FINISH_STOP, FINISH_LENGTH, FINISH_CANCELLED,
    FINISH_DEADLINE, FINISH_ERROR, FINISH_REJECTED,
})


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls.

    ``temperature <= 0`` means greedy (argmax) regardless of the other
    knobs. ``top_k=0`` / ``top_p=1.0`` disable those filters. ``seed=None``
    derives a deterministic per-request key from the engine seed and the
    request id, so reruns reproduce. ``max_new=None`` defers to the
    request's own ``max_new`` (back-compat with the pre-lifecycle API).
    ``stop`` token ids finish the request the step they are emitted (the
    stop token IS appended to the output, mirroring EOS emission);
    ``ignore_eos`` opts out of the engine/config-level EOS id.

    Speculative decoding (engines booted with a draft model):
    ``draft=None`` follows the engine default (speculate when a draft is
    configured), ``False`` opts this request out (it decodes one token per
    window, stream-identical to a non-speculative engine), ``True``
    documents the opt-in explicitly. ``draft_tokens`` caps this request's
    window below the engine's ``num_draft_tokens`` (clipped, never
    raised). Both are inert on engines without a draft model."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    max_new: Optional[int] = None
    stop: tuple[int, ...] = ()
    ignore_eos: bool = False
    draft: Optional[bool] = None
    draft_tokens: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new is not None and self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.draft_tokens is not None and self.draft_tokens < 0:
            raise ValueError(
                f"draft_tokens must be >= 0 (0 disables speculation), "
                f"got {self.draft_tokens}")
        object.__setattr__(self, "stop", tuple(int(t) for t in self.stop))

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0

    def key_data(self, *, engine_seed: int, rid: int) -> np.ndarray:
        """The (2,) uint32 threefry key this request samples under —
        computed in pure numpy so admission does no device round trip.
        Matches ``jax.random.PRNGKey(seed)``'s (hi, lo) layout."""
        seed = self.seed if self.seed is not None else _derived_seed(
            engine_seed, rid)
        return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                        dtype=np.uint32)

    def stop_set(self, eos_id: Optional[int]) -> frozenset[int]:
        ids = set(self.stop)
        if eos_id is not None and not self.ignore_eos:
            ids.add(int(eos_id))
        return frozenset(ids)


def _derived_seed(engine_seed: int, rid: int) -> int:
    """Deterministic per-request default seed: a splitmix64-style hash so
    adjacent rids don't get adjacent (correlated) threefry keys."""
    mask = 0xFFFFFFFFFFFFFFFF
    z = (engine_seed * 0x9E3779B97F4A7C15 + rid + 1) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return z ^ (z >> 31)


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One token (or terminal notice) of a request's output stream.

    ``token`` is None only for a terminal event that emitted no token
    (cancellation of a live or queued request). ``index`` is the 0-based
    position of the token within the request's output; tokenless terminal
    events carry ``index = len(out)`` — one past the stream — so
    ``(rid, index)`` uniquely keys every event. ``stats`` is populated on
    terminal events: ``queue_wait_s`` (submit -> admission), ``ttft_s``
    (submit -> first token), ``decode_tok_s`` (post-first-token
    throughput), ``tokens`` — plus ``draft_proposed`` / ``draft_accepted``
    / ``acceptance_rate`` on speculative engines (the request's own
    rejection-sampling accounting)."""

    rid: int
    token: Optional[int]
    index: int
    finished: bool = False
    finish_reason: Optional[str] = None
    stats: Optional[dict] = None
