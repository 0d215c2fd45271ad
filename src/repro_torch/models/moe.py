"""Mixture-of-Experts block (port of ``repro/models/moe.py``: the top-k
router, per-row sort dispatch into capacity buffers, the expert FFN and
the combine; not the expert-parallel shard-map combine).

Per batch row, the T*k routed assignments are stably sorted by expert id;
an assignment's rank within its expert is its sorted position less the
first position of that expert (``searchsorted``), and ranks at or beyond
the capacity ``cap = min(T*k, max(1, ceil(int(capacity_factor * T * k) /
E)))`` are dropped (Switch semantics). Kept assignments land in the
expert-major buffer ``(E, B*cap, D)``, one slot each; the experts' FFN
runs over all E buffers at once (``core/qlinear.py:qmatmul_experts``: one
expert-axis launch per projection on the card, however many experts),
empty slots included, as the reference computes them.

The combine sums each token's k terms in ascending expert id, in a fixed
order and without atomics, starting from zero: the order of the
reference's scatter-add over the expert-sorted assignments, so the two
agree to the last bit on the CPU and two runs on the card give the same
bits. A dropped term weighs 0 and reads the clamped slot, as the
reference's does.

Every shape is static (the capacity follows from T alone): no host sync,
no boolean-mask indexing. ``top-k`` is a stable descending sort, so a tie
takes the lower expert id first, as ``lax.top_k`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.qlinear import qmatmul_experts
from repro_torch.core.quantize import QTensor
from repro_torch.models.layers import Runtime, activate, dense

Params = dict[str, Any]

__all__ = ["moe_apply", "route", "dispatch", "capacity", "Dispatch"]


def capacity(cfg, rt: Runtime, t: int) -> int:
    """Slots per expert and batch row for a T-token forward."""
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = max(1, -(-int(rt.capacity_factor * t * k) // e))
    return min(cap, t * k)


def route(p: Params, x: torch.Tensor, rt: Runtime, cfg):
    """The router: f32 logits ``x @ router``, softmax, top-k (ties to the
    lower expert id), gates renormalized over the k. Returns ``(gates
    (B, T, k), idx (B, T, k) int64, probs (B, T, E))``."""
    logits = dense(x, p["router"], rt).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates = vals[..., :k]
    gates = gates / (torch.sum(gates, dim=-1, keepdim=True) + 1e-9)
    return gates, idx[..., :k], probs


@dataclasses.dataclass
class Dispatch:
    """Per-row assignment of the (B, T*k) routed slots, in expert-sorted
    order: ``s_eid`` the sorted expert ids, ``order`` the flat assignment
    (t*k + j) at each sorted position, ``rank`` its rank within its
    expert, ``keep = rank < cap`` and ``rankc = min(rank, cap - 1)``."""

    s_eid: torch.Tensor
    order: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    rankc: torch.Tensor


def dispatch(idx: torch.Tensor, cap: int) -> Dispatch:
    """The reference's ``dispatch_row`` for every row of ``idx (B, T, k)``."""
    b, t, k = idx.shape
    eid = idx.reshape(b, t * k)
    s_eid, order = torch.sort(eid, dim=-1, stable=True)
    s_eid = s_eid.contiguous()
    first = torch.searchsorted(s_eid, s_eid, side="left")
    rank = torch.arange(t * k, device=idx.device) - first
    return Dispatch(s_eid, order, rank, rank < cap,
                    torch.clamp(rank, max=cap - 1))


def _edense(x: torch.Tensor, w, rt: Runtime) -> torch.Tensor:
    """Per-expert dense: x (E, M, D) @ w (E, D, F) -> (E, M, F)."""
    if isinstance(w, QTensor):
        return qmatmul_experts(x, w, mode=rt.quant_mode, backend=rt.backend,
                               act_quant=rt.act_quant)
    return torch.bmm(x.to(torch.float32), w.to(torch.float32))


def _expert_ffn(p: Params, x: torch.Tensor, rt: Runtime,
                activation: str) -> torch.Tensor:
    gate = _edense(x, p["gate"], rt) if activation == "swiglu" else None
    return _edense(activate(activation, _edense(x, p["up"], rt), gate),
                   p["down"], rt)


def moe_apply(p: Params, x: torch.Tensor, rt: Runtime, cfg):
    """``x (B, T, D)`` -> (output (B, T, D), Switch load-balancing aux
    loss)."""
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = capacity(cfg, rt, t)
    x = x.to(torch.float32)
    gates, idx, probs = route(p, x, rt, cfg)

    # Switch aux loss: E * sum_e mean_tokens(P_e) * mean_tokens(assigned_e)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(torch.nn.functional.one_hot(idx[..., 0], e).to(
        torch.float32), dim=(0, 1))
    aux = e * torch.sum(me * ce)

    dsp = dispatch(idx, cap)
    rows = torch.arange(b, device=x.device)[:, None]
    # slot of each sorted assignment in the expert-major (E, B, cap) buffer
    slot = (dsp.s_eid * b + rows) * cap + dsp.rankc
    trash = e * b * cap  # dropped rows land past the buffer's end
    buf = x.new_zeros((trash + 1, d))
    buf[torch.where(dsp.keep, slot, trash).reshape(-1)] = x[
        rows, dsp.order // k].reshape(-1, d)
    out_buf = _expert_ffn(p, buf[:trash].view(e, b * cap, d), rt,
                          cfg.activation).reshape(trash, d)

    # back to each token's k assignments, in ascending expert id
    gat = torch.gather(gates.reshape(b, t * k), 1, dsp.order)
    w_sorted = gat * dsp.keep.to(gat.dtype)
    slot_tok = torch.empty_like(slot).scatter_(1, dsp.order, slot)
    w_tok = torch.empty_like(w_sorted).scatter_(1, dsp.order, w_sorted)
    asc = torch.sort(idx, dim=-1).indices  # a token's experts are distinct
    slot_tok = torch.gather(slot_tok.view(b, t, k), 2, asc)
    w_tok = torch.gather(w_tok.view(b, t, k), 2, asc)
    vals = out_buf[slot_tok] * w_tok[..., None]  # (B, T, k, D)
    out = torch.zeros((b, t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + vals[:, :, j]
    return out, aux
