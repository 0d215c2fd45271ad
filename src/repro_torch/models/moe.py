"""Mixture-of-Experts block (port of ``repro/models/moe.py``: the top-k
router, per-row sort dispatch into capacity buffers, the expert FFN, the
combine, and its expert-parallel form).

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

**Expert parallelism** (tensor-parallel serving, ``serve/tp.py``): with
the expert stacks' planes placed E/m per rank, the router and the
dispatch run whole and identically on every rank, and each rank runs the
expert-batched kernels on its own E/m experts' buffers only, under the
cut of the whole stack's launch (``cut_from``). The combine stays exact:
each rank fills the (B, T, k, D) rows of the assignments its experts own
(zeros elsewhere), one all-gather brings them together, and every rank
SELECTS each assignment's row from the rank that owns it, never adding;
then the ascending-order sum above runs as on one device. The reference
instead combines inside a ``shard_map`` with a ``psum`` at (T, D) width:
a cross-device float reduction, whose order would break bit-identity with
the single-device engine. The gather here is (T·k, D) wide per row.

The train step's expert parallelism (``Runtime.model_split``,
``train/tp.py``) is the same form on float stacks of E/m experts: the
router and the dispatch run whole on every rank, the rank's experts run
its capacity rows, and the combine selects each assignment's row from
the all-gathered blocks, the gather's backward handing each rank its own
rows' gradient (the combine is replicated compute).
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


def _edense(x: torch.Tensor, w, rt: Runtime, cut_from=None) -> torch.Tensor:
    """Per-expert dense: x (E, M, D) @ w (E, D, F) -> (E, M, F)."""
    if isinstance(w, QTensor):
        return qmatmul_experts(
            x, w, mode=rt.quant_mode, backend=rt.backend,
            act_quant=rt.act_quant,
            cut_from=None if cut_from is None else (cut_from, w.meta.n))
    return torch.bmm(x.to(torch.float32), w.to(torch.float32))


def _experts_held(w) -> int:
    """Experts whose weights this rank holds for a stack (E/m for a
    stack placed expert-parallel)."""
    if isinstance(w, QTensor):
        return next(v for k, v in w.data.items() if k != "dsign").shape[0]
    return w.shape[0]


def _expert_slice(w, lo: int, n: int):
    """Experts ``lo .. lo+n`` of a whole stack (views), or the stack
    itself when it holds just those."""
    if _experts_held(w) == n:
        return w
    if isinstance(w, QTensor):
        return QTensor({k: v if k == "dsign" and v.dim() == 1
                        else v[lo:lo + n] for k, v in w.data.items()},
                       w.meta)
    return w[lo:lo + n]


def _expert_ffn(p: Params, x: torch.Tensor, rt: Runtime, activation: str,
                lo: int = 0, e_full=None) -> torch.Tensor:
    """The FFN over the experts of ``x`` (E', M, D); ``lo``: the first of
    them (a rank's shard), ``e_full`` the whole stack's E when it is one."""
    e = x.shape[0]
    ws = {k: _expert_slice(p[k], lo, e) for k in ("gate", "up", "down")
          if k in p}
    gate = (_edense(x, ws["gate"], rt, e_full) if activation == "swiglu"
            else None)
    return _edense(activate(activation, _edense(x, ws["up"], rt, e_full),
                            gate), ws["down"], rt, e_full)


def _expert_shard(p: Params, rt: Runtime, e: int):
    """(first expert, experts) of this rank's expert-parallel shard, or
    None when every rank holds the whole stacks."""
    split = rt.model_split
    if split is not None:
        return split.block(e) if split.has("moe.up") else None
    if rt.rules is None:
        return None
    held = min(_experts_held(p[k]) for k in ("gate", "up", "down") if k in p)
    if held == e:
        return None
    return rt.rules.mesh.rank * held, held


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
    if rt.batch_mesh is not None:
        # the global batch's token means (training on a mesh)
        from repro_torch.train import sharded  # moe <-> train
        me = sharded.batch_mean(me, rt.batch_mesh)
        ce = sharded.batch_mean(ce, rt.batch_mesh)
    aux = e * torch.sum(me * ce)

    dsp = dispatch(idx, cap)
    shard = _expert_shard(p, rt, e)
    if shard is not None and rt.model_split is not None:
        x = rt.model_split.enter(x)  # into this rank's experts' rows
    rows = torch.arange(b, device=x.device)[:, None]
    # slot of each sorted assignment in the expert-major (E, B, cap) buffer
    slot = (dsp.s_eid * b + rows) * cap + dsp.rankc
    trash = e * b * cap  # dropped rows land past the buffer's end
    buf = x.new_zeros((trash + 1, d))
    buf[torch.where(dsp.keep, slot, trash).reshape(-1)] = x[
        rows, dsp.order // k].reshape(-1, d)
    if shard is None:
        out_buf = _expert_ffn(p, buf[:trash].view(e, b * cap, d), rt,
                              cfg.activation).reshape(trash, d)
    else:
        lo, held = shard
        out_loc = _expert_ffn(p, buf[:trash].view(e, b * cap, d)[lo:lo + held],
                              rt, cfg.activation, lo, e_full=e)
        out_loc = out_loc.reshape(held * b * cap, d)

    # back to each token's k assignments, in ascending expert id
    gat = torch.gather(gates.reshape(b, t * k), 1, dsp.order)
    w_sorted = gat * dsp.keep.to(gat.dtype)
    slot_tok = torch.empty_like(slot).scatter_(1, dsp.order, slot)
    w_tok = torch.empty_like(w_sorted).scatter_(1, dsp.order, w_sorted)
    asc = torch.sort(idx, dim=-1).indices  # a token's experts are distinct
    slot_tok = torch.gather(slot_tok.view(b, t, k), 2, asc)
    w_tok = torch.gather(w_tok.view(b, t, k), 2, asc)
    if shard is None:
        rows_tok = out_buf[slot_tok]  # (B, T, k, D)
    else:
        rows_tok = _ep_select(out_loc, slot_tok, shard[1] * b * cap, rt)
    vals = rows_tok * w_tok[..., None]
    out = torch.zeros((b, t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + vals[:, :, j]
    return out, aux


def _ep_select(out_loc: torch.Tensor, slot_tok: torch.Tensor, per: int,
               rt: Runtime) -> torch.Tensor:
    """The expert-parallel combine's exchange: ``out_loc`` (per, D) holds
    this rank's experts' buffer rows (``per`` of them, the rank's block of
    the whole (E*B*cap, D) buffer). Each rank fills the (B, T, k, D) rows
    of the assignments it owns, zeros elsewhere; one all-gather; every
    rank selects each assignment's row from its owner's block: the rows
    of the single-device buffer, bit for bit. In training the gather is
    ``train/tp.py``'s ``gather_replicated``."""
    if rt.model_split is not None:
        coord = rt.model_split.coord

        def gather(t):
            return rt.model_split.gather(t, 0)
    else:
        from repro_torch.serve import tp as tp_mod  # moe <-> serve
        mesh = rt.rules.mesh
        coord = mesh.rank

        def gather(t):
            return tp_mod.all_gather(t, 0, mesh)
    local = slot_tok - coord * per
    mine = (local >= 0) & (local < per)
    rows = torch.where(mine[..., None], out_loc[torch.clamp(local, 0,
                                                            per - 1)], 0.0)
    every = gather(rows[None])  # (m, B, T, k, D)
    owner = (slot_tok // per)[None, ..., None].expand(
        1, *rows.shape)
    return torch.gather(every, 0, owner)[0]
