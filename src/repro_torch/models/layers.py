"""Transformer building blocks (port of ``repro/models/layers.py``: the
attention families' blocks, self- and cross-attention; the recurrent
blocks are ``models/ssm.py``).

Every matmul weight flows through :func:`dense`, which dispatches on the
leaf type: a plain tensor (fp) or a :class:`~repro_torch.core.quantize.QTensor`
(any registered format, through :func:`~repro_torch.core.qlinear.qmatmul`,
which also takes the W3A8 ``act_quant`` knob).

The KV cache layout is the reference's: (B, KV_heads, T, head_dim), or,
paged (``serve/paged.py``), pool planes (NB, KV, BS, head_dim) with the
slots' (B, MAXB) block ``"table"`` beside them in the layer's cache dict.
Where XLA wrote a functional cache update into a donated buffer, the port
writes in place into the preallocated cache tensors (``index_put_`` over
per-row positions, so no host sync is needed to place a ragged batch).
Compute is float32 throughout, as the reference serving runtime is; a
training step on the card runs its loss under bf16 autocast instead
(``train/loop.py``), which leaves this code as it is.
The MLP serves the reference's three activations (swiglu, gelu in its
tanh form, relu2) and norms both kinds (rmsnorm, layernorm with a bias);
the MoE block is ``models/moe.py``.

Under tensor-parallel serving (``Runtime.rules``, set by the engine from
its mesh; ``serve/tp.py``) :func:`dense` runs a placed QTensor column-
parallel, and :func:`attention_apply` attends this rank's KV heads against
its head-sharded cache, then gathers the heads: every rank leaves each
block holding the whole activations.

Under the training split (``Runtime.model_split``, set by the train step
alone; ``train/tp.py``) the params are this rank's model slices: the MLP
runs gate and up column-parallel and down row-parallel, and the attention
either attends this rank's ``kv_heads / m`` groups (wq, wk, wv column-,
wo row-parallel), or, where the KV heads do not divide the axis (the
reference's ``kv_seq``), projects every head on the gathered weights and
attends all queries to this rank's block of T/m keys, merging the ranks'
(acc, max, sum) (:func:`_merge_blocks`); where T does not divide the axis
either, it attends replicated. Every block leaves the whole activations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.utils.checkpoint as ckpt_util

from repro_torch.core.qlinear import qmatmul
from repro_torch.core.quantize import QTensor
from repro_torch.kernels.attn_q8 import decode_attn_q8, prefill_attn_q8
from repro_torch.serve.kv_quant import kv_encode_pair

__all__ = ["Runtime", "dense", "norm_apply", "rope", "activate", "mlp_apply",
           "attention_apply"]

Params = dict[str, Any]
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution-time knobs threaded through every apply function (the
    subset of the reference's ``Runtime`` the port serves and trains
    with)."""

    quant_mode: str = "activations"  # qmatmul mode for QTensor weights
    backend: str = "auto"  # auto | ref | cuda (qmatmul and q8 attention)
    kv_quant: bool = False  # rotated-int8 KV cache (serve/kv_quant.py codec)
    decode_token_cache: bool = True  # decode writes one token per layer
    # W3A8 integer compute path: rotate and int8-quantize the activations
    # and contract against the ternary codes with int32 partials
    # (core/act_quant.py). QMeta.act_quant opts single weights out.
    act_quant: bool = False
    capacity_factor: float = 1.25  # MoE expert capacity factor
    attn_chunk: int = 512  # query-chunk size of the fp softmax attention
    # training (models/lm.py:_maybe_remat): recompute each layer in the
    # backward pass; "dots" keeps its plain matmul outputs, "none" nothing
    remat: bool = False
    remat_policy: str = "none"  # none | dots
    rwkv_mode: str = "chunked"  # RWKV6 prefill: chunked | scan (stepwise)
    # tensor-parallel serving (serve/tp.py): the serving Rules, whose mesh
    # is this rank's view of the process group; None on one device
    rules: Any = None
    # training on a mesh (train/sharded.py): the mesh whose batch ranks
    # split the rows, so the MoE aux's means are taken over the global
    # batch; None on one device or one batch rank
    batch_mesh: Any = None
    # training on a mesh whose model axis splits the compute: this rank's
    # train/tp.py ModelSplit (set by the train step, never by serving)
    model_split: Any = None


def dense(x: torch.Tensor, w, rt: Runtime, bias=None, *,
          row: bool = False) -> torch.Tensor:
    """``x @ w (+ bias)`` with QTensor dispatch (the quantization seam);
    under ``rt.rules`` a QTensor runs column-parallel. Under
    ``rt.model_split`` a plain-tensor slice runs by its leaf's role:
    column-parallel on an ``x`` already entered into the split region
    (the caller enters it once for all the products that read it), and,
    with ``row``, row-parallel: the partial products summed over the
    model group in f32 before the bias."""
    if isinstance(w, QTensor) and rt.rules is not None:
        from repro_torch.serve import tp as tp_mod  # layers <-> serve
        y = tp_mod.tp_qmatmul(x, w, rt.rules, mode=rt.quant_mode,
                              backend=rt.backend, act_quant=rt.act_quant)
    elif isinstance(w, QTensor):
        y = qmatmul(x, w, mode=rt.quant_mode, backend=rt.backend,
                    act_quant=rt.act_quant)
    else:
        y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if row:
        y = rt.model_split.leave(y)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def norm_apply(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    x = x.to(torch.float32)
    if kind == "rmsnorm":
        x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(f"unknown norm {kind!r}")
    x = x * p["scale"]
    if "bias" in p:
        x = x + p["bias"]
    return x


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         pct: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the trailing head_dim of x (..., T, HD);
    ``positions`` (..., T) absolute positions."""
    hd = x.shape[-1]
    rot = int(hd * pct)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def activate(activation: str, up: torch.Tensor, gate=None) -> torch.Tensor:
    """The MLP's hidden activation from its ``up`` (and, swiglu, ``gate``)
    projection: ``silu(gate) * up``; ``gelu`` in the tanh form, which is
    ``jax.nn.gelu``'s default; ``relu2`` = ``relu(up) ** 2``, no gate."""
    if activation == "swiglu":
        return torch.nn.functional.silu(gate) * up
    if activation == "gelu":
        return torch.nn.functional.gelu(up, approximate="tanh")
    if activation == "relu2":
        return torch.square(torch.relu(up))
    raise ValueError(f"unknown activation {activation!r}")


def mlp_apply(p: Params, x: torch.Tensor, rt: Runtime,
              activation: str) -> torch.Tensor:
    """The MLP; under a model split whose ``d_ff`` divides the axis, gate
    and up column-parallel and down row-parallel."""
    row = rt.model_split is not None and rt.model_split.has("mlp.up")
    if row:
        x = rt.model_split.enter(x)
    gate = dense(x, p["gate"], rt) if activation == "swiglu" else None
    h = activate(activation, dense(x, p["up"], rt), gate)
    return dense(h, p["down"], rt, row=row)


def _sdpa(q, k, v, *, causal: bool, q_offset, kv_len):
    """Plain attention over an fp cache. q (B, KV, G, Tq, HD); k, v (B,
    KV, Tk, HD); q_offset (B,) absolute position of query 0; kv_len (B,)
    valid keys or None. The cache keeps its dtype: q is taken at k's (a
    bf16 cache is not copied to f32, as the reference keeps K/V in their
    storage dtype) and the softmax runs in f32; all f32 on the serving
    paths."""
    q = q.to(k.dtype)
    b, _, _, tq, hd = q.shape
    tk = k.shape[2]
    s = torch.einsum("bkgqd,bktd->bkgqt", q, k) * (1.0 / math.sqrt(hd))
    kpos = torch.arange(tk, device=q.device)
    mask = torch.ones((b, 1, 1, tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = q_offset[:, None] + torch.arange(tq, device=q.device)
        mask = mask & (kpos[None, None, None, None, :]
                       <= qpos[:, None, None, :, None])
    if kv_len is not None:
        mask = mask & (kpos[None, None, None, None, :]
                       < kv_len[:, None, None, None, None])
    w = torch.softmax(s.masked_fill(~mask, NEG_INF).to(torch.float32), dim=-1)
    return torch.einsum("bkgqt,bktd->bkgqd", w.to(v.dtype), v)


def _sdpa_chunked(q, k, v, rt: Runtime, *, causal: bool, q_offset,
                  kv_len, k_offset: int = 0, partial: bool = False):
    """:func:`_sdpa` over chunks of ``min(rt.attn_chunk, Tq)`` queries, each
    against every key (the reference's ``_sdpa_chunked``), so a long
    prompt never holds a (Tq, Tk) score tensor. The queries are padded to
    a multiple of the chunk; chunk ``ci`` takes the causal positions
    ``q_offset + ci * chunk + arange(chunk)``. With grad enabled and more
    than one chunk, each chunk runs under a non-reentrant checkpoint, so
    the backward pass recomputes its scores instead of keeping them (the
    reference's ``jax.checkpoint`` per chunk). One chunk is :func:`_sdpa`
    itself, bit for bit. Over more, each chunk is two ``bmm`` over the
    (B * KV) heads and its masking, with K, V, the key positions and the
    ``kv_len`` mask laid out once per call: a 32k prompt runs 128 chunks a
    layer, and their host ops, not their arithmetic, bound its time.

    With ``partial`` (the key-split attention of a training model split)
    the keys are one block at absolute positions ``k_offset + 0..Tk-1``
    and the result is unnormalized: ``(acc (B, KV, G, Tq, HD), m, l (B,
    KV, G, Tq))`` in f32, ``m`` the detached row max of the scores and
    ``l`` the sum of ``exp(s - m)``, for :func:`_merge_blocks`. A row
    whose every key is masked has ``m = NEG_INF``: its block weighs
    ``exp(NEG_INF - M) = 0`` in the merge."""
    b, kvh, g, tq, hd = q.shape
    chunk = max(1, min(rt.attn_chunk, tq))
    if chunk == tq and not partial:
        return _sdpa(q, k, v, causal=causal, q_offset=q_offset,
                     kv_len=kv_len)
    tk = k.shape[2]
    if q_offset is None:
        q_offset = torch.zeros((b,), dtype=torch.int64, device=q.device)
    pad = (-tq) % chunk
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad))
    nq = q.shape[3] // chunk
    # (nq, B * KV, G * chunk, HD): each chunk's queries contiguous
    qc = q.to(k.dtype).reshape(b, kvh, g, nq, chunk, hd).permute(
        3, 0, 1, 2, 4, 5).reshape(nq, b * kvh, g * chunk, hd)
    kt = k.reshape(b * kvh, tk, hd).transpose(1, 2)
    v3 = v.reshape(b * kvh, tk, hd)
    kpos = k_offset + torch.arange(tk, device=q.device)
    rows = torch.arange(chunk, device=q.device)[:, None]  # (chunk, 1)
    keep = None if kv_len is None else (
        kpos < kv_len[:, None])[:, None, None, None, :]  # (B, 1, 1, 1, Tk)
    scale = 1.0 / math.sqrt(hd)

    def one_chunk(qi, off):
        s = torch.bmm(qi, kt).view(b, kvh, g, chunk, tk) * scale
        mask = keep
        if causal:  # (B, 1, 1, chunk, Tk)
            c = kpos <= off.view(b, 1, 1, 1, 1) + rows
            mask = c if mask is None else mask & c
        if mask is not None:
            s = s.masked_fill(~mask, NEG_INF)
        s = s.to(torch.float32)
        if partial:
            m = torch.amax(s.detach(), dim=-1, keepdim=True)
            e = torch.exp(s - m)
            acc = torch.bmm(e.to(v.dtype).view(b * kvh, g * chunk, tk), v3)
            return (acc.view(b, kvh, g, chunk, hd).to(torch.float32),
                    m[..., 0], torch.sum(e, dim=-1))
        w = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.bmm(w.view(b * kvh, g * chunk, tk), v3).view(
            b, kvh, g, chunk, hd)

    outs = []
    for ci in range(nq):
        off = q_offset + ci * chunk
        if torch.is_grad_enabled() and nq > 1:
            outs.append(ckpt_util.checkpoint(one_chunk, qc[ci], off,
                                             use_reentrant=False))
        else:
            outs.append(one_chunk(qc[ci], off))
    if partial:
        return tuple(torch.cat(parts, dim=3)[:, :, :, :tq]
                     for parts in zip(*outs))
    return torch.cat(outs, dim=3)[:, :, :, :tq]


def _sdpa_decode_token(q, ck, cv, k_tok, v_tok, *, kv_len):
    """Decode attention against an fp cache that does NOT yet hold the
    current token: softmax over [cached scores | self score]."""
    hd = q.shape[-1]
    tk = ck.shape[2]
    scale = 1.0 / math.sqrt(hd)
    # q at the cache's dtype (a bf16 cache is not copied), as in _sdpa
    s_cache = torch.einsum("bkgqd,bktd->bkgqt", q.to(ck.dtype), ck) * scale
    kpos = torch.arange(tk, device=q.device)
    mask = kpos[None, None, None, None, :] < kv_len[:, None, None, None, None]
    s_cache = torch.where(mask, s_cache, torch.full_like(s_cache, NEG_INF))
    s_self = torch.einsum("bkgqd,bkqd->bkgq", q, k_tok)[..., None] * scale
    w = torch.softmax(torch.cat([s_cache, s_self], dim=-1), dim=-1)
    out = torch.einsum("bkgqt,bktd->bkgqd", w[..., :tk].to(cv.dtype), cv)
    return out + w[..., tk:] * v_tok[:, :, None]


def _write_span(cache: dict, vals: dict, pos_vec: torch.Tensor, t: int):
    """Write a (B, KV, t, X) span per leaf into the cache at per-row start
    ``pos_vec``, in place.

    Dense (B, KV, T, X) leaves: the start is clamped so the span fits, as
    ``lax.dynamic_update_slice`` clamps it in the reference. Paged
    (NB, KV, BS, X) leaves: token ``p`` of slot ``b`` lands in block
    ``table[b, p // BS]`` at offset ``p % BS``, with no clamp; pad and idle
    rows point at the null block, which takes their finite garbage. Two
    slots sharing a prefix block write it with equal values, so the order
    of duplicate writes does not matter."""
    b = pos_vec.shape[0]
    rows = torch.arange(b, device=pos_vec.device)[:, None]
    if "table" in cache:
        bs = cache["k"].shape[2]
        span = pos_vec[:, None] + torch.arange(t, device=pos_vec.device)
        blk = cache["table"][rows, span // bs]  # (B, t)
        off = span % bs
        for key, val in vals.items():
            # (B, t) block and offset around a slice: (B, t, KV, X)
            cache[key][blk, :, off] = val.transpose(1, 2).to(cache[key].dtype)
        return
    tmax = cache["k"].shape[2]
    start = torch.clamp(pos_vec, 0, max(tmax - t, 0))
    span = start[:, None] + torch.arange(t, device=pos_vec.device)  # (B, t)
    for key, val in vals.items():
        # advanced indices around a slice put (B, t) first: (B, t, KV, X)
        cache[key][rows, :, span] = val.transpose(1, 2).to(cache[key].dtype)


def attention_apply(p: Params, x: torch.Tensor, rt: Runtime, cfg, *,
                    cache: Optional[dict] = None, pos=0,
                    token_cache: bool = False, causal: bool = True,
                    memory: Optional[torch.Tensor] = None,
                    cross: bool = False):
    """Self-attention with RoPE, or cross-attention (``cross``). Returns
    (output (B, T, D), cache info).

    * ``cache=None``: attention within ``x`` (no cache), RoPE at positions
      ``pos + 0..T-1``, causal unless ``causal=False`` (the encoder).
    * ``token_cache`` and T == 1 (decode): attend the PRE-write cache plus
      the current token's own (encoded, under kv_quant) K/V, and return
      the token's K/V for the caller to write at ``pos``.
    * otherwise (prefill): write the span's K/V (codes and scales under
      kv_quant) into the cache at ``pos`` in place, then attend the
      POST-write cache causally with ``kv_len = pos + T``. Pad positions of
      a bucketed prompt hold finite garbage behind ``kv_len``.

    A cache dict with a ``"table"`` entry is the paged pool (kv_quant
    only): writes scatter through the table and attention reads through
    it.

    Cross-attention has no RoPE, no bias on K/V and no mask; it attends
    the plain way (``_sdpa_chunked``), as the reference does outside any
    kernel.
    With ``memory`` (B, S, D) it projects K/V from it and, given a cache
    (the layer's fp ``xattn`` leaves, (B, KV, S, HD)), writes them there
    in place; without, it reads them from the cache (decode). The
    reference replaces its cache by the projected K/V whatever their
    length; here a memory whose length is not the cache's raises
    ``ValueError`` instead of writing a cache of another size."""
    if rt.model_split is not None and cache is None and not cross:
        return _split_attention(p, x, rt, cfg, pos=pos, causal=causal), None
    b, t, _ = x.shape
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    g = h // kvh

    q = dense(x, p["wq"], rt, p.get("bq"))
    if cross:
        return _cross_attention(p, q, rt, cfg, cache=cache, memory=memory)
    k = dense(x, p["wk"], rt, p.get("bk")).reshape(b, t, kvh, hd)
    v = dense(x, p["wv"], rt, p.get("bv")).reshape(b, t, kvh, hd)
    pos_vec = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    pos_vec = pos_vec.expand(b) if pos_vec.dim() == 0 else pos_vec
    qpos = pos_vec[:, None] + torch.arange(t, device=x.device)  # (B, T)
    q = rope(q.reshape(b, t, h, hd).transpose(1, 2), qpos[:, None, :],
             cfg.rope_theta, cfg.rotary_pct).reshape(b, kvh, g, t, hd)
    k = rope(k.transpose(1, 2), qpos[:, None, :], cfg.rope_theta,
             cfg.rotary_pct)  # (B, KV, T, HD)
    v = v.transpose(1, 2)

    quant_cache = cache is not None and "k_scale" in cache
    out_cache = None
    tp_mod, heads = _tp_heads(rt, kvh, cache)
    if heads is not None:
        # the cache holds this rank's KV heads alone: K/V are encoded and
        # written for them only; the outputs' heads are gathered below
        k, v = k[:, heads].contiguous(), v[:, heads].contiguous()
    ql = q if heads is None else q[:, heads].contiguous()
    if cache is None:
        out = _sdpa_chunked(q, k, v, rt, causal=causal, q_offset=pos_vec,
                            kv_len=None)
    elif t == 1 and token_cache:
        if quant_cache:
            # the token goes through the codec here, so its self term sees
            # exactly the values every later step reads back from the cache
            (kq, ks), (vq, vs) = kv_encode_pair(k, v, backend=rt.backend)
            out = _decode_q8(tp_mod, q, cache, (kq, ks), (vq, vs), pos_vec,
                             rt)
            out_cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            out = _gathered(tp_mod, _sdpa_decode_token(
                ql, cache["k"], cache["v"], k, v, kv_len=pos_vec), heads, rt)
            out_cache = {"k": k, "v": v}
    elif quant_cache:
        (kq, ks), (vq, vs) = kv_encode_pair(k, v, backend=rt.backend)
        if t == 1:
            # single-token decode without the token write-back: attend the
            # pre-write cache plus the encoded self term, then write
            out = _decode_q8(tp_mod, q, cache, (kq, ks), (vq, vs), pos_vec,
                             rt)
            _write_span(cache, {"k": kq, "v": vq, "k_scale": ks,
                                "v_scale": vs}, pos_vec, t)
        else:
            _write_span(cache, {"k": kq, "v": vq, "k_scale": ks,
                                "v_scale": vs}, pos_vec, t)
            if tp_mod is not None:
                out = tp_mod.tp_prefill_attn_q8(q, cache, pos_vec + t,
                                                pos_vec, rt.rules,
                                                backend=rt.backend)
            else:
                out = prefill_attn_q8(q, cache, pos_vec + t, pos_vec,
                                      backend=rt.backend)
        out_cache = cache
    else:
        _write_span(cache, {"k": k, "v": v}, pos_vec, t)
        out = _gathered(tp_mod, _sdpa_chunked(
            ql, cache["k"], cache["v"], rt, causal=t > 1, q_offset=pos_vec,
            kv_len=pos_vec + t), heads, rt)
        out_cache = cache
    out = out.reshape(b, h, t, hd).transpose(1, 2).reshape(b, t, h * hd)
    return dense(out, p["wo"], rt), out_cache


def _merge_blocks(acc, m, l, split) -> torch.Tensor:
    """The softmax attention of the model group's key blocks from each
    rank's partial :func:`_sdpa_chunked`: the all-reduce max ``M`` of the detached
    maxima, each rank's (acc, l) rescaled by ``exp(m - M)`` and summed over
    the group in one f32 all-reduce, then ``acc / l``."""
    w = torch.exp(m - split.max(m))
    both = split.leave(torch.cat([acc * w[..., None], (l * w)[..., None]],
                                 dim=-1))
    return both[..., :-1] / both[..., -1:]


def _split_attention(p: Params, x: torch.Tensor, rt: Runtime, cfg, *, pos,
                     causal: bool) -> torch.Tensor:
    """Self-attention without a cache under ``rt.model_split``: this
    rank's ``kv_heads / m`` groups where they divide the axis, else every
    head on wq, wk, wv gathered whole in one collective (replicated
    compute) attending all queries to this rank's T/m keys (``kv_seq``;
    replicated where T does not divide the axis); wo row-parallel where it
    holds its rows' slice. Q, K and V are one product, entered into the
    split once. Returns the (B, T, D) output, the same on every rank."""
    split = rt.model_split
    b, t, _ = x.shape
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    g = h // kvh
    pos_vec = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    pos_vec = pos_vec.expand(b) if pos_vec.dim() == 0 else pos_vec
    qpos = pos_vec[:, None] + torch.arange(t, device=x.device)  # (B, T)
    names = ("wq", "wk", "wv")
    seq = not split.heads and t % split.ways == 0
    if split.heads:
        x = split.enter(x)
        h, kvh = h // split.ways, kvh // split.ways
        w = torch.cat([p[n] for n in names], -1)
    else:
        w = split.whole_cat([p[n] for n in names],
                            [f"attn.{n}" for n in names], -1)
    sizes = [h * hd, kvh * hd, kvh * hd]
    bias = None
    if "bq" in p:  # the config's QKV biases, all three
        bias = torch.cat([p["bq"], p["bk"], p["bv"]])
        if split.heads:  # the blocks of this rank's heads
            bias = torch.cat([bv.narrow(0, *split.block(bv.shape[0]))
                              for bv in split.enter(bias).split(
                                  [n * split.ways for n in sizes])])
    qkv = dense(x, w, rt, bias)
    if seq:
        qkv = split.enter(qkv)
    q, k, v = qkv.split(sizes, -1)
    q = rope(q.reshape(b, t, h, hd).transpose(1, 2), qpos[:, None, :],
             cfg.rope_theta, cfg.rotary_pct).reshape(b, kvh, g, t, hd)
    k = rope(k.reshape(b, t, kvh, hd).transpose(1, 2), qpos[:, None, :],
             cfg.rope_theta, cfg.rotary_pct)
    v = v.reshape(b, t, kvh, hd).transpose(1, 2)
    if seq:
        lo, n = split.block(t)
        out = _merge_blocks(*_sdpa_chunked(
            q, k[:, :, lo:lo + n], v[:, :, lo:lo + n], rt, causal=causal,
            q_offset=pos_vec, kv_len=None, k_offset=lo, partial=True),
            split)
    else:
        out = _sdpa_chunked(q, k, v, rt, causal=causal, q_offset=pos_vec,
                            kv_len=None)
    out = out.reshape(b, h, t, hd).transpose(1, 2).reshape(b, t, h * hd)
    if split.heads:
        return dense(out, p["wo"], rt, row=True)
    if split.has("attn.wo"):
        return dense(split.own(out, -1), p["wo"], rt, row=True)
    return dense(out, p["wo"], rt)


def _tp_heads(rt: Runtime, kvh: int, cache):
    """(the tp module, this rank's KV heads) against a head-sharded
    cache; (tp, None) under a replicated one; (None, None) without a
    mesh."""
    if rt.rules is None:
        return None, None
    from repro_torch.serve import tp as tp_mod  # layers <-> serve
    if cache is None:
        return tp_mod, None
    return tp_mod, tp_mod.head_slice(kvh, rt.rules)


def _gathered(tp_mod, out: torch.Tensor, heads, rt: Runtime):
    """``out`` (B, KV/m, ...) of this rank's heads -> every head."""
    return out if heads is None else tp_mod.gather_heads(out, rt.rules)


def _decode_q8(tp_mod, q, cache, k_tok, v_tok, kv_len, rt: Runtime):
    """Decode attention on the q8 cache, head-sharded under a mesh."""
    if tp_mod is not None:
        return tp_mod.tp_decode_attn_q8(q, cache, k_tok, v_tok, kv_len,
                                        rt.rules, backend=rt.backend)
    return decode_attn_q8(q, cache, k_tok, v_tok, kv_len, backend=rt.backend)


def _cross_attention(p: Params, q: torch.Tensor, rt: Runtime, cfg, *,
                     cache: Optional[dict], memory: Optional[torch.Tensor]):
    """The cross branch of :func:`attention_apply` on the projected
    queries ``q`` (B, T, H * HD)."""
    b, t, _ = q.shape
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    q = q.reshape(b, t, h, hd).transpose(1, 2).reshape(b, kvh, h // kvh, t,
                                                       hd)
    tp_mod, heads = _tp_heads(rt, kvh, cache)
    if heads is not None:
        q = q[:, heads]
    if memory is not None:
        s = memory.shape[1]
        if cache is not None and cache["k"].shape[2] != s:
            raise ValueError(
                f"cross-attention memory of {s} positions against a cache "
                f"of {cache['k'].shape[2]} (the config's frontend_len)")
        k = dense(memory, p["wk"], rt).reshape(b, s, kvh, hd).transpose(1, 2)
        v = dense(memory, p["wv"], rt).reshape(b, s, kvh, hd).transpose(1, 2)
        if heads is not None:
            k, v = k[:, heads], v[:, heads]
        if cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    else:
        if cache is None:
            raise ValueError("cross-attention decode needs cached memory K/V")
        k, v = (cache[n].to(torch.float32) for n in ("k", "v"))
    out = _gathered(tp_mod, _sdpa_chunked(q, k, v, rt, causal=False,
                                          q_offset=None, kv_len=None),
                    heads, rt)
    out = out.reshape(b, h, t, hd).transpose(1, 2).reshape(b, t, h * hd)
    return dense(out, p["wo"], rt), cache
