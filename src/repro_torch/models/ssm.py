"""State-space and linear-attention blocks (port of ``repro/models/ssm.py``):
Mamba2 (SSD) and RWKV6 (Finch).

Mamba2 runs the chunked SSD algorithm: within a chunk, attention-like
products under a decay mask; across chunks, the state carried by an
explicit loop (the reference's ``lax.scan``). The masks come from
pairwise differences of cumulative log-decays, masked to ``-inf`` before
``exp``, so every exponentiated quantity is <= 0. Decode is the O(1)
state update with a rolled convolution window.

RWKV6 has per-channel data-dependent decay. Prefill runs either the
chunked (GLA-style) form in 16-step chunks (``Runtime.rwkv_mode=
"chunked"``, the default) or the step-by-step scan (``"scan"``); decode is
one step of the recurrence. The LoRA decay is a plain f32 product and its
weights are never quantized.

Both blocks take and return ``(x, state)``; states are f32 dicts whose
leading axis is the batch: Mamba2 ``{"ssm": (B, H, N, P), "conv": (B,
kw - 1, ed + 2N)}``, RWKV6 ``{"wkv": (B, H, hd_k, hd_v), "tm_prev": (B,
D), "cm_prev": (B, D)}``. The projections flow through
:func:`~repro_torch.models.layers.dense`, so ITQ3_S leaves run the card's
kernels; the scans themselves are plain PyTorch, as the reference leaves
them to XLA.

Under a training model split (``Runtime.model_split``, ``train/tp.py``)
each block runs on this rank's heads where they divide the axis, the
scans unchanged: the column-parallel projections on the entered input,
this rank's blocks of the replicated per-head leaves, the norm over the
split width from the group's sums, and the output projection (and
RWKV6's channel mix, on ``cm_k``'s columns) row-parallel; otherwise the
mixer runs replicated on its projections made whole.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Runtime, dense, norm_apply

Params = dict[str, Any]

__all__ = ["MAMBA_HEADDIM", "CHUNK", "RWKV_CHUNK", "mamba2_dims",
           "mamba2_empty_state", "mamba2_apply", "rwkv6_dims",
           "rwkv6_empty_state", "rwkv6_apply"]

MAMBA_HEADDIM = 64
CHUNK = 128
RWKV_CHUNK = 16  # exp(-L) <= e^(e*16) ~ 8e18: safely inside f32 range


def _f32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32)


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

def mamba2_dims(cfg) -> tuple[int, int, int]:
    """(expanded width, heads of MAMBA_HEADDIM, state size N)."""
    ed = cfg.ssm_expand * cfg.d_model
    return ed, ed // MAMBA_HEADDIM, cfg.ssm_state


def mamba2_empty_state(cfg, batch: int, *, device="cuda") -> Params:
    ed, h, n = mamba2_dims(cfg)
    return {"ssm": torch.zeros(batch, h, n, MAMBA_HEADDIM, device=device),
            "conv": torch.zeros(batch, cfg.ssm_conv - 1, ed + 2 * n,
                                device=device)}


def _segsum(logd: torch.Tensor) -> torch.Tensor:
    """Pairwise decay exponent: out[t, s] = sum_{s < u <= t} logd[u] for
    t >= s, -inf above the diagonal. logd (..., T)."""
    t = logd.shape[-1]
    cs = torch.cumsum(logd, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # (..., T, T): L_t - L_s
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=logd.device))
    return torch.where(mask, diff, float("-inf"))


def _mamba2_chunk_scan(xh, dt, bm, cm, a, *, state):
    """Chunked SSD. xh (B, T, H, P), dt (B, T, H), bm / cm (B, T, N), a
    (H,) > 0, state (B, H, N, P). Returns (y (B, T, H, P), final state).
    A ragged tail is padded with dt = 0 and zero inputs: no decay and no
    state update there."""
    b, t, h, p = xh.shape
    lc = min(CHUNK, t)
    pad = (-t) % lc
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    logd_all = -(a * dt)  # (B, T, H) log decay <= 0
    s, ys = state, []
    for c0 in range(0, xh.shape[1], lc):
        cut = slice(c0, c0 + lc)
        xc, dtc, bc, cc, logd = (xh[:, cut], dt[:, cut], bm[:, cut],
                                 cm[:, cut], logd_all[:, cut])
        xbar = xc * dtc[..., None]  # dt folded into the input
        decay = torch.exp(_segsum(logd.transpose(1, 2)))  # (B, H, lc, lc)
        # intra-chunk: y[t] += C_t . B_s (decay t <- s) xbar_s
        scores = torch.einsum("btn,bsn->bts", cc, bc)[:, None] * decay
        y = torch.einsum("bhts,bshp->bthp", scores, xbar)
        # inter-chunk: y[t] += C_t . (decay to t * s_in)
        cum = torch.cumsum(logd, dim=1)  # (B, lc, H)
        y = y + torch.einsum("btn,bhnp->bthp", cc, s) * torch.exp(
            cum)[..., None]
        # s' = decay_all * s + sum_s decay_from_s B_s xbar_s
        tot = cum[:, -1]  # (B, H)
        rem = torch.exp(tot[:, None] - cum)  # decay from step s to the end
        s = torch.exp(tot)[..., None, None] * s + torch.einsum(
            "bsn,bshp->bhnp", bc, xbar * rem[..., None])
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :t], s


def mamba2_apply(p: Params, x: torch.Tensor, rt: Runtime, cfg, *,
                 state: Optional[Params] = None, decode: bool = False):
    """One Mamba2 mixer on ``x`` (B, T, D). ``decode`` (T == 1, a state
    given) rolls the convolution window and updates the state in O(1);
    otherwise the chunked scan from ``state`` (zeros when None). Returns
    (output (B, T, D), the new state, or None without a state)."""
    b, t, _ = x.shape
    ed, h, n = mamba2_dims(cfg)
    split = rt.model_split
    heads = split is not None and split.case("mamba") == "heads"
    xs = x  # the input of the products whose outputs are split by heads
    if split is not None:
        p, xs = _mamba2_split(p, x, split, heads, ed)
        if heads:
            ed, h = ed // split.ways, h // split.ways
    z = _f32(dense(xs, p["wz"], rt))
    xh = _f32(dense(xs, p["wx"], rt))
    bm = _f32(dense(x, p["wB"], rt))
    cm = _f32(dense(x, p["wC"], rt))
    dt = _f32(dense(xs, p["wdt"], rt)) + p["dt_bias"]
    # jax.nn.softplus is logaddexp(x, 0) everywhere; torch's softplus
    # returns x past its threshold
    dt = torch.logaddexp(dt, torch.zeros_like(dt))  # (B, T, H)
    a = torch.exp(p["A_log"])  # (H,) positive

    conv_in = torch.cat([xh, bm, cm], dim=-1)  # (B, T, ed + 2N)
    conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    kw = cfg.ssm_conv
    if decode:
        window = torch.cat([_f32(state["conv"]), conv_in], dim=1)
        new_conv = window[:, 1:]
        conv = torch.einsum("bkc,kc->bc", window, conv_w) + p["conv_b"]
        conv = F.silu(conv)[:, None]  # (B, 1, C)
    else:
        prevk = (_f32(state["conv"]) if state is not None else
                 x.new_zeros((b, kw - 1, ed + 2 * n), dtype=torch.float32))
        window = torch.cat([prevk, conv_in], dim=1)
        new_conv = window[:, -(kw - 1):]
        stacked = torch.stack([window[:, i:i + t] for i in range(kw)], dim=2)
        conv = F.silu(torch.einsum("btkc,kc->btc", stacked, conv_w)
                      + p["conv_b"])

    xh_c, b_c, c_c = torch.split(conv, [ed, n, n], dim=-1)
    if heads:  # B and C, computed whole, feed every head
        b_c, c_c = split.enter(conv[..., ed:]).split([n, n], dim=-1)
    xhh = xh_c.reshape(b, t, h, MAMBA_HEADDIM)

    if decode:
        s = _f32(state["ssm"])  # (B, H, N, P)
        decay = torch.exp(-(a * dt[:, 0]))  # (B, H)
        xbar = xhh[:, 0] * dt[:, 0][..., None]  # (B, H, P)
        s_new = decay[..., None, None] * s + torch.einsum(
            "bn,bhp->bhnp", b_c[:, 0], xbar)
        y = torch.einsum("bn,bhnp->bhp", c_c[:, 0], s_new)[:, None]
        new_state = {"ssm": s_new, "conv": new_conv}
    else:
        s0 = (_f32(state["ssm"]) if state is not None else
              x.new_zeros((b, h, n, MAMBA_HEADDIM), dtype=torch.float32))
        y, s_new = _mamba2_chunk_scan(xhh, dt, b_c, c_c, a, state=s0)
        new_state = ({"ssm": s_new, "conv": new_conv} if state is not None
                     else None)

    y = y + xhh * p["D"][None, None, :, None]  # skip connection
    y = norm_apply(p["norm"], y.reshape(b, t, ed), "rmsnorm",
                   split=split if heads else None) * F.silu(z)
    if split is None:
        return dense(y, p["out_proj"], rt), new_state
    row = split.has("mamba.out_proj")
    if row and not heads:
        y = split.own(y, -1)
    return dense(y, p["out_proj"], rt, row=row), new_state


def _mamba2_split(p: Params, x: torch.Tensor, split, heads: bool, ed: int):
    """(this rank's view of a Mamba2 mixer's leaves, the input its
    head-split products read) under a training model split. ``heads``:
    wz, wx (and, by the caller, out_proj) are the rank's model slices,
    the input is entered, and the rank takes its heads' blocks of the
    replicated wdt, dt_bias, A_log, D, conv_x, the first ``ed`` entries of
    conv_b and the norm's scale; wB, wC and the B and C channels of the
    convolution stay whole. Else the mixer runs replicated on wz and wx
    made whole."""
    if not heads:
        return dict(p, wz=split.whole(p["wz"], "mamba.wz", -1),
                    wx=split.whole(p["wx"], "mamba.wx", -1)), x
    own = split.own
    return dict(p, wdt=own(p["wdt"], -1), dt_bias=own(p["dt_bias"], 0),
                A_log=own(p["A_log"], 0), D=own(p["D"], 0),
                conv_x=own(p["conv_x"], -1),
                conv_b=torch.cat([own(p["conv_b"][:ed], 0),
                                  p["conv_b"][ed:]])), split.enter(x)


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================

def rwkv6_dims(cfg) -> tuple[int, int]:
    return cfg.num_heads, cfg.resolved_head_dim


def rwkv6_empty_state(cfg, batch: int, *, device="cuda") -> Params:
    h, hd = rwkv6_dims(cfg)
    d = cfg.d_model
    return {"wkv": torch.zeros(batch, h, hd, hd, device=device),
            "tm_prev": torch.zeros(batch, d, device=device),
            "cm_prev": torch.zeros(batch, d, device=device)}


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x (B, T, D) -> the previous-token stream, ``prev`` carried in."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _rwkv6_chunk_scan(r, k, v, logw, u, s0, *, chunk: int = RWKV_CHUNK):
    """Chunked WKV6: S_t = diag(w_t) S_{t-1} + k_t v_t^T and
    y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t as products within each
    chunk plus an inter-chunk state loop. With L_t the cumulative log w
    inside a chunk: qt = r_t exp(L_{t-1}), kt~ = k_t exp(-L_t), strictly
    causal scores qt . kt~_s, y += qt @ S_in, S_out = diag(exp(L_last))
    S_in + (k exp(L_last - L))^T v. A ragged tail is padded with log w = 0
    and zero r, k, v: a no-op on the state.

    r, k, v, logw (B, T, H, hd); u (H, hd); s0 (B, H, hd, hd). Returns
    (y (B, T, H, hd), final state)."""
    b, t, h, hd = r.shape
    lc = min(chunk, t)
    pad = (-t) % lc
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    smask = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=r.device),
                       diagonal=-1)  # strictly causal
    s, ys = s0, []
    for c0 in range(0, r.shape[1], lc):
        cut = slice(c0, c0 + lc)
        rc, kc, vc, lw = r[:, cut], k[:, cut], v[:, cut], logw[:, cut]
        lt = torch.cumsum(lw, dim=1)
        qt = rc * torch.exp(lt - lw)  # r_t * exp(L_{t-1})
        ktil = kc * torch.exp(-lt)
        att = torch.einsum("bthd,bshd->bhts", qt, ktil)
        att = torch.where(smask[None, None], att, 0.0)
        y = torch.einsum("bhts,bshd->bthd", att, vc)
        y = y + torch.einsum("bthk,bhkv->bthv", qt, s)
        bonus = torch.einsum("bthd,bthd->bth", rc, u[None, None] * kc)
        y = y + bonus[..., None] * vc
        ltot = lt[:, -1]  # (B, H, hd)
        krem = kc * torch.exp(ltot[:, None] - lt)
        s = torch.exp(ltot)[..., None] * s + torch.einsum(
            "bshk,bshv->bhkv", krem, vc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :t], s


def _wkv_step(s, r, k, v, w, u):
    """One step of the recurrence; each of r, k, v, w (B, H, hd)."""
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    y = torch.einsum("bhk,bhkv->bhv", r, s + u[None, :, :, None] * kv)
    return w[..., None] * s + kv, y


def rwkv6_apply(p: Params, x: torch.Tensor, rt: Runtime, cfg, *,
                state: Optional[Params] = None, decode: bool = False):
    """A full RWKV6 layer on ``x`` (B, T, D): ``x + time_mix(ln1(x))``,
    then ``+ channel_mix(ln2(.))``, norms and residuals inside (the token
    shift acts on the normed streams and carries across calls in the
    state). Returns (x_new, new state or None without a state)."""
    b, t, d = x.shape
    h, hd = rwkv6_dims(cfg)
    split = rt.model_split
    heads = split is not None and split.case("time_mix") == "heads"
    if heads:
        h //= split.ways
    st = (state if state is not None
          else rwkv6_empty_state(cfg, b, device=x.device))

    x_res = _f32(x)
    xf = norm_apply(p["ln1"], x_res, "layernorm")
    prev = _token_shift(xf, _f32(st["tm_prev"]))
    mu = p["mu"][:, None, None, :]  # (5, 1, 1, D)
    xs = xf[None] + (prev - xf)[None] * mu  # streams r, k, v, w, g

    xe, dd = xs, None  # the streams the head-split products read
    if split is not None:
        p, xe, dd = _time_mix_split(p, xs, split, heads)
    r = _f32(dense(xe[0], p["wr"], rt)).reshape(b, t, h, hd)
    k = _f32(dense(xe[1], p["wk"], rt)).reshape(b, t, h, hd)
    v = _f32(dense(xe[2], p["wv"], rt)).reshape(b, t, h, hd)
    g = _f32(dense(xe[4], p["wg"], rt))
    if dd is None:
        dd = torch.matmul(torch.tanh(torch.matmul(xs[3], p["w_lora_a"])),
                          p["w_lora_b"])
    logw = -torch.exp(torch.clamp(p["w_base"] + dd, -8.0, 1.0))  # <= 0
    w = torch.exp(logw).reshape(b, t, h, hd)  # decay in (0, 1)
    u = p["u"]  # (H, hd)
    # (B, H, hd_k, hd_v); the rank's H/m heads of the zeros in training
    s0 = _f32(st["wkv"])[:, :h]

    if decode:
        s_new, y = _wkv_step(s0, r[:, 0], k[:, 0], v[:, 0], w[:, 0], u)
        y = y[:, None]
    elif rt.rwkv_mode == "chunked":
        y, s_new = _rwkv6_chunk_scan(r, k, v, logw.reshape(b, t, h, hd), u,
                                     s0)
    elif rt.rwkv_mode == "scan":
        s_new, ys = s0, []
        for i in range(t):
            s_new, yi = _wkv_step(s_new, r[:, i], k[:, i], v[:, i], w[:, i],
                                  u)
            ys.append(yi)
        y = torch.stack(ys, dim=1)
    else:
        raise ValueError(f"unknown rwkv_mode {rt.rwkv_mode!r}")

    y = norm_apply(p["ln_out"], y.reshape(b, t, h * hd), "layernorm",
                   split=split if heads else None) * F.silu(g)
    row = split is not None and split.has("wo")
    if row and not heads:
        y = split.own(y, -1)
    tm_out = dense(y, p["wo"], rt, row=row)

    # residual, then the channel mix (its own LayerNorm and token shift)
    x2 = x_res + _f32(tm_out)
    x2n = norm_apply(p["ln2"], x2, "layernorm")
    prev2 = _token_shift(x2n, _f32(st["cm_prev"]))
    xk = x2n + (prev2 - x2n) * p["cm_mu"][0]
    row = split is not None and split.has("cm_v")
    cm_k = p["cm_k"]
    if row:  # cm_k is stored whole: the rank's d_ff/m columns of it
        xk, cm_k = split.enter(xk), split.own(cm_k, -1)
    kcm = torch.square(torch.relu(dense(xk, cm_k, rt)))
    out = x2 + _f32(dense(kcm, p["cm_v"], rt, row=row))
    new_state = None
    if state is not None:
        new_state = {"wkv": s_new, "tm_prev": xf[:, -1],
                     "cm_prev": x2n[:, -1]}
    return out, new_state


def _time_mix_split(p: Params, xs: torch.Tensor, split, heads: bool):
    """(this rank's view of an RWKV6 time mix's leaves, the streams its
    head-split products read, the rank's block of the decay LoRA's
    output or None) under a training model split. ``heads``: wr, wk, wv,
    wg and wo are the rank's model slices, the streams are entered, the
    rank takes its heads' blocks of w_base, u and ln_out; the LoRA's
    hidden is split with its width (w_lora_a column-, w_lora_b
    row-parallel), so its output's partial sums feed the rank's heads
    reduce-scattered (backward: all-gathered). Else the time mix runs
    replicated on its projections made whole."""
    names = ("wr", "wk", "wv", "wg", "w_lora_a")
    if not heads:
        return dict(p, **{n: split.whole(p[n], n, -1) for n in names},
                    w_lora_b=split.whole(p["w_lora_b"], "w_lora_b", 0)), \
            xs, None
    xe = split.enter(xs)
    dd = split.scatter(torch.matmul(torch.tanh(torch.matmul(
        xe[3], p["w_lora_a"])), p["w_lora_b"]), -1)
    return dict(p, w_base=split.own(p["w_base"], 0),
                u=split.own(p["u"], 0)), xe, dd
