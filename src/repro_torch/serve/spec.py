"""Speculative decoding: the propose / verify / commit primitives (port of
``repro/serve/spec.py``).

The engine's decode tick becomes a window of up to K+1 tokens per slot: a
draft model proposes K candidates from its own cache, the target scores
all K+1 window positions in one pass (``lm.score_tokens``: under
``kv_quant`` one ``prefill_attn_q8`` per layer), and :func:`verify_commit`
turns the target's logits and the candidates into each slot's accepted
prefix plus one window-end token, on the device, so the window's result
comes back in one transfer.

Greedy slots accept draft ``d_{w+1}`` iff it equals the target's argmax at
window position ``w``: the committed stream is the non-speculative greedy
stream. Sampled slots use rejection sampling: accept ``d`` with
probability ``min(1, p(d) / q(d))`` (``p`` the target's masked
distribution, ``q`` the draft's); on the first rejection the window-end
token is drawn from the residual ``max(p - q, 0)``.

PRNG streams per slot key (JAX's threefry, ``core/prng.py``): the
window-end draw at accepted length ``a`` uses ``fold_in(key, gen + a)``,
the non-speculative engine's stream for that token, so a slot with
``draft_tokens=0`` commits the non-speculative sampled stream too; the
acceptance uniforms use ``fold_in(fold_in(key, ACCEPT_TAG), gen + w)`` and
the draft's draws ``fold_in(fold_in(key, DRAFT_TAG), gen + w)``. The tags
are above 2**31 and fold in as uint32. Everything that depends only on the
keys and ``gen`` (:func:`draft_keys`, :func:`window_draws`) is computed on
the host and sent up before the window's forwards are queued.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.quantize import QTensor
from repro_torch.models import lm

__all__ = ["ACCEPT_TAG", "DRAFT_TAG", "accept_uniforms", "draft_keys",
           "window_draws", "verify_commit", "draft_from_params"]

# Stream-splitting tags folded into the slot key before the per-position
# fold; the untagged stream stays the committed tokens'.
ACCEPT_TAG = 0x5EC0_ACCE
DRAFT_TAG = 0x5EC0_D4AF

_EPS = 1e-20


def _host(a) -> np.ndarray:
    """Keys or indices as an int64 numpy array (uint32 values)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a).astype(np.int64)


def accept_uniforms(keys, gen, k: int) -> torch.Tensor:
    """(S, K) f32 acceptance uniforms, on the CPU: ``u[s, w]`` from slot
    ``s``'s ACCEPT stream at generation index ``gen[s] + w``."""
    tagged = prng.fold_in(_host(keys), ACCEPT_TAG)  # (S, 2)
    idx = _host(gen)[:, None] + np.arange(k)  # (S, K)
    return prng.uniform(torch.from_numpy(prng.fold_in(tagged[:, None], idx)),
                        ())


def draft_keys(keys, gen, w: int) -> np.ndarray:
    """(S, 2) keys of the draft's ``w``-th proposal draw, on the host."""
    return prng.fold_in(prng.fold_in(_host(keys), DRAFT_TAG),
                        _host(gen) + w)


def _natural_keys(keys, gen, a) -> np.ndarray:
    """Window-end keys, the untagged stream at index ``gen + a``; ``a``
    (S,) or (S, A) gives (S, 2) or (S, A, 2)."""
    keys, a = _host(keys), _host(a)
    g = _host(gen).reshape((-1,) + (1,) * (a.ndim - 1))
    return prng.fold_in(keys.reshape(keys.shape[:1] + (1,) * (a.ndim - 1)
                                     + (2,)), g + a)


def window_draws(keys, gen, k: int, device) -> tuple:
    """The host-side draws of one window on ``device``: the acceptance
    uniforms (S, K) and the K+1 candidate window-end keys (S, K+1, 2), of
    which the device gathers the one at each slot's accepted length."""
    s = len(_host(gen))
    ends = _natural_keys(keys, gen, np.broadcast_to(np.arange(k + 1),
                                                    (s, k + 1)))
    return (accept_uniforms(keys, gen, k).to(device),
            torch.as_tensor(ends, device=device))


def verify_commit(logits: torch.Tensor, cand: torch.Tensor,
                  kvec: torch.Tensor, *, keys=None, gen=None, temp=None,
                  top_k=None, top_p=None, qlog=None, draws=None):
    """The committed tokens of one window.

    ``logits`` (S, K+1, V) are the target's over the window: ``logits[:,
    w]`` follows ``cand[:, :w+1]`` (``cand[:, 0]`` the anchor token already
    emitted, ``cand[:, 1:]`` the proposals). ``kvec`` (S,) the proposals
    each slot may accept, in [0, K]. ``keys=None`` and ``draws=None``: an
    all-greedy window. Otherwise ``keys`` (S, 2) and ``gen`` (S,) give the
    draws (:func:`window_draws`), or ``draws`` gives them ready on the
    device; ``temp`` (S,), ``top_k``, ``top_p`` (S,) or None, and ``qlog``
    (S, K, V) the draft's scaled and masked logits. Returns ``(out (S,
    K+1), n (S,))`` int32: slot ``s`` commits ``out[s, :n[s]]``, its
    accepted prefix and one window-end token, ``1 <= n <= kvec + 1``."""
    s, k1, _ = logits.shape
    k = k1 - 1
    dev = logits.device
    rows = torch.arange(s, device=dev)
    cand = cand.to(torch.int32)
    gr = torch.argmax(logits, dim=-1).to(torch.int32)  # (S, K+1)
    greedy_acc = cand[:, 1:] == gr[:, :k]  # (S, K)
    if draws is None and keys is not None:
        draws = window_draws(keys, gen, k, dev)
    if draws is None:
        accept = greedy_acc
    else:
        u, ends = draws
        temp = temp.to(torch.float32)
        scaled = logits.to(torch.float32) / torch.clamp_min(
            temp, 1e-6)[:, None, None]
        if top_k is not None or top_p is not None:
            # the (B, V) filters over the flattened window, each slot's
            # filter repeated over its K+1 positions
            masked = lm.top_mask(
                scaled.reshape(s * k1, -1),
                None if top_k is None else top_k.repeat_interleave(k1),
                None if top_p is None else top_p.repeat_interleave(k1))
            masked = masked.reshape(s, k1, -1)
        else:
            masked = scaled
        p = torch.softmax(masked, dim=-1)  # (S, K+1, V)
        q = torch.softmax(qlog.to(torch.float32), dim=-1)  # (S, K, V)
        d_idx = cand[:, 1:, None].to(torch.int64)
        p_d = torch.gather(p[:, :k], -1, d_idx)[..., 0]
        q_d = torch.gather(q, -1, d_idx)[..., 0]
        sampled_acc = u * torch.clamp_min(q_d, _EPS) < p_d
        accept = torch.where(temp[:, None] > 0, sampled_acc, greedy_acc)
    window = accept & (torch.arange(k, device=dev)[None, :]
                       < kvec.to(dev)[:, None])
    # the leading accepted run: the first rejection cuts the rest
    a = torch.cumprod(window.to(torch.int32), dim=1).sum(dim=1)
    if draws is None:
        end_tok = gr[rows, a]
    else:
        nat = ends[rows, a]  # (S, 2): the stream at gen + a
        # the direct draw is the non-speculative engine's sample for that
        # index (same stream, same masking); temp <= 0 rows take argmax
        direct = lm.sample_tokens(logits[rows, a], nat, temp, top_k=top_k,
                                  top_p=top_p)
        q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
        resid = torch.clamp_min(p[rows, a] - q_pad[rows, a], 0.0)
        res_ok = resid.sum(dim=-1) > _EPS
        logr = torch.where(resid > 0, torch.log(torch.clamp_min(resid, 1e-38)),
                           float("-inf"))
        res_tok = prng.categorical(nat, logr).to(torch.int32)
        use_res = (temp > 0) & (a < kvec.to(dev)) & res_ok
        end_tok = torch.where(use_res, res_tok, direct)
    # out[:, j] = d_{j+1} for j < a, the window-end token at j = a
    shifted = torch.cat([cand[:, 1:], cand[:, :1]], dim=1)
    out = torch.where(torch.arange(k1, device=dev)[None, :] < a[:, None],
                      shifted, end_tok.to(torch.int32)[:, None])
    return out.to(torch.int32), (a + 1).to(torch.int32)


def _first_layers(node, n: int):
    if isinstance(node, dict):
        return {k: _first_layers(v, n) for k, v in node.items()}
    if isinstance(node, QTensor):
        return node.first_layers(n)
    return node[:n]


def draft_from_params(params, cfg, n_layers: int):
    """Self-draft: the ``n_layers``-deep prefix of the target. The stacked
    ``layers`` leaves are sliced along their leading axis (views; a
    QTensor's planes likewise, its 1-D ``dsign`` shared whole); ``embed``,
    ``ln_f`` and ``lm_head`` are the target's own objects. Returns
    ``(draft_params, draft_cfg)``."""
    if cfg.family not in ("dense", "vlm", "moe"):
        raise ValueError(f"self-draft needs a stacked pure-attention family "
                         f"(dense/vlm/moe), got {cfg.family!r}")
    if not 1 <= n_layers <= cfg.num_layers:
        raise ValueError(f"draft depth {n_layers} outside "
                         f"[1, {cfg.num_layers}]")
    draft = dict(params)
    draft["layers"] = _first_layers(params["layers"], n_layers)
    return draft, dataclasses.replace(cfg, num_layers=n_layers)
