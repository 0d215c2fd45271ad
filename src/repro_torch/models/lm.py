"""Model assembly (port of ``repro/models/lm.py``): all six families of
the reference, dense, MoE, SSM (RWKV6), hybrid (Mamba2 + shared
attention), vlm (a projected patch prefix) and audio (an encoder-decoder
with cross-attention).

Parameters are a plain dict mirroring the reference pytree: ``embed``
(V, D), or a QTensor of the transposed table (D, V) when a policy
quantized it, ``ln_f``, optional ``lm_head``, and stacked layer leaves
(tensors, or QTensors with stacked planes). Dense, MoE, SSM, vlm and
audio models hold ``layers`` with a leading layer axis L: a dense layer
an ``mlp`` (``gate`` only for swiglu), an MoE layer a ``moe`` block (an
fp ``router`` (L, D, E) and (L, E, K, N) expert stacks), an SSM layer one
RWKV6 block, an audio decoder layer also ``ln_x`` and an ``xattn`` block
(wq, wk, wv, wo; no bias). A model with a frontend holds
``frontend_proj`` (F, D); an audio model also the non-causal ``encoder``
(L_enc, ...) of dense layers and its ``enc_ln_f``. A hybrid holds one
``shared_attn`` block (``ln``, ``attn``), ``mamba_blocks`` stacked twice,
(n_full, every, ...), and, when ``attn_every`` does not divide L, a
``mamba_tail`` (tail, ...). Where the reference scans over the stacked
layers, the port loops over them and takes each layer's views.

The serving cache is preallocated once and written in place (the
reference's donated buffers): ``{"attn": {"k", "v"[, "k_scale",
"v_scale"]}}`` with (L, B, KV, T, X) leaves for the attention families
(a vlm's T counts its ``frontend_len`` prefix positions too; an audio
model adds ``"xattn": {"k", "v"}``, (L, B, KV, frontend_len, HD) fp
leaves, written by the prefill and read by every decode step);
``{"ssm": {"wkv", "tm_prev", "cm_prev"}}`` with (L, B, ...) f32 leaves
for RWKV6; for the hybrid ``{"attn": ...}`` over its ``ceil(L / every)``
shared-attention applications plus ``{"ssm": {"ssm", "conv"}}`` (L, B,
...). A paged cache (``serve/paged.py``, attention families only) is
``{"attn": {...}, "table": (B, MAXB) int32}`` with (L, NB, KV, BS, X) pool
leaves; the table has no layer axis and joins each layer's cache view.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch
import torch.utils.checkpoint as ckpt_util

from repro_torch.core import formats, prng
from repro_torch.core.fwht import is_pow2
from repro_torch.core.quantize import QTensor
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    Runtime, attention_apply, dense, mlp_apply, norm_apply,
)

Params = dict[str, Any]

__all__ = ["init_params", "init_quantized_params", "shape_params",
           "model_flops", "init_cache", "forward",
           "forward_xent", "decode_step", "score_tokens", "advance_cache",
           "finite_rows", "top_mask", "sample_tokens", "layer_params",
           "hybrid_dims", "hybrid_layer", "recurrent_layer_apply"]


_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _check_family(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def _norm_spec(d: int, kind: str) -> dict:
    out = {"scale": ("ones", (d,))}
    if kind == "layernorm":
        out["bias"] = ("zeros", (d,))
    return out


def _attn_spec(cfg, bias: bool = True) -> dict:
    """An attention block's projections, with the config's QKV biases
    unless ``bias=False`` (cross-attention has none)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    attn = {"wq": ("w", (d, h * hd)), "wk": ("w", (d, kvh * hd)),
            "wv": ("w", (d, kvh * hd)), "wo": ("w", (h * hd, d))}
    if cfg.qkv_bias and bias:
        attn.update(bq=("zeros", (h * hd,)), bk=("zeros", (kvh * hd,)),
                    bv=("zeros", (kvh * hd,)))
    return attn


def _layer_spec(cfg, cross: bool = False) -> dict:
    """One dense or MoE layer's leaves as the reference builds them, in
    the order the seeded draws take them; ``cross`` adds an audio
    decoder layer's ``ln_x`` and ``xattn``. The kinds of every spec here:
    ``("w", shape[, scale])`` a projection drawn N(0, 1/K) clipped at 3
    sigma (K = shape[-2]), times ``scale``; ``("ones" | "zeros", shape)``
    a norm scale or a bias; ``("normal", shape, std)``, ``("uniform",
    shape)`` on [0, 1), ``("full", shape, value)`` and ``("alog",
    shape)``, Mamba2's log(linspace(1, 16, H))."""
    d, f = cfg.d_model, cfg.d_ff
    lead = (cfg.num_experts,) if cfg.family == "moe" else ()
    ffn = {}
    if cfg.family == "moe":
        ffn["router"] = ("w", (d, cfg.num_experts))
    if cfg.activation == "swiglu":
        ffn["gate"] = ("w", lead + (d, f))
    ffn.update(up=("w", lead + (d, f)), down=("w", lead + (f, d)))
    out = {"ln1": _norm_spec(d, cfg.norm), "attn": _attn_spec(cfg)}
    if cross:
        out.update(ln_x=_norm_spec(d, cfg.norm),
                   xattn=_attn_spec(cfg, bias=False))
    out.update({"ln2": _norm_spec(d, cfg.norm),
                "moe" if cfg.family == "moe" else "mlp": ffn})
    return out


def _rwkv6_spec(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    h, hd = ssm_mod.rwkv6_dims(cfg)
    lora = max(32, d // 32)
    return {
        "mu": ("uniform", (5, d)),  # token-shift mixes of r, k, v, w, g
        "wr": ("w", (d, h * hd)), "wk": ("w", (d, h * hd)),
        "wv": ("w", (d, h * hd)), "wg": ("w", (d, h * hd)),
        "wo": ("w", (h * hd, d)),
        "w_base": ("full", (h * hd,), -1.0),
        "w_lora_a": ("w", (d, lora)), "w_lora_b": ("w", (lora, h * hd), 0.1),
        "u": ("normal", (h, hd), 0.1),
        "ln_out": _norm_spec(h * hd, "layernorm"),
        "ln1": _norm_spec(d, "layernorm"), "ln2": _norm_spec(d, "layernorm"),
        "cm_mu": ("uniform", (2, d)),
        "cm_k": ("w", (d, f)), "cm_v": ("w", (f, d)),
    }


def _mamba_spec(cfg) -> dict:
    """One hybrid layer: its pre-norm and a Mamba2 mixer."""
    d, kw = cfg.d_model, cfg.ssm_conv
    ed, h, n = ssm_mod.mamba2_dims(cfg)
    return {"ln": _norm_spec(d, cfg.norm), "mamba": {
        "wz": ("w", (d, ed)), "wx": ("w", (d, ed)), "wB": ("w", (d, n)),
        "wC": ("w", (d, n)), "wdt": ("w", (d, h)),
        "conv_x": ("normal", (kw, ed), 0.1),
        "conv_B": ("normal", (kw, n), 0.1),
        "conv_C": ("normal", (kw, n), 0.1),
        "conv_b": ("zeros", (ed + 2 * n,)),
        "A_log": ("alog", (h,)), "D": ("ones", (h,)),
        "dt_bias": ("full", (h,), float(np.log(np.e - 1) - 2.0)),
        "norm": {"scale": ("ones", (ed,))},
        "out_proj": ("w", (ed, d))}}


def hybrid_dims(cfg) -> tuple[int, int, int]:
    """(attn_every, full macroblocks, tail layers) of a hybrid."""
    every = cfg.attn_every
    return every, cfg.num_layers // every, cfg.num_layers % every


def _stacks(cfg) -> list:
    """The recurrent families' stacked subtrees, in draw order: (key,
    lead axes, one layer's spec)."""
    if cfg.family == "ssm":
        return [("layers", (cfg.num_layers,), _rwkv6_spec(cfg))]
    every, n_full, tail = hybrid_dims(cfg)
    out = [("shared_attn", (), {"ln": _norm_spec(cfg.d_model, cfg.norm),
                                "attn": _attn_spec(cfg)}),
           ("mamba_blocks", (n_full, every), _mamba_spec(cfg))]
    if tail:
        out.append(("mamba_tail", (tail,), _mamba_spec(cfg)))
    return out


def _const(kind, shape, arg=None) -> np.ndarray:
    """A leaf that takes no draw."""
    if kind == "alog":
        row = np.log(np.linspace(1.0, 16.0, shape[-1])).astype(np.float32)
        return np.broadcast_to(row, shape).copy()
    value = {"ones": 1.0, "zeros": 0.0}.get(kind, arg)
    return np.full(shape, value, np.float32)


def _map_spec(spec, fn, path: str = ""):
    if isinstance(spec, dict):
        return {k: _map_spec(v, fn, f"{path}.{k}" if path else k)
                for k, v in spec.items()}
    return fn(path, *spec)


def _param_tree(cfg, draw) -> dict:
    """The params tree of ``cfg``, each leaf ``draw(kind, shape, *arg)``
    (:func:`_layer_spec`'s kinds) called in the order of the seeded draws:
    layer leaves stacked (L, ...), a hybrid's (n_full, every, ...) and
    (tail, ...), an encoder's (L_enc, ...)."""
    d = cfg.d_model

    def stacked(lead):
        def leaf(_, kind, shape, *arg):
            return draw(kind, lead + shape, *arg)
        return leaf

    def norm():
        return _map_spec(_norm_spec(d, cfg.norm), stacked(()))
    ln_f = norm()
    embed_spec = ("normal", (cfg.vocab_size, d), 0.02)
    if cfg.family in ("ssm", "hybrid"):
        tree = {"embed": draw(*embed_spec), "ln_f": ln_f}
        for key, lead, spec in _stacks(cfg):
            tree[key] = _map_spec(spec, stacked(lead))
    else:
        # attention first, then the table, then the rest: the draw order
        # of the earlier dense slices, so their seeded models are unchanged
        leaf = stacked((cfg.num_layers,))
        spec = _layer_spec(cfg, cross=cfg.family == "audio")
        attn = _map_spec(spec["attn"], leaf)
        tree = {"embed": draw(*embed_spec), "ln_f": ln_f,
                "layers": {k: attn if k == "attn" else _map_spec(v, leaf)
                           for k, v in spec.items()}}
        if cfg.family == "audio":
            tree["encoder"] = _map_spec(_layer_spec(cfg),
                                        stacked((cfg.encoder_layers,)))
            tree["enc_ln_f"] = norm()
    if not cfg.tie_embeddings:
        tree["lm_head"] = draw("w", (d, cfg.vocab_size))
    if cfg.frontend:
        tree["frontend_proj"] = draw("w", (cfg.frontend_dim, d))
    return tree


def init_params(cfg, *, seed: int = 0, device="cuda") -> Params:
    """Seeded random fp weights, drawn with numpy: embedding ~
    N(0, 0.02^2), projections (and the MoE router) ~ N(0, 1/K) clipped at
    3 sigma, norm scales 1, biases 0; the reference's tree (LayerNorm
    biases, no gate but for swiglu, expert stacks; RWKV6's and Mamba2's
    leaves at the reference's scales and constants; a frontend's
    projection, an audio model's encoder and cross-attention), stacked as
    :func:`_param_tree` lays it out.
    For CPU-sized models: the whole f32 tree is held at
    once (:func:`init_quantized_params` draws a full-width model on the
    card)."""
    _check_family(cfg)
    rng = np.random.default_rng(seed)

    def draw(kind, shape, arg=None):
        if kind == "w":
            x = rng.standard_normal(shape, dtype=np.float32)
            x = np.clip(x, -3.0, 3.0) / np.float32(np.sqrt(shape[-2]))
            return x if arg is None else x * np.float32(arg)
        if kind == "normal":
            return rng.standard_normal(shape, dtype=np.float32) * np.float32(
                arg)
        if kind == "uniform":
            return rng.random(shape, dtype=np.float32)
        return _const(kind, shape, arg)

    def to_torch(node):
        if isinstance(node, dict):
            return {k: to_torch(v) for k, v in node.items()}
        return torch.as_tensor(node, device=device)
    return to_torch(_param_tree(cfg, draw))


def shape_params(cfg, mode=None) -> Params:
    """The tree of :func:`init_params` with nothing drawn: the same keys,
    shapes and dtypes as fake CPU tensors of ``mode`` (a new
    ``FakeTensorMode`` when None; read it back from any leaf's
    ``fake_mode``), the counterpart of the reference's
    ``jax.eval_shape(lm.init_params)``. It costs nothing at any width, and
    the port's code runs on it under that mode (``quantize_params``, a
    forward or a train step), computing shapes only."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _check_family(cfg)
    mode = FakeTensorMode() if mode is None else mode
    with mode:
        return _param_tree(cfg, lambda kind, shape, *arg: torch.empty(shape))


def model_flops(cfg, seq_len: int, batch: int, *, decode: bool = False) -> float:
    """The reference's analytic FLOPs of a forward (``2 * matmul params *
    tokens`` plus the attention's scores and values), formula for formula:
    the roofline's MODEL_FLOPS term, independent of what implements the
    step (a train step is 3x this, forward and backward)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd = cfg.resolved_head_dim
    attn_p = d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
    mlp_p = 3 * d * f if cfg.activation == "swiglu" else 2 * d * f
    if cfg.num_experts:
        mlp_p = cfg.experts_per_token * mlp_p + d * cfg.num_experts
    if cfg.family == "ssm":
        attn_p = 5 * d * d + d * d  # r, k, v, g, o and the decay's lora
        mlp_p = 2 * d * f
    if cfg.family == "hybrid":
        ed = cfg.ssm_expand * d
        mamba_p = d * (2 * ed + 2 * cfg.ssm_state + ed // 64) + ed * d
        total_p = cfg.num_layers * mamba_p + (attn_p + mlp_p)
    else:
        total_p = cfg.num_layers * (attn_p + mlp_p)
        if cfg.is_encoder_decoder:
            total_p += cfg.encoder_layers * (attn_p + mlp_p)
    total_p += v * d  # head
    tokens = batch * (1 if decode else seq_len)
    flops = 2.0 * total_p * tokens
    if cfg.family != "ssm":  # scores and values of the attention layers
        q_len = 1 if decode else seq_len
        n_attn = (cfg.num_layers if cfg.family != "hybrid"
                  else cfg.num_layers // cfg.attn_every + 1)
        flops += 4.0 * batch * cfg.num_heads * hd * q_len * seq_len * \
            n_attn * (0.5 if not decode else 1.0)
    return flops


def init_quantized_params(cfg, policy, *, seed: int = 0,
                          device="cuda") -> Params:
    """Seeded random weights at full width, quantized under ``policy`` (a
    format name or a ``QuantPolicy``) as they are drawn: one layer's leaf
    at a time from a ``torch.Generator`` on ``device``, so the whole f32
    model (27.7 GB for olmoe-1b-7b) is never held at once. The
    distributions are :func:`init_params`'s; the draws are torch's, not
    numpy's. Each quantized leaf is blocked per matrix, so stacking the
    layers gives the planes of quantizing the stacked leaf at once."""
    from repro_torch.serve.quantized import QuantPolicy, quantize_params

    _check_family(cfg)
    if not isinstance(policy, QuantPolicy):
        policy = QuantPolicy.uniform(policy)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = cfg.d_model

    def draw(kind, shape, arg=None):
        if kind == "w":
            w = torch.randn(shape, generator=gen, device=device)
            w = w.clamp_(-3.0, 3.0).div_(float(np.sqrt(shape[-2])))
            return w if arg is None else w.mul_(arg)
        if kind == "normal":
            return torch.randn(shape, generator=gen, device=device).mul_(arg)
        if kind == "uniform":
            return torch.rand(shape, generator=gen, device=device)
        return torch.as_tensor(_const(kind, shape, arg), device=device)

    def quantized(path, w):
        tree: Any = w
        for key in reversed(path.split(".")):
            tree = {key: tree}
        out = quantize_params(tree, policy)
        for key in path.split("."):
            out = out[key]
        return out

    def stacked(lead):
        """A leaf stacked over ``lead``, drawn and quantized one matrix at
        a time."""
        def leaf(path, kind, shape, *arg):
            items = [quantized(path, draw(kind, shape, *arg))
                     for _ in range(int(np.prod(lead)))]
            return _stack_lead(items, lead)
        return leaf

    if cfg.family in ("ssm", "hybrid"):
        params = {"embed": torch.randn((cfg.vocab_size, d), generator=gen,
                                       device=device).mul_(0.02)}
        for key, lead, spec in _stacks(cfg):
            params[key] = _map_spec({key: spec}, stacked(lead))[key]
    else:
        spec = _layer_spec(cfg, cross=cfg.family == "audio")
        params = {"layers": _map_spec({"layers": spec},
                                      stacked((cfg.num_layers,)))["layers"],
                  "embed": torch.randn((cfg.vocab_size, d), generator=gen,
                                       device=device).mul_(0.02)}
        if cfg.family == "audio":
            params["encoder"] = _map_spec(
                {"encoder": _layer_spec(cfg)},
                stacked((cfg.encoder_layers,)))["encoder"]
            params["enc_ln_f"] = _map_spec(
                _norm_spec(d, cfg.norm),
                lambda _, kind, shape: draw(kind, shape))
    params["ln_f"] = _map_spec(_norm_spec(d, cfg.norm),
                               lambda _, kind, shape: draw(kind, shape))
    if not cfg.tie_embeddings:
        params["lm_head"] = quantized("lm_head",
                                      draw("w", (d, cfg.vocab_size)))
    if cfg.frontend:
        params["frontend_proj"] = quantized(
            "frontend_proj", draw("w", (cfg.frontend_dim, d)))
    return quantize_params(params, policy)


def _stack_lead(items: list, lead: tuple):
    """Stack per-matrix leaves (tensors or QTensors) into ``lead`` axes."""
    if not lead:
        return items[0]

    def stack(ts):
        return torch.stack(ts).reshape(*lead, *ts[0].shape)
    if isinstance(items[0], QTensor):
        return QTensor({k: stack([q.data[k] for q in items])
                        for k in items[0].data}, items[0].meta)
    return stack(items)


def init_cache(cfg, batch: int, max_len: int, *, kv_quant: bool = False,
               dtype=torch.float32, device="cuda") -> Params:
    """Zeroed serving cache. ``kv_quant=True`` lays the self-attention
    planes out as rotated-int8 codes plus per-token fp16 scales (8.25
    bits/element); it needs a power-of-two head_dim, and an attention-free
    model has no planes for it to change. Recurrent state is f32 whatever
    the planes' dtype. A vlm's planes hold ``max_len + frontend_len``
    positions (the patch prefix); an audio model's cross-attention memory
    (``xattn``, ``frontend_len`` positions) stays fp at ``dtype`` even
    under ``kv_quant``: written once per prefill, read every step."""
    _check_family(cfg)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if kv_quant and not is_pow2(hd):
        raise ValueError(f"kv_quant needs a power-of-two head_dim, got {hd}")

    def kv(n_layers, length=max_len, quant=kv_quant):
        shape = (n_layers, batch, kvh, length)
        if quant:
            return {"k": torch.zeros(*shape, hd, dtype=torch.int8,
                                     device=device),
                    "v": torch.zeros(*shape, hd, dtype=torch.int8,
                                     device=device),
                    "k_scale": torch.zeros(*shape, 1, dtype=torch.float16,
                                           device=device),
                    "v_scale": torch.zeros(*shape, 1, dtype=torch.float16,
                                           device=device)}
        return {"k": torch.zeros(*shape, hd, dtype=dtype, device=device),
                "v": torch.zeros(*shape, hd, dtype=dtype, device=device)}

    def states(empty):
        one = empty(cfg, batch, device=device)
        return {k: v.expand(cfg.num_layers, *v.shape).contiguous()
                for k, v in one.items()}

    if cfg.family == "ssm":
        return {"ssm": states(ssm_mod.rwkv6_empty_state)}
    if cfg.family == "hybrid":
        return {"attn": kv(-(-cfg.num_layers // cfg.attn_every)),
                "ssm": states(ssm_mod.mamba2_empty_state)}
    if cfg.family == "audio":
        return {"attn": kv(cfg.num_layers),
                "xattn": kv(cfg.num_layers, cfg.frontend_len, quant=False)}
    return {"attn": kv(cfg.num_layers,
                       max_len + (cfg.frontend_len if cfg.frontend else 0))}


def layer_params(layers: Params, i: int, *more: int) -> Params:
    """Layer ``i``'s views of the stacked layer leaves; further indices
    take inner lead axes (a hybrid's ``mamba_blocks[i, j]``)."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i, *more) for k, v in layers.items()}
    out = layers.layer(i) if isinstance(layers, QTensor) else layers[i]
    return layer_params(out, *more) if more else out


def _dense_layer_apply(lp, x, rt, cfg, *, cache, pos, token_cache=False,
                       causal=True, memory=None, xcache=None):
    """One decoder (or, ``causal=False``, encoder) layer: self-attention;
    in a layer holding ``xattn`` then cross-attention on ``memory`` (or,
    without it, the layer's ``xcache`` K/V); then the MLP or (a layer
    holding ``moe``) the MoE block. Returns ``(x, cache info, aux)``:
    the MoE block's load-balancing loss (which serving drops), None for
    an MLP layer."""
    h, new_kv = attention_apply(lp["attn"], norm_apply(lp["ln1"], x, cfg.norm),
                                rt, cfg, cache=cache, pos=pos,
                                token_cache=token_cache, causal=causal)
    x = x + h
    if "xattn" in lp:
        h, _ = attention_apply(lp["xattn"],
                               norm_apply(lp["ln_x"], x, cfg.norm), rt, cfg,
                               cache=xcache, memory=memory, cross=True)
        x = x + h
    hn = norm_apply(lp["ln2"], x, cfg.norm)
    aux = None
    if "moe" in lp:
        m, aux = moe_mod.moe_apply(lp["moe"], hn, rt, cfg)
    else:
        m = mlp_apply(lp["mlp"], hn, rt, cfg.activation)
    return x + m, new_kv, aux


def _layer_cache(cache, i: int) -> dict:
    """Layer ``i``'s view of the cache leaves, plus the block table of a
    paged cache."""
    out = {k: v[i] for k, v in cache["attn"].items()}
    if "table" in cache:
        out["table"] = cache["table"]
    return out


def _xattn_cache(cache, i: int) -> Optional[dict]:
    """Layer ``i``'s view of an audio model's cross-attention memory K/V
    (None without a cache or cross-attention)."""
    if cache is None or "xattn" not in cache:
        return None
    return {k: v[i] for k, v in cache["xattn"].items()}


def _run_decoder(params, x, rt, cfg, *, cache, pos, memory=None):
    if cfg.family in ("ssm", "hybrid"):
        # a single token against a cache is a decode step
        decode = cache is not None and x.shape[1] == 1
        for i in range(cfg.num_layers):
            x = recurrent_layer_apply(params, x, rt, cfg, i, cache=cache,
                                      pos=pos, decode=decode)
        return x, cache
    # a one-token prompt with encoder memory takes the layer loop, so the
    # memory reaches the cross-attention cache (the reference's token path
    # would drop it)
    if (cache is not None and x.shape[1] == 1 and rt.decode_token_cache
            and memory is None):
        return _run_decoder_token(params, x, rt, cfg, cache=cache, pos=pos)
    for i in range(cfg.num_layers):
        layer_cache = None if cache is None else _layer_cache(cache, i)
        x = _dense_layer_apply(layer_params(params["layers"], i), x, rt,
                               cfg, cache=layer_cache, pos=pos,
                               memory=memory, xcache=_xattn_cache(cache, i))[0]
    return x, cache


def hybrid_layer(cfg, i: int) -> tuple[Optional[int], int, int]:
    """Layer ``i`` of a hybrid: (the KV layer of the shared attention that
    runs before it, or None; its macroblock, or -1 in the tail; its index
    in that stack)."""
    every, n_full, _ = hybrid_dims(cfg)
    blk, j = divmod(i, every)
    attn = blk if j == 0 else None
    if blk < n_full:
        return attn, blk, j
    return attn, -1, i - n_full * every


def recurrent_layer_apply(params, x, rt, cfg, i: int, *, cache, pos,
                          decode: bool):
    """Layer ``i`` of an SSM or hybrid stack, reading its recurrent state
    from ``cache`` (None: zeros, no state kept) and writing the new one
    back in place. RWKV6: one block. Zamba2: before the first layer of
    each macroblock (and of the tail) the shared attention block, against
    its own KV layer (the tail's is ``n_full``), then the layer's Mamba2
    mixer. The shared attention takes the prefill branch at every length,
    as the reference's does (no token cache)."""
    state = None if cache is None else {k: v[i] for k, v in
                                        cache["ssm"].items()}
    if cfg.family == "ssm":
        x, new = ssm_mod.rwkv6_apply(layer_params(params["layers"], i), x,
                                     _at(rt, "layers"), cfg, state=state,
                                     decode=decode)
    else:
        attn, blk, j = hybrid_layer(cfg, i)
        if attn is not None:
            sa = params["shared_attn"]
            kv = (None if cache is None else
                  {k: v[attn] for k, v in cache["attn"].items()})
            h, _ = attention_apply(sa["attn"], norm_apply(sa["ln"], x,
                                                          cfg.norm),
                                   _at(rt, "shared_attn"), cfg, cache=kv,
                                   pos=pos)
            x = x + h
        lp = (layer_params(params["mamba_blocks"], blk, j) if blk >= 0
              else layer_params(params["mamba_tail"], j))
        h, new = ssm_mod.mamba2_apply(
            lp["mamba"], norm_apply(lp["ln"], x, cfg.norm),
            _at(rt, "mamba_blocks" if blk >= 0 else "mamba_tail"), cfg,
            state=state, decode=decode)
        x = x + h
    if cache is not None:
        for k, v in new.items():
            cache["ssm"][k][i].copy_(v)
    return x


def _run_decoder_token(params, x, rt, cfg, *, cache, pos):
    """Single-token decode: each layer attends its pre-write cache plus
    the token's own K/V, then writes only that token's slice at ``pos``
    (the O(1)-byte decode write). Paged: slot ``b``'s token lands in block
    ``table[b, pos_b // BS]`` at offset ``pos_b % BS`` with no clamp; idle
    slots' table rows point at the null block. An audio layer reads its
    cross-attention K/V from the cache and writes nothing there."""
    b = x.shape[0]
    pos_vec = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    pos_vec = pos_vec.expand(b) if pos_vec.dim() == 0 else pos_vec
    attn = cache["attn"]
    rows = torch.arange(b, device=x.device)
    if "table" in cache:
        bs = attn["k"].shape[3]
        rows = cache["table"][rows, pos_vec // bs]  # the token's block
        at = pos_vec % bs
    else:
        # lax.dynamic_update_slice clamps the write index into range
        at = torch.clamp(pos_vec, 0, attn["k"].shape[3] - 1)
    for i in range(cfg.num_layers):
        layer_cache = _layer_cache(cache, i)
        x, tok, _ = _dense_layer_apply(layer_params(params["layers"], i), x,
                                       rt, cfg, cache=layer_cache,
                                       pos=pos_vec, token_cache=True,
                                       xcache=_xattn_cache(cache, i))
        for k, v in tok.items():  # (B, KV, 1, X) -> layer i, row, pos
            layer_cache[k][rows, :, at] = v[:, :, 0].to(layer_cache[k].dtype)
    return x, cache


def _at(rt, stack: str):
    """``rt`` with its training model split viewing ``stack``'s leaves
    (``train/tp.py:ModelSplit.at``); ``rt`` itself without one."""
    if rt is None or rt.model_split is None:
        return rt
    return dataclasses.replace(rt, model_split=rt.model_split.at(stack))


def _tp(rt):
    """``serve/tp.py`` under tensor-parallel serving, else None."""
    if rt is None or rt.rules is None:
        return None
    from repro_torch.serve import tp as tp_mod  # lm <-> serve
    return tp_mod


def _embed(params, tokens, rt=None, cfg=None):
    """The token rows of the embedding table. Under tensor-parallel
    serving a float table holds this rank's D columns: each rank gathers
    its columns of the rows, then one all-gather along D."""
    table = params["embed"]
    tokens = tokens.to(torch.int64)
    tp_mod = _tp(rt)
    if isinstance(table, QTensor):
        # a policy quantized the tied table: stored transposed (D, V),
        # blocked along D, so the tied head contracts it directly; the
        # gather reconstructs the table first, O(D*V) work per call, the
        # price of keeping only the packed table resident
        if tp_mod is not None:
            table = tp_mod.full_table(table, cfg, rt.rules)
        return formats.dequantize(table).T[tokens]
    if tp_mod is not None:
        return tp_mod.embed_rows(table, tokens, cfg, rt.rules)
    split = None if rt is None else rt.model_split
    if split is not None and split.has("embed"):
        # this rank's D columns of the rows, gathered along D for the
        # replicated stack
        return split.whole(table.to(torch.float32)[tokens], "embed", -1)
    return table.to(torch.float32)[tokens]


def _head_weight(params, rt, cfg):
    """The (D, V) head weight: ``lm_head``, or the tied table. Under a
    model split the vocab-parallel head is this rank's (D, V/m) block:
    ``lm_head``'s own slice, or the rows of the tied table, which is
    stored split along D, moved to this rank by one all-to-all (each
    rank's head reads its rows only, and no rank holds the table whole);
    a head whose vocabulary does not divide the axis is whole."""
    split = None if rt is None else rt.model_split
    if split is not None:
        return _split_head_weight(params, split, cfg)
    w = params.get("lm_head")
    if w is None:
        w = params["embed"]
        if not isinstance(w, QTensor):  # a QTensor table is stored (D, V)
            tp_mod = _tp(rt)
            if tp_mod is not None:
                # a D-sharded table gathered whole: the tied head's product
                # then runs on every rank as on one device (a contraction
                # over sharded D would need a float reduction)
                w = tp_mod.full_table(w, cfg, rt.rules)
            w = w.T  # tied head: a plain f32 product
    return w


def _split_head_weight(params, split, cfg):
    """:func:`_head_weight` under ``split`` (plain tensors)."""
    w = params.get("lm_head")
    if w is not None:
        return w  # its vocab slice where it holds one, else whole
    table = params["embed"]
    if not split.vocab:
        return split.whole(table, "embed", -1).T
    if split.has("embed"):
        return split.swap(table, 0, -1).T
    lo, n = split.block(cfg.vocab_size)
    return split.enter(table)[lo:lo + n].T


def _head(params, x, rt, cfg):
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return dense(x, _head_weight(params, rt, cfg), rt)


def _tokens(tokens, params) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["embed"].device)


def _frontend(params, feats, rt) -> torch.Tensor:
    """``feats`` (B, P, F) through ``frontend_proj`` (F, D). Under a
    training model split the weight, stored column-split, is gathered
    whole for the replicated stack: F x D/m a rank, where gathering the
    output would move B x P x D/m (F is 160 and 1,024 at full width; B x
    P is 4,608 and more in the full-width train runs of ``chip_smoke.py``
    and the dry-run's ``train_4k`` cells)."""
    w = params["frontend_proj"]
    if rt.model_split is not None:
        w = rt.model_split.whole(w, "frontend_proj", -1)
    return dense(feats, w, rt)


def _encode(params, frames, rt, cfg) -> torch.Tensor:
    """The audio encoder: frames (B, S, F) -> memory (B, S, D) through
    ``frontend_proj``, the non-causal encoder stack (RoPE at positions
    0..S-1, no mask) and ``enc_ln_f``."""
    x = _frontend(params, frames, rt)
    enc = _at(rt, "encoder")
    layer = _maybe_remat(lambda xc, i: _dense_layer_apply(
        layer_params(params["encoder"], i), xc, enc, cfg, cache=None, pos=0,
        causal=False)[0], rt)
    for i in range(cfg.encoder_layers):
        x = layer(x, i)
    return norm_apply(params["enc_ln_f"], x, cfg.norm)


def _with_frontend(params, x, rt, cfg, frontend_feats):
    """``(x, memory, prefix)``: an audio model's encoder memory (it needs
    the frames), or a vlm's projected prefix rows put before the token
    rows (``prefix`` of them, stripped before the head)."""
    memory, prefix = None, 0
    if frontend_feats is not None:
        feats = torch.as_tensor(frontend_feats, device=x.device).to(
            torch.float32)
    if cfg.family == "audio":
        if frontend_feats is None:
            raise ValueError("seamless needs encoder frames")
        memory = _encode(params, feats, rt, cfg)
    elif cfg.frontend and frontend_feats is not None:
        x = torch.cat([_frontend(params, feats, rt), x], dim=1)
        prefix = feats.shape[1]
    return x, memory, prefix


def forward(params: Params, tokens, rt: Runtime, cfg, *,
            frontend_feats=None, cache: Optional[Params] = None, pos=0,
            last_only: bool = False, last_idx=None):
    """Full-sequence forward (prefill). Returns (logits (B, T, V), or
    (B, 1, V) with ``last_only`` / ``last_idx``, and the cache). ``last_idx``
    (B,) gathers each row's true last prompt position before the head, so
    a padded-bucket prefill pays one head row per slot.

    ``frontend_feats`` (B, P, F): a vlm prefixes the tokens with their
    ``frontend_proj`` (the cache then holds the P prefix positions from
    ``pos``, and decoding continues at ``pos + P + T``); the prefix rows
    are stripped before ``last_only`` / ``last_idx`` and the head. An
    audio model needs them: the encoder's memory is what every decoder
    layer cross-attends (written into the cache's ``xattn`` leaves)."""
    tokens = _tokens(tokens, params)
    x, memory, prefix = _with_frontend(
        params, _embed(params, tokens, rt, cfg), rt, cfg, frontend_feats)
    x, cache = _run_decoder(params, x, rt, cfg, cache=cache, pos=pos,
                            memory=memory)
    x = x[:, prefix:]
    if last_only:
        x = x[:, -1:]
    elif last_idx is not None:
        idx = torch.as_tensor(last_idx, dtype=torch.int64, device=x.device)
        x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    return _head(params, x, rt, cfg), cache


# The plain matmuls of a layer (``x @ W`` reshaped to 2-D, the router),
# the ops whose outputs the "dots" policy keeps: the counterpart of
# ``checkpoint_dots_with_no_batch_dims``. Batched products (attention's
# einsums, the experts' ``bmm``) are recomputed.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt_util.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else ckpt_util.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(body, rt):
    """Per-layer rematerialization (training): with ``rt.remat`` the
    backward pass re-runs ``body`` instead of keeping its internals
    (``torch.utils.checkpoint``, non-reentrant); ``remat_policy="dots"``
    keeps its plain matmul outputs, ``"none"`` only its inputs. Without
    ``rt.remat``, ``body`` itself."""
    if not rt.remat:
        return body
    if rt.remat_policy == "dots":
        context_fn = functools.partial(
            ckpt_util.create_selective_checkpoint_contexts, _dots_policy)
    elif rt.remat_policy == "none":
        context_fn = ckpt_util.noop_context_fn
    else:
        raise ValueError(f"unknown remat_policy {rt.remat_policy!r}")

    def run(*args):
        return ckpt_util.checkpoint(body, *args, use_reentrant=False,
                                    context_fn=context_fn)
    return run


def _train_stack(params, x, rt, cfg, memory=None):
    """The layer stack of a training forward (no cache), each unit under
    :func:`_maybe_remat` where the reference's scan bodies are: a layer,
    or a hybrid's macroblock (its shared attention and ``attn_every``
    Mamba2 layers; the tail runs outside, as the reference's). Returns
    ``(x, aux)``: the MoE aux loss averaged over the layers, 0 for the
    other families."""
    zero = torch.zeros((), device=x.device)
    rt_layers = _at(rt, "layers")
    if cfg.family in ("ssm", "hybrid"):
        every, n_units = ((1, cfg.num_layers) if cfg.family == "ssm"
                          else hybrid_dims(cfg)[:2])

        def layer(xc, i):
            return recurrent_layer_apply(params, xc, rt, cfg, i, cache=None,
                                         pos=0, decode=False)

        def block(xc, u):
            for i in range(u * every, (u + 1) * every):
                xc = layer(xc, i)
            return xc
        unit = _maybe_remat(block, rt)
        for u in range(n_units):
            x = unit(x, u)
        for i in range(n_units * every, cfg.num_layers):
            x = layer(x, i)
        return x, zero

    def dense_layer(xc, i):
        out, _, aux = _dense_layer_apply(layer_params(params["layers"], i),
                                         xc, rt_layers, cfg, cache=None,
                                         pos=0, memory=memory)
        return out, aux
    unit = _maybe_remat(dense_layer, rt)
    auxs = []
    for i in range(cfg.num_layers):
        x, aux = unit(x, i)
        auxs.append(aux)
    if auxs[0] is None:
        return x, zero
    return x, torch.mean(torch.stack(auxs))


def _xent_chunk(x, labels, w, rt):
    """Summed token cross-entropy of one chunk of positions: the head's
    f32 logits (B, C, V) and their logsumexp; labels < 0 count 0. Under a
    vocab-parallel model split the logits are this rank's (B, C, V/m)
    block (:func:`_vocab_xent`)."""
    logits = dense(x, w, rt).to(torch.float32)
    if rt.model_split is not None and rt.model_split.vocab:
        return _vocab_xent(logits, labels, rt.model_split)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp_min(labels, 0)[..., None])[
        ..., 0]
    return torch.sum((lse - ll) * (labels >= 0).to(torch.float32))


def _vocab_xent(logits, labels, split):
    """The summed cross-entropy of vocab-parallel logits: the logsumexp
    as a detached all-reduce max plus the model group's sum of
    ``exp(logit - max)``; the label's logit from the rank whose block
    holds it, summed over the group (the two sums in one all-reduce)."""
    lo, n = split.block(logits.shape[-1] * split.ways)
    mx = split.max(torch.amax(logits, dim=-1))
    se = torch.sum(torch.exp(logits - mx[..., None]), dim=-1)
    lab = torch.clamp_min(labels, 0) - lo
    mine = (lab >= 0) & (lab < n)
    ll = torch.gather(logits, -1, torch.clamp(lab, 0, n - 1)[..., None])[
        ..., 0]
    both = split.leave(torch.stack([se, torch.where(mine, ll, 0.0)]))
    lse = torch.log(both[0]) + mx
    return torch.sum((lse - both[1]) * (labels >= 0).to(torch.float32))


def forward_xent(params: Params, tokens, labels, rt: Runtime, cfg, *,
                 frontend_feats=None, chunk: int = 512):
    """Full forward and mean token cross-entropy without the (B, T, V)
    logits: the head and its logsumexp run per ``chunk`` positions under a
    checkpoint, so the backward pass holds one (B, chunk, V) slice at a
    time. Labels < 0 are masked; the sum is divided by ``B * T``. The
    frontends as :func:`forward` takes them (a vlm's prefix rows carry no
    label). The layer stack remats per ``rt.remat``. Returns ``(mean
    xent, MoE aux)``, 0-d f32 tensors."""
    tokens = _tokens(tokens, params)
    labels = torch.as_tensor(labels, device=tokens.device).to(torch.int64)
    x, memory, prefix = _with_frontend(
        params, _embed(params, tokens, rt, cfg), rt, cfg, frontend_feats)
    x, aux = _train_stack(params, x, rt, cfg, memory)
    x = norm_apply(params["ln_f"], x[:, prefix:], cfg.norm)
    w = _head_weight(params, rt, cfg)
    if rt.model_split is not None and rt.model_split.vocab:
        x = rt.model_split.enter(x)  # once, for every chunk's head
    b, t, _ = x.shape
    chunk = max(1, min(chunk, t))
    tot = torch.zeros((), device=x.device)
    for c0 in range(0, t, chunk):
        tot = tot + ckpt_util.checkpoint(
            _xent_chunk, x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], w,
            rt, use_reentrant=False)
    return tot / (b * t), aux


def decode_step(params: Params, tokens, cache: Params, pos, rt: Runtime,
                cfg):
    """One autoregressive step against the cache. ``pos`` (B,) or scalar:
    per-row write index. Returns (logits (B, 1, V), cache)."""
    return score_tokens(params, tokens, cache, pos, rt, cfg)


def score_tokens(params: Params, tokens, cache: Params, pos, rt: Runtime,
                 cfg):
    """Score a T-token window per row against the cache in one forward
    (the speculative verify pass). Token ``t`` is written at ``pos + t``
    and attends causally to everything at or before it, so ``logits[:, t]``
    is the next-token distribution after ``tokens[:, :t+1]``; under
    ``kv_quant`` the span runs one ``prefill_attn_q8`` per layer. Returns
    (logits (B, T, V), cache)."""
    tokens = _tokens(tokens, params)
    x = _embed(params, tokens, rt, cfg)
    x, cache = _run_decoder(params, x, rt, cfg, cache=cache, pos=pos)
    return _head(params, x, rt, cfg), cache


def advance_cache(params: Params, tokens, cache: Params, pos, rt: Runtime,
                  cfg) -> Params:
    """Append a token span to the cache at ``pos`` with no head: the
    draft's last propose step (position ``pos + K``, so a fully accepted
    window leaves no hole) and its admission prefill. Returns the
    cache."""
    tokens = _tokens(tokens, params)
    _, cache = _run_decoder(params, _embed(params, tokens, rt, cfg), rt, cfg,
                            cache=cache, pos=pos)
    return cache


def finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """Per-row numeric health: True where every logit in the row is
    finite. Reduces (..., V) -> (...) bool on the device."""
    return torch.isfinite(logits.to(torch.float32)).all(dim=-1)


def top_mask(logits: torch.Tensor, top_k=None, top_p=None) -> torch.Tensor:
    """Mask logits outside each row's top-k / top-p (nucleus) set to -inf.

    Both filters are a per-row value threshold on the descending-sorted
    logits (one sort for the batch, heterogeneous k and p per row), as the
    reference's: ``top_k`` (B,) keeps values >= the k-th largest where
    k > 0 (k clipped to the vocabulary); ``top_p`` (B,) keeps a token iff
    the probability mass strictly before it is < p, where p < 1. Every row
    keeps its argmax; rows are independent. The constants are Python
    scalars: a tensor made from one would be a blocking host-to-device
    copy."""
    v = logits.shape[-1]
    neg_inf = float("-inf")
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    thresh = torch.full(logits.shape[:-1], neg_inf, dtype=torch.float32,
                        device=logits.device)
    if top_k is not None:
        k = torch.as_tensor(top_k, dtype=torch.int64, device=logits.device)
        kth = torch.gather(sorted_desc, -1,
                           torch.clamp(k - 1, 0, v - 1)[..., None])[..., 0]
        thresh = torch.maximum(thresh, torch.where(k > 0, kth, neg_inf))
    if top_p is not None:
        p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
        e = torch.exp(sorted_desc - sorted_desc.max(dim=-1,
                                                    keepdim=True).values)
        probs = e / e.sum(dim=-1, keepdim=True)
        keep = (torch.cumsum(probs, dim=-1) - probs) < p[..., None]
        pth = torch.where(keep, sorted_desc, float("inf")).min(dim=-1).values
        thresh = torch.maximum(thresh, torch.where(p < 1.0, pth, neg_inf))
    return torch.where(logits >= thresh[..., None], logits, neg_inf)


def sample_tokens(logits: torch.Tensor, key=None, temperature=0.0, *,
                  top_k=None, top_p=None) -> torch.Tensor:
    """Greedy argmax (``key=None``: no PRNG op at all) or temperature /
    top-k / top-p sampling on JAX's threefry streams (``core/prng.py``),
    on the logits' device. ``torch.argmax`` takes the first maximum, as
    ``jnp.argmax``.

    The logits are scaled by ``1 / max(temperature, 1e-6)`` before the
    filters. With ``key`` (B, 2) every row draws under its own key (the
    serving path: a row's token does not depend on its batchmates, and
    ``temperature``, ``top_k``, ``top_p`` are (B,) tensors on the logits'
    device); a single (2,) key with a scalar temperature draws one shared
    stream over the batch. Rows with temperature <= 0 take the argmax."""
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if key is None:
        return greedy
    shared = not isinstance(temperature, torch.Tensor)
    if shared:
        # filled on the device (no host-to-device copy); a true division,
        # which CUDA skips for a Python-scalar divisor (it multiplies by
        # the reciprocal)
        scaled = logits / torch.full((), max(float(temperature), 1e-6),
                                     device=logits.device)
    else:
        temp = temperature.to(torch.float32)
        t = torch.clamp_min(temp, 1e-6)
        scaled = logits / (t[..., None] if temp.dim() else t)
    if top_k is not None or top_p is not None:
        scaled = top_mask(scaled, top_k, top_p)
    sampled = prng.categorical(key, scaled).to(torch.int32)
    if shared:
        return sampled if temperature > 0 else greedy
    return torch.where(temp > 0, sampled, greedy)
