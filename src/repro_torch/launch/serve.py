"""Serving launcher of the port: seeded random weights, quantized by the
port with a format or a QuantPolicy, served greedily through the
continuous-batching engine.

    python -m repro_torch.launch.serve --reduced --kv-quant --device cpu
    python -m repro_torch.launch.serve --arch smollm-135m --kv-quant   # GPU

Mixed precision through a policy (the arch's default recipe, or a JSON
file ``{"rules": [{"pattern": ..., "fmt": ...}, ...]}``), the packed tree
checkpointed and served straight from disk, on the W3A8 integer path:

    ... --act-quant --policy mixed --save-quantized /tmp/q   # quantize, save
    ... --act-quant --load-quantized /tmp/q                  # boot from planes

The paged rotated-int8 KV cache (a shared block pool with prefix sharing,
preempting a request when the pool runs dry):

    ... --kv-quant --paged --num-blocks 6 --block-size 16

On a CUDA device every quantized projection, activation rotation, int8
contraction and q8-cache attention runs on the hand-written kernels in
``csrc/``, and the quantizer's ``itq3_s`` blocks go through the
``quantize_blocks`` kernel; with ``--device cpu`` the same path runs their
plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.configs import (
    ARCH_IDS, get_config, mixed_precision_recipe, reduced,
)
from repro_torch.core import grids
from repro_torch.models import lm
from repro_torch.models.layers import Runtime
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.quantized import (
    QuantPolicy, describe_quantized, quantize_params, quantized_bytes,
)


def _load_policy(spec: str, cfg) -> QuantPolicy:
    if spec == "mixed":
        return QuantPolicy.from_dict(mixed_precision_recipe(cfg))
    with open(spec) as f:
        return QuantPolicy.from_dict(json.load(f))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--fmt", default="itq3_s")
    ap.add_argument("--rule", default="paper", choices=sorted(grids.SCALE_RULES))
    ap.add_argument("--policy", default=None,
                    help="'mixed' or path to a QuantPolicy JSON; overrides --fmt")
    ap.add_argument("--save-quantized", default=None,
                    help="write the quantized param tree as a checkpoint")
    ap.add_argument("--load-quantized", default=None,
                    help="serve a previously saved quantized checkpoint")
    ap.add_argument("--quant-mode", default="activations",
                    choices=["activations", "weights", "dequant", "auto"])
    ap.add_argument("--kv-quant", action="store_true",
                    help="rotated-int8 KV cache (8.25 bits/element)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: block pool + per-slot block table "
                         "over the rotated-int8 planes (requires --kv-quant)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="pool size for --paged (default: enough for every "
                         "slot to reach max_len, i.e. dense-equivalent)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per pool block for --paged")
    ap.add_argument("--act-quant", action="store_true",
                    help="W3A8 integer compute path: quantize activations "
                         "to int8 in the rotation domain and contract "
                         "against ternary codes with int32 accumulation "
                         "(QuantPolicy act_quant=False pins paths to float)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.load_quantized:
        t0 = time.perf_counter()
        params, step = ckpt_mod.restore_params(args.load_quantized,
                                               device=args.device)
        print(f"loaded quantized step-{step} tree from {args.load_quantized} "
              f"in {time.perf_counter() - t0:.1f}s "
              f"({quantized_bytes(params) / 1e6:.1f}MB)")
    else:
        params = lm.init_params(cfg, seed=0, device=args.device)
        fp_bytes = sum(leaf.numel() * 2 for leaf in _leaves(params))
        t0 = time.perf_counter()
        if args.policy:
            policy = _load_policy(args.policy, cfg)
            params = quantize_params(params, policy)
            fmts = sorted(set(describe_quantized(params).values()))
            print(f"policy quantized ({len(policy.rules)} rules -> {fmts})")
        elif args.fmt not in ("fp16", "bf16"):
            params = quantize_params(params, args.fmt, rule=args.rule)
        qb = quantized_bytes(params)
        print(f"quantized in {time.perf_counter() - t0:.1f}s: "
              f"{qb / 1e6:.1f}MB vs bf16 {fp_bytes / 1e6:.1f}MB "
              f"({fp_bytes / max(qb, 1):.2f}x smaller)")
        if args.save_quantized:
            path = ckpt_mod.save(args.save_quantized, 0, params)
            print(f"saved quantized tree to {path}")
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}")
    eng = ServeEngine(params, cfg, slots=args.slots, max_len=args.max_len,
                      rt=Runtime(quant_mode=args.quant_mode,
                                 kv_quant=args.kv_quant,
                                 act_quant=args.act_quant),
                      device=args.device, paged=args.paged,
                      num_blocks=args.num_blocks, block_size=args.block_size)
    if args.paged:
        st0 = eng.stats()
        print(f"paged pool: {st0['pool_blocks']} blocks x "
              f"{st0['block_size']} tokens "
              f"({st0['cache_bytes_reserved'] / 1e6:.2f}MB reserved)")
    if args.act_quant:
        print("act_quant: W3A8 integer compute path "
              "(int8 rotation-domain activations, int32 accumulation)")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=8 + i % 5),
                    max_new=args.max_new) for i in range(args.requests)]
    t0 = time.perf_counter()
    done = eng.run(reqs)
    if args.device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = eng.stats()
    total = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests / {total} tokens in {dt:.2f}s on "
          f"{args.device} ({st['syncs_per_token']:.2f} host syncs/token, "
          f"cache {st['cache_bytes'] / 1e6:.1f} MB, "
          f"{st['cache_bytes_per_token']:.0f} B/token)")
    if args.paged:
        print(f"paged: {st['preemptions']} preemptions, {st['resumes']} "
              f"resumes, {st['prefix_hits']} prefix hits, "
              f"{st['pool_blocks_used']} blocks still held")
    for r in done[:3]:
        print(f"  rid={r.rid} -> {r.out[:10]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
