"""Serving launcher of the port: seeded random weights, quantized by the
port, served greedily through the continuous-batching engine.

    python -m repro_torch.launch.serve --reduced --kv-quant --device cpu
    python -m repro_torch.launch.serve --arch smollm-135m --kv-quant   # GPU

On a CUDA device every quantized projection, activation rotation and
q8-cache attention runs on the hand-written kernels in ``csrc/``; with
``--device cpu`` the same path runs their plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.models import lm
from repro_torch.models.layers import Runtime
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.quantized import quantize_params, quantized_bytes


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--fmt", default="itq3_s",
                    choices=["iq3_s", "itq3_s", "itq3_s_sub", "itq3_x"])
    ap.add_argument("--quant-mode", default="activations",
                    choices=["activations", "weights", "dequant", "auto"])
    ap.add_argument("--kv-quant", action="store_true",
                    help="rotated-int8 KV cache (8.25 bits/element)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    t0 = time.perf_counter()
    params = quantize_params(lm.init_params(cfg, seed=0, device=args.device),
                             args.fmt)
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"quantized to {args.fmt} in {time.perf_counter() - t0:.1f}s "
          f"({quantized_bytes(params) / 1e6:.1f} MB)")
    eng = ServeEngine(params, cfg, slots=args.slots, max_len=args.max_len,
                      rt=Runtime(quant_mode=args.quant_mode,
                                 kv_quant=args.kv_quant),
                      device=args.device)
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
    for r in done[:3]:
        print(f"  rid={r.rid} -> {r.out[:10]}")


if __name__ == "__main__":
    main()
