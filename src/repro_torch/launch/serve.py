"""Serving launcher of the port: seeded random weights, quantized by the
port with a format or a QuantPolicy (or a quantized checkpoint booted with
``ServeEngine.from_checkpoint``), served through the continuous-batching
engine.

    python -m repro_torch.launch.serve --reduced --kv-quant --device cpu
    python -m repro_torch.launch.serve --arch smollm-135m --kv-quant   # GPU

Trained weights (``--ckpt-dir``: the latest checkpoint of a training run,
``python -m repro_torch.launch.train --ckpt-dir DIR``, of either package)
are restored into a ``TrainState`` template, then quantized and served as
the seeded ones are:

    ... --ckpt-dir /tmp/ckpt --kv-quant

The recurrent families (``--arch rwkv6-3b``, ``--arch zamba2-7b``) admit
each prompt through the engine's chunk ladder; ``--kv-quant`` changes
nothing on the attention-free rwkv6-3b, and full-width zamba2-7b (head_dim
112) serves its shared attention on the fp cache. The frontend families
serve as the reference's launcher serves them, text only: ``--arch
phi-3-vision-4.2b`` with its ``max_len + frontend_len`` cache (head_dim
96 at full width: the fp cache), and ``--arch seamless-m4t-medium``
fails at its first admission, as the reference's does, for want of
encoder frames (the model takes them through ``lm.forward``).

Mixed precision through a policy (the arch's default recipe, or a JSON
file ``{"rules": [{"pattern": ..., "fmt": ...}, ...]}``), the packed tree
checkpointed and served straight from disk, on the W3A8 integer path:

    ... --act-quant --policy mixed --save-quantized /tmp/q   # quantize, save
    ... --act-quant --load-quantized /tmp/q                  # boot from planes

The paged rotated-int8 KV cache (a shared block pool with prefix sharing,
preempting a request when the pool runs dry):

    ... --kv-quant --paged --num-blocks 6 --block-size 16

Per-request sampling (``--temperature/--top-k/--top-p``; request i draws
under seed ``--sampling-seed`` + i, or a key derived from its rid), stop
tokens, the admission policy (``--scheduler fifo|priority|sjf``, priority
demoed as ``rid % 3``) and ``--stream`` to print events as they arrive:

    ... --temperature 0.8 --top-k 40 --sampling-seed 7 --stream

The resilience layer: a bounded queue (``--max-queue``, ``--shed-policy``),
deadlines (``--deadline-ms``), the decode watchdog
(``--watchdog-timeout-s``) and ``--chaos``, a seeded fault plan (a KV
scale poisoned, a clock skip, a stalled step) under which every request
still ends with a finish reason:

    ... --kv-quant --chaos --stream --scheduler priority --max-queue 4 \
        --shed-policy shed_lowest

Speculative decoding with a self-draft (an N-layer prefix of the target
sharing its embedding and head): each decode tick becomes a window of
``--num-draft-tokens`` proposals verified in one target pass; greedy
token ids equal the non-speculative run's:

    ... --kv-quant --draft-depth 2 --num-draft-tokens 4

Tensor-parallel serving over a ``DATA,MODEL`` mesh on ``torch.distributed``
(one process per rank under torchrun; the packed planes column-sharded,
MoE stacks expert-parallel, the KV cache head-sharded; ``--load-quantized``
then restores each leaf straight into its shard; only rank 0 prints):

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --kv-quant \
        --mesh 1,2

On a CUDA device every quantized projection, activation rotation, int8
contraction and q8-cache attention runs on the hand-written kernels in
``csrc/``, and the quantizer's ``itq3_s`` blocks go through the
``quantize_blocks`` kernel; with ``--device cpu`` the same path runs their
plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed

from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.configs import (
    ARCH_IDS, get_config, mixed_precision_recipe, reduced,
)
from repro_torch.core import grids
from repro_torch.models import lm
from repro_torch.models.layers import Runtime
from repro_torch.serve.engine import Request, SamplingParams, ServeEngine
from repro_torch.serve.quantized import (
    QuantPolicy, describe_quantized, quantize_params, quantized_bytes,
)
from repro_torch.serve import spec as spec_mod
from repro_torch.serve.scheduler import SCHEDULERS
from repro_torch.train import loop as train_loop


def _load_policy(spec: str, cfg) -> QuantPolicy:
    if spec == "mixed":
        return QuantPolicy.from_dict(mixed_precision_recipe(cfg))
    with open(spec) as f:
        return QuantPolicy.from_dict(json.load(f))


def restore_trained(ckpt_dir: str, cfg, device):
    """The fp weights of the latest training checkpoint under
    ``ckpt_dir``, restored into a template from ``init_train_state`` (each
    leaf cast to its dtype), as the reference's ``--ckpt-dir``. Returns
    ``(params, step)``."""
    state = train_loop.init_train_state(cfg, seed=0, device=device)
    state, step = ckpt_mod.restore(ckpt_dir, state)
    return state.params, step


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
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "ref", "cuda"],
                    help="quantized matmuls and q8-cache attention: the "
                         "kernels on CUDA tensors (auto), the plain "
                         "versions (ref), or the kernels only (cuda)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore fp train-state weights before quantizing")
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
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (default); > 0 samples on the device")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k filter (0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus (top-p) filter (1.0 = disabled)")
    ap.add_argument("--sampling-seed", type=int, default=None,
                    help="per-request PRNG seed base (request i uses seed+i); "
                         "default derives deterministic keys from rid")
    ap.add_argument("--sample-on-host", action="store_true",
                    help="per-slot host argmax: one transfer per live slot "
                         "(the measured baseline)")
    ap.add_argument("--stop-token", type=int, action="append", default=None,
                    help="stop-token id finishing a request early "
                         "(repeatable)")
    ap.add_argument("--scheduler", default="fifo", choices=sorted(SCHEDULERS),
                    help="admission policy: fifo | priority (Request."
                         "priority, demoed with rid%%3) | sjf "
                         "(shortest-prompt-first)")
    ap.add_argument("--stream", action="store_true",
                    help="print StreamEvents as tokens arrive instead of "
                         "waiting for the closed batch")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the waiting queue; overflow follows "
                         "--shed-policy (terminal 'rejected' events)")
    ap.add_argument("--shed-policy", default="reject",
                    choices=["reject", "shed_lowest"],
                    help="queue-overflow policy: turn the newcomer away, or "
                         "drop the lowest-priority waiting request instead")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request submit->done deadline; expired "
                         "requests finish with finish_reason='deadline'")
    ap.add_argument("--watchdog-timeout-s", type=float, default=None,
                    help="arm the decode-step watchdog: steps slower than "
                         "this are counted in stats()['stalled_steps']")
    ap.add_argument("--chaos", action="store_true",
                    help="serve under a seeded FaultPlan (KV-scale poison + "
                         "clock skip + stall): every failure drains to a "
                         "terminal finish reason")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--draft-depth", type=int, default=0,
                    help="speculative decoding with a self-draft: serve "
                         "with an N-layer prefix of the target as the "
                         "draft model (0 = off). The decode tick becomes "
                         "propose/verify/commit; greedy streams stay "
                         "bit-identical to non-speculative serving")
    ap.add_argument("--num-draft-tokens", type=int, default=4,
                    help="speculative window size K: draft proposes K "
                         "tokens per slot per step, one batched target "
                         "pass verifies all K+1 positions")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="tensor-parallel serving over a data,model mesh "
                         "of torch.distributed ranks (run under torchrun "
                         "--nproc-per-node MODEL; DATA must be 1): packed "
                         "ITQ3_S planes column-sharded and the KV cache "
                         "head-sharded over the model axis")
    ap.add_argument("--tp-shard-map", action="store_true",
                    help="accepted for the reference's command lines: "
                         "tensor-parallel serving here always runs its "
                         "shards explicitly (serve/tp.py)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; nothing falls back")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        ap.error("no CUDA device: the launcher serves on the GPU unless "
                 "--device cpu is passed")
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_host_mesh
        d, m = (int(x) for x in args.mesh.split(","))
        mesh = make_host_mesh(d, m, device=None if args.device == "cuda"
                              else torch.device(args.device))
        if mesh.rank:  # only rank 0 prints
            sys.stdout = open(os.devnull, "w")
        print(f"serving mesh: {mesh.shape} ({mesh.size} ranks, "
              f"{mesh.device.type})")
    device = mesh.device if mesh is not None else args.device

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    faults = None
    if args.chaos:
        from repro_torch.serve.faults import Fault, FaultPlan
        faults = FaultPlan([
            Fault("kv_nan", step=3, slot=0,
                  plane="k_scale" if args.kv_quant else "k"),
            Fault("clock_skip", step=6, dt=1.0),
            Fault("stall", step=6, dt=2.0),
        ], seed=args.chaos_seed)
        if args.watchdog_timeout_s is None:
            args.watchdog_timeout_s = 0.5
        if args.deadline_ms is None:
            args.deadline_ms = 400.0
        print(f"chaos mode: {len(faults.faults)} seeded faults armed "
              f"(seed {args.chaos_seed}, deterministic clock)")
    engine_kw = dict(
        slots=args.slots, max_len=args.max_len,
        rt=Runtime(quant_mode=args.quant_mode, backend=args.backend,
                   kv_quant=args.kv_quant, act_quant=args.act_quant),
        device=device, sample_on_host=args.sample_on_host,
        scheduler=args.scheduler, max_queue=args.max_queue,
        shed_policy=args.shed_policy,
        watchdog_timeout_s=args.watchdog_timeout_s, faults=faults,
        paged=args.paged, num_blocks=args.num_blocks,
        block_size=args.block_size, num_draft_tokens=args.num_draft_tokens,
        mesh=mesh)
    if args.load_quantized:
        t0 = time.perf_counter()
        eng = ServeEngine.from_checkpoint(args.load_quantized, cfg,
                                          draft_depth=args.draft_depth,
                                          **engine_kw)  # mesh: sharded
        step = ckpt_mod.latest_step(args.load_quantized)
        print(f"loaded quantized step-{step} tree from {args.load_quantized} "
              f"in {time.perf_counter() - t0:.1f}s "
              f"({quantized_bytes(eng.params) / 1e6:.1f}MB) with "
              f"ServeEngine.from_checkpoint")
    else:
        if args.ckpt_dir:
            params, step = restore_trained(args.ckpt_dir, cfg, device)
            print(f"restored step-{step} weights from {args.ckpt_dir}")
        else:
            params = lm.init_params(cfg, seed=0, device=device)
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
        if args.save_quantized and (mesh is None or mesh.rank == 0):
            path = ckpt_mod.save(args.save_quantized, 0, params)
            print(f"saved quantized tree to {path}")
        eng = ServeEngine(params, cfg, **engine_kw,
                          **_draft_kw(params, cfg, args.draft_depth))
    if eng.spec:
        print(f"speculative decoding: {args.draft_depth}-layer self-draft, "
              f"K={args.num_draft_tokens} tokens/window")
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}")
    if args.paged:
        st0 = eng.stats()
        print(f"paged pool: {st0['pool_blocks']} blocks x "
              f"{st0['block_size']} tokens "
              f"({st0['cache_bytes_reserved'] / 1e6:.2f}MB reserved)")
    if args.act_quant:
        print("act_quant: W3A8 integer compute path "
              "(int8 rotation-domain activations, int32 accumulation)")
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        sp = SamplingParams(
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            seed=None if args.sampling_seed is None else args.sampling_seed + i,
            stop=tuple(args.stop_token or ()))
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, size=8 + i % 5),
            max_new=args.max_new, sampling=sp,
            priority=i % 3 if args.scheduler == "priority" else 0,
            deadline_ms=args.deadline_ms))
    t0 = time.perf_counter()
    if args.stream:
        for ev in eng.generate(reqs):
            if ev.finished:
                st = ev.stats or {}
                print(f"  rid={ev.rid} finished [{ev.finish_reason}] "
                      f"{st.get('tokens', 0)} tokens, "
                      f"ttft {st.get('ttft_s', float('nan')) * 1e3:.0f}ms, "
                      f"queue {st.get('queue_wait_s', 0) * 1e3:.0f}ms")
            else:
                print(f"  rid={ev.rid} token {ev.index}: {ev.token}")
        done = reqs
    else:
        done = eng.run(reqs)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = eng.stats()
    total = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests / {total} tokens in {dt:.2f}s on "
          f"{device} ({st['syncs_per_token']:.2f} host syncs/token, "
          f"scheduler={st['scheduler']}, "
          f"cache {st['cache_bytes'] / 1e6:.1f} MB, "
          f"{st['cache_bytes_per_token']:.0f} B/token)")
    if args.draft_depth:
        print(f"speculation: acceptance {st['acceptance_rate']:.1%} "
              f"({st['draft_accepted']}/{st['draft_proposed']} drafts), "
              f"{st['tokens_per_step']:.2f} tokens/step over "
              f"{st['spec_steps']} windows")
    if args.paged:
        print(f"paged: {st['preemptions']} preemptions, {st['resumes']} "
              f"resumes, {st['prefix_hits']} prefix hits, "
              f"{st['pool_blocks_used']} blocks still held")
    resil = {k: st[k] for k in ("quarantined", "deadline_expired",
                                "requests_rejected", "requests_shed",
                                "preemptions", "stalled_steps") if st.get(k)}
    if resil or args.chaos:
        reasons = collections.Counter(r.finish_reason for r in done)
        print(f"resilience: {resil or 'no faults fired'}; "
              f"finish reasons {dict(reasons)}")
        if faults is not None:
            print(f"fault log: {faults.log}")
    if mesh is not None:
        print(f"tensor-parallel: {st['devices']} ranks, "
              f"{st['cache_bytes_per_device'] / 1e6:.2f} MB of cache per "
              f"rank")
    for r in done[:3]:
        print(f"  rid={r.rid} -> {r.out[:10]}")
    if mesh is not None:
        torch.distributed.destroy_process_group()


def _draft_kw(params, cfg, depth: int) -> dict:
    """The engine's draft arguments for ``--draft-depth`` (none when 0)."""
    if not depth:
        return {}
    dparams, dcfg = spec_mod.draft_from_params(params, cfg, depth)
    return dict(draft_params=dparams, draft_cfg=dcfg)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
