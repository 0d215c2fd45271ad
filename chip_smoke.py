#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py                 # every phase (1-18), one card
    python3 chip_smoke.py --kernels-only  # phases 1-3: build and check kernels
    python3 chip_smoke.py --tp-only       # phases 1-2, then 15 (b): the mesh
                                          # over every card (up to 4)
    python3 chip_smoke.py --train-only    # phases 1-2, then 16: training
    python3 chip_smoke.py --train-mesh-only  # phases 1-2, then 17: training
                                          # on a mesh of every card (up to 4)
    python3 chip_smoke.py --dryrun-only   # phases 1-2, then 18: the dry-run
                                          # and three cells on one card
    python3 chip_smoke.py --profile       # also trace a short run of each path
                                          # (its cut sweeps check, untimed)

It drives the port (``src/repro_torch``) and nothing of the JAX package:

1. Report the card: its name and power limit (``nvidia-smi``).
2. Build the kernels from ``src/repro_torch/csrc`` with ``nvcc`` (one
   process per source, all started together): ten kernels in seven
   sources (``attn_q8.cu`` holds the dense and the paged attention,
   ``fwht.cu`` the rotation and the two rotate-and-encode codecs).
3. Check each kernel against its plain PyTorch version on the card at the
   full-width smollm-135m shapes of the serving paths, and time the
   kernel, the plain version and one PyTorch library call that computes
   the same function (a yardstick only; the port never calls it). The int8
   kernels must equal their plain versions exactly with unit scales and
   within 1e-5 of the largest output with real ones; ``quantize_blocks``
   is held to the reference's own contract (``z`` equal, ``d`` within rtol
   1e-3, codes equal on at least 0.999 of the elements: f16 ties only).
   The paged attention must give the dense kernel's bits over the gathered
   view of the same pool, and agree with its plain version within 1e-4.
   Both attention instantiations must give the same bits on two calls, and
   are also checked, untimed, at the edges of their key splits (an empty
   row, a limit on a split boundary, query tiles straddling one, the full
   cache), where the empty rows must end exactly m = -1e30, l = 0,
   acc = 0, and the serving entry point must raise under ``auto`` for a
   shape the kernel does not build (head_dim 256 or 16, 33 query heads
   per KV head); the grid and ptxas's registers for both are printed, and the
   dense kernel is checked and timed under other cuts of its keys and
   queries beside the one it picks. ``itq3_matmul`` (TF32 tensor cores,
   its bound counted at the TF32 rate) must give the same bits on two
   calls; it is checked untimed at the edges of its tiles and splits (all
   five formats, both modes, ragged M and N, one block and six), timed
   under every row tile and split count at the serving shapes beside the
   cut ``matmul_tiles`` picks, and must build without a register spill.
   ``itq3_matvec`` is timed at the serving shapes (M = 4) in three forms:
   fused (x unrotated, its FWHT in the kernel: the float decode path),
   the unfused pair (``fwht.cu``, then the kernel) and weights mode; the
   fused form must give the pair's bits, every form the same bits on two
   calls and within 1e-4 of its plain version. It is checked untimed at
   its edges (all five formats, both modes, other sub-block counts, M 1 to
   16, ragged N, one to 24 blocks, x staged whole and in windows, every
   cut of six blocks), timed under every cut at the serving shapes beside
   the one ``matvec_tiles`` picks, and must build without a spill.
   ``fwht`` is timed at its 256-point and head_dim shapes and must give
   the plain version's bits there and at every block from 2 to 1024.
   ``fwht_act_encode`` (the W3A8 activation codec) and ``fwht_kv_encode``
   (the KV codec of K and V) are timed at their serving shapes beside
   their plain versions and the unfused chains they replace (``fwht.cu``,
   then the plain ops), and must give the bits of both there and at their
   edges (1 to 96 blocks, rotation off, the sign diagonal, zero rows,
   ties, non-finite rows; every head_dim 2 to 1024, a strided V, scales
   at fp16's ends), the same bits on two calls, and no spill in
   ``fwht.cu``.
   The int8 pair is checked untimed at its edges (the three ternary
   formats, every sub-block count from 1 to 256, ragged M and N, one,
   three and six blocks, every cut of K): exactly the plain version with
   unit scales, the bits of ``itq3_matmul_int8_split_ref`` at the cut used
   and within 1e-5 of the plain version with real ones, the same bits on
   two calls; it is timed under every cut at the serving shapes, and no
   instantiation of either source may spill.
   The speculative verify pass's shapes (phase 10) are checked and timed
   apart from the decode and prefill rows, and reported under ``verify``
   in the kernel line: the attention, dense and paged, at TQ = 5 over a
   260-key cache (with its own split edges and cut sweep), and both
   matmuls at M = 20.
4. The float path: serve smollm-135m at full width (seeded random weights,
   quantized by the port to itq3_s, rotated-int8 KV cache, greedy) through
   ``ServeEngine``: 8 requests over 4 slots. The launch counters are reset
   just before and read just after the counted run, and each kernel must
   have launched exactly as often as the path dictates (per layer: 7
   projections, each the fused matvec per decode step or a 256-point FWHT
   then the matmul per prefill wave; one ``fwht_kv_encode`` for K and V;
   two head_dim FWHTs, the attention's query and output; one attention;
   on the W3A8 path one ``fwht_act_encode`` before each int8 projection
   and no 256-point FWHT). The FWHT forms count their launches per block
   size (``fwht/256``, ``fwht/64``, ``fwht_kv/64``, ``fwht_act/256``).
5. Teacher-forced parity: prefill and 4 decode steps through the kernels
   against the same forward with the plain versions on the card, run apart
   (reported) and layer by layer on one cache state (held to 1e-3); the
   plain-version serving run (``AGREE_NEW`` tokens per request, its
   greedy agreement reported) must launch no kernel.
6. With ``--profile`` only: one shorter serving run (8 new tokens per
   request) under ``torch.profiler``, for the device's busy time, idle
   share and host operator calls (phases 7 and 8 trace their paths the
   same way). Phase 3's cut sweeps then check every cut without timing
   it: the plain run beside it times them.
7. The W3A8 deployable path: quantize the seeded model under the mixed
   policy (tied table q8_0, MLP itq3_s_sub, the rest itq3_s through the
   ``quantize_blocks`` kernel, counted), save it in the reference's
   checkpoint layout, restore it with no template (planes checked equal),
   and serve the same 8 requests with ``Runtime(act_quant=True,
   kv_quant=True)``: every ternary projection through the int8 kernels,
   with exact launch counts. Then phase 5's parity on this path, and the
   greedy agreement (reported) with the plain-version run and with the
   float (``act_quant=False``) run of the same checkpoint, over their
   first ``AGREE_NEW`` tokens per request.
8. The paged path on phase 4's model (``ServeEngine(paged=True)``, block
   size 16). (a) Phase 4's requests on the dense-equivalent pool: exact
   launch counts, the paged attention and never the dense one, and the
   greedy streams of phase 4's counted run token for token; then dense and
   paged runs in turns for their step and wave times. (b) Eight
   requests over one shared 32-token prefix on a 13-block pool, too small
   for four live requests: the engine must share prefix blocks, preempt
   and resume, finish every request with ``length`` and leave the pool
   drained; its agreement with a dense run of the same requests is
   reported.
9. Sampled serving and the resilience layer. (a) ``ServeEngine.
   from_checkpoint`` boots phase 7's checkpoint (W3A8, ``kv_quant``) and
   serves phase 7's prompts and rids with ``ignore_eos``: two greedy, two
   at temperature 0.8, two with top-k 40, two with top-p 0.9 (one explicit
   seed, the rest derived). Launches must be exactly phase 7's contract
   (the sampler is plain PyTorch and launches nothing of ``csrc/``), one
   host sync per step and wave, the greedy rows equal to phase 7's counted
   run and a second run equal for every request. The sampler on the card
   against the CPU's on 1000 seeded draws of (4, vocab) logits: threefry
   bits equal, tokens equal on at least 999 (each difference printed with
   its margin). In turns (greedy, sampled, sampled, greedy): ms/step, and
   the sampler's device ms and aten calls per step. (b) Phase 4's model
   under the launcher's ``--chaos`` plan (a K scale poisoned, a clock skip
   and a stall) with a deadline on every request and the watchdog: 4
   requests in one wave, then a burst of 4 over a queue bounded at 6.
   Every request must end with a reason of ``FINISH_REASONS``, one slot
   quarantined, at least one step stalled and one request rejected, the
   healthy slots' streams a prefix of a fault-free run's, and two runs'
   counters equal.
10. Speculative decoding of phase 4's model and requests (K = 4 drafts per
   window, 4 slots, ``kv_quant``, float path). (a) The perfect draft
   (``spec.draft_from_params`` at full depth: the target itself): launches
   exactly the window's contract (the draft's K decode steps and one
   ``advance_cache`` through the fused matvec and the TQ = 1 attention,
   then the target's verify pass over 20 rows through the matmul and the
   TQ = 5 attention), one host sync per window and per wave, and greedy
   streams equal to phase 4's counted run, or parting only where the
   non-speculative path's top-2 logit margin is within phase 5's 1e-3 of
   the largest logit (a tie between the verify kernels' summation order
   and the decode kernels'), each parting printed; every proposal
   accepted and ceil((32 - 1) / 5) = 7 windows per wave, a request short
   of that only where such a parting explains it. (b) A 4-layer
   self-draft, in turns with phase 4's engine (non-spec, spec, spec,
   non-spec): acceptance and ms per committed token, reported only. (c)
   The perfect draft on the paged path: streams, windows and each
   request's acceptance equal to (a)'s, 0 blocks held, ``pool.check`` passing, exact launches with the paged attention
   in the verify pass. (d) ``verify_commit`` on the card against the CPU
   on 1000 seeded mixed-sampling windows at (4, 5, vocab): acceptance
   uniforms bit-equal, ``(out, n)`` equal on at least 999.

11. The MoE path: olmoe-1b-7b at full width, cut to ``MOE_LAYERS`` (2)
   of its 16 layers (64 experts top-8), seeded on the card and quantized as drawn
   (``lm.init_quantized_params``), phase 4's requests, ``kv_quant``. (a)
   Uniform itq3_s: exact launches per decode step and prefill wave (per
   layer 4 dense projections, 3 expert-axis launches, ``fwht_kv/128``,
   two ``fwht/128``, one attention; plus the untied head), one host sync
   per step and wave, two runs' streams equal, layer-forced logits within
   1e-3 on the rows whose routing agrees (a real token's routing may part
   only at a k/k+1 probability gap below 1e-6; a prefill's pad positions
   are counted, not held), and a short traced run for the idle share. (b)
   The mixed policy on W3A8, held alike. Phase 3 also times the four
   expert-axis kernels at olmoe's shapes (E = 64; M = 4 and 40) beside
   their plain versions and ``torch.bmm`` on the dequantized stacks,
   sweeps their cuts, checks them untimed at their edges (ragged M and
   N, E = 1 bit-equal to the one-matrix kernels, qwen3-moe's 128
   experts), the attention at head_dim 128 (G = 1, 6, 16; dense and
   paged) and the dense family's widest shapes (K = 96 and 27 blocks, a
   256,000-column matvec).
12. The rest of the dense family at full width and two layers:
   nemotron-4-15b (LayerNorm, relu2, untied 256,000-column head,
   ``kv_quant``) and stablelm-3b (LayerNorm, partial rotary, head_dim 80
   on the fp cache), each held to phase 11's contract and parity.
13. The recurrent families at full width, cut in depth
   (``RECURRENT_LAYERS``: rwkv6-3b 4 of 32, zamba2-7b 7 of 81, one
   macroblock and a 1-layer tail), seeded on the card and quantized as
   drawn, phase 4's requests on 4 slots through the engine's
   chunk ladder (``prompt_chunk=32``: chunks of 32 rows run the matmul,
   the rest the matvec): (a) rwkv6-3b (attention-free RWKV6, untied
   65,536-column head) on itq3_s; (b) zamba2-7b (Mamba2 layers, one
   shared attention block before every 6th, head_dim 112 on the fp
   cache) on itq3_s; (c) zamba2-7b on W3A8 under the mixed policy. Each:
   exact launches per decode step and per ladder chunk (rwkv6 7 ternary
   projections per layer and the head; zamba2 3 per layer and the shared
   attention's 4 at each of its applications), one host sync per step
   and per admitted request, two runs' streams equal, layer-forced logits
   within 1e-3, peak memory and resident bytes, and a short traced run
   for the idle share. Phase 3 also holds the four contraction kernels at
   these widths (K 2560 to 8960, N up to 65,536) against their plain
   versions and times them (``<kernel>_ssm`` in the kernel line).
14. The frontend families at full width (phi-3-vision-4.2b cut to
   ``PHI_LAYERS`` (4) of its 32 layers; seamless-m4t-medium whole),
   seeded on the card and quantized as drawn, with seeded (4, P, F) features from a generator on
   the card: (a) phi-3-vision-4.2b on itq3_s (head_dim 96 on the fp
   cache), (a1) phase 4's requests through the engine, text only as the
   reference serves a vlm (a cache of 256 + 576 positions), (a2) one
   ``lm.forward(frontend_feats=...)`` of 4 images of 576 patches with
   40-token prompts, then 16 greedy ``lm.decode_step``s; (b)
   seamless-m4t-medium on itq3_s with ``kv_quant``: 4 utterances of 1,024
   frames through the 12-layer encoder, 8-token decoder prompts
   cross-attending the memory (the fp ``xattn`` cache), 32 greedy steps;
   (c) (b) on W3A8 under the mixed policy. Each: exact launches per
   decode step and per prefill, one host transfer per step (the engine's
   run: per step and wave), two runs' streams equal, layer-forced logits
   within 1e-3, ms per prefill and per step, peak memory and resident
   bytes, and a traced 3-step decode window for the idle share. Phase 3
   also holds the contraction kernels at these widths (K = 160 padded to
   one block, M up to 4,096; the int8 pair at seamless's) and ``attn_q8``
   at head_dim 64 with one query head per KV head against their plain
   versions and times them (``<kernel>_frontend`` in the kernel line).
15. Tensor-parallel serving (``serve/tp.py``). (a) On one card, every N/2
   and N/4 shard of qwen1.5-0.5b's projections (1024 x 1024, 1024 x 2816,
   2816 x 1024) and of olmoe-1b-7b's expert stacks (64 experts), and every
   E/2 and E/4 shard of the stacks (and, untimed, of qwen3-moe-235b-
   a22b's 128-expert stacks), at a decode step's and a prefill wave's
   rows, on the float and the W3A8 pair: the launch the TP path
   makes (``tp.shard_qmatmul``, ``cut_from``: the whole launch's cut) must
   equal the full launch's columns bit for bit; untimed, the same shards
   under their own rule's cut are counted where the cut differs and where
   the bits do. ``decode_attn_q8`` / ``prefill_attn_q8`` at qwen1.5-
   0.5b's 16 KV heads and qwen3-moe's 4 (G = 16, head_dim 128), dense and
   paged, must give each 2- and 4-way head shard's heads bit for bit. Each kernel is timed at the whole width and at the 2- and 4-way
   shard beside its bound and ``x @ W`` (``attn_q8`` at 16, 8 and 4 KV
   heads beside SDPA; ``tp_shard_widths`` and ``tp_attn_heads`` in the
   details). (b) qwen1.5-0.5b at full width and depth, seeded on the
   card, saved and served by ``ServeEngine.from_checkpoint(mesh=...)`` in
   ``min(cards, 4)`` spawned NCCL ranks, on the float path and on W3A8:
   each rank's streams equal the single-device engine's (booted from the
   same checkpoint) token for token, its teacher-forced logits bit for
   bit, its launches equal; per rank ``tp_world``,
   ``cache_bytes_per_device`` and ms per step are printed. On a one-card
   machine the mesh runs at world 1 (no leaf sharded, no collective), and
   a line says so. With 2 or more cards olmoe-1b-7b (expert parallel) and
   smollm-135m (3 KV heads: the replicated GQA fallback) are served too.
16. Training on one card (``train/loop.py``), then serving its result:
   smollm-135m at full width and depth, the reference launcher's batch
   of 8 x 256 tokens. (a) 30 steps (warmup 5, lr 3e-3, remat "dots") in
   bf16 autocast and in f32 with TF32 off, from one seeded state: the loss
   finite and falling (the mean of the last 5 steps below the first 5's);
   ms/step (the median after the first), tokens/s and peak memory; the
   steps launch no kernel of ``csrc/`` (the reference's training forward
   reaches no ``pallas_call``); two more f32 steps under
   ``torch.profiler`` for the idle share and aten calls per step. (b) One
   f32 step under remat "dots", "none" and none: loss and gnorm equal
   (their bits printed), each one's
   peak memory; 4 micro-batches against the whole batch at the peak lr:
   loss within 1e-4, gradients within 5e-5 of each leaf's largest and
   params within 1e-4, a param parting further only at a noise-floor
   gradient (AdamW's first step is about lr * sign(g); counted). (c) One
   f32 step at ``reduced()`` size on the card and on the CPU from one
   state: gradients as (b), loss and gnorm within 1e-5 relative, params
   within 1e-5 as (b). (d) The trained f32 state through ``save_async``
   and ``wait_pending``, restored into a fresh template (every leaf
   equal), then the serve launcher's ``--ckpt-dir`` boot
   (``launch/serve.py:restore_trained``), ``itq3_s`` through the
   ``quantize_blocks`` kernel, and phase 4's requests with ``kv_quant``:
   launches exactly phase 4's contract, a second run's streams and
   launches equal, and phase 5's teacher-forced parity on the trained
   weights (layer-forced 1e-3; K codes parting at rounding ties
   reported); the held-out loss of the initial, trained and quantized
   weights is reported.
17. Training on a mesh of ranks (``train/sharded.py``), then serving its
   result: phase 16's model and batches in f32 (TF32 off) on ``world =
   min(cards, 4)`` spawned NCCL ranks. (a) Three steps from the seeded
   state on a ``(data=world, model=1)`` mesh, and with four cards also on
   ``(2, 2)``: every rank's loss and gnorm bit-equal to each other's and
   within 1e-5 relative of one device's (rank 0's own run, the
   yardstick); each step's gradients, reduced to the FSDP specs and
   gathered, within 5e-5 of each leaf's largest; the params within 5e-5,
   a param parting further only at a noise-floor gradient of some step
   (counted); per rank ms/step (the median after the first), peak
   memory, the bytes of its param and moment shards against one
   device's, the mesh's tokens/s and the bytes each collective moves a
   step. (b) ``compressed_pod_allreduce`` over a pod axis of ``world``
   ranks on seeded per-pod gradients, 6 steps: every pod's mean and
   residuals bit-equal to the numpy model of ``tests/test_train.py`` run
   here, the time-averaged mean within the last scale of the truth (at
   world 1 its inputs come back). (c) The first mesh's state saved at step
   3 (rank 0 writes the whole leaves) and restored onto one device, equal
   leaf for leaf to the gathered state; with four cards also onto
   ``plan_remesh(2, model=1)``'s mesh in two fresh ranks, whose next two
   steps' metrics are held to the uninterrupted one-device run as (a).
   (a)-(c) launch nothing of ``csrc/``. (d) The checkpoint through the
   serve launcher's ``--ckpt-dir`` boot on one card as phase 16 (d):
   ``quantize_blocks``, phase 4's contract, two runs equal, layer-forced
   logits within 1e-3. On a one-card machine the mesh runs at world 1 and
   a line says it is not evidence of sharding. (a)'s (2, 2) mesh splits
   the compute over ``model`` (``train/tp.py``). (e) The model axis's
   compute split on ``(data 1, model world)``: smollm-135m at full width
   and depth (3 KV heads: the key sequence splits), qwen1.5-0.5b at full
   width, 8 layers (16 KV heads: each rank its heads; QKV bias, the tied
   151,936-row head vocab-parallel), olmoe-1b-7b at full width, 2 layers
   (64 experts over the ranks, untied vocab-parallel head), three f32
   steps each, held to one device (rank 0's own run) as (a) holds its
   meshes; every gather of a step's params gives each leaf's model slice
   (inside the forward the key-split attention gathers wq, wk, wv whole,
   in one collective, and the tied head takes its rows by an all-to-all);
   per rank ms/step, peak memory, the bytes of the params and moments and
   of the params' working set (derived from the specs), and the bytes
   and count of one step's collectives. With four cards also rwkv6-3b at
   full width, 2 layers, whose family keeps the storage form, on (2, 2),
   held alike. At world 1 the run is one device's and a line says it is
   not evidence of the split.
18. The per-cell dry-run (``launch/steps.py``, ``launch/dryrun.py``,
   ``launch/op_analysis.py``). (a) Host processes, no card visible, write
   the records of smollm-135m's ``train_4k``, ``prefill_32k`` and
   ``decode_32k`` on both production meshes (16 x 16 and 2 x 16 x 16, a
   fake process group of 256 or 512 ranks, fake tensors) and of
   olmoe-1b-7b's ``train_4k`` on the single mesh: every record ``ok``,
   their walls printed. They run while (b) holds the card. (b) Three of
   smollm-135m's cells run their own step function on real seeded
   tensors on one card, the global batch cut: ``prefill_32k`` to one
   32,768-token row (the query-chunked attention at full length,
   ``itq3_matmul`` at M = 32,768), ``decode_32k`` to 32 rows of a
   32,768-position bf16 cache (M = 32), ``train_4k`` to one row. Per
   cell: device ms per step from ``torch.profiler`` on the plain route
   (``backend="ref"``, the work the count models; it must launch nothing
   of ``csrc/``) and on the kernel route (``auto``, its launches named);
   the same cut step's FLOPs and bytes counted by a host process, the
   three roofline terms and each over the measured times; then an f32 run
   of both routes, their last-position logits layer-forced within 1e-3
   of the largest (held) and apart (reported). The launch counters are
   reset before (b) (the model is quantized on the card: row 7) and read
   after it; rows 1 and 3 at (b)'s shapes are checked in phase 3
   (``fwht_cells``, ``itq3_matmul_cells``).

It exits non-zero, printing no result, when there is no CUDA device or any
phase fails. Before the last line it prints the card's name and power
limit and one JSON line with every kernel's launches, error, times and
bound; the last line is the JSON result. Per-shape details and the ptxas
report go to ``chiprun_out/chip_smoke_details.json``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import formats  # noqa: E402
from repro_torch.core.act_quant import act_decode, act_encode  # noqa: E402
from repro_torch.core.fwht import hadamard_matrix  # noqa: E402
from repro_torch.core.quantize import pad_last_dim, to_blocks  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attn_q8 import (  # noqa: E402
    attn_grid, attn_q8, attn_q8_paged, attn_q8_paged_ref, attn_q8_ref,
    decode_attn_q8, paged_row_table, prefill_attn_q8,
)
from repro_torch.kernels.fwht import (  # noqa: E402
    FWHT_BLOCKS, fwht, fwht_act_encode, fwht_act_encode_ref, fwht_kv_encode,
    fwht_kv_encode_ref, fwht_ref,
)
from repro_torch.kernels.itq3 import (  # noqa: E402
    dequant_blocks, itq3_matmul, itq3_matmul_int8, itq3_matmul_int8_ref,
    itq3_matmul_int8_split_ref, itq3_matmul_ref, itq3_matvec,
    itq3_matvec_int8,
)
from repro_torch.kernels.quantize import (  # noqa: E402
    quantize_blocks, quantize_blocks_ref,
)
from repro_torch.serve.kv_quant import kv_encode  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth, the
# f32 rate outside the tensor cores and the int8 tensor-core rate. A
# kernel's bound is the larger of its bytes (inputs read once, outputs
# written once) over the first and its operations over the rate of their
# type: int8 for the two int8 contractions, whatever instruction they use,
# so a later redesign is judged on the same bound; f32 for the rest.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
# The dense TF32 tensor-core rate: itq3_matmul's products run there, two
# TF32 products per f32 product in activations mode (x split into hi and
# lo halves), three in weights mode, and its bound counts them so.
PEAK_TF32_FLOPS = 494.7e12
# The dense bf16 tensor-core rate: phase 16's bf16 autocast training step.
PEAK_BF16_FLOPS = 989e12
# Kernel vs plain version: both f32, summed in a different order (warp
# shuffles, tiles, online softmax against one matmul / plain softmax), so
# they agree to a few ulps of the largest magnitude, well inside 1e-4.
KERNEL_REL_TOL = 1e-4
# The int8 kernels: exact integer partials, and d, the sums and xscale in
# the plain version's order, so with real scales they agree to 1e-5 of the
# largest output (and exactly with unit scales, checked apart).
INT8_REL_TOL = 1e-5
# End-to-end logits, the two paths forced layer by layer onto one cache
# state (see two_paths): 30 layers compound the kernels' differences.
LOGITS_REL_TOL = 1e-3
TIMED_RUNS = 20
# The serving run: 8 requests over 4 slots, 64-token prompt buckets, a
# 256-position cache, 32 new tokens each.
SLOTS, MAX_LEN, PROMPT_PAD, MAX_NEW = 4, 256, 64, 32
# The profiled run (--profile): the same 8 requests with 8 new tokens each,
# two prefill waves and ~14 decode steps, so the trace stays small enough
# for the profiler to walk within the usual call time.
PROFILE_NEW = 8
# The free-running agreement runs of phases 5 and 7 (plain versions, and
# W3A8 against float): 8 new tokens per request, reported, not held.
AGREE_NEW = 8
# The paged path: 16-key blocks (the engine's default); the short pool of
# phase 8 (b) holds 12 usable blocks, and its requests share a 32-token
# prefix (two full blocks).
BLOCK_SIZE, SHORT_POOL, SHARED_PREFIX = 16, 13, 32
DETAILS = ROOT / "chiprun_out" / "chip_smoke_details.json"
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"  # phase 7 writes, 9 boots
TABLE = ROOT / "chiprun_out" / "chip_smoke_profile.txt"


def card_report() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return name, smi.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 10) -> float:
    """Median device time of one call of ``fn`` over TIMED_RUNS runs. Each
    run queues ``reps`` calls behind a kernel that spins for some
    milliseconds, so the card runs them back to back and the CUDA events
    see device time, not the host's launch rate. Inputs stay in the 50 MB
    L2 between calls, as they do on the serving path at these sizes."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def cut_ms(fn, timed: bool):
    """One cut of a sweep: ``device_ms(fn)``, or None where the run checks
    its cuts without timing them (``--profile``: the plain run of the same
    call times them)."""
    return device_ms(fn) if timed else None


def cuts_line(row: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" if v is not None else f"{k} checked"
                     for k, v in row.items())


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error over max |want|)."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    return err, err / scale if scale else err


def bound_ms(nbytes: float, flops: float,
             peak_ops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_PER_S, flops / peak_ops
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


class Ledger:
    """Per-kernel sums over the checked main-path shapes."""

    def __init__(self):
        self.rows = []

    def add(self, kernel, shape, *, err, rel, ms, plain_ms, library_ms,
            nbytes, flops, peak_ops=PEAK_F32_FLOPS, tol=KERNEL_REL_TOL,
            chain_ms=None):
        """One shape of ``kernel``. ``library_ms`` is None where no single
        PyTorch call computes the function; ``chain_ms`` is the time of
        the unfused chain a fused form replaces."""
        b, by = bound_ms(nbytes, flops, peak_ops)
        row = dict(kernel=kernel, shape=shape, max_abs_err=err, max_rel_err=rel,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=b, bound_by=by, bytes=nbytes, flops=flops)
        if chain_ms is not None:
            row["chain_ms"] = chain_ms
        self.rows.append(row)
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        chain = "" if chain_ms is None else f"  chain {chain_ms:.4f} ms"
        print(f"  {kernel:16s} {shape:34s} abs {err:.2e} rel {rel:.2e} | "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
              f"{lib}{chain}  bound {b:.4f} ms ({by})", flush=True)
        if not rel <= tol:
            raise AssertionError(f"{kernel} {shape}: rel error {rel:.3e} > "
                                 f"{tol}")

    def summary(self, kernel, verify: bool = False):
        """Sums over the kernel's main-path shapes (activations mode, so
        no rotate=True rows, and none of the off-path itq3_x rows): one
        call at each shape; the speculative verify shapes apart (``verify``),
        so the decode and prefill sums stay comparable with earlier runs.
        The bound of the sum is the sum of the per-call bounds, labelled by
        the larger part. None where the kernel has no such row."""
        rows = [r for r in self.rows if r["kernel"] == kernel
                and "rotate=True" not in r["shape"]
                and "itq3_x" not in r["shape"]
                and ("verify" in r["shape"]) == verify]
        if not rows:
            return None
        tot = {k: None if any(r.get(k) is None for r in rows)
               else sum(r[k] for r in rows)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "chain_ms")}
        by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        out = dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                   ms=tot["ms"], plain_ms=tot["plain_ms"],
                   bound_ms=tot["bound_ms"],
                   bound_by="bytes" if 2 * by_bytes >= tot["bound_ms"]
                   else "operations",
                   library_ms=tot["library_ms"],
                   shapes=[r["shape"] for r in rows])
        if tot["chain_ms"] is not None:
            out["chain_ms"] = tot["chain_ms"]
        return out


# --- phase 3: each kernel against its plain version ------------------------

SMOLLM_PROJ = {"wq": (576, 576), "wk": (576, 192), "gate": (576, 1536),
               "down": (1536, 576)}
# phase 10's speculative window: K = 4 drafts, so the verify pass runs
# SLOTS x (K+1) = 20 rows through every projection
SPEC_K = 4
VERIFY_M = SLOTS * (SPEC_K + 1)


def weight_bytes(qt) -> int:
    """Bytes of a ternary leaf that a contraction must read: the 2-bit
    payload plane, plane1 only under the five-level grid (the other formats
    keep only the interleave parity bit there, which no decoder reads), the
    scales, and the zero-points only without sub-blocks (sub-block formats
    store z = 0)."""
    d, meta = qt.data, qt.meta
    return (d["plane2"].numel()
            + (d["plane1"].numel() if meta.fivelevel else 0)
            + 2 * d["scales"].numel()
            + (0 if meta.sub_blocks else 2 * d["zps"].numel()))


# The rotations alone on the main path at smollm-135m's widths (4 slots,
# 3 KV heads x 3 query heads, head_dim 64, 64-token prefill buckets): the
# 256-point rotation of a float prefill projection, and the attention's
# query and output rotations at head_dim points. K and V go through
# fwht_kv_encode, the W3A8 activations through fwht_act_encode.
FWHT_HEAD_ROWS = (("decode q", 36), ("decode out", 36), ("prefill q", 2304),
                  ("prefill out", 2304))


def check_fwht(led: Ledger, gen: torch.Generator, dev) -> None:
    """fwht at its main-path shapes: block 256 over the activations of a
    float prefill projection, block head_dim over the attention's
    rotations; each bit-equal to the plain version (the same stages in the
    same order, one f32 scale), timed beside ``x @ H``. Then every block
    from 2 to 1024, untimed, bit-equal as well."""
    hd = 64
    shapes = [("(256,768)", 256, 768, 256)]
    shapes += [(f"{label} ({m},{hd})", m, hd, hd)
               for label, m in FWHT_HEAD_ROWS]
    for shape, m, k, block in shapes:
        x = torch.randn(m, k, generator=gen, device=dev)
        got, want = fwht(x, block), fwht_ref(x, block)
        h = hadamard_matrix(block, device=dev)
        err, rel = rel_err(got, want)
        if err != 0:
            raise AssertionError(f"fwht {shape}: max abs error {err} vs plain")
        led.add("fwht", shape, err=err, rel=rel,
                ms=device_ms(lambda: fwht(x, block)),
                plain_ms=device_ms(lambda: fwht_ref(x, block)),
                library_ms=device_ms(lambda: x.view(-1, block) @ h),
                nbytes=2 * m * k * 4,
                flops=m * k * (int(math.log2(block)) + 1))
    # every block: full thread blocks, and (blocks under 32 points) a
    # ragged last one
    for block in FWHT_BLOCKS:
        for m, k in ((7, 3 * 1024), (5, 48)):
            if k % block:
                continue
            x = torch.randn(m, k, generator=gen, device=dev)
            if not torch.equal(fwht(x, block), fwht_ref(x, block)):
                raise AssertionError(f"fwht block {block} ({m},{k}): not "
                                     f"the plain version's bits")
    print(f"  fwht at every block {FWHT_BLOCKS[0]}..{FWHT_BLOCKS[-1]}: "
          f"bit-equal to the plain version", flush=True)


def _codes_equal(a, b, rows=None) -> bool:
    """Two (codes, scale) pairs with the same bits; ``rows`` limits the
    codes compared (a non-finite row's codes are not defined)."""
    (qa, sa), (qb, sb) = a, b
    if rows is not None:
        qa, qb = qa[rows], qb[rows]
    return (torch.equal(qa, qb) and sa.dtype == sb.dtype
            and torch.equal(sa.view(torch.int16 if sa.dtype == torch.float16
                                    else torch.int32),
                            sb.view(torch.int16 if sb.dtype == torch.float16
                                    else torch.int32)))


def _act_chain(x, **kw):
    """The unfused chain fwht_act_encode replaces: ``fwht.cu`` on the
    padded rows, then the plain codec ops."""
    rotate = kw.pop("rotate", True)
    xp = pad_last_dim(x, 256)
    if rotate:
        dsign = kw.pop("dsign", None)
        if dsign is not None:
            xp = (xp.reshape(xp.shape[0], -1, 256) * dsign).reshape(xp.shape)
        xp = fwht(xp.contiguous(), 256)
    return act_encode(xp, rotate=False)


# fwht_act_encode at the W3A8 projections' shapes: 4 decode rows or one
# 256-row prefill wave, K = d_model (576, read unpadded: three blocks) or
# d_ff (1536, six blocks).
ACT_SHAPES = ((4, 576), (4, 1536), (256, 576), (256, 1536))


def check_fwht_act(led: Ledger, gen: torch.Generator, dev,
                   report: dict) -> None:
    """fwht_act_encode at the serving shapes: bit-equal to its plain
    version and to the unfused chain (``fwht.cu``, then the plain ops),
    two calls bit-equal, timed beside both (no single PyTorch call
    computes it). Then, untimed, its edges: rotation off, quip3's sign
    diagonal, zero and padding-only rows, +-127 and exact .5 ties, 1 to
    96 blocks, non-finite rows (their scale only)."""
    for m, k in ACT_SHAPES:
        x = torch.randn(m, k, generator=gen, device=dev) * 3
        got = fwht_act_encode(x)
        if not (_codes_equal(got, fwht_act_encode_ref(x))
                and _codes_equal(got, _act_chain(x))
                and _codes_equal(got, fwht_act_encode(x))):
            raise AssertionError(f"fwht_act_encode ({m},{k}): not the plain "
                                 f"version's or the chain's bits")
        kb = -(-k // 256)
        led.add("fwht_act", f"({m},{k}) KB {kb}", err=0.0, rel=0.0,
                ms=device_ms(lambda: fwht_act_encode(x)),
                plain_ms=device_ms(lambda: fwht_act_encode_ref(x)),
                chain_ms=device_ms(lambda: _act_chain(x)), library_ms=None,
                nbytes=4 * m * k + m * kb * 256 + 4 * m,
                flops=m * kb * 256 * 13)
    cases = 0
    for kb, k in ((1, 200), (3, 576), (6, 1536), (11, 2816),
                  (96, 96 * 256 - 7)):
        for m in (1, 5, 300):
            x = torch.randn(m, k, generator=gen, device=dev) * torch.rand(
                m, 1, generator=gen, device=dev) * 30
            x[m // 2] = 0.0
            dsign = torch.where(torch.rand(kb, 256, generator=gen,
                                           device=dev) < 0.5, -1.0, 1.0)
            for kw in (dict(rotate=True), dict(rotate=False),
                       dict(rotate=True, dsign=dsign)):
                got = fwht_act_encode(x, **kw)
                if not (_codes_equal(got, fwht_act_encode_ref(x, **kw))
                        and _codes_equal(got, _act_chain(x, **kw))
                        and _codes_equal(got, fwht_act_encode(x, **kw))):
                    raise AssertionError(f"fwht_act_encode edge ({m},{k}) "
                                         f"{sorted(kw)}: not the plain "
                                         f"version's bits")
                if got[1][m // 2].item() != 0 or got[0][m // 2].any():
                    raise AssertionError("fwht_act_encode: a zero row must "
                                         "give scale 0 and codes 0")
                cases += 1
    ties = torch.zeros(3, 300, device=dev)
    ties[0, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5])
    ties[1, :4] = torch.tensor([-127.0, 127.0, -126.5, 3.5])
    ties[2, :3] = torch.tensor([254.0, -254.0, 1.0])
    got = fwht_act_encode(ties, rotate=False)
    if not _codes_equal(got, fwht_act_encode_ref(ties, rotate=False)) or \
            got[0][0, :8].tolist() != [127, 0, 2, 2, 0, -2, -2, 126]:
        raise AssertionError(f"fwht_act_encode ties: {got[0][:, :8]}")
    for bad in (float("nan"), float("inf"), -float("inf")):
        x = torch.randn(3, 600, generator=gen, device=dev)
        x[1, 17] = bad
        for rotate in (True, False):
            if not _codes_equal(fwht_act_encode(x, rotate=rotate),
                                fwht_act_encode_ref(x, rotate=rotate),
                                rows=[0, 2]):
                raise AssertionError(f"fwht_act_encode: a row with {bad} "
                                     f"(rotate={rotate})")
    cases += 7
    report["fwht_act_edges"] = cases
    print(f"  fwht_act_encode: {cases} untimed edge cases (KB 1-96, M 1/5/"
          f"300, rotation off, sign diagonal, zero rows, ties, non-finite "
          f"rows) bit-equal to the plain version and the chain, two calls "
          f"bit-equal", flush=True)


def _kv_pair(gen, dev, b, kvh, t, hd):
    """K contiguous and V as the transpose of a (B, T, KV, HD) projection,
    as the attention hands them over."""
    k = torch.randn(b, kvh, t, hd, generator=gen, device=dev)
    v = torch.randn(b, t, kvh, hd, generator=gen, device=dev).transpose(1, 2)
    return k, v


def _kv_equal(got, want) -> bool:
    return all(_codes_equal(g, w) for g, w in zip(got, want))


# fwht_kv_encode at the serving shapes: a decode step's token (4 slots x 3
# KV heads) and a prefill wave's 64-token buckets, head_dim 64.
KV_SHAPES = (("decode", 1), ("prefill", 64))


def check_fwht_kv(led: Ledger, gen: torch.Generator, dev,
                  report: dict) -> None:
    """fwht_kv_encode at the serving shapes: bit-equal to its plain
    version (two plain kv_encode calls) and to the unfused chain (two
    kv_encode calls with their rotation on ``fwht.cu``), two calls
    bit-equal, timed beside both. Then, untimed, every head_dim 2 to 1024
    with huge, tiny and zero vectors."""
    for label, t in KV_SHAPES:
        k, v = _kv_pair(gen, dev, SLOTS, 3, t, 64)
        n = SLOTS * 3 * t
        got = fwht_kv_encode(k, v)
        chain = lambda: (kv_encode(k), kv_encode(v))  # noqa: E731
        if not (_kv_equal(got, fwht_kv_encode_ref(k, v))
                and _kv_equal(got, chain())
                and _kv_equal(got, fwht_kv_encode(k, v))):
            raise AssertionError(f"fwht_kv_encode {label}: not the plain "
                                 f"version's or the chain's bits")
        led.add("fwht_kv", f"{label} ({n}+{n},64)", err=0.0, rel=0.0,
                ms=device_ms(lambda: fwht_kv_encode(k, v)),
                plain_ms=device_ms(lambda: fwht_kv_encode_ref(k, v)),
                chain_ms=device_ms(chain), library_ms=None,
                nbytes=2 * 4 * n * 64 + 2 * (n * 64 + 2 * n),
                flops=2 * n * 64 * 11)
    for hd in FWHT_BLOCKS:
        k, v = _kv_pair(gen, dev, 2, 3, 37, hd)
        k[0, 0, 0] *= 1e9
        k[1, 2, 36] *= 1e-7
        k[0, 1, 2] = 0.0
        v[1, 0, 1] *= 1e9
        v[0, 2, 3] *= 1e-8
        got = fwht_kv_encode(k, v)
        if not (_kv_equal(got, fwht_kv_encode_ref(k, v))
                and _kv_equal(got, (kv_encode(k), kv_encode(v)))
                and _kv_equal(got, fwht_kv_encode(k, v))):
            raise AssertionError(f"fwht_kv_encode head_dim {hd}: not the "
                                 f"plain version's bits")
        ks, vs = got[0][1].float(), got[1][1].float()
        if not (ks[0, 0, 0].item() == 65504.0 and vs[1, 0, 1].item() == 65504.0
                and ks[1, 2, 36].item() == 2.0 ** -14
                and vs[0, 2, 3].item() == 2.0 ** -14):
            raise AssertionError(f"fwht_kv_encode head_dim {hd}: scales not "
                                 f"clamped to fp16's range")
    report["fwht_kv_edges"] = len(FWHT_BLOCKS)
    print(f"  fwht_kv_encode at every head_dim {FWHT_BLOCKS[0]}.."
          f"{FWHT_BLOCKS[-1]} (V strided, huge, tiny and zero vectors): "
          f"bit-equal to the plain version and the chain, two calls "
          f"bit-equal", flush=True)


def fwht_ptxas_report(report: dict) -> None:
    """Registers and spills of every instantiation in fwht.cu (the
    rotation, the activation codec, the KV codec); fails on a spill."""
    def label(entry):
        n = re.match(r"_Z(\d+)", entry).group(1)
        name = entry[2 + len(n):2 + len(n) + int(n)]
        args = re.findall(r"L[ib](\d+)E", entry[2 + len(n) + int(n):])
        return f"{name}<{', '.join(args)}>"
    report["fwht_ptxas"] = ptxas_spill_report(report, "fwht", label)


def check_matvec(led: Ledger, gen: torch.Generator, dev, weights,
                 report: dict) -> None:
    """itq3_matvec at the four serving shapes, M = 4, in three forms: the
    fused form of the float decode path (unrotated x, ``rotate_x``), the
    unfused pair (fwht.cu, then the matvec on the rotated x) and weights
    mode. The fused form must equal the pair bit for bit; every form must
    give the same bits on two calls and agree with its plain version
    within 1e-4. The yardstick of all three is ``x @ W`` on the IFWHT'd
    dequantized weight, the same function in one call; their bound counts
    the one FWHT of x (fused and pair) or of the weight (weights mode)."""
    m = 4
    for name, qt in weights.items():
        d = qt.data
        planes = (d["plane2"], d["plane1"], d["scales"], d["zps"])
        n, kb = d["plane2"].shape[:2]
        kpad = kb * 256
        w_rot = dequant_blocks(*planes, rotate_weights=True, fivelevel=False,
                               sub_blocks=0).reshape(n, kpad).T.contiguous()
        x = torch.randn(m, kpad, generator=gen, device=dev)
        forms = {
            "rotate_x": (lambda: itq3_matvec(x, *planes, rotate_weights=False,
                                             rotate_x=True),
                         lambda: itq3_matmul_ref(fwht_ref(x), *planes,
                                                 rotate_weights=False)),
            "pair": (lambda: itq3_matvec(fwht(x), *planes,
                                         rotate_weights=False),
                     lambda: itq3_matmul_ref(fwht_ref(x), *planes,
                                             rotate_weights=False)),
            "rotate=True": (lambda: itq3_matvec(x, *planes,
                                                rotate_weights=True),
                            lambda: itq3_matmul_ref(x, *planes,
                                                    rotate_weights=True)),
        }
        got = {}
        for form, (run, plain) in forms.items():
            got[form] = run()
            if not torch.equal(got[form], run()):
                raise AssertionError(f"itq3_matvec {name} {form}: two calls "
                                     f"differ")
            err, rel = rel_err(got[form], plain())
            nbytes = m * kpad * 4 + weight_bytes(qt) + m * n * 4
            rotated = (n if form == "rotate=True" else m) * kpad
            led.add("fwht+itq3_matvec" if form == "pair" else "itq3_matvec",
                    f"{name} M={m} {form}", err=err, rel=rel,
                    ms=device_ms(run), plain_ms=device_ms(plain),
                    library_ms=device_ms(lambda: x @ w_rot), nbytes=nbytes,
                    flops=2 * m * n * kpad + 9 * rotated)
        if not torch.equal(got["rotate_x"], got["pair"]):
            raise AssertionError(f"itq3_matvec {name}: the fused form differs "
                                 f"from fwht.cu + matvec")
    print("  itq3_matvec: fused == fwht.cu + matvec bit for bit, two calls "
          "bit-equal, at every serving shape", flush=True)


def check_itq3(led: Ledger, gen: torch.Generator, dev, weights,
               report: dict) -> None:
    """itq3_matmul at the main-path shapes, both modes. It must also give
    the same bits on two calls (its split-K combine runs in a fixed
    order); its bound counts its TF32 products, and the f32 CUDA-core
    bound of the same shapes is reported beside it."""
    f32_bound = {}
    for name, qt in weights.items():
        d = qt.data
        n, kb = d["plane2"].shape[:2]
        kpad = kb * 256
        # prefill (M = 256) in both modes; the verify pass's M = 20 (4 slots
        # x a K = 4 window) in activations mode
        for m, rotate in ((256, False), (256, True), (VERIFY_M, False)):
            w = dequant_blocks(d["plane2"], d["plane1"], d["scales"], d["zps"],
                               rotate_weights=rotate, fivelevel=False,
                               sub_blocks=0).reshape(n, kpad).T.contiguous()
            x = torch.randn(m, kpad, generator=gen, device=dev)

            def run(x=x):
                return itq3_matmul(x, d["plane2"], d["plane1"], d["scales"],
                                   d["zps"], rotate_weights=rotate)

            def plain(x=x):
                return itq3_matmul_ref(x, d["plane2"], d["plane1"],
                                       d["scales"], d["zps"],
                                       rotate_weights=rotate)
            got = run()
            err, rel = rel_err(got, plain())
            nbytes = m * kpad * 4 + weight_bytes(qt) + m * n * 4
            flops = 2 * m * n * kpad + (n * kb * 256 * 9 if rotate else 0)
            shape = f"{name} M={m} rotate={rotate}" + (
                " verify" if m == VERIFY_M else "")
            if not torch.equal(got, run()):
                raise AssertionError(f"itq3_matmul {shape}: two calls differ")
            f32_bound[shape] = bound_ms(nbytes, flops)[0]
            led.add("itq3_matmul", shape, err=err, rel=rel, ms=device_ms(run),
                    plain_ms=device_ms(plain),
                    library_ms=device_ms(lambda x=x: x @ w),
                    nbytes=nbytes, flops=2 * m * n * kpad * (3 if rotate
                                                             else 2),
                    peak_ops=PEAK_TF32_FLOPS)
    report["itq3_matmul_f32_core_bound_ms"] = f32_bound
    main = sum(v for k, v in f32_bound.items()
               if "rotate=False" in k and "verify" not in k)
    print(f"  itq3_matmul: two calls bit-equal at every shape; bound on the "
          f"f32 CUDA cores over the main-path shapes {main:.4f} ms (the "
          f"rows above: TF32 tensor cores)", flush=True)


def ternary_weight(fmt: str, k: int, n: int, gen, dev):
    """A seeded (K, N) weight quantized by the port to ``fmt``. quip3's
    planes are itq3_s planes of the sign-flipped weight D W: the port does
    not draw quip3's sign diagonal yet, and the kernel sees the same
    flags."""
    w = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
    if fmt != "quip3":
        return formats.quantize(w, fmt)
    sign = torch.randint(0, 2, (k, 1), generator=gen, device=dev) * 2 - 1
    return formats.quantize(w * sign, "itq3_s")


MATMUL_EDGE_FORMATS = ("iq3_s", "quip3", "itq3_s", "itq3_s_sub", "itq3_x")
MATMUL_EDGE_M = (1, 17, 255, 256, 300)
MATMUL_EDGE_NKB = ((24, 1), (24, 6), (192, 1), (192, 6))
MATMUL_EDGE_SUB = (1, 2, 16, 32, 128, 256)  # besides itq3_s_sub's 8


def check_matmul_edges(gen: torch.Generator, dev, report: dict) -> None:
    """itq3_matmul untimed at the edges of its tiles and splits: all five
    formats (sub-blocks, the five-level escape), both modes, ragged M and
    N, one block and six, then other sub-block counts: within 1e-4 of the
    plain version, two calls bit-equal."""
    worst, cases = 0.0, 0
    for fmt in MATMUL_EDGE_FORMATS:
        for n, kb in MATMUL_EDGE_NKB:
            qt = ternary_weight(fmt, kb * 256, n, gen, dev)
            d, meta = qt.data, qt.meta
            planes = (d["plane2"], d["plane1"], d["scales"], d["zps"])
            for rotate in (False, True):
                kw = dict(rotate_weights=rotate, fivelevel=meta.fivelevel,
                          sub_blocks=meta.sub_blocks)
                for m in MATMUL_EDGE_M:
                    x = torch.randn(m, kb * 256, generator=gen, device=dev)
                    got = itq3_matmul(x, *planes, **kw)
                    _, rel = rel_err(got, itq3_matmul_ref(x, *planes, **kw))
                    same = torch.equal(got, itq3_matmul(x, *planes, **kw))
                    if not (rel <= KERNEL_REL_TOL and same):
                        raise AssertionError(
                            f"itq3_matmul edge {fmt} M={m} N={n} KB={kb} "
                            f"rotate={rotate}: rel {rel:.2e}, bit-equal "
                            f"{same}")
                    worst, cases = max(worst, rel), cases + 1
    for sub in MATMUL_EDGE_SUB:  # other sub-block counts, N = 24, KB = 6
        qt = formats.quantize(
            torch.randn(1536, 24, generator=gen, device=dev) / math.sqrt(
                1536), "itq3_s_sub", sub_blocks=sub)
        d = qt.data
        planes = (d["plane2"], d["plane1"], d["scales"], d["zps"])
        for rotate in (False, True):
            for m in (17, 256):
                x = torch.randn(m, 1536, generator=gen, device=dev)
                kw = dict(rotate_weights=rotate, sub_blocks=sub)
                got = itq3_matmul(x, *planes, **kw)
                _, rel = rel_err(got, itq3_matmul_ref(x, *planes, **kw))
                if not rel <= KERNEL_REL_TOL:
                    raise AssertionError(f"itq3_matmul edge sub_blocks={sub}"
                                         f" M={m} rotate={rotate}: rel "
                                         f"{rel:.2e}")
                worst, cases = max(worst, rel), cases + 1
    report["matmul_edges"] = dict(cases=cases, max_rel_err=worst)
    print(f"  itq3_matmul edges: {cases} cases (5 formats x 2 modes x M "
          f"{MATMUL_EDGE_M} x (N, KB) {MATMUL_EDGE_NKB}; sub_blocks "
          f"{MATMUL_EDGE_SUB} x 2 modes x M (17, 256)): max rel error "
          f"{worst:.2e}, two calls bit-equal", flush=True)


def matmul_tile_sweep(gen: torch.Generator, dev, weights,
                      report: dict, timed: bool = True) -> None:
    """itq3_matmul at phase 3's four main-path shapes under every row tile
    and split count (the wrapper's matmul_tiles replaced for the sweep
    only): each within 1e-4 of the plain version and deterministic; times
    printed and written to the details, not summed into the kernel line."""
    from repro_torch.kernels import itq3 as itq3_mod

    chosen = itq3_mod.matmul_tiles
    out = {}
    try:
        for name, qt in weights.items():
            d = qt.data
            n, kb = d["plane2"].shape[:2]
            planes = (d["plane2"], d["plane1"], d["scales"], d["zps"])
            x = torch.randn(256, kb * 256, generator=gen, device=dev)
            want = itq3_matmul_ref(x, *planes, rotate_weights=False)
            pick = chosen(256, n, kb)
            splits = sorted({-(-kb // -(-kb // s)) for s in range(
                1, min(kb, itq3_mod.MATMUL_MAX_SPLITS) + 1)})
            row = {}
            for bm in itq3_mod.MATMUL_BM:
                for sp in splits:
                    itq3_mod.matmul_tiles = lambda *_, t=(bm, sp): t

                    def run():
                        return itq3_matmul(x, *planes, rotate_weights=False)
                    got = run()
                    _, rel = rel_err(got, want)
                    if not (rel <= KERNEL_REL_TOL and torch.equal(got, run())):
                        raise AssertionError(f"itq3_matmul {name} tile "
                                             f"{bm}x{sp}: rel {rel:.2e} or "
                                             f"not deterministic")
                    row[f"{bm}x{sp}"] = cut_ms(run, timed)
            out[name] = dict(pick=f"{pick[0]}x{pick[1]}", ms=row)
            print(f"  itq3_matmul tiles {name} M=256 N={n} KB={kb} (rows x "
                  f"splits: ms; matmul_tiles picks {pick[0]}x{pick[1]}): "
                  + cuts_line(row),
                  flush=True)
    finally:
        itq3_mod.matmul_tiles = chosen
    report["matmul_tiles_ms"] = out


def _under_cut(rule: str, cut, fn):
    """``fn`` called with the tile rule ``rule`` of kernels/itq3.py
    replaced by ``cut`` (None: the rule's own)."""
    from repro_torch.kernels import itq3 as itq3_mod

    def call(*args, **kw):
        own = getattr(itq3_mod, rule)
        if cut is not None:
            setattr(itq3_mod, rule, lambda *_: cut)
        try:
            return fn(*args, **kw)
        finally:
            setattr(itq3_mod, rule, own)
    return call


def _matvec_edge(planes, kw, m, rotate, gen, dev, cut=None) -> float:
    """One itq3_matvec case: within KERNEL_REL_TOL of the plain version,
    two calls bit-equal, and in activations mode the fused form (x
    unrotated, rotate_x) bit-equal to fwht.cu then the matvec. Returns
    the relative error."""
    run = _under_cut("matvec_tiles", cut, itq3_matvec)
    kb = planes[0].shape[1]
    x = torch.randn(m, kb * 256, generator=gen, device=dev)
    what = (f"itq3_matvec {kw} M={m} N={planes[0].shape[0]} KB={kb} "
            f"rotate={rotate} cut={cut}")
    if rotate:
        got = run(x, *planes, rotate_weights=True, **kw)
        want = itq3_matmul_ref(x, *planes, rotate_weights=True, **kw)
        pair_equal = True
        same = torch.equal(got, run(x, *planes, rotate_weights=True, **kw))
    else:
        got = run(x, *planes, rotate_weights=False, rotate_x=True, **kw)
        want = itq3_matmul_ref(fwht_ref(x), *planes, rotate_weights=False,
                               **kw)
        pair_equal = torch.equal(got, run(fwht(x), *planes,
                                          rotate_weights=False, **kw))
        same = torch.equal(got, run(x, *planes, rotate_weights=False,
                                    rotate_x=True, **kw))
    _, rel = rel_err(got, want)
    if not (rel <= KERNEL_REL_TOL and pair_equal and same):
        raise AssertionError(f"{what}: rel {rel:.2e}, fused == pair "
                             f"{pair_equal}, two calls bit-equal {same}")
    return rel


MATVEC_EDGE_M = (1, 4, 5, 16)
MATVEC_EDGE_NKB = tuple((n, kb) for n in (29, 192) for kb in (1, 3, 6, 11, 24))
MATVEC_EDGE_SUB = (1, 32, 256)  # besides itq3_s's 0 and itq3_s_sub's 8
MATVEC_RING_CUTS = ((8, 1), (8, 2), (8, 4), (16, 3))


def check_matvec_edges(gen: torch.Generator, dev, report: dict) -> None:
    """itq3_matvec untimed at its edges (see _matvec_edge), both modes: all
    five formats at M 1/4/5/16, N 29/192 and KB 1/3/6/11/24 (staged whole
    or in windows; one split where KB is prime), at the rule's cut; other
    sub-block counts; every cut of KB 6 at M 16."""
    worst, cases = 0.0, 0
    for fmt in MATMUL_EDGE_FORMATS:
        for n, kb in MATVEC_EDGE_NKB:
            qt = ternary_weight(fmt, kb * 256, n, gen, dev)
            d, meta = qt.data, qt.meta
            planes = (d["plane2"], d["plane1"], d["scales"], d["zps"])
            kw = dict(fivelevel=meta.fivelevel, sub_blocks=meta.sub_blocks)
            for rotate in (False, True):
                for m in MATVEC_EDGE_M:
                    worst = max(worst, _matvec_edge(planes, kw, m, rotate,
                                                    gen, dev))
                    cases += 1
    for sub in MATVEC_EDGE_SUB:
        planes, kw = _int8_case("itq3_s_sub", 29, 6, gen, dev, sub)
        for rotate in (False, True):
            for m in (1, 16):
                worst = max(worst, _matvec_edge(planes, kw, m, rotate, gen,
                                                dev))
                cases += 1
    for fmt, sub in (("itq3_s", None), ("itq3_s_sub", None), ("itq3_x", None),
                     ("itq3_s_sub", 32)):
        planes, kw = _int8_case(fmt, 192, 6, gen, dev, sub)
        for cut in int8_cuts("itq3_matvec_int8", 6):
            for rotate in (False, True):
                worst = max(worst, _matvec_edge(planes, kw, 16, rotate, gen,
                                                dev, cut))
                cases += 1
    # x staged in windows at KB 24, M 16 (double-buffered rings of 6, 3,
    # 2 and 1 blocks per run)
    for fmt in ("itq3_s", "itq3_x"):
        planes, kw = _int8_case(fmt, 29, 24, gen, dev)
        for cut in MATVEC_RING_CUTS:
            for rotate in (False, True):
                worst = max(worst, _matvec_edge(planes, kw, 16, rotate, gen,
                                                dev, cut))
                cases += 1
    report["matvec_edges"] = dict(cases=cases, max_rel_err=worst)
    print(f"  itq3_matvec edges: {cases} cases (5 formats x 2 modes x M "
          f"{MATVEC_EDGE_M} x (N, KB) {MATVEC_EDGE_NKB}; sub_blocks "
          f"{MATVEC_EDGE_SUB}; every cut at KB 6, M 16; cuts "
          f"{MATVEC_RING_CUTS} at KB 24, M 16): max rel error "
          f"{worst:.2e}, fused == fwht.cu + matvec, two calls bit-equal",
          flush=True)


def matvec_tile_sweep(gen: torch.Generator, dev, weights, report: dict,
                      timed: bool = True) -> None:
    """The fused itq3_matvec at phase 3's four serving shapes (M = 4)
    under every cut (features x splits), beside the one matvec_tiles
    picks: each within 1e-4 of the plain version and deterministic; times
    printed and written to the details, not summed into the kernel
    line."""
    from repro_torch.kernels import itq3 as itq3_mod

    out = {}
    for name, qt in weights.items():
        d = qt.data
        planes = (d["plane2"], d["plane1"], d["scales"], d["zps"])
        n, kb = d["plane2"].shape[:2]
        x = torch.randn(4, kb * 256, generator=gen, device=dev)
        want = itq3_matmul_ref(fwht_ref(x), *planes, rotate_weights=False)
        pick = itq3_mod.matvec_tiles(4, n, kb)
        row = {}
        for cut in int8_cuts("itq3_matvec_int8", kb):
            run = _under_cut("matvec_tiles", cut, itq3_matvec)

            def call(run=run):
                return run(x, *planes, rotate_weights=False, rotate_x=True)
            got = call()
            _, rel = rel_err(got, want)
            if not (rel <= KERNEL_REL_TOL and torch.equal(got, call())):
                raise AssertionError(f"itq3_matvec {name} cut {cut}: rel "
                                     f"{rel:.2e} or not deterministic")
            row[f"{cut[0]}x{cut[1]}"] = cut_ms(call, timed)
        out[name] = dict(pick=f"{pick[0]}x{pick[1]}", ms=row)
        print(f"  itq3_matvec cuts {name} M=4 N={n} KB={kb} (features x "
              f"splits: ms; matvec_tiles picks {pick[0]}x{pick[1]}): "
              + cuts_line(row), flush=True)
    report["matvec_tiles_ms"] = out


def ptxas_entries(report: dict, source: str) -> dict:
    """ptxas's register and spill lines per kernel entry of ``source``."""
    regs, entry = {}, None
    for line in report["ptxas"].get(source, "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            regs.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return regs


def ptxas_spill_report(report: dict, source: str, label) -> dict:
    """Registers and spills of every instantiation of ``source`` (``label``
    names one from its mangled entry); fails on a spill."""
    regs = ptxas_entries(report, source)
    if not regs:
        print(f"  ptxas {source}: no report (the library was cached)",
              flush=True)
    for entry, lines in regs.items():
        text = "; ".join(lines)
        print(f"  ptxas {label(entry)}: {text}", flush=True)
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", text)
        if len(spills) != 2 or any(int(b) for b in spills):
            raise AssertionError(f"{source} {entry}: spills ({text})")
    return regs


def matmul_ptxas_report(report: dict) -> None:
    """Registers and spills of every itq3_matmul instantiation (rows per
    block, weight operand); fails on a spill."""
    modes = ("wint", "d_sub*q", "rotated")

    def label(entry):
        wm, mode = re.search(r"ILi(\d+)ELi(\d)E", entry).groups()
        return f"itq3_matmul_kernel<{16 * int(wm)} rows, {modes[int(mode)]}>"
    report["matmul_ptxas"] = ptxas_spill_report(report, "itq3_matmul", label)


INT8_SCALE_MODES = ("d per block", "8 sub-blocks", "any sub-blocks")


def matvec_ptxas_report(report: dict) -> None:
    """Registers and spills of every itq3_matvec instantiation (scale mode
    x weights mode); fails on a spill."""
    def label(entry):
        mode, rotw = re.search(r"ILi(\d)ELb([01])E", entry).groups()
        return (f"itq3_matvec_kernel<{INT8_SCALE_MODES[int(mode)]}, "
                f"{'weights mode' if rotw == '1' else 'activations mode'}>")
    report["matvec_ptxas"] = ptxas_spill_report(report, "itq3_matvec", label)


def int8_ptxas_report(report: dict) -> None:
    """Registers and spills of every instantiation of both int8 sources
    (the matmul's rows per block x scale mode, the matvec's scale mode);
    fails on a spill."""
    def mm_label(entry):
        wm, mode = re.search(r"ILi(\d+)ELi(\d)E", entry).groups()
        return (f"itq3_matmul_int8_kernel<{16 * int(wm)} rows, "
                f"{INT8_SCALE_MODES[int(mode)]}>")

    def mv_label(entry):
        mode = re.search(r"ILi(\d)E", entry).group(1)
        return f"itq3_matvec_int8_kernel<{INT8_SCALE_MODES[int(mode)]}>"
    report["int8_ptxas"] = {
        "itq3_matmul_int8": ptxas_spill_report(report, "itq3_matmul_int8",
                                               mm_label),
        "itq3_matvec_int8": ptxas_spill_report(report, "itq3_matvec_int8",
                                               mv_label)}


def _attn_case(gen, dev, *, r, tq, g, hd, t, kv_len, q_offset, causal):
    q = torch.randn(r, tq, g, hd, generator=gen, device=dev)
    kc = torch.randint(-127, 128, (r, t, hd), generator=gen, device=dev,
                       dtype=torch.int8)
    vc = torch.randint(-127, 128, (r, t, hd), generator=gen, device=dev,
                       dtype=torch.int8)
    ks = (torch.rand(r, t, generator=gen, device=dev) * 0.05 + 1e-3).half()
    vs = (torch.rand(r, t, generator=gen, device=dev) * 0.05 + 1e-3).half()
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    off = torch.tensor(q_offset, dtype=torch.int32, device=dev)
    return (q, kc, ks, vc, vs, kl, off), dict(sm_scale=hd ** -0.5,
                                              causal=causal)


def attn_extent(kv_len, q_offset, tq: int, t: int, causal: bool):
    """What this run's rows need: the (R, TQ, T) bool mask of valid
    (query, key) pairs, the keys each row must read (its largest valid
    key + 1) and the count of valid pairs."""
    kpos = np.arange(t)
    qpos = np.asarray(q_offset)[:, None] + np.arange(tq)  # (R, TQ)
    mask = kpos[None, None, :] < np.asarray(kv_len)[:, None, None]
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
    keys_read = [int(np.nonzero(m.any(0))[0].max()) + 1 if m.any() else 0
                 for m in mask]
    return mask, keys_read, int(mask.sum())


# (label, TQ, kv_len and q_offset per slot, causal, keys T). The verify
# rows are the speculative window's (K = 4, so TQ = 5) over the spec
# engine's max_len + K = 260-key cache, whose last tile holds 4 keys.
ATTN_CASES = (
    ("decode TQ=1", 1, [5, 64, 130, 255], [0, 0, 0, 0], False, 256),
    ("prefill TQ=64", 64, [64, 74, 164, 256], [0, 10, 100, 192], True, 256),
    ("verify TQ=5", 5, [45, 105, 205, 260], [40, 100, 200, 255], True, 260),
)
# Untimed edges of the kernel's key splits, per slot (kv_len, q_offset):
# decode: an empty row, a split boundary (32-key splits), two boundaries,
# the full cache; prefill (64-key splits): a causally empty query tile
# (kv_len 0 past offset 0), a limit on a split boundary, query tiles
# straddling a boundary (rows empty in the second split only), full T;
# verify (32-key splits over 260 keys): an empty window, a window ending
# on a boundary, one straddling it, the full cache with its 4-key tail.
ATTN_EDGES = (
    ("edges decode TQ=1", 1, [0, 32, 64, 256], [0, 0, 0, 0], False, [0],
     256),
    ("edges prefill TQ=64", 64, [0, 64, 104, 256], [20, 0, 40, 192], True,
     [0], 256),
    ("edges verify TQ=5", 5, [0, 32, 67, 260], [0, 27, 62, 255], True, [0],
     260),
)


def _gathered(q, kp, ksp, vp, vsp, kl, off, rows, t: int):
    """The dense kernel's operands over the first ``t`` keys of the view
    that a pool-row table gathers (R, MAXB*BS) from pooled planes."""
    hd = kp.shape[-1]
    span = rows.shape[1] * kp.shape[1]
    return (q, kp[rows].reshape(-1, span, hd)[:, :t].contiguous(),
            ksp[rows].reshape(-1, span)[:, :t].contiguous(),
            vp[rows].reshape(-1, span, hd)[:, :t].contiguous(),
            vsp[rows].reshape(-1, span)[:, :t].contiguous(), kl, off)


def _bit_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _empty_exact(out, rows) -> bool:
    acc, m, l = (x[rows] for x in out)
    return bool((m == -1e30).all() and (l == 0).all() and (acc == 0).all())


def attn_grid_report(report: dict) -> None:
    """The kernel's grid at phase 3's shapes, and ptxas's registers and
    spills for both instantiations at head_dim 64."""
    grids = {}
    for label, tq, *_, t in ATTN_CASES:
        tqb, st, grid = attn_grid(12, tq, 3, t)
        grids[label] = dict(query_tile=tqb, split_keys=32 * st, grid=grid)
        print(f"  attn grid {label}: {grid[0]} splits x {grid[1]} query tiles"
              f" x {grid[2]} rows = {math.prod(grid)} blocks ({32 * st}-key "
              f"splits, {tqb} queries x 3 heads per block)", flush=True)
    report["attn_grid"] = grids
    regs = ptxas_entries(report, "attn_q8")
    report["attn_ptxas"] = regs
    for entry, lines in regs.items():
        for inst, tag in (("ILb0ELi64E", "dense"), ("ILb1ELi64E", "paged")):
            if inst in entry:
                print(f"  ptxas attn_q8_kernel<{tag}, HD=64>: "
                      f"{'; '.join(lines)}", flush=True)


def check_attn_edges(gen: torch.Generator, dev, report: dict) -> None:
    """The split edges at phase 3's widths, untimed: dense and paged
    against the plain version (1e-4), paged equal to dense over the
    gathered view, two calls bit-equal, the empty rows exactly
    m = -1e30, l = 0, acc = 0; and ``decode_attn_q8`` under ``auto``
    raising for three shapes the kernel does not build."""
    slots, kvh, g, hd = 4, 3, 3, 64
    out = {}
    for label, tq, lens, offs, causal, empty, t in ATTN_EDGES:
        maxb = -(-t // BLOCK_SIZE)
        table = (1 + torch.randperm(slots * maxb, generator=gen, device=dev)
                 ).reshape(slots, maxb).to(torch.int32)
        rows = paged_row_table(table, kvh)
        kv_len = [x for x in lens for _ in range(kvh)]
        q_off = [x for x in offs for _ in range(kvh)]
        pool, kw = _attn_case(gen, dev, r=(slots * maxb + 1) * kvh, tq=1, g=g,
                              hd=hd, t=BLOCK_SIZE, kv_len=[0], q_offset=[0],
                              causal=causal)
        _, kp, ksp, vp, vsp, _, _ = pool
        q = torch.randn(slots * kvh, tq, g, hd, generator=gen, device=dev)
        kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        off = torch.tensor(q_off, dtype=torch.int32, device=dev)
        pargs = (q, kp, ksp, vp, vsp, kl, off, rows)
        pkw = dict(kw, block_size=BLOCK_SIZE)
        # the paged kernel against the dense one over the gathered view of
        # its MAXB blocks; the dense kernel also over the first t keys
        view = _gathered(q, kp, ksp, vp, vsp, kl, off, rows, maxb * BLOCK_SIZE)
        dargs = _gathered(q, kp, ksp, vp, vsp, kl, off, rows, t)
        dense, paged = attn_q8(*dargs, **kw), attn_q8_paged(*pargs, **pkw)
        dense_view = attn_q8(*view, **kw) if view[1].shape[1] != t else dense
        errs = _attn_errs(dense, attn_q8_ref(*dargs, **kw))
        empty_rows = [s * kvh + h for s in empty for h in range(kvh)]
        res = dict(
            rel=errs["rel"],
            paged_vs_dense=max((a - b).abs().max().item()
                               for a, b in zip(paged, dense_view)),
            dense_deterministic=_bit_equal(dense, attn_q8(*dargs, **kw)),
            paged_deterministic=_bit_equal(paged,
                                           attn_q8_paged(*pargs, **pkw)),
            empty_exact=_empty_exact(dense, empty_rows)
            and _empty_exact(paged, empty_rows))
        out[label] = res
        print(f"  attn_q8 {label:22s} rel {res['rel']:.2e} | paged vs dense "
              f"{res['paged_vs_dense']} | two calls bit-equal "
              f"{res['dense_deterministic']} / {res['paged_deterministic']} "
              f"| empty rows exact {res['empty_exact']}", flush=True)
        if not (res["rel"] <= KERNEL_REL_TOL and res["paged_vs_dense"] == 0
                and res["dense_deterministic"] and res["paged_deterministic"]
                and res["empty_exact"]):
            raise AssertionError(f"attn_q8 {label}: {res}")
    # shapes the kernel does not build: on the card the serving entry
    # points raise under "auto" too, never serving them plain
    refused = []
    for shp in ((4, kvh, g, 1, 256), (4, kvh, g, 1, 16), (4, kvh, 33, 1, hd)):
        try:
            decode_attn_q8(torch.zeros(shp, device=dev), {}, None, None,
                           None, backend="auto")
        except ValueError:
            refused.append(shp)
    print(f"  attn_q8 under auto refuses {len(refused)}/3 shapes the kernel "
          f"does not build (head_dim 256, 16; 33 query heads)", flush=True)
    if len(refused) != 3:
        raise AssertionError(f"attn_q8 auto served unbuilt shapes: {refused}")
    out["auto_refusals"] = len(refused)
    report["attn_edges"] = out


# Other cuts of phase 3's attention shapes, (query tile, split tiles):
# the kernel at each, against the plain version and timed beside the cut
# that attn_grid picks, so the choice rests on a measurement.
ATTN_CUTS = {"decode TQ=1": [(1, 1), (1, 2), (1, 4), (1, 8)],
             "prefill TQ=64": [(10, 1), (10, 2), (10, 4), (10, 8), (5, 1),
                               (5, 2), (5, 4), (2, 1), (2, 2)],
             "verify TQ=5": [(5, 1), (5, 2), (5, 3), (5, 5), (5, 9), (3, 1),
                             (1, 1), (1, 2)]}


def attn_cut_sweep(gen: torch.Generator, dev, report: dict,
                   timed: bool = True) -> None:
    """The dense kernel at phase 3's timed rows under other cuts (the
    wrapper's attn_grid replaced for the sweep only): every cut within 1e-4
    of the plain version and deterministic; times printed, not summed into
    the kernel line."""
    from repro_torch.kernels import attn_q8 as attn_mod

    slots, kvh, g, hd = 4, 3, 3, 64
    chosen = attn_mod.attn_grid
    out = {}
    try:
        for label, tq, lens, offs, causal, t in ATTN_CASES:
            kv_len = [x for x in lens for _ in range(kvh)]
            q_off = [x for x in offs for _ in range(kvh)]
            args, kw = _attn_case(gen, dev, r=slots * kvh, tq=tq, g=g, hd=hd,
                                  t=t, kv_len=kv_len, q_offset=q_off,
                                  causal=causal)
            want = attn_q8_ref(*args, **kw)
            pick = chosen(slots * kvh, tq, g, t)[:2]
            row = {}
            for tqb, st in ATTN_CUTS[label]:
                attn_mod.attn_grid = (
                    lambda r, tq_, g_, t_, tqb=tqb, st=st:
                    (tqb, st, (-(-t_ // (32 * st)), -(-tq_ // tqb), r)))
                got = attn_q8(*args, **kw)
                rel = _attn_errs(got, want)["rel"]
                if not (rel <= KERNEL_REL_TOL
                        and _bit_equal(got, attn_q8(*args, **kw))):
                    raise AssertionError(f"attn_q8 {label} cut {tqb}x{st}: "
                                         f"rel {rel:.2e} or not deterministic")
                row[f"{tqb}x{st}"] = cut_ms(lambda: attn_q8(*args, **kw),
                                            timed)
            out[label] = row
            print(f"  attn cuts {label} (query tile x split tiles: ms; "
                  f"attn_grid picks {pick[0]}x{pick[1]}): "
                  + cuts_line(row),
                  flush=True)
    finally:
        attn_mod.attn_grid = chosen
    report["attn_cuts_ms"] = out


def check_attn(led: Ledger, gen: torch.Generator, dev, *, name="attn_q8",
               cases=ATTN_CASES, kvh: int = 3, g: int = 3, hd: int = 64,
               model: str = "") -> None:
    """The dense attention over SLOTS slots of ``kvh`` KV heads at
    ``cases``: two calls bit-equal, within 1e-4 of its plain version,
    timed beside ``scaled_dot_product_attention`` as row ``name``
    (smollm-135m's rows by default)."""
    for label, tq, lens, offs, causal, t in cases:
        kv_len = [x for x in lens for _ in range(kvh)]
        q_off = [x for x in offs for _ in range(kvh)]
        args, kw = _attn_case(gen, dev, r=SLOTS * kvh, tq=tq, g=g, hd=hd,
                              t=t, kv_len=kv_len, q_offset=q_off,
                              causal=causal)
        got, want = attn_q8(*args, **kw), attn_q8_ref(*args, **kw)
        if not _bit_equal(got, attn_q8(*args, **kw)):
            raise AssertionError(f"{name} {model}{label}: two calls differ")
        q, kc, ks, vc, vs, _, _ = args
        mask, keys_read, pairs = attn_extent(kv_len, q_off, tq, t, causal)
        nbytes = (2 * q.numel() * 4 + sum(keys_read) * 2 * (hd + 2)
                  + 2 * len(kv_len) * 4 + 2 * (q.numel() // hd) * 4)
        led.add(name, f"{model}{label} R={SLOTS * kvh} G={g} HD={hd} T={t}",
                **_attn_errs(got, want),
                ms=device_ms(lambda: attn_q8(*args, **kw)),
                plain_ms=device_ms(lambda: attn_q8_ref(*args, **kw)),
                library_ms=device_ms(_attn_library(args, kw, mask, dev)),
                nbytes=nbytes, flops=pairs * g * 4 * hd)


def _attn_errs(got, want) -> dict:
    acc_err, acc_rel = rel_err(got[0], want[0])
    l_err, l_rel = rel_err(got[2], want[2])
    m_err, _ = rel_err(got[1], want[1])
    return dict(err=max(acc_err, l_err, m_err), rel=max(acc_rel, l_rel))


def _attn_library(args, kw, mask, dev):
    """The yardstick: scaled_dot_product_attention over the dequantized
    dense K/V, masked as the kernel masks."""
    q, kc, ks, vc, vs, _, _ = args
    g = q.shape[2]
    kd = (kc.float() * ks.float()[..., None])[:, None].expand(-1, g, -1, -1)
    vd = (vc.float() * vs.float()[..., None])[:, None].expand(-1, g, -1, -1)
    qh = q.permute(0, 2, 1, 3)  # (R, G, TQ, HD)
    m = torch.as_tensor(mask, device=dev)[:, None]  # (R, 1, TQ, T)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=m, scale=kw["sm_scale"])


def check_attn_paged(led: Ledger, gen: torch.Generator, dev,
                     report: dict) -> None:
    """The paged kernel on phase 3's attention rows, their 256 keys cut
    into 16-key blocks scattered over a shuffled pool (the dense-equivalent
    pool of 4 x MAXB blocks plus the null block; the verify rows' 260 keys
    take 17 blocks): the same bits as the dense kernel over the gathered
    view, within 1e-4 of the plain version."""
    slots, kvh, g, hd = 4, 3, 3, 64
    exact = {}
    for label, tq, lens, offs, causal, t in ATTN_CASES:
        maxb = -(-t // BLOCK_SIZE)
        nb = slots * maxb + 1
        table = (1 + torch.randperm(slots * maxb, generator=gen, device=dev)
                 ).reshape(slots, maxb).to(torch.int32)
        rows = paged_row_table(table, kvh)  # (R, MAXB) pool rows
        kv_len = [x for x in lens for _ in range(kvh)]
        q_off = [x for x in offs for _ in range(kvh)]
        args, kw = _attn_case(gen, dev, r=nb * kvh, tq=1, g=g, hd=hd,
                              t=BLOCK_SIZE, kv_len=[0] * (nb * kvh),
                              q_offset=[0] * (nb * kvh), causal=causal)
        _, kp, ksp, vp, vsp, _, _ = args  # pooled planes (PR, BS, ...)
        q = torch.randn(slots * kvh, tq, g, hd, generator=gen, device=dev)
        kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        off = torch.tensor(q_off, dtype=torch.int32, device=dev)
        pargs = (q, kp, ksp, vp, vsp, kl, off, rows)
        pkw = dict(kw, block_size=BLOCK_SIZE)
        got = attn_q8_paged(*pargs, **pkw)
        if not _bit_equal(got, attn_q8_paged(*pargs, **pkw)):
            raise AssertionError(f"attn_q8_paged {label}: two calls differ")
        dense = _gathered(q, kp, ksp, vp, vsp, kl, off, rows,
                          maxb * BLOCK_SIZE)
        vs_dense = attn_q8(*dense, **kw)
        exact[label] = max((a - b).abs().max().item()
                           for a, b in zip(got, vs_dense))
        if exact[label] != 0:
            raise AssertionError(f"attn_q8_paged {label}: differs from the "
                                 f"dense kernel by {exact[label]}")
        mask, keys_read, pairs = attn_extent(kv_len, q_off, tq,
                                             maxb * BLOCK_SIZE, causal)
        nbytes = (2 * q.numel() * 4 + sum(keys_read) * 2 * (hd + 2)
                  + sum(-(-k // BLOCK_SIZE) for k in keys_read) * 4
                  + 2 * len(kv_len) * 4 + 2 * (q.numel() // hd) * 4)
        led.add("attn_q8_paged",
                f"{label} R=12 G=3 HD=64 BS=16 MAXB={maxb}",
                **_attn_errs(got, attn_q8_paged_ref(*pargs, **pkw)),
                ms=device_ms(lambda: attn_q8_paged(*pargs, **pkw)),
                plain_ms=device_ms(lambda: attn_q8_paged_ref(*pargs, **pkw)),
                library_ms=device_ms(_attn_library(dense, kw, mask, dev)),
                nbytes=nbytes, flops=pairs * g * 4 * hd)
    report["attn_q8_paged_vs_dense_kernel_abs_err"] = exact
    print(f"  attn_q8_paged vs the dense kernel over the gathered view: max "
          f"abs error {max(exact.values())} (exact)", flush=True)


def quantize_smollm_projections(gen, dev):
    out = {}
    for name, (k, n) in SMOLLM_PROJ.items():
        w = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
        out[name] = formats.quantize(w, "itq3_s")
    return out


def int8_weights(gen, dev):
    """The W3A8 main-path shapes under the mixed policy (wq, wk itq3_s;
    gate, down itq3_s_sub) and one itq3_x shape."""
    out = {}
    for name, (k, n), fmt in (("wq", SMOLLM_PROJ["wq"], "itq3_s"),
                              ("wk", SMOLLM_PROJ["wk"], "itq3_s"),
                              ("gate", SMOLLM_PROJ["gate"], "itq3_s_sub"),
                              ("down", SMOLLM_PROJ["down"], "itq3_s_sub"),
                              ("wq", SMOLLM_PROJ["wq"], "itq3_x")):
        w = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
        out[f"{name} {fmt}"] = formats.quantize(w, fmt)
    return out


def check_itq3_int8(led: Ledger, gen: torch.Generator, dev, weights,
                    report: dict) -> None:
    """Each int8 kernel against its plain version: exactly with unit
    scales (every output an integer below 2**24), to 1e-5 of the largest
    output with real ones."""
    unit_errs = {}
    for name, qt in weights.items():
        d, meta = qt.data, qt.meta
        n, kb = d["plane2"].shape[:2]
        kpad = kb * 256
        kw = dict(fivelevel=meta.fivelevel, sub_blocks=meta.sub_blocks)
        w = dequant_blocks(d["plane2"], d["plane1"], d["scales"], d["zps"],
                           rotate_weights=False,
                           **kw).reshape(n, kpad).T.contiguous()
        for kernel, m, fn in (("itq3_matvec_int8", 4, itq3_matvec_int8),
                              ("itq3_matmul_int8", 256, itq3_matmul_int8),
                              ("itq3_matmul_int8", VERIFY_M,
                               itq3_matmul_int8)):
            x = torch.randn(m, kpad, generator=gen, device=dev)
            xq, xs = act_encode(x)
            ones = torch.ones_like(d["scales"])
            unit = (fn(xq, torch.ones_like(xs), d["plane2"], d["plane1"],
                       ones, d["zps"], **kw)
                    - itq3_matmul_int8_ref(xq, torch.ones_like(xs),
                                           d["plane2"], d["plane1"], ones,
                                           d["zps"], **kw)).abs().max().item()
            unit_errs[f"{kernel} {name} M={m}"] = unit
            if unit != 0:
                raise AssertionError(f"{kernel} {name} M={m}: unit-scale "
                                     f"outputs differ by {unit}")

            def run(fn=fn, xq=xq, xs=xs):
                return fn(xq, xs, d["plane2"], d["plane1"], d["scales"],
                          d["zps"], **kw)

            def plain(xq=xq, xs=xs):
                return itq3_matmul_int8_ref(xq, xs, d["plane2"], d["plane1"],
                                            d["scales"], d["zps"], **kw)
            err, rel = rel_err(run(), plain())
            xdec = act_decode(xq, xs)
            nbytes = m * kpad + m * 4 + weight_bytes(qt) + m * n * 4
            led.add(kernel, f"{name} M={m}" + (" verify" if m == VERIFY_M
                                               else ""), err=err, rel=rel,
                    ms=device_ms(run), plain_ms=device_ms(plain),
                    library_ms=device_ms(lambda xdec=xdec: xdec @ w),
                    nbytes=nbytes, flops=2 * m * n * kpad,
                    peak_ops=PEAK_INT8_OPS, tol=INT8_REL_TOL)
    report["int8_unit_scale_abs_err"] = unit_errs
    print(f"  int8 kernels with unit scales: max abs error "
          f"{max(unit_errs.values())} over {len(unit_errs)} shapes "
          f"(exact)", flush=True)


def _int8_case(fmt, n, kb, gen, dev, sub_blocks=None):
    """Seeded (KB*256, N) planes of ``fmt`` and their kwargs. With
    ``sub_blocks``, the codes of an itq3_s_sub quantization and that many
    seeded fp16 sub-block scales of the same magnitude (sub-blocks of one
    element leave the quantizer nothing to scale: every code 0)."""
    w = torch.randn(kb * 256, n, generator=gen, device=dev) / math.sqrt(
        kb * 256)
    qt = formats.quantize(w, fmt)
    d, meta = qt.data, qt.meta
    planes = (d["plane2"], d["plane1"], d["scales"], d["zps"])
    if sub_blocks is None:
        return planes, dict(fivelevel=meta.fivelevel,
                            sub_blocks=meta.sub_blocks)
    mag = d["scales"].float().abs().mean()
    scales = (mag * (0.5 + torch.rand(n, kb, sub_blocks, generator=gen,
                                      device=dev))).half()
    return ((planes[0], planes[1], scales, planes[3]),
            dict(fivelevel=meta.fivelevel, sub_blocks=sub_blocks))


def _with_cut(kernel, cut):
    """The int8 wrapper ``kernel`` with its tile rule replaced by ``cut``
    (None: the wrapper's own), and the K splits it then takes."""
    from repro_torch.kernels import itq3 as itq3_mod

    rule = "matvec_int8_tiles" if kernel == "itq3_matvec_int8" \
        else "matmul_tiles"
    call = _under_cut(rule, cut, itq3_matvec_int8
                      if kernel == "itq3_matvec_int8" else itq3_matmul_int8)

    def run(xq, xs, planes, kw):
        splits = cut[1] if cut else getattr(itq3_mod, rule)(
            xq.shape[0], *planes[0].shape[:2])[1]
        return call(xq, xs, *planes, **kw), splits
    return run


def _int8_edge(kernel, cut, planes, kw, m, gen, dev) -> float:
    """One int8 case: unit scales exactly the plain version; real scales
    bit-equal to the split model at the cut used and within INT8_REL_TOL
    of the plain version; two calls bit-equal. Returns the relative
    error."""
    run = _with_cut(kernel, cut)
    kb = planes[0].shape[1]
    xq, xs = act_encode(torch.randn(m, kb * 256, generator=gen, device=dev))
    ones = torch.ones_like(xs)
    unit = (planes[0], planes[1], torch.ones_like(planes[2]), planes[3])
    got, splits = run(xq, ones, unit, kw)
    what = f"{kernel} {kw} M={m} N={planes[0].shape[0]} KB={kb} cut={cut}"
    if not torch.equal(got, itq3_matmul_int8_ref(xq, ones, *unit, **kw)):
        raise AssertionError(f"{what}: unit scales not exact")
    got, splits = run(xq, xs, planes, kw)
    model = itq3_matmul_int8_split_ref(xq, xs, *planes, splits=splits, **kw)
    _, rel = rel_err(got, itq3_matmul_int8_ref(xq, xs, *planes, **kw))
    same = torch.equal(got, run(xq, xs, planes, kw)[0])
    if not (torch.equal(got, model) and rel <= INT8_REL_TOL and same):
        raise AssertionError(f"{what}: split model bit-equal "
                             f"{torch.equal(got, model)}, rel {rel:.2e}, "
                             f"two calls bit-equal {same}")
    return rel


INT8_EDGE_FORMATS = ("itq3_s", "itq3_s_sub", "itq3_x")
INT8_EDGE_M = {"itq3_matvec_int8": (1, 4, 16),
               "itq3_matmul_int8": (17, 255, 256, 300)}
INT8_EDGE_NKB = ((24, 1), (24, 3), (24, 6), (192, 1), (192, 3), (192, 6))
INT8_EDGE_SUB = (1, 2, 4, 16, 32, 64, 128, 256)  # besides itq3_s_sub's 8


def int8_cuts(kernel: str, kb: int) -> list:
    """Every cut of ``kernel`` the sweep tries at KB blocks: (rows, splits)
    for the matmul, (features, splits) for the matvec; splits of equal
    runs, none empty, within the cluster (matmul) or the block's warps
    (matvec)."""
    from repro_torch.kernels import itq3 as itq3_mod

    splits = sorted({-(-kb // -(-kb // s)) for s in range(1, min(kb, 8) + 1)})
    if kernel == "itq3_matmul_int8":
        return [(bm, sp) for bm in itq3_mod.MATMUL_BM for sp in splits]
    return [(f, sp) for f in itq3_mod.MATVEC_INT8_FEATURES for sp in splits
            if f // 8 * sp <= itq3_mod.MATVEC_INT8_MAX_WARPS]


def check_int8_edges(gen: torch.Generator, dev, report: dict) -> None:
    """Both int8 kernels untimed at their edges (see _int8_edge): the
    three ternary formats at ragged M and N, one, three and six blocks, at
    the wrapper's own cut; every other sub-block count on itq3_s_sub
    planes; every cut the sweep tries, at six blocks."""
    worst, cases = 0.0, 0
    for kernel, ms in INT8_EDGE_M.items():
        for fmt in INT8_EDGE_FORMATS:
            for n, kb in INT8_EDGE_NKB:
                planes, kw = _int8_case(fmt, n, kb, gen, dev)
                for m in ms:
                    worst = max(worst, _int8_edge(kernel, None, planes, kw, m,
                                                  gen, dev))
                    cases += 1
        for sub in INT8_EDGE_SUB:
            planes, kw = _int8_case("itq3_s_sub", 24, 6, gen, dev, sub)
            for m in (ms[0], ms[-1]):
                worst = max(worst, _int8_edge(kernel, None, planes, kw, m,
                                              gen, dev))
                cases += 1
        for fmt, sub in (("itq3_s", None), ("itq3_s_sub", None),
                         ("itq3_s_sub", 16)):
            planes, kw = _int8_case(fmt, 192, 6, gen, dev, sub)
            for cut in int8_cuts(kernel, 6):
                worst = max(worst, _int8_edge(kernel, cut, planes, kw, ms[-1],
                                              gen, dev))
                cases += 1
    report["int8_edges"] = dict(cases=cases, max_rel_err=worst)
    print(f"  int8 edges: {cases} cases (matvec M {INT8_EDGE_M['itq3_matvec_int8']}"
          f", matmul M {INT8_EDGE_M['itq3_matmul_int8']}; {INT8_EDGE_FORMATS}"
          f" x (N, KB) {INT8_EDGE_NKB}; sub_blocks {INT8_EDGE_SUB}; every "
          f"cut at KB 6): unit scales exact, bit-equal to the split model, "
          f"max rel error {worst:.2e} vs plain, two calls bit-equal",
          flush=True)


def int8_tile_sweep(gen: torch.Generator, dev, weights, report: dict,
                    timed: bool = True) -> None:
    """Both int8 kernels at phase 3's four main-path shapes (M = 4 for the
    matvec, 256 for the matmul) under every cut (the wrapper's rule
    replaced for the sweep only): each bit-equal to the split model at its
    cut; times printed and written to the details, not summed into the
    kernel lines."""
    from repro_torch.kernels import itq3 as itq3_mod

    out = {}
    for kernel, m, rule in (("itq3_matvec_int8", 4, "matvec_int8_tiles"),
                            ("itq3_matmul_int8", 256, "matmul_tiles")):
        out[kernel] = {}
        for name, qt in weights.items():
            if "itq3_x" in name:
                continue
            d, meta = qt.data, qt.meta
            n, kb = d["plane2"].shape[:2]
            planes = (d["plane2"], d["plane1"], d["scales"], d["zps"])
            kw = dict(fivelevel=meta.fivelevel, sub_blocks=meta.sub_blocks)
            xq, xs = act_encode(torch.randn(m, kb * 256, generator=gen,
                                            device=dev))
            pick = getattr(itq3_mod, rule)(m, n, kb)
            row = {}
            for cut in int8_cuts(kernel, kb):
                run = _with_cut(kernel, cut)
                got = run(xq, xs, planes, kw)[0]
                model = itq3_matmul_int8_split_ref(xq, xs, *planes,
                                                   splits=cut[1], **kw)
                if not torch.equal(got, model):
                    raise AssertionError(f"{kernel} {name} cut {cut}: not "
                                         f"the split model's bits")
                row[f"{cut[0]}x{cut[1]}"] = cut_ms(
                    lambda run=run: run(xq, xs, planes, kw), timed)
            out[kernel][name] = dict(pick=f"{pick[0]}x{pick[1]}", ms=row)
            print(f"  {kernel} cuts {name} M={m} N={n} KB={kb} "
                  f"({'rows' if 'matmul' in kernel else 'features'} x "
                  f"splits: ms; the rule picks {pick[0]}x{pick[1]}): "
                  + cuts_line(row),
                  flush=True)
    report["int8_tiles_ms"] = out


# rotation (8 butterfly stages + the normalization), the two statistics
# (sum; deviation, square, sum), and the codes (divide, round, add z, two
# clamps, +1): operations per element of quantize_blocks
QUANT_OPS_PER_ELEM = 19


def check_quantize(led: Ledger, gen: torch.Generator, dev,
                   report: dict) -> None:
    """quantize_blocks over every block of one stacked wq leaf (30 layers
    of 576 x 576: 30 x 576 x 3 blocks), held to the reference's own
    contract for its TPU kernel (tests/test_kernels.py): z equal, d within
    rtol 1e-3, codes equal on at least 0.999 of the elements."""
    k, n = SMOLLM_PROJ["wq"]
    w = torch.randn(30, k, n, generator=gen, device=dev) / math.sqrt(k)
    wb = to_blocks(w, 256).reshape(-1, 256).contiguous()
    (ck, dk, zk), (cp, dp, zp) = quantize_blocks(wb), quantize_blocks_ref(wb)
    agree = (ck == cp).float().mean().item()
    d_err = (dk.float() - dp.float()).abs()
    d_rel = (d_err / dp.float().abs().clamp_min(1e-30)).max().item()
    z_err = (zk.float() - zp.float()).abs().max().item()
    report["quantize_blocks_check"] = dict(
        blocks=wb.shape[0], codes_agree=agree, d_max_rel=d_rel,
        d_differ=int((dk != dp).sum().item()), z_max_abs=z_err)
    print(f"  quantize_blocks over {wb.shape[0]} blocks: codes agree on "
          f"{agree:.6f}, d max rel diff {d_rel:.2e} "
          f"({report['quantize_blocks_check']['d_differ']} differ), z max "
          f"abs diff {z_err}", flush=True)
    if not (agree >= 0.999 and z_err == 0):
        raise AssertionError(f"quantize_blocks: codes agree {agree}, z diff "
                             f"{z_err}")
    h = hadamard_matrix(256, device=dev)
    nb = wb.shape[0]
    led.add("quantize_blocks", f"wq x30 NB={nb}",
            err=max(d_err.max().item(), z_err), rel=d_rel,
            ms=device_ms(lambda: quantize_blocks(wb)),
            plain_ms=device_ms(lambda: quantize_blocks_ref(wb)),
            library_ms=device_ms(lambda: wb @ h),
            nbytes=nb * (256 * 4 + 256 + 2 + 2),
            flops=nb * 256 * QUANT_OPS_PER_ELEM, tol=1e-3)


# --- phases 4 and 5: serve the full-width model ----------------------------

def two_paths(params, cfg, tokens, caches, pos, last_idx, forced: bool,
              act_quant: bool = False, kv_quant: bool = True):
    """One prefill (or decode step) through the kernel path and the plain
    path, each on its own cache; returns both logits.

    ``forced=False`` runs the two forwards apart. The int8 KV codec then
    rounds a few codes to neighbouring values at ties (inputs differ by
    ~1e-6 relative), and each such code feeds every later layer, so this
    measures the codec's tie sensitivity as much as the kernels.
    ``forced=True`` runs them layer by layer: every layer of both paths
    takes the plain path's input, and after each layer the kernel path's
    cache rows are overwritten with the plain path's, so a tie stays in
    its layer. That is the kernels' end-to-end difference the tolerance
    holds."""
    from repro_torch.models import lm
    from repro_torch.models.layers import Runtime

    rts = [Runtime(kv_quant=kv_quant, backend=b,
                   decode_token_cache=not forced, act_quant=act_quant)
           for b in ("auto", "ref")]
    if not forced:
        step = lm.decode_step if tokens.shape[1] == 1 else None
        return [step(params, tokens, c, pos, rt, cfg)[0] if step else
                lm.forward(params, tokens, rt, cfg, cache=c, pos=pos,
                           last_idx=last_idx)[0]
                for rt, c in zip(rts, caches)]
    x = lm._embed(params, torch.as_tensor(tokens, device=caches[0]["attn"][
        "k"].device))
    for i in range(cfg.num_layers):
        lp = lm.layer_params(params["layers"], i)
        outs = [lm._dense_layer_apply(
            lp, x, rt, cfg, cache={k: v[i] for k, v in c["attn"].items()},
            pos=pos)[0] for rt, c in zip(rts, caches)]
        for k, v in caches[0]["attn"].items():
            v[i].copy_(caches[1]["attn"][k][i])
        x = outs[1]
    if last_idx is not None:
        rows = torch.arange(x.shape[0], device=x.device)
        outs = [h[rows, last_idx][:, None] for h in outs]
    return [lm._head(params, h, rt, cfg) for h, rt in zip(outs, rts)]


def make_prompts(cfg) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, size=int(p)).astype(np.int32)
            for p in rng.integers(8, 41, size=8)]


def serve_run(params, cfg, prompts, dev, *, count: bool,
              max_new: int = MAX_NEW, engine_kw=None, **rt_kw):
    """One serving run of ``prompts`` (8 requests, 4 slots, ``max_new`` new
    tokens each); with ``count`` the launch counters are reset just before
    it and read just after. ``engine_kw`` goes to the engine (the paged
    path's options)."""
    from repro_torch.models.layers import Runtime
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(params, cfg, slots=SLOTS, max_len=MAX_LEN,
                      prompt_pad=PROMPT_PAD,
                      rt=Runtime(**{"kv_quant": True, **rt_kw}), device=dev,
                      **(engine_kw or {}))
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if count:
        _build.reset_launches()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launches) if count else None
    return eng, reqs, wall, counts


def check_serving(label, eng, reqs, wall, counts, cfg, *, matvec, matmul,
                  attn="attn_q8", act_quant=False):
    """Hold a counted serving run to its contract: every request finishes
    with ``length``, no quarantine, and each kernel launched exactly as the
    path dictates, per layer: 7 projections through ``matvec`` per decode
    step and ``matmul`` per prefill wave; before each of them one
    ``fwht_act_encode`` on the W3A8 path (``act_quant``: rotate and encode
    in one launch), a 256-point FWHT before each prefill projection only
    on the float path (its matvec rotates x itself); one
    ``fwht_kv_encode`` (the layer's K and V), two head_dim FWHTs (the
    attention's query and output) and one ``attn`` per step and per wave;
    nothing else. Returns the run's numbers."""
    st = eng.stats()
    bad = [r.rid for r in reqs if r.finish_reason != "length"
           or len(r.out) != MAX_NEW]
    if bad:
        raise AssertionError(f"{label}: requests {bad} did not finish with "
                             f"length")
    if st["quarantined"]:
        raise AssertionError(f"{label}: non-finite logits quarantined a slot")
    layers = cfg.num_layers
    proj = layers * 7  # wq wk wv wo gate up down
    steps, waves = st["decode_steps"], st["prefill_waves"]
    hd = cfg.resolved_head_dim
    per_step, per_wave = collections.Counter(), collections.Counter()
    for per, contraction in ((per_step, matvec), (per_wave, matmul)):
        per[contraction] += proj
        per[f"fwht/{hd}"] += 2 * layers
        per[f"fwht_kv/{hd}"] += layers
        per[attn] += layers
        if act_quant:
            per["fwht_act/256"] += proj
    if not act_quant:
        per_wave["fwht/256"] += proj
    expected = {k: per_step[k] * steps + per_wave[k] * waves
                for k in per_step | per_wave}
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts} != expected "
                             f"{expected}")
    out = dict(
        wall_s=wall, launches=counts, stats=st,
        decode_tok_s=st["tokens_decoded"] / st["decode_seconds"],
        decode_ms_per_step=1e3 * st["decode_seconds"] / st["decode_steps"],
        prefill_ms_per_wave=1e3 * st["prefill_seconds"] / st["prefill_waves"],
        launches_per_decode_step=dict(per_step),
        launches_per_prefill_wave=dict(per_wave),
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    print(f"  served {len(reqs)} requests / {sum(len(r.out) for r in reqs)} "
          f"tokens in {wall:.2f} s: decode {out['decode_tok_s']:.1f} tok/s "
          f"({out['decode_ms_per_step']:.1f} ms/step over "
          f"{st['decode_steps']} steps), prefill "
          f"{out['prefill_ms_per_wave']:.1f} ms/wave over "
          f"{st['prefill_waves']} waves, {st['syncs_per_token']:.3f} host "
          f"syncs/token, peak memory {out['peak_mem_bytes'] / 2**20:.0f} MiB",
          flush=True)
    print(f"  launches while serving: {counts} (per decode step "
          f"{dict(per_step)}, per prefill wave {dict(per_wave)})", flush=True)
    return out


def parity_phase(params, cfg, prompts, dev, report: dict, key: str,
                 act_quant: bool = False) -> None:
    """Teacher-forced logits, kernel path against plain path, prefill then
    4 decode steps, run apart (reported) and layer-forced (held)."""
    from repro_torch.models import lm

    n = SLOTS
    toks = torch.as_tensor(np.stack([np.pad(p, (0, PROMPT_PAD - len(p)))
                                     for p in prompts[:n]]), device=dev)
    last = torch.as_tensor([len(p) - 1 for p in prompts[:n]], device=dev)
    for forced in (False, True):
        caches = [lm.init_cache(cfg, n, MAX_LEN, kv_quant=True, device=dev)
                  for _ in range(2)]
        logits = two_paths(params, cfg, toks, caches, 0, last, forced,
                           act_quant)
        errs = [rel_err(*logits)[1]]
        pos = last + 1
        for _ in range(4):
            nxt = logits[1][:, 0].argmax(-1)[:, None]
            logits = two_paths(params, cfg, nxt, caches, pos, None, forced,
                               act_quant)
            errs.append(rel_err(*logits)[1])
            pos = pos + 1
        code_diff = (caches[0]["attn"]["k"] != caches[1]["attn"]["k"]
                     ).float().mean().item()
        name = "layer_forced" if forced else "free_running"
        report[f"{key}_{name}"] = dict(logits_rel=errs, k_code_diff=code_diff)
        print(f"  {name}: logits rel error (max |diff| / max |logit|), "
              f"prefill then 4 decode steps: "
              f"{', '.join(f'{e:.2e}' for e in errs)}; K codes differing "
              f"after the run: {code_diff:.2e}", flush=True)
    if not max(errs) <= LOGITS_REL_TOL:
        raise AssertionError(f"{key}: layer-forced logits rel error "
                             f"{max(errs):.3e} > {LOGITS_REL_TOL}")


def agreement(reqs, other) -> tuple[int, int]:
    same = sum(a == b for r, p in zip(reqs, other)
               for a, b in zip(r.out, p.out))
    return same, sum(len(r.out) for r in reqs)


def prefix_agreement(reqs, short) -> tuple[int, int]:
    """(equal tokens, tokens of ``short``): a shorter run's streams against
    the first tokens of ``reqs``'."""
    same = sum(a == b for r, p in zip(reqs, short)
               for a, b in zip(r.out, p.out))
    return same, sum(len(p.out) for p in short)


def float_path_params(cfg, dev):
    """Phase 4's model: seeded random weights quantized by the port to
    itq3_s (deterministic, so phase 8 rebuilds the same planes)."""
    from repro_torch.models import lm
    from repro_torch.serve.quantized import quantize_params

    return quantize_params(lm.init_params(cfg, seed=0, device=dev), "itq3_s")


def serve_phase(dev, report: dict, cfg, profile: bool = False) -> dict:
    """Phases 4 and 5 (and 6 with ``profile``) on ``cfg``; returns the
    counted run's launches and its requests."""
    t0 = time.perf_counter()
    params = float_path_params(cfg, dev)
    torch.cuda.synchronize()
    report["quantize_s"] = time.perf_counter() - t0
    print(f"phase 4: {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}), seeded weights quantized "
          f"by the port to itq3_s in {report['quantize_s']:.1f} s", flush=True)
    prompts = make_prompts(cfg)

    def serve(backend, count, max_new=MAX_NEW):
        return serve_run(params, cfg, prompts, dev, count=count,
                         max_new=max_new, backend=backend)

    serve("auto", count=False)  # warm-up: first-use allocations
    eng, reqs, wall, counts = serve("auto", count=True)
    report["serve"] = check_serving("float path", eng, reqs, wall, counts,
                                    cfg, matvec="itq3_matvec",
                                    matmul="itq3_matmul")

    # phase 5: the same forward through the kernels and through the plain
    # versions, teacher-forced with the plain path's tokens
    print("phase 5: teacher-forced parity, kernels vs plain versions",
          flush=True)
    parity_phase(params, cfg, prompts, dev, report, "parity")
    # the free-running plain run is reported, not held: its first
    # AGREE_NEW tokens per request keep the script within its time
    _, plain_reqs, plain_wall, plain_counts = serve("ref", count=True,
                                                    max_new=AGREE_NEW)
    if plain_counts:
        raise AssertionError(f"the plain-version run launched {plain_counts}")
    same, total = prefix_agreement(reqs, plain_reqs)
    report["greedy_agreement"] = same / total
    report["plain_serve_wall_s"] = plain_wall
    print(f"  free-running greedy streams: {same}/{total} tokens agree with "
          f"the plain-version run ({plain_wall:.2f} s, no kernel launched)",
          flush=True)
    if profile:
        print("phase 6: the float path under torch.profiler", flush=True)
        profile_phase(lambda: serve("auto", count=False,
                                    max_new=PROFILE_NEW), report)
    return counts, reqs


def tree_bytes_equal(a, b) -> bool:
    """Every leaf of ``a`` equal to ``b``'s bit for bit (QTensor data and
    metas included)."""
    from repro_torch.core.quantize import QTensor

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_bytes_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, QTensor):
        return (isinstance(b, QTensor) and a.meta == b.meta
                and tree_bytes_equal(a.data, b.data))
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


def w3a8_phase(dev, report: dict, cfg, profile: bool = False):
    """Phase 7: quantize under the mixed policy, save (into ``CKPT_DIR``,
    which phase 9 boots from), restore with no template, serve on the W3A8
    path. Returns the launches of the counted quantize and serving runs,
    and the counted run's requests."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import mixed_precision_recipe
    from repro_torch.models import lm
    from repro_torch.serve.quantized import (
        QuantPolicy, describe_quantized, quantize_params, quantized_bytes,
    )

    policy = QuantPolicy.from_dict(mixed_precision_recipe(cfg))
    fp = lm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    params = quantize_params(fp, policy)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    quant_counts = dict(_build.launches)
    fmts = describe_quantized(params)
    n_itq3 = sum(f == "itq3_s" for f in fmts.values())
    print(f"phase 7: {cfg.name} quantized under the mixed policy in "
          f"{quant_s:.2f} s: {sorted(set(fmts.values()))}; launches "
          f"{quant_counts}", flush=True)
    if fmts.get("embed") != "q8_0" or quant_counts != {
            "quantize_blocks": n_itq3} or n_itq3 != 4:
        raise AssertionError(f"mixed policy: formats {fmts}, launches "
                             f"{quant_counts}")
    del fp
    # kept for phase 9, which boots from it; main() removes it
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    path = Path(ckpt.save(str(CKPT_DIR), 0, params))
    save_s = time.perf_counter() - t0
    ckpt_bytes = sum(f.stat().st_size for f in path.iterdir())
    t0 = time.perf_counter()
    restored, step = ckpt.restore_params(str(CKPT_DIR), device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if step != 0 or not tree_bytes_equal(params, restored):
        raise AssertionError("restored checkpoint differs from the saved tree")
    print(f"  saved {ckpt_bytes} bytes in {save_s:.2f} s, restored with no "
          f"template in {restore_s:.2f} s: every plane, scale and meta equal "
          f"({quantized_bytes(restored)} bytes resident)", flush=True)
    del params
    prompts = make_prompts(cfg)

    def serve(count, **kw):
        return serve_run(restored, cfg, prompts, dev, count=count, **kw)

    serve(False, act_quant=True)  # warm-up
    eng, reqs, wall, counts = serve(True, act_quant=True)
    out = check_serving("W3A8 path", eng, reqs, wall, counts, cfg,
                        matvec="itq3_matvec_int8", matmul="itq3_matmul_int8",
                        act_quant=True)
    if not eng.stats()["act_quant"]:
        raise AssertionError("the engine did not report act_quant")
    out.update(quantize_s=quant_s, quantize_launches=quant_counts,
               formats=fmts, checkpoint_bytes=ckpt_bytes, save_s=save_s,
               restore_s=restore_s)
    parity_phase(restored, cfg, prompts, dev, report, "w3a8_parity",
                 act_quant=True)
    _, plain_reqs, plain_wall, _ = serve(False, act_quant=True, backend="ref",
                                         max_new=AGREE_NEW)
    _, float_reqs, float_wall, _ = serve(False, act_quant=False,
                                         max_new=AGREE_NEW)
    out["greedy_agreement_plain"] = prefix_agreement(reqs, plain_reqs)
    out["greedy_agreement_float"] = prefix_agreement(reqs, float_reqs)
    out["plain_serve_wall_s"], out["float_serve_wall_s"] = plain_wall, \
        float_wall
    print(f"  greedy streams: {'/'.join(map(str, out['greedy_agreement_plain']))}"
          f" tokens agree with the plain-version W3A8 run ({plain_wall:.2f} "
          f"s), {'/'.join(map(str, out['greedy_agreement_float']))} with the "
          f"float (act_quant=False) run of the same checkpoint "
          f"({float_wall:.2f} s); checkpoint {ckpt_bytes / 1e6:.1f} MB",
          flush=True)
    report["w3a8"] = out
    if profile:
        profile_phase(lambda: serve(False, act_quant=True,
                                    max_new=PROFILE_NEW), report,
                      "w3a8_profile", TABLE.with_name(
                          "chip_smoke_profile_w3a8.txt"))
    return {**counts, **quant_counts}, reqs


def shared_prefix_prompts(cfg) -> list:
    """Phase 8 (b)'s requests: one 32-token prefix (two full blocks) and
    8-24 private tokens each."""
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, size=SHARED_PREFIX)
    return [np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                 size=int(n))]).astype(np.int32)
            for n in rng.integers(8, 25, size=8)]


def paged_phase(dev, report: dict, cfg, dense_reqs,
                profile: bool = False) -> dict:
    """Phase 8: the paged path on phase 4's model, rebuilt from its seed
    (phase 7's peak memory does not carry it); with ``profile`` also one
    short traced run on the full pool. Returns the counted run's
    launches."""
    params = float_path_params(cfg, dev)
    paged_kw = dict(paged=True, block_size=BLOCK_SIZE)
    prompts = make_prompts(cfg)
    serve_run(params, cfg, prompts, dev, count=False, engine_kw=paged_kw)
    eng, reqs, wall, counts = serve_run(params, cfg, prompts, dev, count=True,
                                        engine_kw=paged_kw)
    st = eng.stats()
    print(f"phase 8 (a): paged, dense-equivalent pool of {st['pool_blocks']} "
          f"blocks x {BLOCK_SIZE} tokens", flush=True)
    out = {"full_pool": check_serving(
        "paged path", eng, reqs, wall, counts, cfg, matvec="itq3_matvec",
        matmul="itq3_matmul", attn="attn_q8_paged")}
    same, total = agreement(reqs, dense_reqs)
    out["full_pool"].update(agreement_with_phase4=(same, total),
                            pool_bytes=eng.cache_bytes)
    print(f"  greedy streams: {same}/{total} tokens equal to phase 4's "
          f"counted run; pool {eng.cache_bytes} B", flush=True)
    if same != total:
        raise AssertionError("paged streams differ from the dense path's")
    if st["pool_blocks_used"] != 0:
        raise AssertionError("blocks still held after the run")
    # the paged step against the dense one in turns (dense, paged, paged,
    # dense), so the host's drift during the call shows in each pair
    turns: dict = {"dense": [], "paged": []}
    for label in ("dense", "paged", "paged", "dense"):
        e, _, _, _ = serve_run(params, cfg, prompts, dev, count=False,
                               engine_kw=paged_kw if label == "paged" else None)
        es = e.stats()
        turns[label].append((1e3 * es["decode_seconds"] / es["decode_steps"],
                             1e3 * es["prefill_seconds"] / es["prefill_waves"]))
    out["full_pool"]["turns_ms_step_wave"] = turns
    print("  in turns (dense, paged, paged, dense): "
          + "; ".join(f"{what} dense {turns['dense'][0][i]:.1f} / "
                      f"{turns['dense'][1][i]:.1f}, paged "
                      f"{turns['paged'][0][i]:.1f} / {turns['paged'][1][i]:.1f}"
                      for i, what in enumerate(("ms/step", "ms/wave"))),
          flush=True)

    del e, eng  # their caches would count in (b)'s peak memory
    prompts = shared_prefix_prompts(cfg)
    eng, reqs, wall, _ = serve_run(
        params, cfg, prompts, dev, count=False,
        engine_kw=dict(paged_kw, num_blocks=SHORT_POOL))
    st, peak = eng.stats(), torch.cuda.max_memory_allocated()
    deng, dreqs, _, _ = serve_run(params, cfg, prompts, dev, count=False)
    same, total = agreement(reqs, dreqs)
    dense_bytes = deng.cache_bytes
    short = dict(
        wall_s=wall, stats=st, peak_mem_bytes=peak,
        decode_tok_s=st["tokens_decoded"] / st["decode_seconds"],
        decode_ms_per_step=1e3 * st["decode_seconds"] / st["decode_steps"],
        prefill_ms_per_wave=1e3 * st["prefill_seconds"] / st["prefill_waves"],
        pool_bytes=st["cache_bytes"], dense_cache_bytes=int(dense_bytes),
        agreement_with_dense=(same, total),
        differing_rids=[r.rid for r, d in zip(reqs, dreqs) if r.out != d.out])
    out["short_pool"] = short
    print(f"phase 8 (b): {len(reqs)} requests over a shared "
          f"{SHARED_PREFIX}-token prefix on a {SHORT_POOL}-block pool: "
          f"{st['preemptions']} preemptions, {st['resumes']} resumes, "
          f"{st['blocks_swapped']} blocks swapped, {st['prefix_hits']} prefix "
          f"hits, {st['max_concurrent']} live at most; decode "
          f"{short['decode_tok_s']:.1f} tok/s ({short['decode_ms_per_step']:.1f}"
          f" ms/step over {st['decode_steps']} steps), prefill "
          f"{short['prefill_ms_per_wave']:.1f} ms/wave over "
          f"{st['prefill_waves']} waves; pool {st['cache_bytes']} B against "
          f"the dense cache's {int(dense_bytes)} B; peak memory "
          f"{short['peak_mem_bytes'] / 2**20:.0f} MiB; {same}/{total} tokens "
          f"equal to a dense run (differing rids {short['differing_rids']})",
          flush=True)
    bad = [r.rid for r in reqs if r.finish_reason != "length"
           or len(r.out) != MAX_NEW]
    eng.pool.check(eng._table)
    if (bad or st["preemptions"] < 1 or st["resumes"] < 1
            or st["prefix_hits"] < 6 or st["pool_blocks_used"] != 0
            or st["quarantined"]):
        raise AssertionError(f"short pool: requests {bad} did not finish "
                             f"with length, or stats {st}")
    report["paged"] = out
    if profile:
        profile_phase(lambda: serve_run(params, cfg, make_prompts(cfg), dev,
                                        count=False, max_new=PROFILE_NEW,
                                        engine_kw=paged_kw),
                      report, "paged_profile",
                      TABLE.with_name("chip_smoke_profile_paged.txt"))
    return counts


# --- phase 9: sampled serving from a checkpoint; resilience ----------------

# Phase 9 (a)'s requests: phase 7's prompts and rids, each (temperature,
# top_k, top_p, seed): two greedy, two at 0.8, two with top-k 40 at 0.8,
# two with top-p 0.9 at 1.0; one explicit seed, the rest derived from the
# engine seed and the rid. Each wave of 4 slots holds one of each kind.
SAMPLED_MIX = [(0.0, 0, 1.0, None), (0.8, 0, 1.0, None), (0.8, 40, 1.0, None),
               (1.0, 0, 0.9, None), (0.0, 0, 1.0, None), (0.8, 0, 1.0, 1234),
               (0.8, 40, 1.0, None), (1.0, 0, 0.9, None)]
ENGINE_SEED = 7
# The sampler on the card against the CPU's: draws of (4, V) logits, each
# row under its own key and knobs. The threefry bits are integers and must
# be equal; the tokens may differ only where the card's and the CPU's f32
# log differ in the last bit and move the argmax of gumbel + logits, which
# needs the two best perturbed logits within ~1e-6 of each other.
SAMPLER_DRAWS, SAMPLER_MIN_EQUAL = 1000, 999
SAMPLER_ROWS = [(0.8, 0, 1.0), (0.8, 40, 1.0), (1.0, 0, 0.9), (1.3, 0, 1.0)]
# Phase 9 (b): the launcher's --chaos plan on the float path, one wave of
# 4 requests, then a burst of 4 more over a queue bounded at 6.
CHAOS_DEADLINE_MS, CHAOS_WATCHDOG_S, CHAOS_MAX_QUEUE, CHAOS_BURST = \
    400.0, 0.5, 6, 4


def sampled_requests(prompts, greedy_only: bool = False) -> list:
    from repro_torch.serve.engine import Request
    from repro_torch.serve.sampling import SamplingParams

    out = []
    for i, (p, (t, k, tp, seed)) in enumerate(zip(prompts, SAMPLED_MIX)):
        sp = (SamplingParams(ignore_eos=True) if greedy_only else
              SamplingParams(temperature=t, top_k=k, top_p=tp, seed=seed,
                             ignore_eos=True))
        out.append(Request(rid=i, prompt=p, max_new=MAX_NEW, sampling=sp))
    return out


def boot_run(cfg, dev, prompts, *, count: bool, greedy_only: bool = False):
    """One serving run of the W3A8 path booted from phase 7's checkpoint
    with ``ServeEngine.from_checkpoint``; with ``count`` the launch counters
    are reset just before the run and read just after."""
    from repro_torch.models.layers import Runtime
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine.from_checkpoint(
        str(CKPT_DIR), cfg, slots=SLOTS, max_len=MAX_LEN,
        prompt_pad=PROMPT_PAD, seed=ENGINE_SEED, device=dev,
        rt=Runtime(kv_quant=True, act_quant=True))
    reqs = sampled_requests(prompts, greedy_only)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if count:
        _build.reset_launches()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, reqs, wall, dict(_build.launches) if count else None


class AtenCount(TorchDispatchMode):
    """Counts the aten operators dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def busy_ms(fn, reps: int = 10) -> float:
    """The device's busy time per call of ``fn``: the self device time of
    every kernel ``reps`` calls ran, under ``torch.profiler``, over
    ``reps``. Unlike ``device_ms`` it does not need the host to queue the
    calls faster than the card runs them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def sampler_cost(eng, dev) -> dict:
    """The sampler at a decode step's shape (4 slots, the full vocabulary),
    with the knobs of SAMPLED_MIX's first wave, against the greedy argmax:
    the device's busy ms per draw (step keys and vectors already on the
    card), ``device_ms`` of one draw queued behind a spinning kernel
    (~240 launches at the host's rate: the draw's wall on an idle card),
    and for the engine's whole token selection (step keys folded on the
    host and sent up with the vectors, the draw, the tokens' transfer) the
    aten calls it issues and its host wall, ending in that transfer."""
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    last = torch.randn(SLOTS, eng.cfg.vocab_size, generator=g, device=dev)
    mix = SAMPLED_MIX[:SLOTS]
    keys = np.stack([np.array([0, 1000 + i], np.uint32) for i in range(SLOTS)])
    knobs = (keys, np.arange(SLOTS) + 5,
             np.array([m[0] for m in mix], np.float32),
             *eng._filter_vectors([m[1] for m in mix], [m[2] for m in mix]))
    args = eng._sampling_args(*knobs)
    out = {}
    for name, draw, whole in (
            ("greedy", lambda: eng._sample(last, ()), None),
            ("sampled", lambda: eng._sample(last, args),
             lambda: eng._sample(last, eng._sampling_args(*knobs)))):
        whole = whole or draw
        with AtenCount() as c:
            whole()
        out[f"{name}_aten_calls"] = c.n
        out[f"{name}_busy_ms"] = busy_ms(draw)
        out[f"{name}_ms"] = device_ms(draw, reps=1)
        walls = []
        for _ in range(TIMED_RUNS):
            t0 = time.perf_counter()
            whole().cpu()
            walls.append(1e3 * (time.perf_counter() - t0))
        out[f"{name}_host_ms"] = statistics.median(walls)
    out["aten_calls_added"] = out["sampled_aten_calls"] - \
        out["greedy_aten_calls"]
    return out


def check_sampler_on_card(dev, vocab: int) -> dict:
    """SAMPLER_DRAWS seeded draws of (4, ``vocab``) logits: the card's
    threefry bits equal to the CPU's, the tokens of ``lm.sample_tokens``
    on the card equal to the CPU's on at least SAMPLER_MIN_EQUAL draws,
    each difference printed with its margin (the gap between the CPU's two
    best perturbed logits)."""
    from repro_torch.core import prng
    from repro_torch.models import lm

    rng = np.random.default_rng(21)
    rows = len(SAMPLER_ROWS)
    temp = torch.tensor([r[0] for r in SAMPLER_ROWS])
    top_k = torch.tensor([r[1] for r in SAMPLER_ROWS])
    top_p = torch.tensor([r[2] for r in SAMPLER_ROWS])
    vecs = [(v, v.to(dev)) for v in (temp, top_k, top_p)]
    bits_equal, equal, diffs = True, 0, []
    for d in range(SAMPLER_DRAWS // rows):
        logits = torch.from_numpy(
            (rng.standard_normal((rows, vocab)) * 3).astype(np.float32))
        keys = torch.from_numpy(rng.integers(0, 2**32, (rows, 2),
                                             dtype=np.uint64).astype(np.int64))
        if d < 8:  # the integer stage on its own, exactly
            bits_equal &= torch.equal(
                prng.random_bits(keys.to(dev), (vocab,)).cpu(),
                prng.random_bits(keys, (vocab,)))
        (t, tc), (k, kc), (p, pc) = vecs
        cpu = lm.sample_tokens(logits, keys, t, top_k=k, top_p=p)
        card = lm.sample_tokens(logits.to(dev), keys.to(dev), tc, top_k=kc,
                                top_p=pc).cpu()
        equal += int((cpu == card).sum())
        for r in torch.nonzero(cpu != card).flatten().tolist():
            scaled = lm.top_mask(logits[r:r + 1] / t[r], k[r:r + 1],
                                 p[r:r + 1])
            pert = (prng.gumbel(keys[r], (vocab,)) + scaled[0]).sort(
                descending=True).values
            diffs.append(dict(draw=d, row=r, cpu=int(cpu[r]),
                              card=int(card[r]),
                              margin=float(pert[0] - pert[1])))
    total = rows * (SAMPLER_DRAWS // rows)
    print(f"  sampler on the card: threefry bits {'equal' if bits_equal else 'DIFFER'}"
          f" to the CPU's; tokens equal on {equal}/{total} draws of "
          f"({rows}, {vocab}) logits"
          + "".join(f"; draw {x['draw']} row {x['row']}: cpu {x['cpu']} card "
                    f"{x['card']}, margin {x['margin']:.3e}" for x in diffs),
          flush=True)
    if not bits_equal or equal < SAMPLER_MIN_EQUAL * total // SAMPLER_DRAWS:
        raise AssertionError(f"sampler: bits equal {bits_equal}, tokens "
                             f"equal {equal}/{total}")
    return dict(bits_equal=bits_equal, tokens_equal=equal, draws=total,
                differences=diffs)


def sampled_phase(dev, report: dict, cfg, w3a8_reqs) -> None:
    """Phase 9 (a): sampled serving booted from phase 7's checkpoint."""
    prompts = make_prompts(cfg)
    first = boot_run(cfg, dev, prompts, count=False)
    eng, reqs, wall, counts = boot_run(cfg, dev, prompts, count=True)
    print(f"phase 9 (a): booted from phase 7's checkpoint with "
          f"ServeEngine.from_checkpoint; {len(reqs)} requests: "
          f"{sum(m[0] <= 0 for m in SAMPLED_MIX)} greedy, the rest sampled "
          f"(temperature, top-k, top-p; one explicit seed)", flush=True)
    out = check_serving("sampled W3A8 path", eng, reqs, wall, counts, cfg,
                        matvec="itq3_matvec_int8", matmul="itq3_matmul_int8",
                        act_quant=True)
    st = eng.stats()
    if st["host_syncs"] != st["decode_steps"] + st["prefill_waves"]:
        raise AssertionError(f"host syncs {st['host_syncs']} != steps + "
                             f"waves")
    greedy = [r.rid for r in reqs if SAMPLED_MIX[r.rid][0] <= 0]
    phase7 = {r.rid: r.out for r in w3a8_reqs}
    same_greedy = all(reqs[i].out == phase7[i] for i in greedy)
    repeat = all(a.out == b.out for a, b in zip(first[1], reqs))
    sampled_differs = sum(r.out != phase7[r.rid] for r in reqs
                          if r.rid not in greedy)
    print(f"  greedy rows {greedy} {'equal' if same_greedy else 'DIFFER from'}"
          f" phase 7's counted run; a second run gives "
          f"{'identical' if repeat else 'DIFFERENT'} streams for every "
          f"request; {sampled_differs}/{len(reqs) - len(greedy)} sampled "
          f"streams differ from their greedy ones", flush=True)
    if not (same_greedy and repeat):
        raise AssertionError("sampled serving: greedy rows differ from "
                             "phase 7's, or two runs differ")
    out.update(greedy_equal_phase7=same_greedy, repeat_identical=repeat,
               streams={r.rid: r.out for r in reqs})
    out["sampler_vs_cpu"] = check_sampler_on_card(dev, cfg.vocab_size)
    cost = sampler_cost(eng, dev)
    out["sampler_cost"] = cost
    del first, eng
    # ms/step of an all-greedy and of the sampled request set in turns
    turns: dict = {"greedy": [], "sampled": []}
    for label in ("greedy", "sampled", "sampled", "greedy"):
        e, _, _, _ = boot_run(cfg, dev, prompts, count=False,
                              greedy_only=label == "greedy")
        es = e.stats()
        turns[label].append(1e3 * es["decode_seconds"] / es["decode_steps"])
    out["turns_ms_per_step"] = turns
    print(f"  in turns (greedy, sampled, sampled, greedy): ms/step greedy "
          f"{turns['greedy'][0]:.1f} / {turns['greedy'][1]:.1f}, sampled "
          f"{turns['sampled'][0]:.1f} / {turns['sampled'][1]:.1f}; the "
          f"sampler at (4, {cfg.vocab_size}): device busy "
          f"{cost['sampled_busy_ms']:.4f} ms against the argmax's "
          f"{cost['greedy_busy_ms']:.4f} ms, one draw on an idle card "
          f"{cost['sampled_ms']:.4f} ms against {cost['greedy_ms']:.4f} ms, "
          f"host wall of the step's token selection (fold, upload, draw, "
          f"transfer) {cost['sampled_host_ms']:.3f} ms against "
          f"{cost['greedy_host_ms']:.3f} ms, "
          f"{cost['sampled_aten_calls']} aten calls against "
          f"{cost['greedy_aten_calls']} (+{cost['aten_calls_added']} per "
          f"step)", flush=True)
    report["sampled"] = out


def chaos_run(params, cfg, dev, prompts, *, faults: bool):
    """Phase 9 (b)'s run: 4 requests in one wave on the float path, then a
    burst over the bounded queue; with ``faults`` under the launcher's
    --chaos plan (a K scale poisoned at step 3, the clock skipped and a
    step stalled at step 6), a deadline on every request and the
    watchdog. Returns (engine, requests, events, plan)."""
    from repro_torch.models.layers import Runtime
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.faults import Fault, FaultPlan, burst

    plan = FaultPlan([Fault("kv_nan", step=3, slot=0, plane="k_scale"),
                      Fault("clock_skip", step=6, dt=1.0),
                      Fault("stall", step=6, dt=2.0)]) if faults else None
    eng = ServeEngine(params, cfg, slots=SLOTS, max_len=MAX_LEN,
                      prompt_pad=PROMPT_PAD, rt=Runtime(kv_quant=True),
                      device=dev, max_queue=CHAOS_MAX_QUEUE, faults=plan,
                      watchdog_timeout_s=CHAOS_WATCHDOG_S if faults else None)
    deadline = CHAOS_DEADLINE_MS if faults else None
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW, deadline_ms=deadline)
            for i, p in enumerate(prompts[:SLOTS])]
    reqs += burst(CHAOS_BURST, cfg.vocab_size, seed=3, plen=16,
                  max_new=MAX_NEW, rid0=SLOTS, deadline_ms=deadline)
    for r in reqs:
        eng.submit_request(r)
    events = list(eng.generate())
    torch.cuda.synchronize()
    return eng, reqs, events, plan


def chaos_phase(dev, report: dict, cfg) -> None:
    """Phase 9 (b): the resilience layer on the float path."""
    from repro_torch.serve.sampling import FINISH_REASONS

    params = float_path_params(cfg, dev)
    prompts = make_prompts(cfg)
    runs = [chaos_run(params, cfg, dev, prompts, faults=True)
            for _ in range(2)]
    _, clean, _, _ = chaos_run(params, cfg, dev, prompts, faults=False)
    eng, reqs, events, plan = runs[0]
    st = eng.stats()
    reasons = collections.Counter(r.finish_reason for r in reqs)
    counters = ("quarantined", "deadline_expired", "requests_rejected",
                "requests_shed", "stalled_steps", "decode_steps",
                "tokens_decoded", "host_syncs", "waiting", "swapped")
    same_counters = all(runs[1][0].stats()[k] == st[k] for k in counters)
    # the first wave's other slots: the same wave, so the same numerics
    healthy = [r.rid for r in reqs[:SLOTS] if r.finish_reason != "error"]
    prefix = all(r.out == c.out[:len(r.out)] for r, c in zip(reqs, clean)
                 if r.rid in healthy)
    terminal = [e for e in events if e.finished]
    print(f"phase 9 (b): float path under the --chaos plan, {len(reqs)} "
          f"requests ({SLOTS} in one wave, a burst of {CHAOS_BURST} over a "
          f"queue of {CHAOS_MAX_QUEUE}): finish reasons {dict(reasons)}; "
          f"fault log {plan.log}; "
          + ", ".join(f"{k} {st[k]}" for k in counters[:5])
          + f"; healthy slots {healthy}: streams {'are' if prefix else 'are NOT'}"
          f" prefixes of a fault-free run's; two runs' counters "
          f"{'equal' if same_counters else 'DIFFER'}", flush=True)
    if (set(reasons) - FINISH_REASONS or len(terminal) != len(reqs)
            or st["quarantined"] != 1 or not prefix or not same_counters
            or st["stalled_steps"] < 1 or st["requests_rejected"] < 1
            or len(plan.log) != 3 or any(r is not None for r in eng.active)):
        raise AssertionError(f"chaos: reasons {dict(reasons)}, stats {st}")
    report["chaos"] = dict(finish_reasons=dict(reasons), fault_log=plan.log,
                           stats=st, healthy_prefix_of_clean=prefix,
                           counters_repeat=same_counters)


# --- phase 10: speculative decoding ------------------------------------------

# Phase 10 (b)'s self-draft depth; (d)'s windows: SPEC_WINDOWS seeded
# (4, K+1, vocab) windows of mixed knobs (two greedy rows among sampled
# ones), each slot's (out, n) from the card against the CPU's. Only a
# last-bit difference of the residual draw's f32 log, or of a softmax sum
# at an acceptance boundary, may move one.
SPEC_SMALL_DRAFT = 4
SPEC_WINDOWS, SPEC_MIN_EQUAL = 1000, 999
SPEC_ROWS = [(0.8, 0, 1.0), (0.0, 0, 1.0), (1.0, 40, 0.9), (1.3, 0, 0.95)]


def spec_kw(params, cfg, depth: int, **kw) -> dict:
    """Engine arguments of a ``depth``-layer self-draft with K = SPEC_K."""
    from repro_torch.serve import spec

    dparams, dcfg = spec.draft_from_params(params, cfg, depth)
    return dict(draft_params=dparams, draft_cfg=dcfg,
                num_draft_tokens=SPEC_K, **kw)


def check_spec_serving(label, eng, reqs, wall, counts, cfg, depth: int, *,
                       attn="attn_q8") -> dict:
    """Hold a counted speculative run to its contract: every request
    finishes with ``length``, no quarantine, one host sync per window and
    per wave, and each kernel launched exactly as the window dictates. Per
    window: the draft's K decode steps and its ``advance_cache`` (K+1
    token passes of ``depth`` layers: per layer 7 fused matvecs, the
    query and output FWHTs, one ``fwht_kv_encode``, one dense
    ``attn_q8``), then the target's verify pass over 4 x (K+1) rows
    (per layer 7 matmuls after 7 256-point FWHTs, the two head_dim FWHTs,
    one ``fwht_kv_encode``, one ``attn``). Per wave: the target's prefill
    and the draft's, prefill-shaped. Returns the run's numbers."""
    st = eng.stats()
    bad = [r.rid for r in reqs if r.finish_reason != "length"
           or len(r.out) != MAX_NEW]
    if bad or st["quarantined"]:
        raise AssertionError(f"{label}: requests {bad} did not finish with "
                             f"length, or a slot was quarantined")
    hd = cfg.resolved_head_dim

    def token_pass(per, layers, contraction, attention, rotate256):
        per[contraction] += 7 * layers
        per[f"fwht/{hd}"] += 2 * layers
        per[f"fwht_kv/{hd}"] += layers
        per[attention] += layers
        if rotate256:
            per["fwht/256"] += 7 * layers

    per_window, per_wave = collections.Counter(), collections.Counter()
    for _ in range(SPEC_K + 1):
        token_pass(per_window, depth, "itq3_matvec", "attn_q8", False)
    token_pass(per_window, cfg.num_layers, "itq3_matmul", attn, True)
    token_pass(per_wave, cfg.num_layers, "itq3_matmul", attn, True)
    token_pass(per_wave, depth, "itq3_matmul", "attn_q8", True)
    windows, waves = st["spec_steps"], st["prefill_waves"]
    expected = {k: per_window[k] * windows + per_wave[k] * waves
                for k in per_window | per_wave}
    if counts is not None and counts != expected:
        raise AssertionError(f"{label}: launches {counts} != expected "
                             f"{expected}")
    if st["host_syncs"] != windows + waves or windows != st["decode_steps"]:
        raise AssertionError(f"{label}: host syncs {st['host_syncs']} != "
                             f"windows {windows} + waves {waves}")
    committed = sum(r.accepted + r.spec_windows for r in reqs)
    if not (st["tokens_decoded"] <= committed
            and st["draft_accepted"] == sum(r.accepted for r in reqs)
            and st["draft_proposed"] == sum(r.drafted for r in reqs)):
        raise AssertionError(f"{label}: window counters disagree: {st}")
    out = dict(
        wall_s=wall, launches=counts, stats=st,
        windows=windows, waves=waves,
        acceptance_rate=st["acceptance_rate"],
        tokens_per_window=st["tokens_decoded"] / windows,
        ms_per_window=1e3 * st["decode_seconds"] / windows,
        ms_per_token=1e3 * st["decode_seconds"] / st["tokens_decoded"],
        launches_per_window=dict(per_window),
        launches_per_wave=dict(per_wave),
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    print(f"  {label}: {windows} windows, {waves} waves, acceptance "
          f"{st['draft_accepted']}/{st['draft_proposed']} = "
          f"{st['acceptance_rate']:.4f}, {out['tokens_per_window']:.3f} tokens"
          f" per window over 4 slots, {out['ms_per_window']:.1f} ms/window, "
          f"{out['ms_per_token']:.2f} ms per committed token, "
          f"{st['host_syncs']} host syncs, peak memory "
          f"{out['peak_mem_bytes'] / 2**20:.0f} MiB", flush=True)
    if counts is not None:
        print(f"  launches per window {dict(per_window)}, per wave "
              f"{dict(per_wave)}: exact", flush=True)
    return out


def check_perfect_acceptance(run: dict, reqs, parted: list) -> None:
    """The perfect draft is the target, so every proposal is accepted and
    each wave takes ceil((MAX_NEW - 1) / (K + 1)) windows (the prefill
    emits the first token). A request may fall short only where a printed
    parting (a top-2 tie within ``LOGITS_REL_TOL``, already held) explains
    it: the draft's decode kernels and the verify kernels then chose
    different tokens."""
    st = run["stats"]
    want = run["waves"] * -(-(MAX_NEW - 1) // (SPEC_K + 1))
    short = {r.rid: (r.accepted, r.drafted) for r in reqs
             if r.accepted != r.drafted}
    unexplained = sorted(set(short) - {p["rid"] for p in parted})
    print(f"  perfect draft: {st['draft_accepted']}/{st['draft_proposed']} "
          f"accepted, {run['windows']} windows (want {want})"
          + (f"; short of full acceptance {short}" if short else ""),
          flush=True)
    if unexplained or (not short and run["windows"] != want):
        raise AssertionError(f"perfect draft: requests {unexplained} rejected"
                             f" a proposal with no tie to explain it, or "
                             f"{run['windows']} windows != {want}")


def decode_margin(params, cfg, prompt, stream, j: int, dev) -> float:
    """The non-speculative path's top-2 logit margin at stream position
    ``j``, over the largest logit: the prompt prefilled and the stream's
    first ``j`` tokens decoded through the kernels, one step at a time."""
    from repro_torch.models import lm
    from repro_torch.models.layers import Runtime

    rt = Runtime(kv_quant=True)
    cache = lm.init_cache(cfg, 1, MAX_LEN, kv_quant=True, device=dev)
    logits, cache = lm.forward(params, prompt[None], rt, cfg, cache=cache,
                               pos=0, last_only=True)
    for i in range(j):
        logits, cache = lm.decode_step(params, [[stream[i]]], cache,
                                       torch.tensor([len(prompt) + i],
                                                    device=dev), rt, cfg)
    row = logits[0, 0].float()
    top = row.topk(2).values
    return float((top[0] - top[1]) / row.abs().max())


def partings(params, cfg, reqs, other, dev) -> list:
    """Each request whose stream parts from ``other``'s: the first
    differing position and the non-speculative path's top-2 margin there
    (relative to the largest logit)."""
    out = []
    for r, o in zip(reqs, other):
        j = next((i for i, (a, b) in enumerate(zip(r.out, o.out)) if a != b),
                 None)
        if j is not None:
            out.append(dict(rid=r.rid, position=j, spec=r.out[j],
                            non_spec=o.out[j], margin=decode_margin(
                                params, cfg, r.prompt, o.out, j, dev)))
    return out


def check_verify_on_card(dev, vocab: int) -> dict:
    """SPEC_WINDOWS / 4 seeded batches of 4 windows at (4, K+1, ``vocab``):
    the acceptance uniforms drawn on the card bit-equal to the CPU's, and
    ``verify_commit`` on the card (the port's kernel-free ops on CUDA
    tensors) against the CPU on every window's committed tokens and
    count."""
    from repro_torch.core import prng
    from repro_torch.models import lm
    from repro_torch.serve import spec

    rng = np.random.default_rng(31)
    rows, k1 = len(SPEC_ROWS), SPEC_K + 1
    temp = torch.tensor([r[0] for r in SPEC_ROWS])
    top_k = torch.tensor([r[1] for r in SPEC_ROWS])
    top_p = torch.tensor([r[2] for r in SPEC_ROWS])
    uni_equal, equal, diffs = True, 0, []
    for d in range(SPEC_WINDOWS // rows):
        logits = torch.from_numpy(
            (rng.standard_normal((rows, k1, vocab)) * 3).astype(np.float32))
        draft = logits[:, :SPEC_K] + torch.from_numpy(
            rng.standard_normal((rows, SPEC_K, vocab)).astype(np.float32))
        qlog = lm.top_mask(
            (draft / temp.clamp_min(1e-6)[:, None, None]).reshape(-1, vocab),
            top_k.repeat_interleave(SPEC_K),
            top_p.repeat_interleave(SPEC_K)).reshape(rows, SPEC_K, vocab)
        q = torch.softmax(qlog, dim=-1).double().numpy()
        cand = np.zeros((rows, k1), np.int32)
        cand[:, 0] = rng.integers(0, vocab, rows)
        for s in range(rows):
            for w in range(SPEC_K):
                cand[s, w + 1] = (int(logits[s, w].argmax()) if temp[s] <= 0
                                  and rng.random() < 0.7 else
                                  rng.choice(vocab, p=q[s, w] / q[s, w].sum()))
        kvec = torch.from_numpy(rng.integers(0, SPEC_K + 1, rows,
                                             dtype=np.int64).astype(np.int32))
        keys = rng.integers(0, 2**32, (rows, 2), dtype=np.uint64
                            ).astype(np.int64)
        gen = rng.integers(0, 200, rows)
        if d < 8:  # the uniforms drawn on the card, exactly
            tagged = prng.fold_in(torch.as_tensor(keys, device=dev),
                                  spec.ACCEPT_TAG)
            idx = torch.as_tensor(gen, device=dev)[:, None] + torch.arange(
                SPEC_K, device=dev)
            card_u = prng.uniform(prng.fold_in(tagged[:, None], idx), ())
            uni_equal &= torch.equal(card_u.cpu(),
                                     spec.accept_uniforms(keys, gen, SPEC_K))
        args = dict(keys=keys, gen=gen)
        cpu = spec.verify_commit(logits, torch.from_numpy(cand), kvec,
                                 temp=temp, top_k=top_k, top_p=top_p,
                                 qlog=qlog, **args)
        card = spec.verify_commit(
            logits.to(dev), torch.from_numpy(cand).to(dev), kvec.to(dev),
            temp=temp.to(dev), top_k=top_k.to(dev), top_p=top_p.to(dev),
            qlog=qlog.to(dev), **args)
        card = [c.cpu() for c in card]
        for s in range(rows):
            n = int(cpu[1][s])
            same = (int(card[1][s]) == n
                    and torch.equal(card[0][s, :n], cpu[0][s, :n]))
            equal += same
            if not same:
                diffs.append(dict(batch=d, row=s, cpu=cpu[0][s, :n].tolist(),
                                  card=card[0][s, :int(card[1][s])].tolist()))
    total = rows * (SPEC_WINDOWS // rows)
    print(f"  verify_commit on the card: acceptance uniforms "
          f"{'equal' if uni_equal else 'DIFFER'} to the CPU's; (out, n) equal "
          f"on {equal}/{total} seeded windows of ({rows}, {k1}, {vocab})"
          + "".join(f"; batch {x['batch']} row {x['row']}: cpu {x['cpu']} "
                    f"card {x['card']}" for x in diffs), flush=True)
    if not uni_equal or equal < SPEC_MIN_EQUAL * total // SPEC_WINDOWS:
        raise AssertionError(f"verify_commit: uniforms equal {uni_equal}, "
                             f"windows equal {equal}/{total}")
    return dict(uniforms_equal=uni_equal, windows_equal=equal,
                windows=total, differences=diffs)


def spec_phase(dev, report: dict, cfg, dense_reqs) -> dict:
    """Phase 10: speculative serving of phase 4's model and requests
    (float path, ``kv_quant``, 4 slots, K = SPEC_K). Returns the counted
    perfect-draft run's launches."""
    params = float_path_params(cfg, dev)
    prompts = make_prompts(cfg)
    perfect = spec_kw(params, cfg, cfg.num_layers)
    out: dict = {}

    # (a) the perfect draft: the full-depth self-draft is the target
    serve_run(params, cfg, prompts, dev, count=False, engine_kw=perfect)
    eng, reqs, wall, counts = serve_run(params, cfg, prompts, dev,
                                        count=True, engine_kw=perfect)
    print(f"phase 10 (a): speculative, {cfg.num_layers}-layer self-draft "
          f"(the target), K = {SPEC_K}", flush=True)
    out["perfect"] = check_spec_serving("perfect draft", eng, reqs, wall,
                                        counts, cfg, cfg.num_layers)
    parted = partings(params, cfg, reqs, dense_reqs, dev)
    same, total = agreement(reqs, dense_reqs)
    out["perfect"].update(agreement_with_phase4=(same, total), partings=parted)
    print(f"  greedy streams: {same}/{total} tokens equal to phase 4's counted"
          f" run" + "".join(f"; rid {p['rid']} parts at {p['position']} "
                            f"({p['spec']} vs {p['non_spec']}), top-2 margin "
                            f"{p['margin']:.2e} of the largest logit"
                            for p in parted), flush=True)
    if any(p["margin"] > LOGITS_REL_TOL for p in parted):
        raise AssertionError(f"speculative streams part from phase 4's "
                             f"beyond a tie: {parted}")
    check_perfect_acceptance(out["perfect"], reqs, parted)
    del eng

    # (b) a 4-layer self-draft, in turns with phase 4's engine
    small = spec_kw(params, cfg, SPEC_SMALL_DRAFT)
    turns: dict = {"non_spec": [], "spec": []}
    runs = {}
    for label in ("non_spec", "spec", "spec", "non_spec"):
        e, rs, w, _ = serve_run(params, cfg, prompts, dev, count=False,
                                engine_kw=small if label == "spec" else None)
        es = e.stats()
        turns[label].append(1e3 * es["decode_seconds"] / es["tokens_decoded"])
        runs[label] = (e, rs, w)
    e, rs, w = runs["spec"]
    out["small"] = check_spec_serving(
        f"{SPEC_SMALL_DRAFT}-layer draft", e, rs, w, None, cfg,
        SPEC_SMALL_DRAFT)
    out["small"]["turns_ms_per_token"] = turns
    same, total = agreement(rs, dense_reqs)
    out["small"]["agreement_with_phase4"] = (same, total)
    print(f"  in turns (non-spec, spec, spec, non-spec): ms per committed "
          f"token non-spec {turns['non_spec'][0]:.2f} / "
          f"{turns['non_spec'][1]:.2f}, {SPEC_SMALL_DRAFT}-layer draft "
          f"{turns['spec'][0]:.2f} / {turns['spec'][1]:.2f}; {same}/{total} "
          f"tokens equal to phase 4's", flush=True)
    del runs, e

    # (c) the perfect draft on the paged path (dense-equivalent pool)
    paged_kw = dict(perfect, paged=True, block_size=BLOCK_SIZE)
    serve_run(params, cfg, prompts, dev, count=False, engine_kw=paged_kw)
    peng, preqs, pwall, pcounts = serve_run(params, cfg, prompts, dev,
                                            count=True, engine_kw=paged_kw)
    print(f"phase 10 (c): the perfect draft on the paged path, "
          f"{peng.stats()['pool_blocks']} blocks x {BLOCK_SIZE}", flush=True)
    out["paged"] = check_spec_serving("paged perfect draft", peng, preqs,
                                      pwall, pcounts, cfg, cfg.num_layers,
                                      attn="attn_q8_paged")
    same, total = agreement(preqs, reqs)
    held = peng.stats()["pool_blocks_used"]
    peng.pool.check(peng._table)
    out["paged"].update(agreement_with_dense_spec=(same, total),
                        blocks_held=held)
    print(f"  streams: {same}/{total} tokens equal to (a)'s; {held} blocks "
          f"held at the end; pool.check passes", flush=True)
    if same != total or held:
        raise AssertionError("paged speculative streams differ from the "
                             "dense ones, or blocks are still held")
    if (out["paged"]["windows"] != out["perfect"]["windows"]
            or [(r.accepted, r.drafted) for r in preqs]
            != [(r.accepted, r.drafted) for r in reqs]):
        raise AssertionError("paged perfect draft: windows or per-request "
                             "acceptance differ from (a)'s")

    # (d) verify_commit on the card against the CPU
    print("phase 10 (d): verify_commit, card against CPU", flush=True)
    out["verify_vs_cpu"] = check_verify_on_card(dev, cfg.vocab_size)
    report["spec"] = out
    return counts


# --- the MoE and dense-family slice: phase 3's shapes, phases 11 and 12 ---

# olmoe-1b-7b's expert projections (K, N), its 64 experts, and the rows per
# expert its serving path gives them: a decode step of 4 slots routes at
# capacity 1 (M = 4); a prefill wave of 4 prompts in a 64-token bucket at
# capacity ceil(int(1.25 * 64 * 8) / 64) = 10 (M = 40)
OLMOE_EXPERTS = 64
EXPERT_PROJ = {"gate": (2048, 1024), "down": (1024, 2048)}
EXPERT_M = (("decode", 4), ("prefill", 40))
# qwen3-moe-235b-a22b's widths, untimed: 128 experts, decode M = 4 and a
# prefill wave's M = 4 x ceil(640 / 128) = 20
QWEN3_EXPERTS = 128
QWEN3_PROJ = {"gate": (4096, 1536), "down": (1536, 4096)}
# MoE routing parity: a routing that parts kernel and plain path must sit
# on a k/k+1 probability gap below this, as a phase-10 parting sits on a
# top-2 tie; the logits are held on the rows whose routing agrees
ROUTE_GAP_TOL = 1e-6
# phase 12: each dense-family model at full width and two layers (full
# depth would seed 15.6 B parameters for no new shape); stablelm-3b's
# head_dim 80 has no int8 KV codec and serves on the fp cache
DENSE_FAMILY = (("nemotron-4-15b", True), ("stablelm-3b", False))
DENSE_FAMILY_LAYERS = 2
# The script's time limit stays while it grows: phases 11, 13 and 14 serve
# their models at full width and cut depth (every layer kind kept: MoE
# layers; rwkv6's blocks; zamba2's macroblocks, tail and shared attention;
# phi's decoder), which cuts their host-bound steps and plain-path
# parities in proportion.
MOE_LAYERS = 2
RECURRENT_LAYERS = {"rwkv6-3b": 4, "zamba2-7b": 7}
PHI_LAYERS = 4


def expert_stack(fmt: str, e: int, k: int, n: int, gen, dev):
    """A seeded (E, K, N) expert stack quantized by the port to ``fmt``."""
    w = torch.randn(e, k, n, generator=gen, device=dev) / math.sqrt(k)
    return formats.quantize(w, fmt)


def _planes(qt):
    d = qt.data
    return (d["plane2"], d["plane1"], d["scales"], d["zps"])


def _stack_weight(qt, rotate: bool) -> torch.Tensor:
    """The dequantized (E, K, N) f32 stack (the IFWHT'd one with
    ``rotate``): the library yardstick's operand."""
    e, n, kb = qt.data["plane2"].shape[:3]
    w = dequant_blocks(*_planes(qt), rotate_weights=rotate,
                       fivelevel=qt.meta.fivelevel,
                       sub_blocks=qt.meta.sub_blocks)
    return w.reshape(e, n, kb * 256).transpose(1, 2).contiguous()


def _rows_fwht(x: torch.Tensor, fn) -> torch.Tensor:
    return fn(x.reshape(-1, x.shape[-1])).reshape(x.shape)


def _expert_forms(qt, x, int8: bool):
    """(kernel name, run, plain) of the path's expert launch on ``x (E, M,
    K)``: the float matvec rotating x itself (M <= 16) or the tiled kernel
    on rotated rows; the int8 pair on the activation codes."""
    kw = dict(fivelevel=qt.meta.fivelevel, sub_blocks=qt.meta.sub_blocks)
    planes = _planes(qt)
    small = x.shape[1] <= 16
    if int8:
        xq, xs = act_encode(x.reshape(-1, x.shape[-1]))
        xq = xq.reshape(x.shape)
        xs = xs.reshape(x.shape[0], x.shape[1], 1)
        fn = itq3_matvec_int8 if small else itq3_matmul_int8
        return (("itq3_matvec_int8_experts" if small
                 else "itq3_matmul_int8_experts"),
                lambda: fn(xq, xs, *planes, **kw),
                lambda: itq3_matmul_int8_ref(xq, xs, *planes, **kw),
                (xq, xs))
    if small:
        return ("itq3_matvec_experts",
                lambda: itq3_matvec(x, *planes, rotate_weights=False,
                                    rotate_x=True, **kw),
                lambda: itq3_matmul_ref(_rows_fwht(x, fwht_ref), *planes,
                                        rotate_weights=False, **kw), None)
    return ("itq3_matmul_experts",
            lambda: itq3_matmul(x, *planes, rotate_weights=False, **kw),
            lambda: itq3_matmul_ref(x, *planes, rotate_weights=False, **kw),
            None)


def check_experts(led: Ledger, gen: torch.Generator, dev,
                  report: dict) -> None:
    """The four expert-axis kernels at olmoe's serving shapes (64
    experts; decode M = 4, prefill M = 40; gate/up 2048 -> 1024, down
    1024 -> 2048): one launch over the whole stack, timed beside its plain
    version (the per-matrix plain function expert by expert) and
    ``torch.bmm`` on the dequantized f32 stack; two calls bit-equal;
    within 1e-4 of the plain version (the int8 pair: exact with unit
    scales, 1e-5 with real ones). The float pair on itq3_s (the float
    path's uniform policy), the int8 pair on itq3_s_sub (the mixed
    policy's expert format). Bounds count every expert's planes once."""
    for name, (k, n) in EXPERT_PROJ.items():
        for fmt, int8 in (("itq3_s", False), ("itq3_s_sub", True)):
            qt = expert_stack(fmt, OLMOE_EXPERTS, k, n, gen, dev)
            e = OLMOE_EXPERTS
            for label, m in EXPERT_M:
                x = torch.randn(e, m, k, generator=gen, device=dev)
                kernel, run, plain, codes = _expert_forms(qt, x, int8)
                rot = not int8 and m <= 16
                w = _stack_weight(qt, rotate=rot)
                got = run()
                if not torch.equal(got, run()):
                    raise AssertionError(f"{kernel} {name}: two calls "
                                         f"differ")
                err, rel = rel_err(got, plain())
                if int8:
                    xq, xs = codes
                    ones = torch.ones_like(qt.data["scales"])
                    kw = dict(fivelevel=False,
                              sub_blocks=qt.meta.sub_blocks)
                    fn = itq3_matvec_int8 if m <= 16 else itq3_matmul_int8
                    unit = (fn(xq, torch.ones_like(xs), qt.data["plane2"],
                               qt.data["plane1"], ones, qt.data["zps"], **kw)
                            - itq3_matmul_int8_ref(
                                xq, torch.ones_like(xs), qt.data["plane2"],
                                qt.data["plane1"], ones, qt.data["zps"],
                                **kw)).abs().max().item()
                    if unit != 0:
                        raise AssertionError(f"{kernel} {name}: unit-scale "
                                             f"outputs differ by {unit}")
                    xdec = act_decode(xq.reshape(-1, k),
                                      xs.reshape(-1, 1)).reshape(e, m, k)
                    def library(xd=xdec, w=w):
                        return torch.bmm(xd, w)
                    nbytes = e * m * (k + 4) + weight_bytes(qt) + e * m * n * 4
                    flops, peak = 2 * e * m * n * k, PEAK_INT8_OPS
                    tol = INT8_REL_TOL
                else:
                    def library(x=x, w=w):
                        return torch.bmm(x, w)
                    nbytes = e * m * k * 4 + weight_bytes(qt) + e * m * n * 4
                    if m <= 16:  # f32 FMAs and the rotation of x
                        flops, peak = 2 * e * m * n * k + 9 * e * m * k, \
                            PEAK_F32_FLOPS
                    else:  # two TF32 products per product (x hi and lo)
                        flops, peak = 2 * 2 * e * m * n * k, PEAK_TF32_FLOPS
                    tol = KERNEL_REL_TOL
                led.add(kernel, f"olmoe {name} E={e} M={m} {label} {fmt}",
                        err=err, rel=rel, ms=device_ms(run),
                        plain_ms=device_ms(plain, reps=1),
                        library_ms=device_ms(library), nbytes=nbytes,
                        flops=flops, peak_ops=peak, tol=tol)
                del w
            del qt
    torch.cuda.empty_cache()
    print("  expert kernels: two calls bit-equal at every olmoe shape; the "
          "int8 pair exact with unit scales", flush=True)


def expert_tile_sweep(gen: torch.Generator, dev, report: dict,
                      timed: bool = True) -> None:
    """The four expert-axis kernels at olmoe's shapes under every cut
    (the wrapper's rule replaced for the sweep only) beside the one the
    rule picks: each within tolerance of the plain version and bit-equal
    on two calls; for the float decode also the unfused pair (one
    ``fwht.cu`` over all E x M rows, then the matvec on rotated x) at the
    picked cut. Times printed and written to the details, not summed
    into the kernel lines."""
    from repro_torch.kernels import itq3 as itq3_mod

    e = OLMOE_EXPERTS
    out = {}
    for name, (k, n) in EXPERT_PROJ.items():
        kb = k // 256
        for fmt, int8 in (("itq3_s", False), ("itq3_s_sub", True)):
            qt = expert_stack(fmt, e, k, n, gen, dev)
            kw = dict(fivelevel=False, sub_blocks=qt.meta.sub_blocks)
            planes = _planes(qt)
            for label, m in EXPERT_M:
                x = torch.randn(e, m, k, generator=gen, device=dev)
                kernel, _, plain, codes = _expert_forms(qt, x, int8)
                want = plain()
                small = m <= 16
                if int8:
                    rule = "matvec_int8_tiles" if small else "matmul_tiles"
                    fn = itq3_matvec_int8 if small else itq3_matmul_int8
                    args, fkw = (*codes, *planes), kw
                    tol = INT8_REL_TOL
                else:
                    rule = "matvec_tiles" if small else "matmul_tiles"
                    fn = itq3_matvec if small else itq3_matmul
                    args = (x, *planes)
                    fkw = dict(kw, rotate_weights=False,
                               **({"rotate_x": True} if small else {}))
                    tol = KERNEL_REL_TOL
                pick = getattr(itq3_mod, rule)(m, n, kb, e)
                cuts = int8_cuts("itq3_matmul_int8" if not small
                                 else "itq3_matvec_int8", kb)
                if rule == "matvec_tiles":
                    cuts = [c for c in cuts
                            if itq3_mod.matvec_window(m, kb, *c) >= 1]
                row = {}
                for cut in cuts:
                    run = _under_cut(rule, cut, fn)

                    def call(run=run):
                        return run(*args, **fkw)
                    got = call()
                    _, rel = rel_err(got, want)
                    if not (rel <= tol and torch.equal(got, call())):
                        raise AssertionError(f"{kernel} {name} cut {cut}: "
                                             f"rel {rel:.2e} or not "
                                             f"deterministic")
                    row[f"{cut[0]}x{cut[1]}"] = cut_ms(call, timed)
                if not int8 and small:
                    def pair():
                        xr = fwht(x.reshape(-1, k)).reshape(x.shape)
                        return itq3_matvec(xr, *planes, rotate_weights=False,
                                           **kw)
                    if not torch.equal(pair(), fn(*args, **fkw)):
                        raise AssertionError(f"{kernel} {name}: the pair "
                                             f"differs from the fused form")
                    row["pair"] = cut_ms(pair, timed)
                key = f"{kernel} {name} M={m}"
                out[key] = dict(pick=f"{pick[0]}x{pick[1]}", ms=row)
                print(f"  {kernel} cuts {name} E={e} M={m} N={n} KB={kb} "
                      f"(the rule picks {pick[0]}x{pick[1]}): "
                      + cuts_line(row), flush=True)
            del qt
    torch.cuda.empty_cache()
    report["expert_tiles_ms"] = out


EXPERT_EDGE_FORMATS = ("itq3_s", "itq3_s_sub", "itq3_x")


def _expert_edge(qt, x, int8: bool, tol: float, what: str) -> float:
    """One untimed expert-axis case: within ``tol`` of the plain version,
    two calls bit-equal, and E = 1 (the first expert as a stack of one)
    bit-equal to the one-matrix call of the same kernel."""
    kernel, run, plain, codes = _expert_forms(qt, x, int8)
    got = run()
    if not torch.equal(got, run()):
        raise AssertionError(f"{what}: two calls differ")
    _, rel = rel_err(got, plain())
    if not rel <= tol:
        raise AssertionError(f"{what}: rel error {rel:.3e} > {tol}")
    first = type(qt)({k: v[:1] for k, v in qt.data.items()}, qt.meta)
    _, run1, _, _ = _expert_forms(first, x[:1], int8)
    flat = type(qt)({k: v[0] for k, v in qt.data.items()}, qt.meta)
    kw = dict(fivelevel=qt.meta.fivelevel, sub_blocks=qt.meta.sub_blocks)
    small = x.shape[1] <= 16
    if int8:
        xq, xs = codes
        fn = itq3_matvec_int8 if small else itq3_matmul_int8
        two_d = fn(xq[0], xs[0], *_planes(flat), **kw)
    elif small:
        two_d = itq3_matvec(x[0], *_planes(flat), rotate_weights=False,
                            rotate_x=True, **kw)
    else:
        two_d = itq3_matmul(x[0], *_planes(flat), rotate_weights=False, **kw)
    if not torch.equal(run1()[0], two_d):
        raise AssertionError(f"{what}: E = 1 differs from the one-matrix "
                             f"kernel")
    return rel


def check_expert_edges(gen: torch.Generator, dev, report: dict) -> None:
    """Untimed edges of the expert axis: three formats, ragged M (the
    matmul's 17, 33 and 65 rows leave a partial row tile at each expert's
    end of the folded y axis) and ragged N, one and three blocks; E = 1
    bit-equal to the one-matrix kernel; qwen3-moe's widths (128 experts,
    4096 -> 1536 and 1536 -> 4096); a y axis past 65,535 refused."""
    from repro_torch.kernels import itq3 as itq3_mod

    worst = {}
    cases = 0
    for fmt in EXPERT_EDGE_FORMATS:
        for n, kb in ((29, 1), (200, 3)):
            qt = expert_stack(fmt, 3, kb * 256, n, gen, dev)
            for int8 in (False, True):
                if int8 and fmt == "itq3_x" and n == 200:
                    continue
                for m in (1, 5, 16, 17, 33, 65):
                    x = torch.randn(3, m, kb * 256, generator=gen, device=dev)
                    what = (f"expert {'int8' if int8 else 'float'} {fmt} "
                            f"E=3 M={m} N={n} KB={kb}")
                    rel = _expert_edge(qt, x, int8, INT8_REL_TOL if int8
                                       else KERNEL_REL_TOL, what)
                    key = "int8" if int8 else "float"
                    worst[key] = max(worst.get(key, 0.0), rel)
                    cases += 1
    for name, (k, n) in QWEN3_PROJ.items():
        for fmt, int8 in (("itq3_s", False), ("itq3_s_sub", True)):
            qt = expert_stack(fmt, QWEN3_EXPERTS, k, n, gen, dev)
            for m in (4, 20):
                x = torch.randn(QWEN3_EXPERTS, m, k, generator=gen,
                                device=dev)
                rel = _expert_edge(qt, x, int8, INT8_REL_TOL if int8
                                   else KERNEL_REL_TOL,
                                   f"qwen3-moe {name} {fmt} M={m}")
                worst[f"qwen3 {name} {fmt} M={m}"] = rel
                cases += 1
            del qt
    try:
        itq3_mod._matmul_cut(65536, 17, 64, 1)
    except ValueError:
        pass
    else:
        raise AssertionError("an expert axis past the y limit was not "
                             "refused")
    torch.cuda.empty_cache()
    report["expert_edges"] = dict(cases=cases, worst_rel=worst)
    print(f"  expert edges: {cases} cases (ragged M and N, E = 1 bit-equal "
          f"to the one-matrix kernels, qwen3-moe's 128 experts) within "
          f"tolerance, two calls bit-equal", flush=True)


# The dense family's widths the contraction kernels had not served:
# nemotron's down (K = 96 blocks: the matvec stages x in windows) and
# stablelm's (27 blocks: an odd count for the split rules), and nemotron's
# untied head (N = 256,000) through the matvec
WIDE_SHAPES = (("nemotron down", 24576, 6144), ("stablelm down", 6912, 2560))
NEMOTRON_HEAD = (6144, 256000)


def check_dense_family_widths(gen: torch.Generator, dev,
                              report: dict) -> None:
    """Untimed: itq3_matvec (fused, M = 4) and itq3_matmul (M = 256) at
    nemotron's and stablelm's widest reductions, and the fused matvec at
    nemotron's 256,000-column head, each within 1e-4 of its plain version
    (the head's plain version column block by column block) and bit-equal
    on two calls."""
    rels = {}
    for name, k, n in WIDE_SHAPES:
        qt = formats.quantize(torch.randn(k, n, generator=gen, device=dev)
                              / math.sqrt(k), "itq3_s")
        planes = _planes(qt)
        for m in (4, 256):
            x = torch.randn(m, k, generator=gen, device=dev)
            if m <= 16:
                run = lambda x=x: itq3_matvec(  # noqa: E731
                    x, *planes, rotate_weights=False, rotate_x=True)
                want = itq3_matmul_ref(fwht_ref(x), *planes,
                                       rotate_weights=False)
            else:
                run = lambda x=x: itq3_matmul(  # noqa: E731
                    x, *planes, rotate_weights=False)
                want = itq3_matmul_ref(x, *planes, rotate_weights=False)
            got = run()
            if not torch.equal(got, run()):
                raise AssertionError(f"{name} M={m}: two calls differ")
            rels[f"{name} M={m}"] = rel_err(got, want)[1]
        del qt
    k, n = NEMOTRON_HEAD
    qt = formats.quantize(torch.randn(k, n, generator=gen, device=dev)
                          / math.sqrt(k), "itq3_s")
    planes = _planes(qt)
    x = torch.randn(4, k, generator=gen, device=dev)
    got = itq3_matvec(x, *planes, rotate_weights=False, rotate_x=True)
    if not torch.equal(got, itq3_matvec(x, *planes, rotate_weights=False,
                                        rotate_x=True)):
        raise AssertionError("nemotron head: two calls differ")
    xr = fwht_ref(x)
    want = torch.cat([itq3_matmul_ref(xr, *(p[c:c + 32000] for p in planes),
                                      rotate_weights=False)
                      for c in range(0, n, 32000)], dim=1)
    rels["nemotron head N=256000 M=4"] = rel_err(got, want)[1]
    del qt, planes
    torch.cuda.empty_cache()
    bad = {k: v for k, v in rels.items() if not v <= KERNEL_REL_TOL}
    report["dense_family_widths_rel"] = rels
    if bad:
        raise AssertionError(f"dense-family widths past 1e-4: {bad}")
    print(f"  dense-family widths (K 96 and 27 blocks, N 256,000): max rel "
          f"error {max(rels.values()):.2e}, two calls bit-equal", flush=True)


# head_dim 128 attention: olmoe (16 KV heads, G = 1) and nemotron (8 KV
# heads, G = 6) timed at the decode and prefill rows of phase 3; qwen3-moe
# (4 KV heads, G = 16) checked untimed
HD128_MODELS = (("olmoe", 16, 1, True), ("nemotron", 8, 6, True),
                ("qwen3-moe", 4, 16, False))


def check_attn_hd128(led: Ledger, gen: torch.Generator, dev,
                     report: dict) -> None:
    """attn_q8 dense and paged at head_dim 128 over 4 slots: within 1e-4
    of its plain version, two calls bit-equal, the paged kernel the dense
    one's bits over the gathered view; olmoe's and nemotron's rows timed
    (kernel ``attn_q8_hd128``). Then the head_dim-128 rotations at
    olmoe's serving rows (the query and output FWHTs, the KV codec),
    bit-equal to their plain versions."""
    hd = 128
    exact = {}
    for model, kvh, g, timed in HD128_MODELS:
        for label, tq, lens, offs, causal, t in ATTN_CASES[:2]:
            kv_len = [x for x in lens for _ in range(kvh)]
            q_off = [x for x in offs for _ in range(kvh)]
            args, kw = _attn_case(gen, dev, r=SLOTS * kvh, tq=tq, g=g, hd=hd,
                                  t=t, kv_len=kv_len, q_offset=q_off,
                                  causal=causal)
            got, want = attn_q8(*args, **kw), attn_q8_ref(*args, **kw)
            what = f"{model} {label} R={SLOTS * kvh} G={g} HD={hd} T={t}"
            if not _bit_equal(got, attn_q8(*args, **kw)):
                raise AssertionError(f"attn_q8 {what}: two calls differ")
            errs = _attn_errs(got, want)
            if not errs["rel"] <= KERNEL_REL_TOL:
                raise AssertionError(f"attn_q8 {what}: rel error "
                                     f"{errs['rel']:.3e}")
            # the same rows through the paged kernel: a shuffled pool
            maxb = -(-t // BLOCK_SIZE)
            table = (1 + torch.randperm(SLOTS * maxb, generator=gen,
                                        device=dev)).reshape(SLOTS, maxb)
            rows = paged_row_table(table.to(torch.int32), kvh)
            q, kc, ks, vc, vs, kl, off = args
            pool = [torch.zeros((SLOTS * maxb + 1) * kvh, BLOCK_SIZE,
                                *p.shape[2:], dtype=p.dtype, device=dev)
                    for p in (kc, ks, vc, vs)]
            for plane, dense in zip(pool, (kc, ks, vc, vs)):
                plane[rows.reshape(-1)] = dense.reshape(
                    dense.shape[0] * maxb, BLOCK_SIZE, *dense.shape[2:])
            pkw = dict(kw, block_size=BLOCK_SIZE)
            paged = attn_q8_paged(q, *pool, kl, off, rows, **pkw)
            exact[what] = max((a - b).abs().max().item()
                              for a, b in zip(paged, got))
            if exact[what] != 0:
                raise AssertionError(f"attn_q8_paged {what}: differs from "
                                     f"the dense kernel")
            if not timed:
                continue
            mask, keys_read, pairs = attn_extent(kv_len, q_off, tq, t, causal)
            nbytes = (2 * q.numel() * 4 + sum(keys_read) * 2 * (hd + 2)
                      + 2 * len(kv_len) * 4 + 2 * (q.numel() // hd) * 4)
            # the MoE path's rows (olmoe) name the kernel line's entry; the
            # others stay in the details
            led.add("attn_q8_hd128" if model == "olmoe"
                    else f"attn_q8_hd128/{model}", what, **errs,
                    ms=device_ms(lambda: attn_q8(*args, **kw)),
                    plain_ms=device_ms(lambda: attn_q8_ref(*args, **kw)),
                    library_ms=device_ms(_attn_library(args, kw, mask, dev)),
                    nbytes=nbytes, flops=pairs * g * 4 * hd)
    # olmoe's rotations: q and out (4 slots x 16 heads per decode step,
    # x 64 positions per wave), K and V (16 KV heads)
    for m in (SLOTS * 16, SLOTS * 16 * PROMPT_PAD):
        x = torch.randn(m, hd, generator=gen, device=dev)
        if not torch.equal(fwht(x, hd), fwht_ref(x, hd)):
            raise AssertionError(f"fwht/128 ({m},128): not the plain bits")
    for t in (1, PROMPT_PAD):
        k, v = _kv_pair(gen, dev, SLOTS, 16, t, hd)
        if not _kv_equal(fwht_kv_encode(k, v), fwht_kv_encode_ref(k, v)):
            raise AssertionError(f"fwht_kv/128 T={t}: not the plain bits")
    report["attn_hd128_paged_vs_dense_abs_err"] = exact
    print("  head_dim 128: attn_q8 dense and paged at G = 1, 6, 16 within "
          "1e-4, paged == dense bit for bit; fwht/128 and fwht_kv/128 at "
          "olmoe's rows bit-equal to the plain versions", flush=True)


def family_contract(cfg, *, kv_quant: bool, act_quant: bool,
                    head: bool) -> tuple:
    """The kernels of one decode step (all SLOTS slots) and of one prefill
    wave (SLOTS prompts in one PROMPT_PAD bucket) of ``cfg``: per layer its
    dense projections (4 attention, plus the MLP's 3 for swiglu or 2), the
    MoE's expert projections as one expert-axis launch each (M = slots x
    capacity rows per expert), and with ``kv_quant`` the attention's two
    head_dim FWHTs, one KV codec and one ``attn_q8``; ``head`` when the
    untied head is a ternary leaf (one more contraction of SLOTS rows).
    A contraction of M <= 16 rows is the matvec (float: it rotates x
    itself), else a 256-point FWHT and the matmul; on the W3A8 path one
    ``fwht_act_encode`` and the int8 kernel."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import Runtime

    layers = cfg.num_layers
    mlp = 3 if cfg.activation == "swiglu" else 2
    moe = cfg.family == "moe"
    hd = cfg.resolved_head_dim
    out = []
    for t in (1, PROMPT_PAD):
        per = collections.Counter()

        def add(rows, n, suffix=""):
            small = rows <= 16
            if act_quant:
                per["fwht_act/256"] += n
                per[("itq3_matvec_int8" if small else "itq3_matmul_int8")
                    + suffix] += n
            else:
                per[("itq3_matvec" if small else "itq3_matmul")
                    + suffix] += n
                if not small:
                    per["fwht/256"] += n
        add(SLOTS * t, layers * (4 if moe else 4 + mlp))
        if moe:
            cap = moe_mod.capacity(cfg, Runtime(), t)
            add(SLOTS * cap, layers * mlp, "_experts")
        if head:
            add(SLOTS, 1)
        if kv_quant:
            per[f"fwht/{hd}"] += 2 * layers
            per[f"fwht_kv/{hd}"] += layers
            per["attn_q8"] += layers
        out.append(per)
    return tuple(out)


def check_family_serving(label, eng, reqs, wall, counts, per_step,
                         per_wave) -> dict:
    """A counted serving run held to its contract: every request finishes
    with ``length`` and no slot is quarantined, one host sync per step and
    per wave, and each kernel launched exactly ``per_step`` times per
    decode step and ``per_wave`` times per prefill wave. Returns the run's
    numbers."""
    st = eng.stats()
    bad = [r.rid for r in reqs if r.finish_reason != "length"
           or len(r.out) != MAX_NEW]
    if bad or st["quarantined"]:
        raise AssertionError(f"{label}: requests {bad} did not finish with "
                             f"length / {st['quarantined']} quarantined")
    steps, waves = st["decode_steps"], st["prefill_waves"]
    if st["host_syncs"] != steps + waves:
        raise AssertionError(f"{label}: {st['host_syncs']} host syncs for "
                             f"{steps} steps and {waves} waves")
    expected = {k: per_step[k] * steps + per_wave[k] * waves
                for k in per_step | per_wave}
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts} != expected "
                             f"{expected}")
    out = dict(
        wall_s=wall, launches=counts, stats=st,
        decode_tok_s=st["tokens_decoded"] / st["decode_seconds"],
        decode_ms_per_step=1e3 * st["decode_seconds"] / steps,
        prefill_ms_per_wave=1e3 * st["prefill_seconds"] / waves,
        launches_per_decode_step=dict(per_step),
        launches_per_prefill_wave=dict(per_wave),
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    print(f"  {label}: {len(reqs)} requests / "
          f"{sum(len(r.out) for r in reqs)} tokens in {wall:.2f} s: decode "
          f"{out['decode_tok_s']:.1f} tok/s ({out['decode_ms_per_step']:.1f} "
          f"ms/step over {steps} steps), prefill "
          f"{out['prefill_ms_per_wave']:.1f} ms/wave over {waves} waves, "
          f"one host sync per step and wave, peak memory "
          f"{out['peak_mem_bytes'] / 2**30:.2f} GiB", flush=True)
    print(f"  launches per decode step {dict(per_step)}; per prefill wave "
          f"{dict(per_wave)}", flush=True)
    return out


def family_parity(params, cfg, prompts, dev, *, kv_quant: bool,
                  act_quant: bool = False) -> dict:
    """Layer-forced logits, kernel path against plain path (``two_paths``),
    prefill then 4 decode steps, held to 1e-3 of the largest logit. For
    an MoE the router's choices of both paths are compared at every layer:
    a real token routed differently must sit on a k/k+1 probability gap
    below ROUTE_GAP_TOL (printed with the two paths' largest probability
    difference for it), and its batch row leaves that step's logits check.
    A prefill's pad positions are counted apart and not held: they follow
    the prompt, so the stable sort ranks them after every real token of
    their expert (they never take a real token's slot) and no real token
    attends them; their identical inputs repeat any one KV rounding tie
    at every pad position of the row."""
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod

    records = []
    real = moe_mod.route

    def spy(p, x, rt, cfg_):
        out = real(p, x, rt, cfg_)
        records.append((out[1], out[2]))
        return out
    n = SLOTS
    toks = torch.as_tensor(np.stack([np.pad(p, (0, PROMPT_PAD - len(p)))
                                     for p in prompts[:n]]), device=dev)
    last = torch.as_tensor([len(p) - 1 for p in prompts[:n]], device=dev)
    caches = [lm.init_cache(cfg, n, MAX_LEN, kv_quant=kv_quant, device=dev)
              for _ in range(2)]
    errs, partings, pad_partings = [], [], 0
    moe_mod.route = spy
    try:
        tokens, pos, idx = toks, 0, last
        for step in range(5):
            records.clear()
            logits = two_paths(params, cfg, tokens, caches, pos, idx, True,
                               act_quant, kv_quant)
            parted = set()
            for layer, ((ki, kp), (pi, pp)) in enumerate(
                    zip(records[0::2], records[1::2])):
                for b, t in (ki != pi).any(-1).nonzero().tolist():
                    if step == 0 and t > last[b]:
                        pad_partings += 1
                        continue
                    top = torch.sort(pp[b, t], descending=True).values
                    k = cfg.experts_per_token
                    gap = (top[k - 1] - top[k]).item()
                    dp = (kp[b, t] - pp[b, t]).abs().max().item()
                    partings.append(dict(step=step, layer=layer, row=b,
                                         token=t, gap=gap, max_dp=dp))
                    print(f"  routing parts at step {step} layer {layer} row "
                          f"{b} token {t}: k/k+1 gap {gap:.2e}, the paths' "
                          f"largest probability difference {dp:.2e}",
                          flush=True)
                    if not gap < ROUTE_GAP_TOL:
                        raise AssertionError(
                            f"{cfg.name}: routing parts on a gap of {gap:.3e}")
                    parted.add(b)
            rows = [b for b in range(n) if b not in parted]
            errs.append(rel_err(logits[0][rows], logits[1][rows])[1]
                        if rows else 0.0)
            tokens = logits[1][:, 0].argmax(-1)[:, None]
            pos = last + 1 + step
            idx = None
    finally:
        moe_mod.route = real
    print(f"  layer-forced logits rel error (max |diff| / max |logit|), "
          f"prefill then 4 decode steps: "
          f"{', '.join(f'{e:.2e}' for e in errs)}; {len(partings)} routing "
          f"partings of real tokens, {pad_partings} of prefill pad "
          f"positions (not held)", flush=True)
    if not max(errs) <= LOGITS_REL_TOL:
        raise AssertionError(f"{cfg.name}: layer-forced logits rel error "
                             f"{max(errs):.3e} > {LOGITS_REL_TOL}")
    return dict(logits_rel=errs, routing_partings=partings,
                pad_routing_partings=pad_partings)


def family_serve(params, cfg, dev, report: dict, key: str, *,
                 kv_quant: bool, act_quant: bool, head: bool,
                 profile_table=None) -> dict:
    """Serve phase 4's 8 requests on ``params`` twice (the first run warms
    up; the streams must be equal), the second counted and held to
    :func:`family_contract`; then the layer-forced parity, and with
    ``profile_table`` one short traced run for the device's idle share.
    Returns the counted run's launches."""
    prompts = make_prompts(cfg)

    def serve(count, max_new=MAX_NEW):
        return serve_run(params, cfg, prompts, dev, count=count,
                         max_new=max_new, kv_quant=kv_quant,
                         act_quant=act_quant)

    _, first, _, _ = serve(False)
    eng, reqs, wall, counts = serve(True)
    if [r.out for r in reqs] != [r.out for r in first]:
        raise AssertionError(f"{key}: two runs' streams differ")
    per_step, per_wave = family_contract(cfg, kv_quant=kv_quant,
                                         act_quant=act_quant, head=head)
    out = check_family_serving(f"{key} ({cfg.num_layers} layers)", eng,
                               reqs, wall, counts, per_step, per_wave)
    out["parity"] = family_parity(params, cfg, prompts, dev,
                                  kv_quant=kv_quant, act_quant=act_quant)
    report[key] = out
    if profile_table is not None:
        profile_phase(lambda: serve(False, max_new=PROFILE_NEW), report,
                      f"{key}_profile", profile_table)
    return counts


def seeded_model(cfg, policy, dev, report: dict, key: str):
    """``cfg`` at full width, seeded on the card and quantized as drawn;
    records the seconds, the resident bytes and the peak memory."""
    from repro_torch.models import lm
    from repro_torch.serve.quantized import quantized_bytes

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_quantized_params(cfg, policy, seed=0, device=dev)
    torch.cuda.synchronize()
    info = dict(seed_quantize_s=time.perf_counter() - t0,
                quantized_bytes=quantized_bytes(params),
                seed_peak_mem_bytes=torch.cuda.max_memory_allocated())
    report[f"{key}_model"] = info
    print(f"  {cfg.name} at full width, {cfg.num_layers} layers: seeded and "
          f"quantized on the card in {info['seed_quantize_s']:.1f} s, "
          f"{info['quantized_bytes'] / 2**30:.2f} GiB resident, peak "
          f"{info['seed_peak_mem_bytes'] / 2**30:.2f} GiB", flush=True)
    return params


def moe_phase(dev, report: dict) -> dict:
    """Phase 11: olmoe-1b-7b at full width, ``MOE_LAYERS`` deep (d_model
    2048, 64 experts top-8, vocab 50,304). (a) The float path: uniform
    itq3_s, ``kv_quant``, 4 slots, phase 4's 8 requests; exact launches,
    one host sync per step and wave, two runs' streams equal, layer-forced
    logits under the routing rule, and a short traced run for the idle
    share. (b) The W3A8 path: the mixed policy (experts itq3_s_sub, head
    q8_0, router fp) with ``act_quant``, held alike. Returns (a)'s
    launches, with (b)'s int8 ones."""
    from repro_torch.configs import mixed_precision_recipe
    from repro_torch.serve.quantized import QuantPolicy

    cfg = dataclasses.replace(get_config("olmoe-1b-7b"),
                              num_layers=MOE_LAYERS)
    print(f"phase 11: the MoE path, {cfg.name} ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_experts} experts top-"
          f"{cfg.experts_per_token}, vocab {cfg.vocab_size})", flush=True)
    params = seeded_model(cfg, "itq3_s", dev, report, "moe")
    counts = family_serve(params, cfg, dev, report, "moe", kv_quant=True,
                          act_quant=False, head=True,
                          profile_table=TABLE.with_name(
                              "chip_smoke_profile_moe.txt"))
    del params
    print("  (b) the W3A8 path: mixed policy, act_quant", flush=True)
    policy = QuantPolicy.from_dict(mixed_precision_recipe(cfg))
    params = seeded_model(cfg, policy, dev, report, "moe_w3a8")
    w3a8 = family_serve(params, cfg, dev, report, "moe_w3a8", kv_quant=True,
                        act_quant=True, head=False)
    del params
    torch.cuda.empty_cache()
    return {**counts, **{k: v for k, v in w3a8.items() if "int8" in k}}


def dense_family_phase(dev, report: dict) -> None:
    """Phase 12: nemotron-4-15b (LayerNorm, relu2, GQA 48/8, untied
    256,000-column head, ``kv_quant`` at head_dim 128) and stablelm-3b
    (LayerNorm, rotary_pct 0.25, head_dim 80 on the fp cache), each at
    full width and two layers, uniform itq3_s: greedy streams equal on two
    runs, exact launches, layer-forced logits within 1e-3."""
    print("phase 12: the rest of the dense family at full width, "
          f"{DENSE_FAMILY_LAYERS} layers each", flush=True)
    for arch, kv_quant in DENSE_FAMILY:
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=DENSE_FAMILY_LAYERS)
        params = seeded_model(cfg, "itq3_s", dev, report, arch)
        family_serve(params, cfg, dev, report, arch, kv_quant=kv_quant,
                     act_quant=False, head=True)
        del params
        torch.cuda.empty_cache()


# --- the recurrent families: phase 3's widths, phase 13 ---------------------

# phase 13's ladder: prompts of 8-40 tokens are fed in power-of-two chunks
# of at most 32 rows (the engine's own prompt_chunk), so a chunk of 32 runs
# itq3_matmul and the rest (<= 16 rows) itq3_matvec
RECURRENT_CHUNK = 32
# (label, K, N) of the recurrent families' ITQ3_S projections: rwkv6-3b's
# time mix, channel mix (K = 8960: 35 blocks) and untied 65,536-column head;
# zamba2-7b's in and out projections and its shared attention
SSM_SHAPES = (("rwkv6 r/k/v/g/o", 2560, 2560), ("rwkv6 cm_k", 2560, 8960),
              ("rwkv6 cm_v", 8960, 2560), ("zamba2 wz/wx", 3584, 7168),
              ("zamba2 out_proj", 7168, 3584), ("zamba2 attn", 3584, 3584))
RWKV_HEAD = ("rwkv6 head", 2560, 65536)
# phase 13's cases: (key, arch, W3A8 under the mixed policy, the untied head
# a ternary leaf); zamba2's head_dim 112 has no int8 KV codec, so its
# shared attention serves on the fp cache
# the traced window of each case: decode steps of 4 live slots, after an
# untraced admission (a ladder's trace would hold ~0.5 M host events for
# the profiler to walk)
RECURRENT_PROFILE_STEPS = 3
RECURRENT_CASES = (("rwkv6", "rwkv6-3b", False, True),
                   ("zamba2", "zamba2-7b", False, False),
                   ("zamba2_w3a8", "zamba2-7b", True, False))


def check_ssm_widths(led: Ledger, gen: torch.Generator, dev,
                     report: dict) -> None:
    """The four contraction kernels at the recurrent families' widths, M =
    4 (a decode step of 4 slots) and M = 32 (a ladder chunk), on itq3_s:
    the fused float matvec (x unrotated) and the int8 matvec at M = 4, the
    float matmul and the int8 matmul at M = 32, and the fused matvec alone
    at rwkv6's head (N = 65,536); :func:`check_widths` holds and times
    them (``<kernel>_ssm`` rows)."""
    cases = [(label, k, n, (4, RECURRENT_CHUNK), True)
             for label, k, n in SSM_SHAPES] + [RWKV_HEAD + ((4,), False)]
    unit = check_widths(led, gen, dev, cases, "ssm")
    report["ssm_widths_int8_unit_scale_abs_err"] = unit
    print(f"  recurrent widths: every kernel within its tolerance, two calls "
          f"bit-equal; int8 with unit scales exact over {len(unit)} shapes",
          flush=True)


def check_widths(led: Ledger, gen: torch.Generator, dev, cases,
                 suffix: str) -> dict:
    """The contraction kernels on itq3_s at ``cases``, each ``(label, K, N,
    the Ms, with the int8 pair)``: M <= 16 the fused float matvec (x
    unrotated) and the int8 matvec, else the float matmul and the int8
    matmul; x is zero-padded to whole 256-blocks, as ``qmatmul`` pads it.
    Each within 1e-4 of its plain version (the int8 pair: exact with unit
    scales, 1e-5 with real ones), two calls bit-equal, timed once per
    shape beside its bound, its plain version and ``x @ W`` on the
    dequantized f32 weight (the IFWHT'd one for the fused matvec). The
    kernels' instantiations are those phase 3's ptxas reports hold
    spill-free; the rows are named ``<kernel>_<suffix>``. Returns the
    int8 pair's unit-scale errors; raises if any is not 0."""
    unit = {}
    for label, k, n, ms, int8 in cases:
        qt = formats.quantize(torch.randn(k, n, generator=gen, device=dev)
                              / math.sqrt(k), "itq3_s")
        planes, wbytes = _planes(qt), weight_bytes(qt)
        kp = planes[0].shape[1] * 256  # K padded to whole blocks
        kw = dict(fivelevel=False, sub_blocks=0)
        w = dequant_blocks(*planes, rotate_weights=False,
                           **kw).reshape(n, kp).T.contiguous()
        w_rot = dequant_blocks(*planes, rotate_weights=True,
                               **kw).reshape(n, kp).T.contiguous()
        for m in ms:
            x = pad_last_dim(torch.randn(m, k, generator=gen, device=dev),
                             256)
            xq, xs = act_encode(x)
            xdec = act_decode(xq, xs)
            small = m <= 16
            forms = [(
                f"itq3_matvec_{suffix}" if small else f"itq3_matmul_{suffix}",
                (lambda x=x: itq3_matvec(x, *planes, rotate_weights=False,
                                         rotate_x=True)) if small else
                (lambda x=x: itq3_matmul(x, *planes, rotate_weights=False)),
                (lambda x=x: itq3_matmul_ref(fwht_ref(x), *planes,
                                             rotate_weights=False))
                if small else (lambda x=x: itq3_matmul_ref(
                    x, *planes, rotate_weights=False)),
                (lambda x=x: x @ w_rot) if small else (lambda x=x: x @ w),
                m * kp * 4, 2 * m * n * kp + (9 * m * kp if small else 0),
                PEAK_F32_FLOPS if small else PEAK_TF32_FLOPS,
                1 if small else 2, KERNEL_REL_TOL)]
            if int8:
                fn = itq3_matvec_int8 if small else itq3_matmul_int8
                name = (f"itq3_matvec_int8_{suffix}" if small
                        else f"itq3_matmul_int8_{suffix}")
                ones = torch.ones_like(planes[2])
                got = fn(xq, torch.ones_like(xs), planes[0], planes[1], ones,
                         planes[3], **kw)
                want = itq3_matmul_int8_ref(xq, torch.ones_like(xs),
                                            planes[0], planes[1], ones,
                                            planes[3], **kw)
                unit[f"{name} {label} M={m}"] = (got - want).abs().max().item()
                forms.append((
                    name,
                    lambda fn=fn, xq=xq, xs=xs: fn(xq, xs, *planes, **kw),
                    lambda xq=xq, xs=xs: itq3_matmul_int8_ref(xq, xs, *planes,
                                                              **kw),
                    lambda xdec=xdec: xdec @ w, m * kp + m * 4,
                    2 * m * n * kp, PEAK_INT8_OPS, 1, INT8_REL_TOL))
            for (name, run, plain, library, xbytes, ops, peak, products,
                 tol) in forms:
                got = run()
                if not torch.equal(got, run()):
                    raise AssertionError(f"{name} {label} M={m}: two calls "
                                         f"differ")
                err, rel = rel_err(got, plain())
                led.add(name, f"{label} ({k}x{n}) M={m}", err=err, rel=rel,
                        ms=device_ms(run), plain_ms=device_ms(plain, reps=1),
                        library_ms=device_ms(library, reps=2),
                        nbytes=xbytes + wbytes + m * n * 4,
                        flops=ops * products, peak_ops=peak, tol=tol)
        del qt, planes, w, w_rot
    torch.cuda.empty_cache()
    if any(v != 0 for v in unit.values()):
        raise AssertionError(f"int8 kernels at the {suffix} widths: unit-"
                             f"scale outputs differ: {unit}")
    return unit


def ladder(plen: int, chunk: int = RECURRENT_CHUNK) -> list:
    """The chunk sizes a ``plen``-token prompt is fed in: each time the
    largest power of two <= ``chunk`` that fits what is left."""
    sizes = []
    while plen:
        c = chunk
        while c > plen:
            c //= 2
        sizes.append(c)
        plen -= c
    return sizes


def recurrent_contract(cfg, *, act_quant: bool, head: bool):
    """The kernels of one decode step (all SLOTS slots) and, as a function
    of its rows, of one ladder chunk of ``cfg``: rwkv6 7 ternary
    projections per layer (r, k, v, g, o and the channel mix's two);
    zamba2 3 per layer (wz, wx, out_proj; wB, wC, wdt stay fp) and the
    shared attention's 4 at each of its ceil(L / every) applications. A
    contraction of M <= 16 rows is the fused matvec, else a 256-point FWHT
    and the matmul; on W3A8 one ``fwht_act_encode`` and the int8 kernel.
    ``head``: the untied ternary head, one more row per step and one on a
    request's last chunk. No attention kernel: rwkv6 has none and zamba2
    serves on the fp cache."""
    if cfg.family == "ssm":
        proj = 7 * cfg.num_layers
    else:
        proj = 3 * cfg.num_layers + 4 * -(-cfg.num_layers // cfg.attn_every)

    def add(per, rows, n):
        small = rows <= 16
        if act_quant:
            per["fwht_act/256"] += n
            per["itq3_matvec_int8" if small else "itq3_matmul_int8"] += n
        else:
            per["itq3_matvec" if small else "itq3_matmul"] += n
            if not small:
                per["fwht/256"] += n

    def per_chunk(rows: int, last: bool):
        per = collections.Counter()
        add(per, rows, proj)
        if head and last:
            add(per, 1, 1)
        return per

    per_step = collections.Counter()
    add(per_step, SLOTS, proj + (1 if head else 0))
    return per_step, per_chunk


def check_recurrent_serving(label, eng, reqs, wall, counts, per_step,
                            per_chunk) -> dict:
    """A counted recurrent serving run held to its contract: every request
    finishes with ``length``, no quarantine; one host sync per decode step
    and per admitted request (its whole ladder); each kernel launched
    exactly ``per_step`` times per step plus ``per_chunk`` over every
    request's ladder. Returns the run's numbers."""
    st = eng.stats()
    bad = [r.rid for r in reqs if r.finish_reason != "length"
           or len(r.out) != MAX_NEW]
    if bad or st["quarantined"]:
        raise AssertionError(f"{label}: requests {bad} did not finish with "
                             f"length / {st['quarantined']} quarantined")
    steps, admitted = st["decode_steps"], len(reqs)
    ladders = [ladder(len(r.prompt)) for r in reqs]
    if (st["host_syncs"] != steps + admitted
            or st["prefill_waves"] != admitted
            or st["prefill_chunks"] != sum(map(len, ladders))):
        raise AssertionError(
            f"{label}: {st['host_syncs']} host syncs, "
            f"{st['prefill_waves']} admissions and {st['prefill_chunks']} "
            f"ladder calls for {steps} steps and {admitted} requests "
            f"({sum(map(len, ladders))} chunks)")
    expected = collections.Counter({k: v * steps for k, v in
                                    per_step.items()})
    for sizes in ladders:
        for i, c in enumerate(sizes):
            expected.update(per_chunk(c, i == len(sizes) - 1))
    if counts != dict(expected):
        raise AssertionError(f"{label}: launches {counts} != expected "
                             f"{dict(expected)}")
    chunk_sizes = sorted({c for sizes in ladders for c in sizes})
    out = dict(
        wall_s=wall, launches=counts, stats=st,
        decode_tok_s=st["tokens_decoded"] / st["decode_seconds"],
        decode_ms_per_step=1e3 * st["decode_seconds"] / steps,
        ms_per_admitted_request=1e3 * st["prefill_seconds"] / admitted,
        ladder_calls=st["prefill_chunks"],
        launches_per_decode_step=dict(per_step),
        launches_per_chunk={c: dict(per_chunk(c, False))
                            for c in chunk_sizes},
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    print(f"  {label}: {admitted} requests / "
          f"{sum(len(r.out) for r in reqs)} tokens in {wall:.2f} s: decode "
          f"{out['decode_tok_s']:.1f} tok/s ({out['decode_ms_per_step']:.1f} "
          f"ms/step over {steps} steps), "
          f"{out['ms_per_admitted_request']:.1f} ms per admitted request "
          f"({st['prefill_chunks']} ladder calls), one host sync per step and "
          f"request, peak memory {out['peak_mem_bytes'] / 2**30:.2f} GiB",
          flush=True)
    print(f"  launches per decode step {dict(per_step)}; per ladder chunk "
          f"{out['launches_per_chunk']} (plus the head's on a request's "
          f"last)", flush=True)
    return out


def recurrent_parity(params, cfg, prompts, dev, *, act_quant: bool) -> dict:
    """Layer-forced logits, kernel path against plain path: a 32-token
    prefill of 4 rows (the matmul) then 4 decode steps (the matvec), each
    layer of both paths on the plain path's input and, after it, the
    kernel path's state (and the layer's KV) overwritten with the plain
    path's, so the paths start every layer from one state; held to 1e-3
    of the largest logit."""
    from repro_torch.models import lm
    from repro_torch.models.layers import Runtime

    rts = [Runtime(backend=b, act_quant=act_quant) for b in ("auto", "ref")]
    toks = torch.as_tensor(np.stack([np.resize(p, RECURRENT_CHUNK)
                                     for p in prompts[:SLOTS]]), device=dev)
    caches = [lm.init_cache(cfg, SLOTS, MAX_LEN, device=dev)
              for _ in range(2)]
    errs, tokens, pos = [], toks, 0
    for step in range(5):
        x = lm._embed(params, tokens)
        for i in range(cfg.num_layers):
            outs = [lm.recurrent_layer_apply(params, x, rt, cfg, i, cache=c,
                                             pos=pos, decode=step > 0)
                    for rt, c in zip(rts, caches)]
            for k, v in caches[0]["ssm"].items():
                v[i].copy_(caches[1]["ssm"][k][i])
            attn = (lm.hybrid_layer(cfg, i)[0] if cfg.family == "hybrid"
                    else None)
            if attn is not None:
                for k, v in caches[0]["attn"].items():
                    v[attn].copy_(caches[1]["attn"][k][attn])
            x = outs[1]
        logits = [lm._head(params, h[:, -1:], rt, cfg)
                  for h, rt in zip(outs, rts)]
        errs.append(rel_err(*logits)[1])
        tokens = logits[1][:, 0].argmax(-1)[:, None]
        pos = RECURRENT_CHUNK + step
    print(f"  layer-forced logits rel error (max |diff| / max |logit|), "
          f"prefill then 4 decode steps: "
          f"{', '.join(f'{e:.2e}' for e in errs)}", flush=True)
    if not max(errs) <= LOGITS_REL_TOL:
        raise AssertionError(f"{cfg.name}: layer-forced logits rel error "
                             f"{max(errs):.3e} > {LOGITS_REL_TOL}")
    return dict(logits_rel=errs)


def recurrent_serve(params, cfg, dev, report: dict, key: str, *,
                    act_quant: bool, head: bool) -> dict:
    """Phase 13 on one case: phase 4's 8 requests over 4 slots through the
    chunk ladder (``prompt_chunk=32``), twice (the first warms up; the
    streams must be equal), the second counted and held to
    :func:`recurrent_contract`; the layer-forced parity; one short traced
    decode window (:func:`decode_window`) for the idle share. Returns the
    counted run's launches."""
    prompts = make_prompts(cfg)

    def serve(count, reqs=prompts, max_new=MAX_NEW):
        return serve_run(params, cfg, reqs, dev, count=count,
                         max_new=max_new, kv_quant=False,
                         act_quant=act_quant,
                         engine_kw={"prompt_chunk": RECURRENT_CHUNK})

    _, first, _, _ = serve(False)
    eng, reqs, wall, counts = serve(True)
    if [r.out for r in reqs] != [r.out for r in first]:
        raise AssertionError(f"{key}: two runs' streams differ")
    per_step, per_chunk = recurrent_contract(cfg, act_quant=act_quant,
                                             head=head)
    out = check_recurrent_serving(f"{key} ({cfg.num_layers} layers)", eng,
                                  reqs, wall, counts, per_step, per_chunk)
    out["cache_bytes"] = eng.stats()["cache_bytes"]
    out["parity"] = recurrent_parity(params, cfg, prompts, dev,
                                     act_quant=act_quant)
    report[key] = out
    del eng
    profile_phase(decode_window(params, cfg, prompts, dev,
                                act_quant=act_quant),
                  report, f"{key}_profile",
                  TABLE.with_name(f"chip_smoke_profile_{key}.txt"),
                  steps=RECURRENT_PROFILE_STEPS)
    return counts


def decode_window(params, cfg, prompts, dev, *, act_quant: bool):
    """An engine with the first 4 requests admitted and one step taken;
    returns the window a trace wraps: RECURRENT_PROFILE_STEPS decode steps
    of the 4 live slots, timed on the host's clock to a synchronize."""
    from repro_torch.models.layers import Runtime
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(params, cfg, slots=SLOTS, max_len=MAX_LEN,
                      prompt_chunk=RECURRENT_CHUNK,
                      rt=Runtime(act_quant=act_quant), device=dev)
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts[:SLOTS])]
    eng.admit(reqs)
    eng.step()
    torch.cuda.synchronize()

    def run():
        t0 = time.perf_counter()
        for _ in range(RECURRENT_PROFILE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        return eng, reqs, time.perf_counter() - t0, None
    return run


def recurrent_phase(dev, report: dict) -> dict:
    """Phase 13: rwkv6-3b (d_model 2560, untied 65,536-column head) and
    zamba2-7b (Mamba2 layers, d_model 3584, one shared attention block
    before every 6th) at full width, ``RECURRENT_LAYERS`` deep, seeded on
    the card and quantized as drawn. (a) rwkv6 on itq3_s; (b) zamba2 on
    itq3_s, its shared attention on the fp cache; (c) zamba2 on W3A8
    under the mixed policy (the tied table q8_0, every other projection
    itq3_s: (b)'s planes, with the table quantized). Returns the float
    kernels' launches of (a) and (b) and the int8 ones of (c)."""
    from repro_torch.configs import mixed_precision_recipe
    from repro_torch.serve.quantized import QuantPolicy, quantize_params

    print("phase 13: the recurrent families at full width, cut in depth, "
          f"through the chunk ladder (prompt_chunk={RECURRENT_CHUNK})",
          flush=True)
    totals = collections.Counter()
    params = None
    for key, arch, act_quant, head in RECURRENT_CASES:
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=RECURRENT_LAYERS[arch])
        if act_quant:
            policy = QuantPolicy.from_dict(mixed_precision_recipe(cfg))
            params = quantize_params(params, policy)
            print(f"  ({key}) W3A8: the mixed policy, act_quant; table "
                  f"{params['embed'].meta.fmt}", flush=True)
        else:
            params = None
            torch.cuda.empty_cache()
            params = seeded_model(cfg, "itq3_s", dev, report, key)
        counts = recurrent_serve(params, cfg, dev, report, key,
                                 act_quant=act_quant, head=head)
        totals.update(counts)
    del params
    torch.cuda.empty_cache()
    return dict(totals)


# --- the frontend families: phase 3's widths, phase 14 ----------------------

# phase 14's model-level loops: 4 images of 576 patches, each with a
# 40-token prompt, then 16 greedy steps (phi); 4 utterances of 1,024
# frames, each with an 8-token decoder prompt, then 32 greedy steps
# (seamless)
VLM_PROMPT, VLM_STEPS = 40, 16
AUDIO_PROMPT, AUDIO_STEPS = 8, 32
FRONTEND_PROFILE_STEPS = 3
PHI_PREFILL_M = SLOTS * (576 + VLM_PROMPT)
# (label, K, N, the Ms, with the int8 pair) at the frontend families'
# widths: phi-3-vision's patch projection at 4 x 576 patches, its
# attention and MLP at a decode step and at the image prefill's rows, its
# untied head; seamless's frame projection (K = 160: one padded block)
# and encoder at 4 x 1,024 frames, its decoder at a decode step, the int8
# pair beside (W3A8 runs on seamless only)
FRONTEND_SHAPES = (
    ("phi frontend_proj", 1024, 3072, (SLOTS * 576,), False),
    ("phi wq/wk/wv/wo", 3072, 3072, (SLOTS, PHI_PREFILL_M), False),
    ("phi gate/up", 3072, 8192, (SLOTS, PHI_PREFILL_M), False),
    ("phi down", 8192, 3072, (SLOTS, PHI_PREFILL_M), False),
    ("phi head", 3072, 32064, (SLOTS,), False),
    ("seamless frontend_proj", 160, 1024, (SLOTS * 1024,), True),
    ("seamless attn", 1024, 1024, (SLOTS, SLOTS * 1024), True),
    ("seamless up", 1024, 4096, (SLOTS, SLOTS * 1024), True),
    ("seamless down", 4096, 1024, (SLOTS, SLOTS * 1024), True),
)
# seamless's self-attention on the int8 cache: 4 slots x 16 KV heads of
# 64, G = 1; a decode step over the 256-key cache and the 8-token
# decoder prompt's prefill
FRONTEND_ATTN = (
    ("decode TQ=1", 1, [9, 64, 130, 255], [0, 0, 0, 0], False, 256),
    ("prefill TQ=8", 8, [8, 8, 8, 8], [0, 0, 0, 0], True, 256),
)


def check_frontend_widths(led: Ledger, gen: torch.Generator, dev,
                          report: dict) -> None:
    """The contraction kernels at the frontend families' widths
    (:func:`check_widths`, ``<kernel>_frontend`` rows), then ``attn_q8``
    at seamless's head_dim 64 with one query head per KV head (R = 64),
    within 1e-4 of its plain version, two calls bit-equal, timed beside
    ``scaled_dot_product_attention`` (``attn_q8_frontend``)."""
    unit = check_widths(led, gen, dev, FRONTEND_SHAPES, "frontend")
    report["frontend_widths_int8_unit_scale_abs_err"] = unit
    check_attn(led, gen, dev, name="attn_q8_frontend", cases=FRONTEND_ATTN,
               kvh=16, g=1, hd=64, model="seamless ")
    print(f"  frontend widths: every kernel within its tolerance, two calls "
          f"bit-equal; int8 with unit scales exact over {len(unit)} shapes; "
          f"attn_q8 at HD 64, G 1 within 1e-4", flush=True)


def frontend_inputs(cfg, prompt: int, dev):
    """Seeded frontend features (SLOTS, frontend_len, frontend_dim) f32 and
    prompts (SLOTS, ``prompt``), drawn from a generator on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    feats = torch.randn(SLOTS, cfg.frontend_len, cfg.frontend_dim,
                        generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (SLOTS, prompt), generator=gen,
                         device=dev, dtype=torch.int32)
    return feats, toks


def frontend_prefix(cfg) -> int:
    """Cache positions ahead of the prompt: a vlm's patch prefix."""
    return cfg.frontend_len if cfg.family == "vlm" else 0


def frontend_contract(cfg, *, kv_quant: bool, act_quant: bool,
                      prompt: int) -> tuple:
    """The kernels of one greedy decode step and of the frontend prefill
    (``lm.forward(frontend_feats=..., last_only=True)``) of SLOTS rows.
    Per decoder layer the self-attention's 4 projections and the MLP's (3
    for swiglu, else 2), plus on an audio model the cross-attention's
    wq and wo (its wk and wv run on the memory at the prefill only). The
    prefill adds ``frontend_proj`` on the SLOTS x frontend_len features;
    a vlm's layers run over prefix and prompt rows together; an audio
    model's encoder layers (4 + MLP each) and the cross-attention's wk,
    wv run on the frame rows, its decoder on the prompt rows. An untied
    head is one more contraction of SLOTS rows (a tied table contracts
    plain). M <= 16 rows is the fused matvec, else a 256-point FWHT and
    the matmul; on W3A8 one ``fwht_act_encode`` and the int8 kernel.
    ``kv_quant``: per layer two head_dim FWHTs, one KV codec and one
    ``attn_q8`` (the encoder and the cross-attention attend plain)."""
    layers, hd = cfg.num_layers, cfg.resolved_head_dim
    mlp = 3 if cfg.activation == "swiglu" else 2
    audio = cfg.family == "audio"
    head = 0 if cfg.tie_embeddings else 1

    def add(per, rows, n):
        small = rows <= 16
        if act_quant:
            per["fwht_act/256"] += n
            per["itq3_matvec_int8" if small else "itq3_matmul_int8"] += n
        else:
            per["itq3_matvec" if small else "itq3_matmul"] += n
            if not small:
                per["fwht/256"] += n

    step, prefill = collections.Counter(), collections.Counter()
    add(step, SLOTS, layers * (4 + mlp + (2 if audio else 0)) + head)
    frames = SLOTS * cfg.frontend_len
    if audio:
        add(prefill, frames, 1 + cfg.encoder_layers * (4 + mlp) + 2 * layers)
        add(prefill, SLOTS * prompt, layers * (4 + mlp + 2))
    else:
        add(prefill, frames, 1)
        add(prefill, frames + SLOTS * prompt, layers * (4 + mlp))
    add(prefill, SLOTS, head)
    if kv_quant:
        for per in (step, prefill):
            per[f"fwht/{hd}"] += 2 * layers
            per[f"fwht_kv/{hd}"] += layers
            per["attn_q8"] += layers
    return ({k: v for k, v in step.items() if v},
            {k: v for k, v in prefill.items() if v})


def frontend_loop(params, cfg, feats, toks, dev, *, steps: int,
                  kv_quant: bool, act_quant: bool, count: bool) -> dict:
    """One frontend prefill (``lm.forward`` with the features, the head on
    each row's last position) and ``steps`` greedy ``lm.decode_step``s
    from its cache, each token fed back on the device and fetched to the
    host once per step (the engine's one transfer). With ``count`` the
    launch counters are reset just before and read just after."""
    from repro_torch.models import lm
    from repro_torch.models.layers import Runtime

    rt = Runtime(kv_quant=kv_quant, act_quant=act_quant)
    cache = lm.init_cache(cfg, SLOTS, MAX_LEN, kv_quant=kv_quant, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if count:
        _build.reset_launches()
    t0 = time.perf_counter()
    logits, cache = lm.forward(params, toks, rt, cfg, frontend_feats=feats,
                               cache=cache, last_only=True)
    tok = lm.sample_tokens(logits[:, 0])
    stream, transfers = [tok.cpu()], 1
    prefill_s = time.perf_counter() - t0
    pos = frontend_prefix(cfg) + toks.shape[1]
    t1 = time.perf_counter()
    for step in range(steps):
        logits, cache = lm.decode_step(params, tok[:, None], cache,
                                       pos + step, rt, cfg)
        tok = lm.sample_tokens(logits[:, 0])
        stream.append(tok.cpu())
        transfers += 1
    decode_s = time.perf_counter() - t1
    counts = dict(_build.launches) if count else None
    return dict(stream=torch.stack(stream).numpy(), prefill_s=prefill_s,
                decode_s=decode_s, transfers=transfers, counts=counts,
                finite=bool(torch.isfinite(logits).all()),
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                cache_bytes=sum(v.numel() * v.element_size()
                                for part in cache.values()
                                for v in part.values()))


def forced_stack(params, cfg, key: str, x, caches, pos, rts, *,
                 memory=None, causal=True):
    """Every layer of ``params[key]`` on both paths (``rts``: kernel,
    plain) from the plain path's input; after each layer the kernel
    path's cache layer (self- and cross-attention) is overwritten with the
    plain path's, so the paths start every layer from one state. Returns
    both paths' last outputs and the largest per-layer rel error."""
    from repro_torch.models import lm

    worst = 0.0
    n = cfg.num_layers if key == "layers" else cfg.encoder_layers
    for i in range(n):
        lp = lm.layer_params(params[key], i)
        outs = [lm._dense_layer_apply(
            lp, x, rt, cfg, pos=pos, causal=causal, memory=memory,
            cache=None if c is None else lm._layer_cache(c, i),
            xcache=lm._xattn_cache(c, i))[0] for rt, c in zip(rts, caches)]
        worst = max(worst, rel_err(*outs)[1])
        if caches[0] is not None:
            for part in ("attn", "xattn"):
                for k, v in caches[0].get(part, {}).items():
                    v[i].copy_(caches[1][part][k][i])
        x = outs[1]
    return outs, worst


def frontend_parity(params, cfg, feats, toks, dev, *, kv_quant: bool,
                    act_quant: bool) -> dict:
    """Layer-forced logits of the frontend prefill and 4 decode steps,
    kernel path against plain path (:func:`forced_stack`), held to 1e-3
    of the largest logit: the frontend projection (held to 1e-4, then
    the plain one feeds both), a vlm's layers over prefix and prompt, an
    audio model's encoder layer by layer (each held to 1e-3; the plain
    memory feeds both decoders) and its decoder."""
    from repro_torch.models import lm
    from repro_torch.models.layers import Runtime

    rts = [Runtime(kv_quant=kv_quant, backend=b, decode_token_cache=False,
                   act_quant=act_quant) for b in ("auto", "ref")]
    caches = [lm.init_cache(cfg, SLOTS, MAX_LEN, kv_quant=kv_quant,
                            device=dev) for _ in range(2)]
    projs = [lm.dense(feats, params["frontend_proj"], rt) for rt in rts]
    proj_rel = rel_err(*projs)[1]
    x, memory, enc_rel = lm._embed(params, toks), None, None
    if cfg.family == "audio":
        outs, enc_rel = forced_stack(params, cfg, "encoder", projs[1],
                                     (None, None), 0, rts, causal=False)
        memory = lm.norm_apply(params["enc_ln_f"], outs[1], cfg.norm)
    else:
        x = torch.cat([projs[1], x], dim=1)
    errs, pos = [], 0
    for step in range(5):
        outs, _ = forced_stack(params, cfg, "layers", x, caches, pos, rts,
                               memory=memory)
        logits = [lm._head(params, h[:, -1:], rt, cfg)
                  for h, rt in zip(outs, rts)]
        errs.append(rel_err(*logits)[1])
        x = lm._embed(params, logits[1][:, 0].argmax(-1)[:, None])
        pos, memory = frontend_prefix(cfg) + toks.shape[1] + step, None
    print(f"  layer-forced logits rel error (max |diff| / max |logit|), "
          f"frontend prefill then 4 decode steps: "
          f"{', '.join(f'{e:.2e}' for e in errs)}; frontend_proj "
          f"{proj_rel:.2e}"
          + ("" if enc_rel is None else f", encoder layers <= {enc_rel:.2e}"),
          flush=True)
    if not (max(errs) <= LOGITS_REL_TOL and proj_rel <= KERNEL_REL_TOL
            and (enc_rel is None or enc_rel <= LOGITS_REL_TOL)):
        raise AssertionError(f"{cfg.name}: layer-forced rel errors {errs}, "
                             f"frontend_proj {proj_rel}, encoder {enc_rel}")
    return dict(logits_rel=errs, frontend_proj_rel=proj_rel,
                encoder_layer_rel=enc_rel)


def frontend_window(params, cfg, feats, toks, dev, *, kv_quant: bool,
                    act_quant: bool):
    """The model-level loop's prefill, run untraced; returns the window a
    trace wraps: FRONTEND_PROFILE_STEPS greedy decode steps, timed on the
    host's clock to a synchronize."""
    import types

    from repro_torch.models import lm
    from repro_torch.models.layers import Runtime

    rt = Runtime(kv_quant=kv_quant, act_quant=act_quant)
    cache = lm.init_cache(cfg, SLOTS, MAX_LEN, kv_quant=kv_quant, device=dev)
    logits, cache = lm.forward(params, toks, rt, cfg, frontend_feats=feats,
                               cache=cache, last_only=True)
    first = lm.sample_tokens(logits[:, 0])
    pos = frontend_prefix(cfg) + toks.shape[1]
    torch.cuda.synchronize()

    def run():
        tok = first
        t0 = time.perf_counter()
        for step in range(FRONTEND_PROFILE_STEPS):
            logits, _ = lm.decode_step(params, tok[:, None], cache,
                                       pos + step, rt, cfg)
            tok = lm.sample_tokens(logits[:, 0])
            tok.cpu()
        torch.cuda.synchronize()
        return types.SimpleNamespace(cfg=cfg), None, \
            time.perf_counter() - t0, None
    return run


def frontend_model_phase(params, cfg, dev, report: dict, key: str, *,
                         kv_quant: bool, act_quant: bool, prompt: int,
                         steps: int) -> dict:
    """The model-level frontend path of phase 14 on one case: seeded
    features and prompts, :func:`frontend_loop` twice (the first warms
    up; the streams must be equal), the second counted and held to
    :func:`frontend_contract` and to one transfer per step; the
    layer-forced parity; a traced decode window for the idle share.
    Returns the counted run's launches."""
    feats, toks = frontend_inputs(cfg, prompt, dev)

    def loop(count):
        return frontend_loop(params, cfg, feats, toks, dev, steps=steps,
                             kv_quant=kv_quant, act_quant=act_quant,
                             count=count)
    first = loop(False)
    run = loop(True)
    if not np.array_equal(run["stream"], first["stream"]):
        raise AssertionError(f"{key}: two runs' streams differ")
    if not run["finite"] or run["transfers"] != steps + 1:
        raise AssertionError(f"{key}: non-finite logits or "
                             f"{run['transfers']} transfers for {steps} "
                             f"steps and one prefill")
    per_step, per_prefill = frontend_contract(
        cfg, kv_quant=kv_quant, act_quant=act_quant, prompt=prompt)
    expected = {k: per_step.get(k, 0) * steps + per_prefill.get(k, 0)
                for k in per_step | per_prefill}
    if run["counts"] != expected:
        raise AssertionError(f"{key}: launches {run['counts']} != expected "
                             f"{expected}")
    out = dict(
        launches=run["counts"], launches_per_decode_step=per_step,
        launches_per_prefill=per_prefill, stream=run["stream"].tolist(),
        prefill_ms=1e3 * run["prefill_s"],
        decode_ms_per_step=1e3 * run["decode_s"] / steps,
        decode_tok_s=SLOTS * steps / run["decode_s"],
        transfers=run["transfers"], peak_mem_bytes=run["peak_mem_bytes"],
        cache_bytes=run["cache_bytes"])
    print(f"  {key}: prefill of {SLOTS} x ({cfg.frontend_len} "
          f"{cfg.frontend} features + {prompt} tokens) "
          f"{out['prefill_ms']:.1f} ms, {steps} greedy steps at "
          f"{out['decode_ms_per_step']:.1f} ms/step "
          f"({out['decode_tok_s']:.1f} tok/s), one transfer per step, two "
          f"runs equal; cache {run['cache_bytes'] / 2**30:.2f} GiB, peak "
          f"memory {run['peak_mem_bytes'] / 2**30:.2f} GiB", flush=True)
    print(f"  launches per decode step {per_step}; per prefill "
          f"{per_prefill}", flush=True)
    out["parity"] = frontend_parity(params, cfg, feats, toks, dev,
                                    kv_quant=kv_quant, act_quant=act_quant)
    report[key] = out
    profile_phase(frontend_window(params, cfg, feats, toks, dev,
                                  kv_quant=kv_quant, act_quant=act_quant),
                  report, f"{key}_profile",
                  TABLE.with_name(f"chip_smoke_profile_{key}.txt"),
                  steps=FRONTEND_PROFILE_STEPS)
    return run["counts"]


def frontend_phase(dev, report: dict) -> dict:
    """Phase 14: the frontend families at full width (phi ``PHI_LAYERS``
    deep, seamless whole), seeded on
    the card and quantized as drawn. (a) phi-3-vision-4.2b on itq3_s
    (head_dim 96: the fp cache): (a1) phase 4's requests through the
    engine, text only, as the reference serves a vlm (the cache 256 +
    576 positions), held as phase 12's paths; (a2) the image path: 4
    images and 40-token prompts in one frontend prefill, 16 greedy decode
    steps. (b) seamless-m4t-medium on itq3_s with ``kv_quant``: 4
    utterances of 1,024 frames through the encoder, 8-token decoder
    prompts, 32 greedy steps. (c) (b) on W3A8 under the mixed policy.
    Returns the float kernels' launches of (a) and (b) and the int8 ones
    of (c)."""
    from repro_torch.configs import mixed_precision_recipe
    from repro_torch.serve.quantized import QuantPolicy

    print("phase 14: the frontend families at full width (phi-3-vision "
          f"cut to {PHI_LAYERS} layers)", flush=True)
    totals = collections.Counter()
    cfg = dataclasses.replace(get_config("phi-3-vision-4.2b"),
                              num_layers=PHI_LAYERS)
    params = seeded_model(cfg, "itq3_s", dev, report, "vlm")
    print("  (a1) text through the engine, as the reference serves a vlm",
          flush=True)
    totals.update(family_serve(params, cfg, dev, report, "vlm_text",
                               kv_quant=False, act_quant=False, head=True))
    positions = report["vlm_text"]["stats"]["cache_bytes"] // (
        2 * cfg.num_layers * SLOTS * cfg.num_kv_heads
        * cfg.resolved_head_dim * 4)
    if positions != MAX_LEN + cfg.frontend_len:
        raise AssertionError(f"vlm engine cache of {positions} positions")
    profile_phase(decode_window(params, cfg, make_prompts(cfg), dev,
                                act_quant=False),
                  report, "vlm_text_profile",
                  TABLE.with_name("chip_smoke_profile_vlm_text.txt"),
                  steps=FRONTEND_PROFILE_STEPS)
    print("  (a2) the image path: lm.forward(frontend_feats=...), then "
          "lm.decode_step", flush=True)
    totals.update(frontend_model_phase(
        params, cfg, dev, report, "vlm_image", kv_quant=False,
        act_quant=False, prompt=VLM_PROMPT, steps=VLM_STEPS))
    del params
    torch.cuda.empty_cache()
    cfg = get_config("seamless-m4t-medium")
    for key, policy, act_quant in (
            ("audio", "itq3_s", False),
            ("audio_w3a8", QuantPolicy.from_dict(mixed_precision_recipe(cfg)),
             True)):
        print(f"  ({'c' if act_quant else 'b'}) {cfg.name}"
              + (": the mixed policy, act_quant" if act_quant else ""),
              flush=True)
        params = seeded_model(cfg, policy, dev, report, key)
        totals.update(frontend_model_phase(
            params, cfg, dev, report, key, kv_quant=True,
            act_quant=act_quant, prompt=AUDIO_PROMPT, steps=AUDIO_STEPS))
        del params
        torch.cuda.empty_cache()
    return dict(totals)


# --- phase 15: tensor-parallel serving ----------------------------------------
# (a) On one card: every N/m shard of qwen1.5-0.5b's projections and of
# olmoe-1b-7b's expert stacks, and every E/m shard of the stacks, through the
# launch the TP path makes (the whole launch's cut), bitwise against the full
# launch; attn_q8 at 16 KV heads against its 8- and 4-head shards. (b) The
# TP engine itself over NCCL, one spawned process per card.

TP_WAYS = (2, 4)
# qwen1.5-0.5b at full width (d_model 1024, 16 MHA heads of 64, d_ff 2816):
# wq, wk, wv and wo share one shape, gate and up another
TP_PROJ = (("qwen1.5 wq/wk/wv/wo", 1024, 1024),
           ("qwen1.5 gate/up", 1024, 2816), ("qwen1.5 down", 2816, 1024))
# olmoe-1b-7b's expert stacks, 64 experts each
TP_STACKS = (("olmoe gate/up", 2048, 1024), ("olmoe down", 1024, 2048))
# qwen3-moe-235b-a22b's stacks (128 experts), checked untimed: its TP layout
# at full width, which no one card can serve at full depth
TP_QWEN3_STACKS = tuple((f"qwen3-moe {name}", k, n)
                        for name, (k, n) in QWEN3_PROJ.items())
TP_QWEN3_M = (("decode", 4), ("prefill", 20))
# a decode step of 4 slots and a prefill wave of 4 x 64-token buckets
TP_M = (("decode", SLOTS), ("prefill", SLOTS * PROMPT_PAD))
# (label, KV heads, query heads per KV head, head_dim, timed): qwen1.5-
# 0.5b's MHA, and qwen3-moe-235b-a22b's 4 KV heads of 16 queries each
TP_ATTN = (("qwen1.5-0.5b", 16, 1, 64, True),
           ("qwen3-moe-235b-a22b", 4, 16, 128, False))
# (b): (arch, act_quant) served through the mesh; with 2 or more cards also
# olmoe-1b-7b (expert parallel) and smollm-135m (3 KV heads: the
# replicated GQA fallback) on the float path
TP_SERVE = (("qwen1.5-0.5b", False), ("qwen1.5-0.5b", True))
TP_SERVE_MULTI = (("olmoe-1b-7b", False), ("smollm-135m", False))
TP_NEW = 16  # new tokens per request in (b)
TP_FORCED = 32  # tokens of (b)'s teacher-forced prefill
TP_DIR = ROOT / "build" / "chip_smoke_tp"


def _rows_of(qt, lo: int, n: int, axis: int):
    """``qt`` with rows ``lo .. lo+n`` of axis ``axis`` of every packed
    array (contiguous copies): an N or an E shard, its meta unchanged (a
    placed leaf keeps its whole weight's meta)."""
    from repro_torch.core.quantize import QTensor

    return QTensor({k: v.narrow(axis, lo, n).contiguous()
                    for k, v in qt.data.items()}, qt.meta)


def _local_meta(qt, n: int):
    from repro_torch.core.quantize import QTensor

    return QTensor(qt.data, dataclasses.replace(qt.meta,
                                                shape=(qt.meta.k, n)))


def _staged(x, act: bool, small: bool):
    """The kernel's operands as the kernel path stages them: x padded
    (the fused matvec rotates it), rotated (the tiled kernel), or the int8
    codes and row scales."""
    xp = pad_last_dim(x, 256).contiguous()
    if act:
        xq, xs = fwht_act_encode(xp.reshape(-1, xp.shape[-1]), block=256,
                                 rotate=True, dsign=None)
        return xq.reshape(xp.shape), xs.reshape(*xp.shape[:-1], 1)
    if small:
        return (xp,)
    return (fwht(xp.reshape(-1, xp.shape[-1]), 256).reshape(xp.shape),)


def _kernel_call(act: bool, small: bool, ops, planes, cut):
    kw = dict(fivelevel=False, sub_blocks=0, cut=cut)
    if act:
        fn = itq3_matvec_int8 if small else itq3_matmul_int8
        return lambda: fn(*ops, *planes, **kw)
    if small:
        return lambda: itq3_matvec(*ops, *planes, rotate_weights=False,
                                   rotate_x=True, **kw)
    return lambda: itq3_matmul(*ops, *planes, rotate_weights=False, **kw)


def _shard_checks(x, qt, full, act: bool, e: int, counts: dict,
                  broken: list) -> None:
    """Every N/m shard (a stack's E/m shards too) for m in TP_WAYS: the TP
    launch (whole launch's cut) equal to ``full``'s columns bit for bit;
    the shard under its own rule's cut counted where its cut differs and
    where its bits do, those listed in ``broken`` with their error over
    the largest output."""
    from repro_torch.core.qlinear import launch_cut, qmatmul, qmatmul_experts
    from repro_torch.serve import tp as tp_mod

    m, k, n = x.shape[-2], qt.meta.k, qt.meta.n
    kb = qt.data["plane2"].shape[-2]
    whole = launch_cut(m, kb, act_quant=act, e=e, n=n)
    splits = [("N", 0 if e == 1 else 1, n)] + ([("E", 0, e)] if e > 1
                                                else [])
    for ways in TP_WAYS:
        for what, axis, size in splits:
            per = size // ways
            for r in range(ways):
                cols = slice(r * per, (r + 1) * per)
                sh = _rows_of(qt, r * per, per, axis)
                if e == 1:
                    got = tp_mod.shard_qmatmul(x, sh, mode="activations",
                                               backend="auto", act_quant=act)
                    own = qmatmul(x, _local_meta(sh, per), backend="auto",
                                  act_quant=act)
                    want, own_cut = full[:, cols], launch_cut(
                        m, kb, act_quant=act, e=1, n=per)
                else:
                    xe = x if what == "N" else x[cols]
                    got = qmatmul_experts(xe, sh, backend="auto",
                                          act_quant=act, cut_from=(e, n))
                    own = qmatmul_experts(xe, sh, backend="auto",
                                          act_quant=act)
                    want = full[..., cols] if what == "N" else full[cols]
                    own_cut = launch_cut(m, kb, act_quant=act,
                                         e=e if what == "N" else per,
                                         n=per if what == "N" else n)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"TP shard {what}/{ways} #{r} (K={k}, N={n}, E={e}, "
                        f"M={m}, act_quant={act}): differs from the full "
                        f"launch")
                counts["checked"] += 1
                counts["own_cut_differs"] += tuple(own_cut) != tuple(whole)
                if not torch.equal(own, want):
                    counts["own_cut_broken"] += 1
                    broken.append(dict(
                        k=k, n=n, e=e, m=m, act_quant=act,
                        shard=f"{what}/{ways} #{r}", whole_cut=list(whole),
                        own_cut=list(own_cut),
                        rel=((own - want).abs().max()
                             / want.abs().max()).item()))


def _time_widths(label, x, qt, act: bool, e: int, rows: list) -> None:
    """The path's kernel alone at the whole width and at one shard of each
    of TP_WAYS (N/m, or E/m for a stack), under the whole launch's cut,
    beside its bound and ``x @ W`` (``bmm`` for a stack) on the
    dequantized f32 weight (the IFWHT'd one for the fused matvec)."""
    from repro_torch.core.qlinear import launch_cut

    m, k, n = x.shape[-2], qt.meta.k, qt.meta.n
    kb = qt.data["plane2"].shape[-2]
    kp, small = kb * 256, m <= 16
    cut = launch_cut(m, kb, act_quant=act, e=e, n=n)
    ops = _staged(x, act, small)
    name = ("itq3_matvec" if small else "itq3_matmul") + (
        "_int8" if act else "") + ("_experts" if e > 1 else "")
    for ways in (1,) + TP_WAYS:
        pn, pe = (n // ways, 1) if e == 1 else (n, e // ways)
        sh = (_rows_of(qt, 0, pn, 0) if e == 1 else _rows_of(qt, 0, pe, 0))
        xs = ops if e == 1 else tuple(o[:pe] for o in ops)
        run = _kernel_call(act, small, xs, _planes(sh), cut)
        wd = dequant_blocks(*_planes(sh), rotate_weights=small and not act,
                            fivelevel=False, sub_blocks=0)
        xin = pad_last_dim(x if e == 1 else x[:pe], 256)
        if e == 1:
            wd = wd.reshape(pn, kp).T.contiguous()
            lib = lambda xin=xin, wd=wd: xin @ wd  # noqa: E731
        else:
            wd = wd.reshape(pe, pn, kp).transpose(1, 2).contiguous()
            lib = lambda xin=xin, wd=wd: torch.bmm(xin, wd)  # noqa: E731
        rows_m = pe * m
        xbytes = rows_m * kp * (1 if act else 4) + (rows_m * 4 if act else 0)
        flops = 2 * rows_m * pn * kp + (9 * rows_m * kp if small and not act
                                        else 0)
        peak = (PEAK_INT8_OPS if act else
                PEAK_F32_FLOPS if small else PEAK_TF32_FLOPS)
        b, by = bound_ms(xbytes + weight_bytes(sh) + rows_m * pn * 4,
                         flops * (1 if act or small else 2), peak)
        width = "whole" if ways == 1 else f"{'N' if e == 1 else 'E'}/{ways}"
        row = dict(kernel=name, shape=f"{label} M={m}", width=width,
                   cut=list(cut), ms=device_ms(run), bound_ms=b, bound_by=by,
                   library_ms=device_ms(lib, reps=2))
        rows.append(row)
        print(f"  {name:24s} {row['shape']:36s} {width:6s} kernel "
              f"{row['ms']:.4f} ms  library {row['library_ms']:.4f} ms  "
              f"bound {b:.4f} ms ({by})", flush=True)
        del wd


def tp_contraction_shards(gen, dev, report: dict) -> None:
    """Phase 15 (a), the four contraction kernels: qwen1.5-0.5b's three
    projection shapes and olmoe-1b-7b's two expert stacks, M = 4 and a
    prefill wave, the float and the W3A8 pair, each shard checked
    (:func:`_shard_checks`) and the widths timed (:func:`_time_widths`);
    qwen3-moe-235b-a22b's stacks checked untimed."""
    from repro_torch.core.qlinear import qmatmul, qmatmul_experts

    rows, broken = [], []
    counts = collections.Counter()
    cases = [(label, k, n, 1, TP_M, True) for label, k, n in TP_PROJ] + [
        (label, k, n, OLMOE_EXPERTS, EXPERT_M, True)
        for label, k, n in TP_STACKS] + [
        (label, k, n, QWEN3_EXPERTS, TP_QWEN3_M, False)
        for label, k, n in TP_QWEN3_STACKS]
    for label, k, n, e, ms, timed in cases:
        lead = (e,) if e > 1 else ()
        qt = formats.quantize(torch.randn(*lead, k, n, generator=gen,
                                          device=dev) / math.sqrt(k),
                              "itq3_s")
        for _, m in ms:
            x = torch.randn(*lead, m, k, generator=gen, device=dev)
            for act in (False, True):
                full = (qmatmul_experts(x, qt, backend="auto", act_quant=act)
                        if e > 1 else qmatmul(x, qt, backend="auto",
                                              act_quant=act))
                _shard_checks(x, qt, full, act, e, counts, broken)
                if timed:
                    _time_widths(f"{label} ({k}x{n}"
                                 + (f", E={e})" if e > 1 else ")"), x, qt,
                                 act, e, rows)
        del qt
        torch.cuda.empty_cache()
    report["tp_shard_widths"] = rows
    report["tp_shards"] = dict(counts)
    report["tp_shards_own_cut_broken"] = broken
    for b in broken:
        print(f"  under its own cut {b['own_cut']} (whole {b['whole_cut']}): "
              f"{'int8' if b['act_quant'] else 'float'} K={b['k']} "
              f"N={b['n']} E={b['e']} M={b['m']} {b['shard']}, "
              f"{b['rel']:.1e} of the largest output", flush=True)
    print(f"  {counts['checked']} shard launches equal to the full launch's "
          f"columns bit for bit under the whole launch's cut; under their "
          f"own rule's cut {counts['own_cut_differs']} would take another "
          f"cut and {counts['own_cut_broken']} would give other bits",
          flush=True)


def _head_cache(cache: dict, heads: slice) -> dict:
    return {k: v if k == "table" else v[:, heads].contiguous()
            for k, v in cache.items()}


def tp_attention_shards(gen, dev, report: dict) -> None:
    """Phase 15 (a), the attention: decode and a 64-token prefill at each
    ``TP_ATTN`` model's KV heads (4 slots, a 256-position cache), dense and
    paged (16-key blocks over a shuffled pool): every 2- and 4-way head
    shard of ``decode_attn_q8`` / ``prefill_attn_q8`` (the calls the TP
    path makes on its heads) equal to the full call's heads bit for bit;
    at qwen1.5-0.5b's shape ``attn_q8`` is timed at 16, 8 and 4 KV heads
    beside its bound and ``scaled_dot_product_attention``."""
    b, t, bs = SLOTS, MAX_LEN, BLOCK_SIZE
    maxb = t // bs
    kv_len = torch.tensor([5, 64, 130, 191], dtype=torch.int64, device=dev)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(*shape):
        return (torch.rand(*shape, generator=gen, device=dev) * 0.05
                + 1e-3).half()

    def planes(lead, kvh, length, hd):
        return {"k": codes(lead, kvh, length, hd),
                "v": codes(lead, kvh, length, hd),
                "k_scale": scales(lead, kvh, length, 1),
                "v_scale": scales(lead, kvh, length, 1)}

    checked, rows = 0, []
    for label, kvh, g, hd, timed in TP_ATTN:
        paged = planes(b * maxb + 1, kvh, bs, hd)
        paged["table"] = (1 + torch.randperm(
            b * maxb, generator=gen, device=dev)).reshape(b, maxb).to(
            torch.int32)
        kt = (codes(b, kvh, 1, hd), scales(b, kvh, 1, 1))
        vt = (codes(b, kvh, 1, hd), scales(b, kvh, 1, 1))
        calls = {
            "decode": (torch.randn(b, kvh, g, 1, hd, generator=gen,
                                   device=dev),
                       lambda q, c, hs: decode_attn_q8(
                           q, c, tuple(a[:, hs].contiguous() for a in kt),
                           tuple(a[:, hs].contiguous() for a in vt), kv_len,
                           backend="auto")),
            "prefill": (torch.randn(b, kvh, g, PROMPT_PAD, hd, generator=gen,
                                    device=dev),
                        lambda q, c, hs: prefill_attn_q8(
                            q, c, kv_len + PROMPT_PAD, kv_len,
                            backend="auto"))}
        for layout, cache in (("dense", planes(b, kvh, t, hd)),
                              ("paged", paged)):
            for phase, (q, call) in calls.items():
                full = call(q, cache, slice(None))
                for ways in TP_WAYS:
                    per = kvh // ways
                    for r in range(ways):
                        hs = slice(r * per, (r + 1) * per)
                        got = call(q[:, hs].contiguous(),
                                   _head_cache(cache, hs), hs)
                        if not torch.equal(got, full[:, hs]):
                            raise AssertionError(
                                f"attn {label} {layout} {phase}: head "
                                f"shard {r} of {ways} differs from the "
                                f"full call")
                        checked += 1
        if not timed:
            continue
        lens = [5, 64, 130, 191]
        for heads in (kvh,) + tuple(kvh // w for w in TP_WAYS):
            kl = [x for x in lens for _ in range(heads)]
            args, kw = _attn_case(gen, dev, r=b * heads, tq=1, g=g, hd=hd,
                                  t=t, kv_len=kl, q_offset=[0] * len(kl),
                                  causal=False)
            mask, keys_read, pairs = attn_extent(kl, [0] * len(kl), 1, t,
                                                 False)
            q = args[0]
            nbytes = (2 * q.numel() * 4 + sum(keys_read) * 2 * (hd + 2)
                      + 2 * len(kl) * 4 + 2 * (q.numel() // hd) * 4)
            bnd, by = bound_ms(nbytes, pairs * g * 4 * hd)
            row = dict(kernel="attn_q8", shape=f"{label} decode R={b * heads}"
                       f" G={g} HD={hd} T={t}", kv_heads=heads,
                       ms=device_ms(lambda: attn_q8(*args, **kw)),
                       library_ms=device_ms(_attn_library(args, kw, mask,
                                                          dev)),
                       bound_ms=bnd, bound_by=by)
            rows.append(row)
            print(f"  attn_q8 {heads:2d} KV heads ({row['shape']}): kernel "
                  f"{row['ms']:.4f} ms  library {row['library_ms']:.4f} ms  "
                  f"bound {bnd:.4f} ms ({by})", flush=True)
    report["tp_attn_heads"] = rows
    report["tp_attn_shards_checked"] = checked
    print(f"  {checked} attention head shards (decode and prefill, dense and "
          f"paged; qwen1.5-0.5b and qwen3-moe-235b-a22b) equal to the full "
          f"call's heads bit for bit", flush=True)


def tp_serve_case(arch: str, act: bool, ckpt: Path, mesh, dev) -> dict:
    """One serving run of phase 15 (b), on one device (``mesh`` None) or
    as one rank of the mesh: boot from ``ckpt`` (restore-to-sharding under
    a mesh), serve phase 4's 8 requests (``TP_NEW`` new tokens, counted
    launches), then teacher-forced logits: a ``TP_FORCED``-token prefill of
    4 prompts and one forced decode step through the engine's params and
    runtime."""
    from repro_torch.models import lm
    from repro_torch.models.layers import Runtime
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(arch)
    t0 = time.perf_counter()
    eng = ServeEngine.from_checkpoint(
        str(ckpt), cfg, mesh=mesh, device=dev, slots=SLOTS, max_len=MAX_LEN,
        prompt_pad=PROMPT_PAD, rt=Runtime(kv_quant=True, act_quant=act))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    reqs = [Request(rid=i, prompt=p, max_new=TP_NEW)
            for i, p in enumerate(make_prompts(cfg))]
    _build.reset_launches()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launches)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(SLOTS, TP_FORCED))
    cache = eng._new_cache(cfg, SLOTS, eng.rt)
    pre, _ = lm.forward(eng.params, toks, eng.rt, cfg, cache=cache, pos=0,
                        last_only=True)
    nxt = rng.integers(0, cfg.vocab_size, size=(SLOTS, 1))
    step, _ = lm.decode_step(eng.params, nxt, cache, TP_FORCED, eng.rt, cfg)
    st = eng.stats()
    out = dict(streams=[list(r.out) for r in reqs], counts=counts,
               wall_s=wall, boot_s=boot_s,
               ms_per_step=1e3 * st["decode_seconds"] / st["decode_steps"],
               cache_bytes=st["cache_bytes"],
               logits=(pre.cpu(), step.cpu()),
               reasons=[r.finish_reason for r in reqs])
    if mesh is not None:
        out.update(devices=st["devices"], tp_shard_map=st["tp_shard_map"],
                   cache_bytes_per_device=st["cache_bytes_per_device"])
    del eng, cache
    torch.cuda.empty_cache()
    return out


def tp_rank(rank: int, world: int, store: str, cases, out_dir: str) -> None:
    """One rank of phase 15 (b), in a process of its own on ``cuda:rank``:
    join the NCCL group through the file store, serve every case through
    the mesh and save the results for the parent."""
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)
    mesh = make_host_mesh(1, world, device=dev, init_method=store,
                          rank=rank, world_size=world)
    try:
        res = {key: tp_serve_case(arch, act, Path(out_dir) / arch, mesh, dev)
               for key, arch, act in cases}
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def tp_phase(dev, report: dict, shards: bool = True) -> dict:
    """Phase 15: tensor-parallel serving. (a) On one card, the shard
    launches of the contraction kernels and the attention, bitwise
    against the full launches, and their times at each width. (b) qwen1.5-
    0.5b at full width and depth, seeded on the card, saved, then served
    through ``ServeEngine.from_checkpoint(mesh=...)`` by ``world =
    min(cards, 4)`` spawned NCCL ranks, on the float path and on W3A8:
    every rank's streams equal to the single-device engine's (booted from
    the same checkpoint) token for token, its teacher-forced logits equal
    bit for bit and its launches equal the single-device run's; with 2 or
    more cards also olmoe-1b-7b (expert parallel) and smollm-135m (the
    GQA fallback). ``shards=False`` skips (a). Returns the mesh runs'
    launches (rank 0, summed over the cases)."""
    from repro_torch.models import lm
    from repro_torch.checkpoint import ckpt as ckpt_mod

    if shards:
        print("phase 15 (a): tensor-parallel shard launches at qwen1.5-"
              "0.5b's and olmoe-1b-7b's widths, bitwise against the full "
              "launches", flush=True)
        gen = torch.Generator(device=dev)
        gen.manual_seed(15)
        tp_contraction_shards(gen, dev, report)
        tp_attention_shards(gen, dev, report)

    world = min(torch.cuda.device_count(), 4)
    print(f"phase 15 (b): tp_world {world}: ServeEngine.from_checkpoint("
          f"mesh=...) over NCCL, {world} spawned rank(s)", flush=True)
    if world == 1:
        print("  one card: the mesh path runs at world 1 (every leaf and "
              "the cache replicated, no collective); not evidence of "
              "sharding", flush=True)
    serve = TP_SERVE + (TP_SERVE_MULTI if world > 1 else ())
    cases = [(arch + ("_w3a8" if act else ""), arch, act)
             for arch, act in serve]
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    for arch in dict.fromkeys(a for a, _ in serve):
        t0 = time.perf_counter()
        params = lm.init_quantized_params(get_config(arch), "itq3_s", seed=0,
                                          device=dev)
        ckpt_mod.save(str(TP_DIR / arch), 0, params)
        del params
        torch.cuda.empty_cache()
        print(f"  {arch}: seeded, quantized and saved in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    base = {key: tp_serve_case(arch, act, TP_DIR / arch, None, dev)
            for key, arch, act in cases}
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        tp_rank, args=(world, f"file://{TP_DIR / 'store'}", cases,
                       str(TP_DIR)), nprocs=world, start_method="spawn")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(TP_DIR / f"rank{r}.pt") for r in range(world)]
    out = {"world": world, "spawn_s": spawn_s, "cases": {}}
    counts = collections.Counter()
    for key, arch, act in cases:
        want = base[key]
        if set(want["reasons"]) != {"length"}:
            raise AssertionError(f"{key}: single-device finish reasons "
                                 f"{want['reasons']}")
        # the path's kernels, each launched in the counted run
        path = {f"itq3_{form}{'_int8' if act else ''}"
                for form in ("matvec", "matmul")} | {"attn_q8"}
        if get_config(arch).family == "moe":
            path |= {f"itq3_{form}_experts" for form in ("matvec",
                                                           "matmul")}
        missing = sorted(k for k in path if not want["counts"].get(k))
        if missing:
            raise AssertionError(f"{key}: {missing} launched no time")
        row = dict(single_ms_per_step=want["ms_per_step"],
                   cache_bytes=want["cache_bytes"], ranks=[])
        for r, res in enumerate(ranks):
            got = res[key]
            if got["streams"] != want["streams"]:
                raise AssertionError(f"{key} rank {r}: streams differ from "
                                     f"the single-device engine's")
            if not all(torch.equal(a, b) for a, b in zip(got["logits"],
                                                         want["logits"])):
                raise AssertionError(f"{key} rank {r}: teacher-forced "
                                     f"logits differ from one device's")
            if got["counts"] != want["counts"]:
                raise AssertionError(f"{key} rank {r}: launches "
                                     f"{got['counts']} != the single "
                                     f"device's {want['counts']}")
            row["ranks"].append({k: got[k] for k in (
                "ms_per_step", "cache_bytes_per_device", "devices",
                "tp_shard_map", "boot_s", "wall_s")})
            print(f"  {key} rank {r}: tp_world {got['devices']}, "
                  f"cache_bytes_per_device {got['cache_bytes_per_device']} "
                  f"of {got['cache_bytes']}, {got['ms_per_step']:.3f} ms/step "
                  f"(one device {want['ms_per_step']:.3f}), booted in "
                  f"{got['boot_s']:.1f} s", flush=True)
        counts.update(ranks[0][key]["counts"])
        out["cases"][key] = row
        print(f"  {key}: {world} rank(s) equal to the single-device engine: "
              f"{sum(map(len, want['streams']))} tokens, teacher-forced "
              f"logits bit for bit, launches {want['counts']}", flush=True)
    report["tp"] = out
    shutil.rmtree(TP_DIR, ignore_errors=True)
    return dict(counts)


# --- phase 16: training on one card, then serving the trained weights ------

# (a) the reference launcher's default batch (8 x 256 tokens); warmup 5 and
# lr 3e-3, so 30 steps move the loss of the full-width model
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 30
TRAIN_KW = dict(lr_peak=3e-3, warmup=5, total_steps=TRAIN_STEPS)
# (b) and (c): gradients within TRAIN_GRAD_TOL of each leaf's largest
# element (f32 sums in two orders), then the params. AdamW's first steps
# move a param by about lr * sign(g), so an element whose gradient sits at
# the noise floor of its sum can take the other sign and part by up to
# 2 lr: an element outside the param tolerance passes only where its
# reference gradient is under FLIP_FLOOR of its leaf's largest, at most
# FLIP_SHARE of a leaf's elements, each counted and printed.
TRAIN_GRAD_TOL, FLIP_FLOOR, FLIP_SHARE = 5e-5, 1e-4, 1e-3
CPU_BATCH, CPU_SEQ = 4, 64  # (c) at reduced() size
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"


def train_steps(cfg, state, *, steps: int, compute_dtype,
                batch=(TRAIN_BATCH, TRAIN_SEQ), remat: bool = True,
                remat_policy: str = "dots", num_micro: int = 1):
    """``steps`` train steps of ``cfg`` from ``state`` over the corpus's
    first batches (the reference launcher's corpus, seed 17). Returns
    (state, per-step metrics as floats, per-step host ms ending in the
    metrics' transfer, peak device memory: None off the card)."""
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.models.layers import Runtime
    from repro_torch.train import loop

    step = loop.make_train_step(cfg, Runtime(capacity_factor=2.0),
                                remat=remat, remat_policy=remat_policy,
                                num_micro=num_micro,
                                compute_dtype=compute_dtype, **TRAIN_KW)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=17)
    cuda = state.step.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    metrics, ms = [], []
    for s in range(steps):
        b = corpus.batch(s, *batch)
        t0 = time.perf_counter()
        state, m = step(state, b)
        m = {k: float(v) for k, v in m.items()}  # waits for the step
        ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    return state, metrics, ms, peak


def xent_grads(cfg, params, batch: dict):
    """The f32 train loss's gradients (``forward_xent`` + 0.01 aux, no
    remat) of ``params`` on ``batch``."""
    from repro_torch.models import lm
    from repro_torch.models.layers import Runtime
    from repro_torch.train.grad import value_and_grad

    def loss(p, b):
        xent, aux = lm.forward_xent(p, b["tokens"], b["labels"],
                                    Runtime(capacity_factor=2.0), cfg)
        return xent + 0.01 * aux, aux
    dev = params["embed"].device
    return value_and_grad(loss, params, {k: torch.as_tensor(v, device=dev)
                                         for k, v in batch.items()})[1]


def hold_grads(label: str, want, got) -> float:
    """Each leaf of ``got`` within TRAIN_GRAD_TOL of ``want``'s largest
    element; returns the worst share."""
    from repro_torch.train.tree import tree_leaves

    worst = 0.0
    for i, (a, b) in enumerate(zip(tree_leaves(want), tree_leaves(got))):
        a = a.double()  # on want's device: a card's trees stay there
        b = b.to(a.device).double()
        err = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
        worst = max(worst, err)
        if not err <= TRAIN_GRAD_TOL:
            raise AssertionError(f"{label}: gradient leaf {i} parts by "
                                 f"{err:.2e} of its largest")
    return worst


def hold_params(label: str, want, got, ref_grads, tol: float) -> dict:
    """Params within ``tol``, or parted at a noise-floor gradient (see
    FLIP_FLOOR) of ``ref_grads`` (a tree, or a list of them: one per step,
    the floor at any of them). Returns the largest difference and the
    flips."""
    from repro_torch.train.tree import tree_leaves

    steps = ref_grads if isinstance(ref_grads, list) else [ref_grads]
    worst, flips = 0.0, 0
    for i, (a, b) in enumerate(zip(tree_leaves(want), tree_leaves(got))):
        d = (a.double() - b.to(a.device).double()).abs()
        worst = max(worst, float(d.max()))
        apart = d > tol
        if not bool(apart.any()):
            continue
        floor = torch.zeros_like(apart)
        for tree in steps:
            g = tree_leaves(tree)[i].abs().to(a.device)
            floor |= g < FLIP_FLOOR * g.max()
        if bool((apart & ~floor).any()) or float(apart.double().mean()) > (
                FLIP_SHARE):
            raise AssertionError(f"{label}: param leaf {i} parts by "
                                 f"{float(d.max()):.2e} beyond the flips "
                                 f"of noise-floor gradients")
        flips += int(apart.sum())
    return {"max_abs": worst, "flips": flips}


def train_work(cfg, b: int, t: int) -> tuple[float, float]:
    """(operations, bytes) of one train step of a dense model on B x T
    tokens. Operations: the forward's matmuls (the layers' projections
    and the tied head) and its attention products (every T x T score, as
    the plain attention computes them), three times (the forward and the
    backward pass), plus what remat "dots" recomputes: the attention's
    products and the head (checkpointed per chunk). Bytes: the f32 params
    read by the forward and the backward pass, the gradients written, and
    AdamW's reads of params, gradients and both moments and its three
    writes; activations are not counted."""
    d, f, v, n = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    qd, kvd = cfg.num_heads * cfg.resolved_head_dim, (
        cfg.num_kv_heads * cfg.resolved_head_dim)
    layer = 2 * d * qd + 2 * d * kvd + 3 * d * f
    attn = n * 4 * b * t * t * qd
    head = 2 * b * t * d * v
    ops = 3 * (2 * b * t * n * layer + head + attn) + attn + head
    params = n * (layer + 2 * d) + v * d + d
    return ops, 10 * 4 * params


TRAIN_PROFILE_STEPS = 2


def train_profile(cfg, state) -> dict:
    """TRAIN_PROFILE_STEPS f32 steps (remat "dots") under
    ``torch.profiler``: the device's busy time (the self device time of
    every kernel and copy, one stream), the idle share of the host wall,
    aten calls per step and the five costliest device kernels. Tracing
    slows the host, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, ms, _ = train_steps(cfg, state, steps=TRAIN_PROFILE_STEPS,
                                  compute_dtype=torch.float32)
    events = prof.key_averages()
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_events) / 1e6
    wall = sum(ms) / 1e3
    ops = sum(e.count for e in events if e.device_type == DeviceType.CPU
              and e.key.startswith("aten::"))
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:5]
    return dict(wall_s=wall, device_busy_s=busy, idle_share=1 - busy / wall,
                aten_calls_per_step=ops / TRAIN_PROFILE_STEPS,
                top_kernels_ms_per_step=[
                    (e.key[:60], e.self_device_time_total / 1e3
                     / TRAIN_PROFILE_STEPS) for e in top])


def _bits(x: float) -> str:
    return float(x).hex()


def _gib(nbytes) -> str:
    """Peak memory for a line: "not measured" off the card."""
    return "not measured" if nbytes is None else f"{nbytes / 2**30:.2f} GiB"


def serve_trained(ckpt_dir: Path, cfg, dev, out: dict):
    """A trained checkpoint through the serve launcher's ``--ckpt-dir``
    boot (``launch/serve.py:restore_trained``), ``itq3_s`` through the
    ``quantize_blocks`` kernel, then phase 4's requests with ``kv_quant``:
    launches exactly phase 4's contract, a second run's streams and
    launches equal, and phase 5's layer-forced parity. Returns (the fp
    params, the quantized params, the counted run's launches)."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve.quantized import quantize_params

    t0 = time.perf_counter()
    params, _ = serve_mod.restore_trained(str(ckpt_dir), cfg, dev)
    _build.reset_launches()
    q = quantize_params(params, "itq3_s")
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    quant_launches = dict(_build.launches)
    if not quant_launches.get("quantize_blocks"):
        raise AssertionError(f"quantizing launched {quant_launches}")
    out["boot"] = dict(boot_s=boot_s, quantize_launches=quant_launches)
    print(f"  --ckpt-dir boot and itq3_s in {boot_s:.1f} s "
          f"({quant_launches})", flush=True)
    prompts = make_prompts(cfg)
    eng, reqs, wall, counts = serve_run(q, cfg, prompts, dev, count=True)
    out["serve"] = check_serving("trained float path", eng, reqs, wall,
                                 counts, cfg, matvec="itq3_matvec",
                                 matmul="itq3_matmul")
    _, again, _, counts2 = serve_run(q, cfg, prompts, dev, count=True)
    if [r.out for r in again] != [r.out for r in reqs] or counts2 != counts:
        raise AssertionError("two runs on the trained weights differ")
    print("  a second run: streams and launches equal", flush=True)
    parity_phase(q, cfg, prompts, dev, out, "parity")
    return params, q, counts


def train_phase(dev, report: dict) -> dict:
    """Phase 16: smollm-135m at full width and depth trained on the card,
    then served from its checkpoint. (a) TRAIN_STEPS steps in bf16
    autocast and in f32 (TF32 off) from one seeded state: the loss finite
    and falling (the mean of the last 5 below the first 5's); ms/step,
    tokens/s, peak memory; no kernel of ``csrc/`` launched; a traced
    window of f32 steps (``train_profile``). (b) One f32
    step under remat "dots", "none" and none at all: equal loss and gnorm
    (their bits printed), each one's peak memory; accumulation over 4
    micro-batches against the whole batch at the peak lr: loss within
    1e-4, gradients and params held as (c). (c) One f32 step at
    ``reduced()`` size on the card and on the CPU from one state:
    gradients, then loss and gnorm 1e-5 relative and params 1e-5. (d) The
    trained f32 state through ``save_async`` and ``wait_pending``,
    restored into a fresh template (every leaf equal), then the serve
    launcher's ``--ckpt-dir`` boot (``restore_trained``), ``itq3_s``
    through ``quantize_blocks``, and phase 4's requests with ``kv_quant``:
    launches exactly phase 4's contract, two runs' streams equal, and
    phase 5's layer-forced parity on the trained weights (1e-3; K codes
    parting at rounding ties reported). Returns (d)'s counted launches."""
    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.configs import reduced
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.models import lm
    from repro_torch.models.layers import Runtime
    from repro_torch.train import loop
    from repro_torch.train.grad import accumulate_grads

    out: dict = {}
    cfg = get_config("smollm-135m")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"phase 16 (a): train {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}) {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, remat dots, bf16 autocast "
          f"and f32", flush=True)
    ops, nbytes = train_work(cfg, TRAIN_BATCH, TRAIN_SEQ)
    bounds = {"f32": bound_ms(nbytes, ops), "bf16": bound_ms(
        nbytes, ops, PEAK_BF16_FLOPS)}
    out["work"] = dict(ops=ops, bytes=nbytes, bound_ms=bounds)
    print(f"  {ops / 1e12:.3f} TFLOP and {nbytes / 1e9:.2f} GB a step: "
          f"bound {bounds['f32'][0]:.2f} ms in f32 ({bounds['f32'][1]}), "
          f"{bounds['bf16'][0]:.2f} ms at the bf16 rate "
          f"({bounds['bf16'][1]})", flush=True)
    init = loop.init_train_state(cfg, seed=0, device=dev)
    _build.reset_launches()
    runs = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        state, m, ms, peak = train_steps(cfg, init, steps=TRAIN_STEPS,
                                         compute_dtype=dtype)
        losses = [r["loss"] for r in m]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        first5, last5 = statistics.mean(losses[:5]), statistics.mean(
            losses[-5:])
        if not last5 < first5:
            raise AssertionError(f"{name}: the loss did not fall: first 5 "
                                 f"{first5:.4f}, last 5 {last5:.4f}")
        med = statistics.median(ms[1:])
        runs[name] = state
        out[f"train_{name}"] = dict(
            ms_per_step=med, first_step_ms=ms[0],
            tokens_per_s=tokens / med * 1e3, bound_ms=bounds[name][0],
            peak_mem_bytes=peak, loss_first=losses[0], loss_last=losses[-1],
            loss_first5=first5, loss_last5=last5, gnorm_last=m[-1]["gnorm"],
            ms_all=ms, losses=losses)
        print(f"  {name}: {med:.1f} ms/step (median after the first; first "
              f"{ms[0]:.0f} ms; bound {bounds[name][0]:.2f}), "
              f"{tokens / med * 1e3:.0f} tokens/s, peak "
              f"memory {_gib(peak)}, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} (means of 5: {first5:.4f} -> {last5:.4f})",
              flush=True)
    if _build.launches:
        raise AssertionError(f"training launched {dict(_build.launches)}")
    prof = out["train_profile"] = train_profile(cfg, init)
    print(f"  traced {TRAIN_PROFILE_STEPS} f32 steps: device busy "
          f"{prof['device_busy_s']:.3f} s of {prof['wall_s']:.3f} s wall "
          f"(idle share {prof['idle_share']:.3f}), "
          f"{prof['aten_calls_per_step']:.0f} aten calls per step; top "
          f"kernels (ms/step): " + ", ".join(
              f"{k} {v:.1f}" for k, v in prof["top_kernels_ms_per_step"]),
          flush=True)

    print("phase 16 (b): one f32 step under each remat; accumulation over 4 "
          "micro-batches against one batch", flush=True)
    rem = {}
    for name, kw in (("dots", dict(remat_policy="dots")),
                     ("none", dict(remat_policy="none")),
                     ("off", dict(remat=False))):
        _, m, ms, peak = train_steps(cfg, init, steps=1,
                                     compute_dtype=torch.float32, **kw)
        rem[name] = dict(loss=m[0]["loss"], gnorm=m[0]["gnorm"],
                         loss_bits=_bits(m[0]["loss"]),
                         gnorm_bits=_bits(m[0]["gnorm"]),
                         peak_mem_bytes=peak, ms=ms[0])
        print(f"  remat {name}: loss {rem[name]['loss_bits']} gnorm "
              f"{rem[name]['gnorm_bits']}, peak memory {_gib(peak)}, "
              f"{ms[0]:.0f} ms", flush=True)
    for k in ("loss_bits", "gnorm_bits"):
        if len({r[k] for r in rem.values()}) != 1:
            raise AssertionError(f"remat variants part on {k}: {rem}")
    out["remat"] = rem
    # accumulation at the peak lr (a step at step 0 has lr 0)
    warm = dataclasses.replace(init, step=torch.full_like(
        init.step, TRAIN_KW["warmup"]))
    batch = SyntheticCorpus(cfg.vocab_size, seed=17).batch(
        0, TRAIN_BATCH, TRAIN_SEQ)
    one, m1, _, _ = train_steps(cfg, warm, steps=1,
                                compute_dtype=torch.float32)
    four, m4, _, _ = train_steps(cfg, warm, steps=1, num_micro=4,
                                 compute_dtype=torch.float32)
    g1 = xent_grads(cfg, init.params, batch)
    dev_batch = {k: torch.as_tensor(v, device=dev).reshape(
        4, TRAIN_BATCH // 4, TRAIN_SEQ) for k, v in batch.items()}

    def loss_fn(p, b):
        xent, aux = lm.forward_xent(p, b["tokens"], b["labels"],
                                    Runtime(capacity_factor=2.0), cfg)
        return xent + 0.01 * aux, aux
    _, g4, _ = accumulate_grads(loss_fn, init.params, dev_batch, num_micro=4)
    acc = dict(loss_1=m1[0]["loss"], loss_4=m4[0]["loss"],
               grad_worst=hold_grads("accumulation", g1, g4),
               **hold_params("accumulation", one.params, four.params, g1,
                             1e-4))
    if not abs(acc["loss_1"] - acc["loss_4"]) <= 1e-4:
        raise AssertionError(f"accumulation: loss {acc}")
    out["accumulation"] = acc
    print(f"  num_micro 4 vs 1 at lr {TRAIN_KW['lr_peak']}: loss "
          f"{acc['loss_4']:.6f} vs {acc['loss_1']:.6f}, gradients within "
          f"{acc['grad_worst']:.2e} of each leaf's largest, params "
          f"{acc['max_abs']:.2e} apart ({acc['flips']} noise-floor flips)",
          flush=True)
    del one, four, g1, g4

    print("phase 16 (c): one f32 step at reduced() size, card against CPU",
          flush=True)
    rcfg = reduced(cfg)
    rbatch = SyntheticCorpus(rcfg.vocab_size, seed=17).batch(
        0, CPU_BATCH, CPU_SEQ)
    side = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        s = loop.init_train_state(rcfg, seed=0, device=d)
        g = xent_grads(rcfg, s.params, rbatch)
        s = dataclasses.replace(s, step=torch.full_like(
            s.step, TRAIN_KW["warmup"]))
        s, m, _, _ = train_steps(rcfg, s, steps=1, compute_dtype=torch.float32,
                                 batch=(CPU_BATCH, CPU_SEQ))
        side[name] = (g, s, m[0])
    (gc, sc, dev_m), (gh, sh, cpu_m) = side["card"], side["cpu"]
    cmp = dict(grad_worst=hold_grads("card vs cpu", gh, gc),
               **hold_params("card vs cpu", sh.params, sc.params, gh, 1e-5),
               loss=(dev_m["loss"], cpu_m["loss"]),
               gnorm=(dev_m["gnorm"], cpu_m["gnorm"]))
    for k in ("loss", "gnorm"):
        a, b = cmp[k]
        if not abs(a - b) <= 1e-5 * abs(b):
            raise AssertionError(f"card vs cpu: {k} {a} vs {b}")
    out["card_vs_cpu"] = cmp
    print(f"  loss {dev_m['loss']:.7f} vs {cpu_m['loss']:.7f}, gnorm "
          f"{dev_m['gnorm']:.7f} vs {cpu_m['gnorm']:.7f}, gradients within "
          f"{cmp['grad_worst']:.2e} of each leaf's largest, params "
          f"{cmp['max_abs']:.2e} apart ({cmp['flips']} noise-floor flips)",
          flush=True)

    print("phase 16 (d): save_async the trained f32 state, restore it, boot "
          "the serve launcher's --ckpt-dir path on it", flush=True)
    trained = runs["f32"]
    del runs
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    step = int(trained.step)
    t0 = time.perf_counter()
    ckpt_mod.save_async(str(TRAIN_DIR), step, trained)
    snap_s = time.perf_counter() - t0
    ckpt_mod.wait_pending()
    save_s = time.perf_counter() - t0
    back, got_step = ckpt_mod.restore(str(TRAIN_DIR), loop.init_train_state(
        cfg, seed=1, device=dev))
    steps_equal = all(a.dtype == torch.int32 and int(a) == int(b) for a, b in
                      ((back.step, trained.step),
                       (back.opt.step, trained.opt.step)))
    if got_step != step or not steps_equal or not tree_bytes_equal(
            {"p": back.params, "m": back.opt.mu, "n": back.opt.nu},
            {"p": trained.params, "m": trained.opt.mu,
             "n": trained.opt.nu}):
        raise AssertionError("the restored train state differs from the "
                             "saved one")
    del back
    out["ckpt"] = dict(step=step, snapshot_s=snap_s, save_s=save_s)
    print(f"  step {step}: save_async returned in {snap_s:.1f} s, written "
          f"in {save_s:.1f} s; restored equal leaf for leaf", flush=True)
    params, q, counts = serve_trained(TRAIN_DIR, cfg, dev, out)
    # reported only: what training and quantizing did to a held-out loss
    ev = next(SyntheticCorpus(cfg.vocab_size, seed=17).eval_batches(
        1, TRAIN_BATCH, TRAIN_SEQ))
    with torch.no_grad():
        out["eval_xent"] = {name: float(lm.forward_xent(
            p, ev["tokens"], ev["labels"], Runtime(), cfg)[0])
            for name, p in (("init", init.params), ("trained", params),
                            ("trained_itq3_s", q))}
    print(f"  held-out xent: init {out['eval_xent']['init']:.4f}, trained "
          f"{out['eval_xent']['trained']:.4f}, trained itq3_s "
          f"{out['eval_xent']['trained_itq3_s']:.4f}", flush=True)
    report["train"] = out
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return counts


# --- phase 17: training on a mesh of ranks ---------------------------------

# (a) three f32 steps of phase 16's model and batches from the seeded state
# on every mesh; (c) two more after an elastic resume. Params held as
# tests/test_torch_train_mesh.py holds three steps: MESH_PARAM_TOL, and
# the flip rule of FLIP_FLOOR / FLIP_SHARE.
MESH_STEPS, MESH_RESUME_STEPS = 3, 2
MESH_PARAM_TOL, MESH_REL_TOL = 5e-5, 1e-5
MESH_DIR = ROOT / "build" / "chip_smoke_mesh"
# (b) the pod exchange: seeded per-pod gradients, the reference test's
# 64-element leaf and a projection of smollm's width, POD_STEPS steps
POD_LEAVES = {"v": (64,), "gate": (576, 1536)}
POD_STEPS = 6


def mesh_shapes(world: int) -> list:
    """(a)'s meshes: every rank on ``data``; with four, also (2, 2)."""
    return [{"data": world, "model": 1}] + (
        [{"data": 2, "model": 2}] if world == 4 else [])


def mesh_step_grads(cfg, state, batch, mesh, specs):
    """The f32 train loss's gradients at ``state`` (no remat), whole: on a
    mesh as the train step takes them, this rank's rows, the params
    gathered (along ``data`` only where the model axis splits the
    compute, ``train/tp.py``), the gradients reduced to the specs, then
    gathered whole (every rank calls it)."""
    from repro_torch.models import lm
    from repro_torch.models.layers import Runtime
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import sharded, tp
    from repro_torch.train.grad import value_and_grad

    split = None if mesh is None else tp.plan(cfg, mesh, specs.params)
    rt = sharded.step_runtime(Runtime(capacity_factor=2.0), mesh, split)
    params = state.params
    if mesh is not None:
        batch = sharded.split_batch(batch, mesh, make_rules(mesh, cfg))
        params = sharded.gather_params(params, specs.params, mesh, split)

    def loss(p, b):
        xent, aux = lm.forward_xent(p, b["tokens"], b["labels"], rt, cfg)
        return xent + 0.01 * aux, aux
    dev = state.step.device
    _, grads = value_and_grad(loss, params, {
        k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    del params
    if mesh is None:
        return grads
    grads = sharded.reduce_grads(grads, specs.params, mesh, split)
    return sharded.gather_params(grads, specs.params, mesh)


def mesh_train(cfg, dev, mesh, *, steps: int, start: int = 0, state=None,
               on_grads=None):
    """``steps`` f32 steps (remat "dots", TF32 off) of ``cfg`` on ``mesh``
    (None: one device) from the seeded state (or ``state``, this rank's
    slices), over phase 16's batches ``start ..``. Before each step
    ``on_grads(s, whole grads)`` sees the step's gradients (computed apart,
    untimed). Returns (state, specs, per-step metrics as floats, host ms
    per step ending in the metrics' transfer, the steps' peak memory)."""
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.launch.mesh import barrier
    from repro_torch.models.layers import Runtime
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import loop

    specs = None
    if mesh is not None:
        specs = loop.state_specs(cfg, make_rules(mesh, cfg))
    if state is None:
        state = loop.init_train_state(cfg, seed=0, device=dev, mesh=mesh,
                                      specs=specs)
    step = loop.make_train_step(cfg, Runtime(capacity_factor=2.0),
                                compute_dtype=torch.float32, mesh=mesh,
                                specs=specs, **TRAIN_KW)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=17)
    metrics, ms, peak = [], [], 0
    for s in range(start, start + steps):
        b = corpus.batch(s, TRAIN_BATCH, TRAIN_SEQ)
        if on_grads is not None:
            on_grads(s, mesh_step_grads(cfg, state, b, mesh, specs))
        torch.cuda.synchronize()
        if mesh is not None:  # every rank starts the timed step together
            barrier(mesh)
            torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, b)
        m = {k: float(v) for k, v in m.items()}  # waits for the step
        ms.append(1e3 * (time.perf_counter() - t0))
        peak = max(peak, torch.cuda.max_memory_allocated())
        metrics.append(m)
    return state, specs, metrics, ms, peak


def state_bytes(state) -> int:
    """Bytes of a train state's params and both moments (this rank's)."""
    from repro_torch.train.tree import tree_leaves

    return sum(t.numel() * t.element_size() for tree in (
        state.params, state.opt.mu, state.opt.nu) for t in tree_leaves(tree))


def collective_bytes(specs, cfg, shape: dict, split=None) -> dict:
    """Bytes one mesh step moves through the state's collectives on a
    rank, from the specs and the f32 leaf sizes: ``all_gather`` the
    leaves a gather builds (whole, or under ``split`` (``train/tp.py``)
    each leaf's model slice, gathered along ``data`` only);
    ``reduce_scatter`` the inputs of the reduce-scatters (a leaf's model
    slice, where it has a data dim); ``all_reduce`` those of the
    all-reduces (the leaves with no data dim, when data > 1). A split
    step's collectives inside the forward and backward are counted
    apart (``count_ops``)."""
    from repro_torch.models import lm
    from repro_torch.train.tree import tree_leaves

    leaves = tree_leaves(lm.init_params(cfg, seed=0, device="meta"))
    out = dict(all_gather=0, reduce_scatter=0, all_reduce=0)
    for leaf, spec in zip(leaves, tree_leaves(specs.params)):
        whole = leaf.numel() * 4
        if split is not None:
            if "data" in spec:
                out["all_gather"] += (whole // shape["model"]
                                      if "model" in spec else whole)
        elif any(ax is not None for ax in spec):
            out["all_gather"] += whole
        part = whole // shape["model"] if "model" in spec else whole
        if "data" in spec:
            out["reduce_scatter"] += part
        elif shape["data"] > 1:
            out["all_reduce"] += part
    return out


def collective_ms(state, specs, mesh, split=None) -> dict:
    """Host ms of a step's param gathers alone and of its gradient
    reduction alone (on the gathered params as gradients), each started
    by every rank together and ended by a synchronize; under ``split``
    the gathers along ``data`` only."""
    from repro_torch.launch.mesh import barrier
    from repro_torch.train import sharded

    def timed(fn):
        barrier(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)
    whole, ag = timed(lambda: sharded.gather_params(state.params,
                                                    specs.params, mesh, split))
    _, red = timed(lambda: sharded.reduce_grads(whole, specs.params, mesh,
                                                split))
    return dict(all_gather=ag, reduce=red)


def pod_grads(world: int, pod: int) -> dict:
    """Pod ``pod``'s seeded partial gradient tree (f32 numpy)."""
    rng = np.random.default_rng(17)
    trees = [{k: rng.normal(size=shape).astype(np.float32)
              for k, shape in POD_LEAVES.items()} for _ in range(world)]
    return trees[pod]


def pod_model(world: int) -> list:
    """``tests/test_train.py``'s numpy model of the exchange, in f32, on
    ``world`` pods: per step (the mean, each pod's residuals, the
    scales)."""
    pods = [pod_grads(world, p) for p in range(world)]
    errs = [{k: np.zeros_like(v) for k, v in g.items()} for g in pods]
    out = []
    for _ in range(POD_STEPS):
        mean, new, scales = {}, [{} for _ in pods], {}
        for k in POD_LEAVES:
            xs = [g[k] + e[k] for g, e in zip(pods, errs)]
            amax = max(np.abs(x).max() for x in xs)
            scale = np.float32(max(amax, np.float32(1e-12))) / np.float32(127)
            qs = [np.clip(np.round(x / scale), -127, 127) for x in xs]
            for p, (x, q) in enumerate(zip(xs, qs)):
                new[p][k] = x - q * scale
            mean[k] = sum(qs) * scale / np.float32(world)
            scales[k] = scale
        errs = new
        out.append((mean, errs, scales))
    return out


def mesh_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of phase 17 (a)-(c) on ``cuda:rank``. Rank 0 first runs
    the single-device yardstick (MESH_STEPS + MESH_RESUME_STEPS steps) and
    keeps its gradients; then every rank joins the NCCL group and trains
    on each mesh of ``mesh_shapes``, rank 0 holding each step's whole
    gradients, then the params, to the yardstick's; the first mesh's state
    is saved (c), gathered, and rank 0 restores it onto its one device;
    last the pod exchange (b). Each rank saves its results."""
    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import loop, sharded, tp
    from repro_torch.train.grad import (compressed_pod_allreduce,
                                        zeros_error_buf)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    cfg = get_config("smollm-135m")
    res: dict = {"meshes": []}
    _build.reset_launches()
    if rank == 0:  # the yardstick: one device, then (c)'s two steps on
        yard_grads = {}
        one, _, m1, ms1, _ = mesh_train(
            cfg, dev, None, steps=MESH_STEPS,
            on_grads=yard_grads.__setitem__)
        yard_params = one.params
        _, _, m2, _, _ = mesh_train(cfg, dev, None, steps=MESH_RESUME_STEPS,
                                    start=MESH_STEPS, state=one)
        res["one_device"] = dict(metrics=m1 + m2, ms=ms1,
                                 state_bytes=state_bytes(one))
        del one
    try:
        for i, shape in enumerate(mesh_shapes(world)):
            mesh = make_mesh(shape, device=dev, init_method=store, rank=rank,
                             world_size=world)
            held = {"grad_worst": 0.0}

            def on_grads(s, g):
                if rank == 0:
                    held["grad_worst"] = max(held["grad_worst"], hold_grads(
                        f"mesh {shape} step {s}", yard_grads[s], g))
            state, specs, m, ms, peak = mesh_train(
                cfg, dev, mesh, steps=MESH_STEPS, on_grads=on_grads)
            split = tp.plan(cfg, mesh, specs.params)
            row = dict(shape=shape, metrics=m, ms=ms, peak_mem_bytes=peak,
                       state_bytes=state_bytes(state),
                       split=None if split is None else split.attention,
                       collective_bytes=collective_bytes(specs, cfg, shape,
                                                         split),
                       collective_ms=collective_ms(state, specs, mesh,
                                                   split))
            whole = sharded.gather_params(state.params, specs.params, mesh)
            if rank == 0:
                row.update(grad_worst=held["grad_worst"], **hold_params(
                    f"mesh {shape}", yard_params, whole,
                    list(yard_grads.values()), MESH_PARAM_TOL))
            del whole
            if i == 0:  # (c) the save, then a restore onto one device
                places = sharded.placements(specs, mesh)
                t0 = time.perf_counter()
                ckpt_mod.save(str(MESH_DIR / "ckpt"), MESH_STEPS, state,
                              shardings=places)
                res["save_s"] = time.perf_counter() - t0
                gathered = sharded.map_state(lambda t, p: p.gather(t), state,
                                             places)
                if rank == 0:
                    back, got = ckpt_mod.restore(
                        str(MESH_DIR / "ckpt"), loop.init_train_state(
                            cfg, seed=1, device=dev))
                    res["restore_equal"] = (
                        got == int(back.step) == int(back.opt.step)
                        == MESH_STEPS and all(tree_bytes_equal(a, b) for a, b
                                              in ((back.params,
                                                   gathered.params),
                                                  (back.opt.mu,
                                                   gathered.opt.mu),
                                                  (back.opt.nu,
                                                   gathered.opt.nu))))
                    del back
                del gathered
            res["meshes"].append(row)
            del state
            torch.cuda.empty_cache()
        # (b) the pod exchange over every rank
        mesh = make_mesh({"pod": world, "data": 1, "model": 1}, device=dev,
                         init_method=store, rank=rank, world_size=world)
        g = {k: torch.from_numpy(v)[None].to(dev)
             for k, v in pod_grads(world, rank).items()}
        e = zeros_error_buf(g)
        pod, pod_ms = [], []
        for _ in range(POD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            red, new_e = compressed_pod_allreduce(g, e, mesh)
            torch.cuda.synchronize()
            pod_ms.append(1e3 * (time.perf_counter() - t0))
            if world == 1 and (red is not g or new_e is not e):
                raise AssertionError("one pod: the exchange must return its "
                                     "inputs")
            pod.append(({k: v.cpu() for k, v in red.items()},
                        {k: v.cpu() for k, v in new_e.items()}))
            e = new_e
        res.update(pod=pod, pod_ms=pod_ms, launches=dict(_build.launches))
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def remesh_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of phase 17 (c)'s elastic resume: the mesh ``plan_remesh(
    world, model=1)`` gives, restored from the saved checkpoint through
    its placements, then MESH_RESUME_STEPS more steps."""
    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.ft.monitor import plan_remesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import loop, sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    cfg = get_config("smollm-135m")
    plan = plan_remesh(world, model=1)
    try:
        mesh = make_mesh({"data": plan.data, "model": plan.model},
                         device=dev, init_method=store, rank=rank,
                         world_size=world)
        specs = loop.state_specs(cfg, make_rules(mesh, cfg))
        template = loop.init_train_state(cfg, seed=1, device=dev, mesh=mesh,
                                         specs=specs)
        state, start = ckpt_mod.restore(str(MESH_DIR / "ckpt"), template,
                                        shardings=sharded.placements(specs,
                                                                     mesh))
        _, _, m, ms, _ = mesh_train(cfg, dev, mesh, steps=MESH_RESUME_STEPS,
                                    start=start, state=state)
        torch.save(dict(shape=dict(mesh.shape), start=start, metrics=m,
                        ms=ms), Path(out_dir) / f"remesh{rank}.pt")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


# (e) the model axis's compute split (train/tp.py) on (data 1, model
# world): (arch, layers kept or None for every one), each against one
# device by (a)'s bounds. smollm's 3 KV heads do not divide 2 or 4 (the
# key sequence splits, T = 256); qwen1.5's 16 do (heads; QKV bias, tied
# 151,936-row head); olmoe's 64 experts split, its head untied.
SPLIT_ARCHS = (("smollm-135m", None), ("qwen1.5-0.5b", 8),
               ("olmoe-1b-7b", 2))
# with four cards, a family that keeps the storage form (train/tp.py
# SPLIT_FAMILIES) on (2, 2), held alike: its leaves gathered whole, the
# gradients' model slices taken after
STORAGE_ARCH, STORAGE_LAYERS = "rwkv6-3b", 2


def split_runs(world: int) -> list:
    """(e)'s runs: (arch, layers kept or None, mesh shape)."""
    runs = [(a, n, {"data": 1, "model": world}) for a, n in SPLIT_ARCHS]
    if world == 4:
        runs.append((STORAGE_ARCH, STORAGE_LAYERS, {"data": 2, "model": 2}))
    return runs


def split_cfg(arch: str, layers):
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def _sliced(shape, spec, shape_of: dict, axes) -> tuple:
    """``shape`` with each dim named by one of ``axes`` in ``spec`` cut
    by that axis's size."""
    return tuple(n // shape_of[ax] if ax in axes else n
                 for n, ax in zip(shape, spec))


def split_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of phase 17 (e) on ``cuda:rank``: per run of
    :func:`split_runs` (SPLIT_ARCHS on a (1, world) NCCL mesh, with four
    cards the storage form on (2, 2)) rank 0 first runs the one-device
    yardstick (MESH_STEPS f32 steps, its gradients kept) while the others
    wait, then every rank trains MESH_STEPS steps on the mesh, rank 0
    holding each step's whole gradients and then the params to the
    yardstick's. Every gather of the split step's params is checked to
    give each leaf's model slice; the storage form's step must not split.
    One more step, untimed and dropped, counts the collectives it
    dispatches (``count_ops``). At world 1 the mesh step is one device's:
    no yardstick, nothing to count. Each rank saves its results."""
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.launch.mesh import barrier, make_mesh
    from repro_torch.launch.op_analysis import count_ops
    from repro_torch.models import lm
    from repro_torch.models.layers import Runtime
    from repro_torch.train import loop, sharded, tp
    from repro_torch.train.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    _build.reset_launches()
    res: dict = {}
    meshes: dict = {}
    gather = sharded.gather_params
    # at world 1 the mesh step is one device's (no split): it is its own
    # yardstick, and it dispatches no collective to count
    yard = world > 1
    try:
        for arch, layers, shape in split_runs(world):
            key = tuple(shape.values())
            if key not in meshes:
                meshes[key] = make_mesh(shape, device=dev, init_method=store,
                                        rank=rank, world_size=world)
            mesh = meshes[key]
            cfg = split_cfg(arch, layers)
            row: dict = {}
            if rank == 0 and yard:
                yard_grads = {}
                one, _, m1, ms1, peak1 = mesh_train(
                    cfg, dev, None, steps=MESH_STEPS,
                    on_grads=yard_grads.__setitem__)
                row["one_device"] = dict(metrics=m1, ms=ms1,
                                         peak_mem_bytes=peak1,
                                         state_bytes=state_bytes(one))
                yard_params = one.params
                del one
                torch.cuda.empty_cache()
            barrier(mesh)
            held = {"grad_worst": 0.0}
            sets = []

            def on_grads(s, g):
                if rank == 0:
                    held["grad_worst"] = max(held["grad_worst"], hold_grads(
                        f"split {arch} step {s}", yard_grads[s], g))

            def spy(local, pspecs, mesh_, split=None):
                out = gather(local, pspecs, mesh_, split)
                if split is not None:
                    sets.append([tuple(t.shape) for t in tree_leaves(out)])
                return out
            sharded.gather_params = spy
            try:
                state, specs, m, ms, peak = mesh_train(
                    cfg, dev, mesh, steps=MESH_STEPS,
                    on_grads=on_grads if yard else None)
            finally:
                sharded.gather_params = gather
            split = tp.plan(cfg, mesh, specs.params)
            whole = [tuple(t.shape) for t in tree_leaves(lm.shape_params(
                cfg))]
            pspecs = tree_leaves(specs.params)
            want = [_sliced(w, sp, mesh.shape, ("model",))
                    for w, sp in zip(whole, pspecs)]
            if arch == STORAGE_ARCH:
                if split is not None or sets:
                    raise AssertionError(f"{arch}: the storage form split")
                want = whole
            elif world > 1 and (not sets or any(got != want
                                                for got in sets)):
                raise AssertionError(f"split {arch}: a gather gave other "
                                     f"than each leaf's model slice")
            coll: dict = {"bytes": {}, "counts": {}}
            if yard:
                step = loop.make_train_step(
                    cfg, Runtime(capacity_factor=2.0),
                    compute_dtype=torch.float32, mesh=mesh, specs=specs,
                    **TRAIN_KW)
                batch = SyntheticCorpus(cfg.vocab_size, seed=17).batch(
                    MESH_STEPS, TRAIN_BATCH, TRAIN_SEQ)
                with count_ops(tags=False) as st:
                    step(state, batch)
                torch.cuda.synchronize()
                coll = {"bytes": dict(st.collective_bytes),
                        "counts": dict(st.collective_counts)}
            row.update(
                metrics=m, ms=ms, peak_mem_bytes=peak,
                state_bytes=state_bytes(state),
                working_bytes=4 * sum(math.prod(w) for w in want),
                whole_bytes=4 * sum(math.prod(w) for w in whole),
                attention=None if split is None else split.attention,
                collective_bytes=coll["bytes"],
                collective_counts=coll["counts"])
            if not yard:
                row.update(one_device=dict(
                    metrics=m, ms=ms, peak_mem_bytes=peak,
                    state_bytes=row["state_bytes"]), grad_worst=0.0,
                    max_abs=0.0, flips=0)
            elif rank == 0:
                params = sharded.gather_params(state.params, specs.params,
                                               mesh)
                row.update(grad_worst=held["grad_worst"], **hold_params(
                    f"split {arch}", yard_params, params,
                    list(yard_grads.values()), MESH_PARAM_TOL))
                del yard_params, yard_grads, params
            else:  # every rank takes the gather's collectives
                sharded.gather_params(state.params, specs.params, mesh)
            del state
            torch.cuda.empty_cache()
            res[arch] = row
        res["launches"] = dict(_build.launches)
        torch.save(res, Path(out_dir) / f"split{rank}.pt")
    finally:
        sharded.gather_params = gather
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def split_phase(world: int, out: dict) -> None:
    """Phase 17 (e): SPLIT_ARCHS trained on a (1, world) mesh whose model
    axis splits the compute, and with four cards STORAGE_ARCH's storage
    form on (2, 2), each held to one device as (a) holds its meshes; per
    rank ms/step, peak memory, the params and moments' bytes, the working
    set's bytes (derived from the specs: each leaf's model slice, whole
    under the storage form) and the collectives of one measured step."""
    print(f"phase 17 (e): the model axis's compute split on (data 1, model "
          f"{world}) NCCL rank(s): "
          + ", ".join(f"{a} ({'all' if n is None else n} layers)"
                      for a, n in SPLIT_ARCHS)
          + f", {MESH_STEPS} f32 steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens each, against one device", flush=True)
    if world == 1:
        print("  one card: the split path runs at world 1 (a model axis of "
              "one rank splits nothing, no collective; the run is one "
              "device's, so it is its own yardstick); not evidence of the "
              "split; the storage form's (2, 2) needs four cards",
              flush=True)
    else:
        print(f"  and {STORAGE_ARCH} ({STORAGE_LAYERS} layers), which keeps "
              f"the storage form, on (data 2, model 2)" if world == 4 else
              "  the storage form's (2, 2) needs four cards", flush=True)
    torch.cuda.empty_cache()
    torch.multiprocessing.start_processes(
        split_rank, args=(world, f"file://{MESH_DIR / 'store_split'}",
                          str(MESH_DIR)), nprocs=world, start_method="spawn")
    ranks = [torch.load(MESH_DIR / f"split{r}.pt") for r in range(world)]
    launched = {r: res["launches"] for r, res in enumerate(ranks)
                if res["launches"]}
    if launched:
        raise AssertionError(f"split training launched {launched}")
    out["split"] = {}
    for arch, layers, shape in split_runs(world):
        row0 = ranks[0][arch]
        one = row0["one_device"]
        label = f"split {arch}"
        for r, res in enumerate(ranks):
            if res[arch]["metrics"] != row0["metrics"]:
                raise AssertionError(f"{label}: rank {r}'s metrics differ "
                                     f"from rank 0's")
        for s, (got, want) in enumerate(zip(row0["metrics"],
                                            one["metrics"])):
            _metrics_close(f"{label} step {s}", got, want)
        one_ms = statistics.median(one["ms"][1:])
        per_rank = [dict(ms_per_step=statistics.median(res[arch]["ms"][1:]),
                         **{k: res[arch][k] for k in (
                             "ms", "peak_mem_bytes", "state_bytes",
                             "working_bytes", "collective_bytes",
                             "collective_counts")})
                    for res in ranks]
        out["split"][arch] = dict(
            layers=layers, mesh=shape, attention=row0["attention"],
            one_device=dict(ms_per_step=one_ms, **one), ranks=per_rank,
            whole_bytes=row0["whole_bytes"], grad_worst=row0["grad_worst"],
            params_max_abs=row0["max_abs"], flips=row0["flips"],
            metrics=row0["metrics"])
        held = ("the run is one device's" if world == 1 else
                f"within {MESH_REL_TOL} of one device's; gradients within "
                f"{row0['grad_worst']:.2e} of each leaf's largest; params "
                f"{row0['max_abs']:.2e} apart ({row0['flips']} noise-floor "
                f"flips)")
        form = row0["attention"] or ("storage form" if arch == STORAGE_ARCH
                                     else "one rank")
        print(f"  {arch} on {tuple(shape.values())} ({form}): every rank's "
              f"loss and gnorm bit-equal ({_bits(row0['metrics'][-1]['loss'])}"
              f", {_bits(row0['metrics'][-1]['gnorm'])}), {held}", flush=True)
        for r, p in enumerate(per_rank):
            coll = ", ".join(f"{k} {p['collective_counts'][k]:.0f} calls "
                             f"{p['collective_bytes'][k] / 1e6:.1f} MB"
                             for k in sorted(p["collective_counts"]))
            print(f"    rank {r}: {p['ms_per_step']:.1f} ms/step (one device "
                  f"{one_ms:.1f}), peak memory {_gib(p['peak_mem_bytes'])} "
                  f"(one device {_gib(one['peak_mem_bytes'])}), params and "
                  f"moments {p['state_bytes'] / 1e9:.3f} GB (one device "
                  f"{one['state_bytes'] / 1e9:.3f}), params' working set "
                  f"from the specs {p['working_bytes'] / 1e9:.3f} GB of "
                  f"{row0['whole_bytes'] / 1e9:.3f}; one step's "
                  f"collectives {coll or 'none'}", flush=True)


def _metrics_close(label: str, got: dict, want: dict) -> None:
    for k in ("loss", "gnorm", "moe_aux"):
        if not abs(got[k] - want[k]) <= MESH_REL_TOL * max(abs(want[k]),
                                                            1e-30):
            raise AssertionError(f"{label}: {k} {got[k]!r} vs one device's "
                                 f"{want[k]!r}")
    if got["lr"] != want["lr"]:
        raise AssertionError(f"{label}: lr {got['lr']} vs {want['lr']}")


def mesh_phase(dev, report: dict) -> dict:
    """Phase 17: smollm-135m at full width and depth trained on a mesh of
    ``world = min(cards, 4)`` spawned NCCL ranks, f32 (TF32 off), phase
    16's batches. (a) MESH_STEPS steps from the seeded state on a
    ``(data=world, model=1)`` mesh (and (2, 2) with four cards): every
    rank's metrics bit-equal to each other's and within 1e-5 relative of
    one device's, each step's gradients within 5e-5 of each leaf's largest,
    the params within MESH_PARAM_TOL under the flip rule; per rank ms/step,
    tokens/s, peak memory, the state's bytes against one device's and the
    bytes each collective moves. (b) ``compressed_pod_allreduce`` over a
    pod axis of ``world`` ranks: equal on every pod, equal to the numpy
    model of ``tests/test_train.py`` step by step, the time-averaged mean
    within a scale of the truth (at world 1: its inputs back). (c) The
    first mesh's state saved at step MESH_STEPS and restored onto one
    device equal leaf for leaf; with four cards also onto ``plan_remesh(2,
    model=1)``'s mesh, whose next MESH_RESUME_STEPS steps' metrics must
    equal an uninterrupted one-device run's within (a)'s bounds. (a)-(c)
    launch nothing of ``csrc/``. (d) The checkpoint through the serve
    launcher's ``--ckpt-dir`` boot on one card (``serve_trained``). (e)
    The model axis's compute split (``train/tp.py``) on ``(data 1, model
    world)`` for SPLIT_ARCHS (:func:`split_phase`), held as (a); (a)'s
    (2, 2) mesh runs the split too. Returns (d)'s counted launches."""
    out: dict = {}
    cfg = get_config("smollm-135m")
    world = min(torch.cuda.device_count(), 4)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"phase 17 (a): train {cfg.name} on a mesh of {world} NCCL "
          f"rank(s) {[tuple(s.values()) for s in mesh_shapes(world)]} "
          f"(data, model), {MESH_STEPS} f32 steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, against one device", flush=True)
    if world == 1:
        print("  one card: the mesh path runs at world 1 (no leaf sharded, "
              "no collective); not evidence of sharding", flush=True)
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        mesh_rank, args=(world, f"file://{MESH_DIR / 'store'}",
                         str(MESH_DIR)), nprocs=world, start_method="spawn")
    out["spawn_s"] = time.perf_counter() - t0
    ranks = [torch.load(MESH_DIR / f"rank{r}.pt") for r in range(world)]
    one = ranks[0]["one_device"]
    one_ms = statistics.median(one["ms"][1:])
    out["one_device"] = dict(ms_per_step=one_ms, metrics=one["metrics"],
                             state_bytes=one["state_bytes"])
    out["meshes"] = []
    for i, row0 in enumerate(ranks[0]["meshes"]):
        shape = row0["shape"]
        label = f"mesh {tuple(shape.values())}" + (
            f" (split, {row0['split']})" if row0.get("split") else "")
        for r, res in enumerate(ranks):
            if res["meshes"][i]["metrics"] != row0["metrics"]:
                raise AssertionError(f"{label}: rank {r}'s metrics differ "
                                     f"from rank 0's")
        for s, (got, want) in enumerate(zip(row0["metrics"],
                                            one["metrics"])):
            _metrics_close(f"{label} step {s}", got, want)
        per_rank = []
        for r, res in enumerate(ranks):
            row = res["meshes"][i]
            med = statistics.median(row["ms"][1:])
            per_rank.append(dict(ms_per_step=med, ms=row["ms"],
                                 peak_mem_bytes=row["peak_mem_bytes"],
                                 state_bytes=row["state_bytes"],
                                 collective_ms=row["collective_ms"]))
        cb = row0["collective_bytes"]
        out["meshes"].append(dict(
            shape=shape, split=row0.get("split"), ranks=per_rank,
            collective_bytes=cb,
            grad_worst=row0["grad_worst"], params_max_abs=row0["max_abs"],
            flips=row0["flips"], metrics=row0["metrics"],
            tokens_per_s=tokens / max(p["ms_per_step"] for p in per_rank)
            * 1e3))
        for r, p in enumerate(per_rank):
            print(f"  {label} rank {r}: {p['ms_per_step']:.1f} ms/step "
                  f"(median after the first; one device {one_ms:.1f}), peak "
                  f"memory {_gib(p['peak_mem_bytes'])}, params and "
                  f"moments {p['state_bytes'] / 1e9:.3f} GB (one device "
                  f"{one['state_bytes'] / 1e9:.3f}); alone, the gathers "
                  f"{p['collective_ms']['all_gather']:.1f} ms and the "
                  f"gradient reduction {p['collective_ms']['reduce']:.1f} "
                  f"ms", flush=True)
        print(f"  {label}: {out['meshes'][-1]['tokens_per_s']:.0f} tokens/s "
              f"for the mesh; per step all-gathered "
              f"{cb['all_gather'] / 1e9:.3f} GB, reduce-scattered "
              f"{cb['reduce_scatter'] / 1e9:.3f} GB, all-reduced "
              f"{cb['all_reduce'] / 1e9:.4f} GB; every rank's loss and "
              f"gnorm bit-equal ({_bits(row0['metrics'][-1]['loss'])}, "
              f"{_bits(row0['metrics'][-1]['gnorm'])}), within "
              f"{MESH_REL_TOL} of one device's; gradients within "
              f"{row0['grad_worst']:.2e} of each leaf's largest; params "
              f"{row0['max_abs']:.2e} apart ({row0['flips']} noise-floor "
              f"flips)", flush=True)
    launched = {r: res["launches"] for r, res in enumerate(ranks)
                if res["launches"]}
    if launched:
        raise AssertionError(f"mesh training launched {launched}")

    print(f"phase 17 (b): compressed_pod_allreduce over {world} pod(s), "
          f"{POD_STEPS} steps", flush=True)
    model = pod_model(world)
    for r, res in enumerate(ranks):
        for s, ((mean, errs, _), (red, err)) in enumerate(zip(model,
                                                              res["pod"])):
            for k in POD_LEAVES:
                want_mean = (pod_grads(world, r)[k] if world == 1
                             else mean[k])
                want_err = np.zeros_like(want_mean) if world == 1 else (
                    errs[r][k])
                if not (np.array_equal(red[k][0].numpy(), want_mean)
                        and np.array_equal(err[k][0].numpy(), want_err)):
                    raise AssertionError(f"pod exchange: rank {r} step {s} "
                                         f"leaf {k} differs from the numpy "
                                         f"model")
    pod_err = {}
    for k in POD_LEAVES:
        truth = np.mean([pod_grads(world, p)[k] for p in range(world)],
                        axis=0)
        avg = np.mean([r[k][0].numpy() for r, _ in ranks[0]["pod"]], axis=0)
        pod_err[k] = float(np.abs(avg - truth).max())
        if world > 1 and not pod_err[k] <= model[-1][2][k]:
            raise AssertionError(f"pod exchange: time-averaged error "
                                 f"{pod_err[k]} over the scale "
                                 f"{model[-1][2][k]}")
    pod_ms = statistics.median(ranks[0]["pod_ms"][1:])
    out["pod"] = dict(world=world, err=pod_err, ms=pod_ms)
    print(f"  every pod equal to the numpy model bit for bit; time-averaged "
          f"error {pod_err}; {pod_ms:.3f} ms per exchange (median after "
          f"the first)", flush=True)

    first = tuple(mesh_shapes(world)[0].values())
    print(f"phase 17 (c): the state saved from mesh {first} at step "
          f"{MESH_STEPS}, restored onto one device", flush=True)
    if not ranks[0].get("restore_equal"):
        raise AssertionError("the restored state differs from the gathered "
                             "mesh state")
    out["ckpt"] = dict(save_s=ranks[0]["save_s"])
    print(f"  saved in {ranks[0]['save_s']:.1f} s; restored equal leaf for "
          f"leaf", flush=True)
    if world == 4:
        from repro_torch.ft.monitor import plan_remesh
        plan = plan_remesh(2, model=1)
        torch.multiprocessing.start_processes(
            remesh_rank, args=(plan.devices, f"file://{MESH_DIR / 'store2'}",
                               str(MESH_DIR)), nprocs=plan.devices,
            start_method="spawn")
        rem = [torch.load(MESH_DIR / f"remesh{r}.pt")
               for r in range(plan.devices)]
        for r, res in enumerate(rem):
            if res["start"] != MESH_STEPS or res["metrics"] != rem[0][
                    "metrics"]:
                raise AssertionError(f"elastic resume: rank {r} {res}")
        for s, got in enumerate(rem[0]["metrics"]):
            _metrics_close(f"elastic resume step {MESH_STEPS + s}", got,
                           one["metrics"][MESH_STEPS + s])
        out["remesh"] = dict(shape=rem[0]["shape"], metrics=rem[0]["metrics"],
                             ms=[r["ms"] for r in rem])
        print(f"  resumed onto plan_remesh(2, model=1)'s mesh "
              f"{rem[0]['shape']}: steps {MESH_STEPS}-"
              f"{MESH_STEPS + MESH_RESUME_STEPS - 1} within {MESH_REL_TOL} "
              f"of the uninterrupted one-device run", flush=True)

    print("phase 17 (d): the mesh-trained checkpoint through the serve "
          "launcher's --ckpt-dir boot on one card", flush=True)
    _, _, counts = serve_trained(MESH_DIR / "ckpt", cfg, dev, out)
    split_phase(world, out)
    report["mesh"] = out
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    return counts


# --- phase 18: the per-cell dry-run, and three cells measured -------------

# (a) the dry-run's records on the production meshes: (arch, shape, mesh)
DRYRUN_RECORDS = (("smollm-135m", "train_4k", "both"),
                  ("smollm-135m", "prefill_32k", "both"),
                  ("smollm-135m", "decode_32k", "both"),
                  ("olmoe-1b-7b", "train_4k", "single"))
# (b) the cells run on one card, each with its cut of the global batch:
# one 32,768-token prompt; 32 rows of a 32,768-position bf16 cache; one
# 4,096-token training row
CELL_ARCH = "smollm-135m"
MEASURED_CELLS = (("prefill_32k", 1), ("decode_32k", 32), ("train_4k", 1))
DRYRUN_DIR = ROOT / "chiprun_out" / "phase18"
# rows 1 and 3 at (b)'s shapes: smollm-135m's projections at the decode
# cell's M = 32 and the prefill cell's M = 32,768
CELL_SHAPES = [("wq", 576, 576, (32, 32768), False),
               ("wk", 576, 192, (32, 32768), False),
               ("gate", 576, 1536, (32, 32768), False),
               ("down", 1536, 576, (32, 32768), False)]
CELL_FWHT_ROWS = (32, 32768)


def start_dryrun_jobs() -> list:
    """(a)'s records and the cut cells' counts, each a ``python -m
    repro_torch.launch.dryrun`` process on the host's cores, with no card
    visible: they run while (b) holds the card. Returns ``(label, process,
    log path, waiter thread, its note of the exit code and wall)``."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    runs = [(f"{a} {s} {m}", ["--arch", a, "--shape", s, "--mesh", m,
                              "--jobs", "2" if m == "both" else "1",
                              "--out", str(DRYRUN_DIR / "records")])
            for a, s, m in DRYRUN_RECORDS]
    runs += [(f"{CELL_ARCH} {s} rows {r}",
              ["--arch", CELL_ARCH, "--shape", s, "--mesh", "one", "--rows",
               str(r), "--out", str(DRYRUN_DIR / "cuts")])
             for s, r in MEASURED_CELLS]
    jobs = []
    for i, (label, args) in enumerate(runs):
        log = DRYRUN_DIR / f"job{i}.log"
        with open(log, "w") as f:
            # niced: (b)'s host-bound steps keep the host's first claim
            proc = subprocess.Popen(base + args, cwd=ROOT, env=env,
                                    stdout=f, stderr=subprocess.STDOUT,
                                    preexec_fn=lambda: os.nice(10),
                                    start_new_session=True)
        done: dict = {}
        # a waiter per job notes when it ends, while (b) holds the card
        waiter = threading.Thread(target=_note_end, daemon=True,
                                  args=(proc, done, time.perf_counter()))
        waiter.start()
        jobs.append((label, proc, log, waiter, done))
    return jobs


def _note_end(proc, done: dict, t0: float) -> None:
    done["rc"] = proc.wait()
    done["wall_s"] = time.perf_counter() - t0


def stop_dryrun_jobs(jobs: list) -> None:
    """Kill every job still running, with the workers it forked (each job
    leads a session of its own)."""
    for _, proc, _, _, _ in jobs:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def join_dryrun_jobs(jobs: list, timeout: float) -> dict:
    """Wait for every job; raise unless each exited 0 and wrote only
    ``ok`` records. Returns the walls and the records by file name."""
    walls = {}
    end = time.perf_counter() + max(1.0, timeout)
    for label, proc, log, waiter, done in jobs:
        waiter.join(max(0.0, end - time.perf_counter()))
        if "rc" not in done:
            raise AssertionError(f"dry-run job {label!r} still running "
                                 f"after {timeout:.0f} s")
        walls[label], rc = done["wall_s"], done["rc"]
        if rc != 0:
            raise AssertionError(f"dry-run job {label!r} exit {rc}:\n"
                                 + log.read_text()[-3000:])
    recs = {}
    for path in sorted(DRYRUN_DIR.glob("*/*.json")):
        rec = json.loads(path.read_text())
        if rec["status"] != "ok":
            raise AssertionError(f"{path.name}: {rec.get('error')}")
        recs[f"{path.parent.name}/{path.stem}"] = rec
    return dict(walls=walls, records=recs)


def check_fwht_cells(led: Ledger, gen: torch.Generator, dev) -> None:
    """fwht (block 256) over the 768-wide (576 padded) activations of the
    measured cells' projections, M = 32 and 32,768: the plain version's
    bits, timed beside ``x @ H``."""
    h = hadamard_matrix(256, device=dev)
    for m in CELL_FWHT_ROWS:
        x = torch.randn(m, 768, generator=gen, device=dev)
        got, want = fwht(x, 256), fwht_ref(x, 256)
        err, rel = rel_err(got, want)
        if err != 0:
            raise AssertionError(f"fwht ({m},768): max abs error {err}")
        led.add("fwht_cells", f"({m},768)", err=err, rel=rel,
                ms=device_ms(lambda: fwht(x, 256)),
                plain_ms=device_ms(lambda: fwht_ref(x, 256), reps=2),
                library_ms=device_ms(lambda: x.view(-1, 256) @ h, reps=2),
                nbytes=2 * m * 768 * 4, flops=m * 768 * 9)


def _cell_logits(cell, backends, forced: bool):
    """Last-position f32 logits of ``cell``'s step input through each of
    ``backends`` (no autocast, no grad). ``forced``: layer by layer, every
    route fed the last route's input at each layer (a decode cell attends
    its cache with the token's own K/V, writing nothing), as phase 5's
    ``two_paths``."""
    from repro_torch.models import lm

    cfg = cell.cfg
    rts = [dataclasses.replace(cell.rt, backend=b) for b in backends]
    if cell.shape.kind == "decode":
        params, tokens, cache, pos = cell.args
    else:
        params, batch = cell.args
        params = getattr(params, "params", params)  # a TrainState's
        tokens, cache, pos = batch["tokens"], None, 0
    with torch.no_grad():
        if not forced:
            if cache is not None:
                return [lm.decode_step(params, tokens, cache, pos, rt,
                                       cfg)[0] for rt in rts]
            return [lm.forward(params, tokens, rt, cfg, last_only=True)[0]
                    for rt in rts]
        x = lm._embed(params, tokens.to(torch.int64))
        for i in range(cfg.num_layers):
            lp = lm.layer_params(params["layers"], i)
            kw = (dict(cache=None, pos=0) if cache is None else
                  dict(cache=lm._layer_cache(cache, i), pos=pos,
                       token_cache=True))
            outs = [lm._dense_layer_apply(lp, x, rt, cfg, **kw)[0]
                    for rt in rts]
            x = outs[-1]
        return [lm._head(params, o[:, -1:], rt, cfg)
                for o, rt in zip(outs, rts)]


def _route_ms(cell) -> dict:
    """One step of ``cell`` under ``torch.profiler`` (CUDA activity): the
    device's busy time, the self time of every kernel and copy on its one
    stream; the host wall of that step (traced, and the route's first, so
    it also loads what the route first uses: an upper bound); the
    ``csrc/`` launches of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = collections.Counter(_build.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cell.run()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    launches = {k: v - before.get(k, 0) for k, v in _build.launches.items()
                if v != before.get(k, 0)}
    return dict(device_ms=busy, traced_wall_ms=wall, launches=launches,
                top_kernels_ms=[(e.key[:50], e.self_device_time_total / 1e3)
                                for e in top])


def _cut_record(cuts: dict, shape_name: str, rows: int) -> dict:
    return cuts[f"cuts/{CELL_ARCH}_{shape_name}_one_activations_rows{rows}"]


def measure_cell(shape_name: str, rows: int, dev) -> dict:
    """(b) for one cell: its own step function (``launch/steps.py``) on
    real seeded tensors on a one-device mesh, the global batch cut to
    ``rows``, timed on both routes (``_route_ms``): ``ref``, the plain
    path the dry-run counts, and ``auto``, the card's kernels. Then the
    f32 route check: the last-position logits layer-forced within
    LOGITS_REL_TOL of the largest (held) and apart (reported)."""
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.launch.steps import build_cell

    cell = build_cell(CELL_ARCH, shape_name, local_mesh(dev), fake=False,
                      rows=rows, seed=18)
    out = {"rows": rows, "seq_len": cell.shape.seq_len,
           "reduced": [f"global_batch {cell.shape.global_batch} -> {rows}",
                       "one device (1 x 1 mesh)"]}
    for route in ("ref", "auto"):
        out[route] = _route_ms(cell.with_backend(route))
        if route == "ref" and out[route]["launches"]:
            raise AssertionError(f"{shape_name}: the plain route launched "
                                 f"{out[route]['launches']}")
        torch.cuda.empty_cache()
    forced = _cell_logits(cell, ("auto", "ref"), forced=True)
    err, rel = rel_err(forced[0], forced[1])
    apart = _cell_logits(cell, ("auto", "ref"), forced=False)
    a_err, a_rel = rel_err(apart[0], apart[1])
    out["f32"] = dict(forced_abs=err, forced_rel=rel, apart_abs=a_err,
                      apart_rel=a_rel,
                      finite=bool(torch.isfinite(apart[1]).all()))
    if not rel <= LOGITS_REL_TOL or not out["f32"]["finite"]:
        raise AssertionError(f"{shape_name}: f32 routes, layer-forced, rel "
                             f"{rel:.3e} > {LOGITS_REL_TOL} (or not finite)")
    del cell, forced, apart
    torch.cuda.empty_cache()
    return out


def check_cell_widths(led: Ledger, gen: torch.Generator, dev) -> None:
    """Rows 1 and 3 at phase 18 (b)'s shapes (``fwht_cells``,
    ``itq3_matmul_cells``)."""
    check_fwht_cells(led, gen, dev)
    check_widths(led, gen, dev, CELL_SHAPES, "cells")
    print("  measured cells' widths: fwht bit-equal, itq3_matmul within "
          "1e-4, two calls bit-equal, at M = 32 and 32,768", flush=True)


def dryrun_phase(dev, report: dict) -> dict:
    """Phase 18. (a) and the cut counts start as host processes; (b) runs
    the three cells on the card, with the launch counters reset before
    them (the seeded model's quantization included) and read after them;
    then (a) is joined: every record ``ok``. Returns the launches of (b).
    Rows 1 and 3 at (b)'s shapes are phase 3's (``check_cell_widths``)."""
    t0 = time.perf_counter()
    jobs = start_dryrun_jobs()
    try:
        return _dryrun_phase(dev, report, jobs, t0)
    finally:
        stop_dryrun_jobs(jobs)


def _dryrun_phase(dev, report: dict, jobs: list, t0: float) -> dict:
    print(f"phase 18 (a): {len(jobs)} dry-run processes started on the "
          f"host ({', '.join(j[0] for j in jobs)})", flush=True)
    _build.reset_launches()
    cells = {}
    for shape_name, rows in MEASURED_CELLS:
        cells[shape_name] = measure_cell(shape_name, rows, dev)
        c = cells[shape_name]
        print(f"phase 18 (b): {CELL_ARCH} {shape_name}, {rows} row(s): "
              f"device ms/step ref {c['ref']['device_ms']:.2f}, auto "
              f"{c['auto']['device_ms']:.2f} (launches "
              f"{c['auto']['launches']}); traced first step's wall ms ref "
              f"{c['ref']['traced_wall_ms']:.1f}, auto "
              f"{c['auto']['traced_wall_ms']:.1f}; "
              f"f32 routes layer-forced rel {c['f32']['forced_rel']:.2e}, "
              f"apart rel {c['f32']['apart_rel']:.2e}", flush=True)
    counts = dict(_build.launches)
    missing = [k for k in ("quantize_blocks", "fwht/256", "itq3_matmul")
               if not counts.get(k)]
    if missing:
        raise AssertionError(f"phase 18 (b) launched none of {missing}")
    budget = 600 - (time.perf_counter() - t0)
    dry = join_dryrun_jobs(jobs, budget)
    for shape_name, rows in MEASURED_CELLS:
        c, rec = cells[shape_name], _cut_record(dry["records"], shape_name,
                                                rows)
        terms = {k: v * 1e3 for k, v in rec["roofline"].items()}  # ms
        c["counted"] = dict(flops=rec["hlo_flops"], bytes=rec["hlo_bytes"],
                            model_flops=rec["model_flops_global"],
                            terms_ms=terms)
        c["term_over_measured"] = {
            route: {k: v / c[route]["device_ms"] for k, v in terms.items()}
            for route in ("ref", "auto")}
        print(f"  {shape_name}: counted {rec['hlo_flops']:.4g} FLOPs, "
              f"{rec['hlo_bytes']:.4g} bytes; terms compute "
              f"{terms['compute_s']:.3f} ms, memory {terms['memory_s']:.3f} "
              f"ms over the measured ref {c['ref']['device_ms']:.2f} ms: "
              f"{c['term_over_measured']['ref']['compute_s']:.4f} and "
              f"{c['term_over_measured']['ref']['memory_s']:.4f}", flush=True)
    for name, rec in dry["records"].items():
        if name.startswith("records/"):
            print(f"  record {rec['arch']} {rec['shape']} {rec['mesh']}: "
                  f"traced {rec['trace_s']} s; {rec['hlo_flops']:.4g} FLOPs, "
                  f"{rec['hlo_bytes']:.4g} bytes, collectives "
                  f"{rec['collective_bytes']} per device; bottleneck "
                  f"{rec['bottleneck']}, useful "
                  f"{rec['useful_flops_frac']:.4f}", flush=True)
    print("  dry-run process walls (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in dry["walls"].items()), flush=True)
    report["dryrun"] = dict(cells=cells, walls=dry["walls"],
                            records=dry["records"])
    return counts


def profile_phase(run, report: dict, key: str = "profile",
                  table: Path = TABLE, steps: int | None = None) -> None:
    """With ``--profile``: one shorter kernel-path serving run (``run()``,
    ``PROFILE_NEW`` new tokens per request) under ``torch.profiler``; the device's busy time is the sum of the self
    device time of every kernel and copy on the card (one stream, so they
    never overlap). Tracing slows the host, so the idle share read here is
    an upper bound on the unprofiled run's. Also counts the PyTorch
    operator calls the host issued (nested calls included), per layer and
    forward pass. ``steps``: ``run()`` traces a window of that many decode
    steps after an untraced admission, of an engine or of a model-level
    loop (whose first return value then only carries ``cfg``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng, _, wall, _ = run()
    events = prof.key_averages()
    # device-side rows only: the operator rows repeat their kernels' time
    busy_s = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA) / 1e6
    what = "serving run" if steps is None else f"{steps}-step decode window"
    if steps is None:
        st = eng.stats()
        steps = st["decode_steps"]
        passes = (steps + st["prefill_waves"]) * eng.cfg.num_layers
    else:
        passes = steps * eng.cfg.num_layers
    ops = sum(e.count for e in events if e.device_type == DeviceType.CPU
              and e.key.startswith("aten::"))
    report[key] = dict(wall_s=wall, device_busy_s=busy_s,
                       idle_share=1 - busy_s / wall,
                       decode_steps=steps,
                       aten_calls_per_layer_pass=ops / passes)
    table.parent.mkdir(parents=True, exist_ok=True)
    table.write_text(events.table(sort_by="self_device_time_total",
                                  row_limit=40))
    print(f"  profiled {what}: device busy {busy_s:.3f} s of "
          f"{wall:.3f} s wall (idle share {1 - busy_s / wall:.3f}); "
          f"{ops / passes:.0f} aten calls per layer and forward pass; "
          f"kernel table in {table.relative_to(ROOT)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after building and checking the kernels")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one short serving run of each path "
                         "with torch.profiler")
    ap.add_argument("--tp-only", action="store_true",
                    help="build the kernels, then run phase 15 (b) alone: "
                         "tensor-parallel serving over every card (up to "
                         "4) against the single-device engine")
    ap.add_argument("--train-only", action="store_true",
                    help="build the kernels, then run phase 16 alone: "
                         "training on one card, then serving the trained "
                         "weights")
    ap.add_argument("--train-mesh-only", action="store_true",
                    help="build the kernels, then run phase 17 alone: "
                         "training on a mesh of every card (up to 4), then "
                         "serving the mesh-trained weights")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="build the kernels, then run phase 18 alone: the "
                         "dry-run's records and three cells measured on "
                         "one card")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # tolerances assume f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    report: dict = {}

    kind, smi = card_report()
    print(f"phase 1: card {kind!r}; nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    builds = _build.build()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {k: v["ptxas"] for k, v in builds.items()}
    print(f"phase 2: built {len(builds)} kernels with nvcc for sm_90a in "
          f"{report['build_s']:.1f} s "
          f"({', '.join(f'{k} {v['seconds']:.1f} s' for k, v in builds.items())})",
          flush=True)
    for k, v in builds.items():
        for line in v["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {k}: {line.strip()}")

    if (args.tp_only or args.train_only or args.train_mesh_only
            or args.dryrun_only):
        t0 = time.perf_counter()
        if args.tp_only:
            tp_phase(dev, report, shards=False)
        elif args.train_only:
            report["train_launches"] = train_phase(dev, report)
            print(f"phase walls (s): 16 {time.perf_counter() - t0:.1f}",
                  flush=True)
        elif args.dryrun_only:
            report["dryrun_launches"] = dryrun_phase(dev, report)
            print(f"phase walls (s): 18 {time.perf_counter() - t0:.1f}",
                  flush=True)
        else:
            report["mesh_launches"] = mesh_phase(dev, report)
            print(f"phase walls (s): 17 {time.perf_counter() - t0:.1f}",
                  flush=True)
        DETAILS.parent.mkdir(parents=True, exist_ok=True)
        DETAILS.write_text(json.dumps(report, indent=1, default=str))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    # the wall of each phase (and of phase 3's parts), printed at the end
    laps = {"start": time.perf_counter()}

    def lap(name: str) -> None:
        laps[name] = time.perf_counter()

    print("phase 3: kernels vs plain versions at smollm-135m main-path "
          "shapes (ms = median device time of one call)", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    led = Ledger()
    check_fwht(led, gen, dev)
    check_fwht_act(led, gen, dev, report)
    check_fwht_kv(led, gen, dev, report)
    fwht_ptxas_report(report)
    proj = quantize_smollm_projections(gen, dev)
    check_matvec(led, gen, dev, proj, report)
    check_itq3(led, gen, dev, proj, report)
    check_attn(led, gen, dev)
    int8w = int8_weights(gen, dev)
    check_itq3_int8(led, gen, dev, int8w, report)
    check_quantize(led, gen, dev, report)
    check_attn_paged(led, gen, dev, report)
    check_attn_edges(gen, dev, report)
    attn_grid_report(report)
    attn_cut_sweep(gen, dev, report, timed=not args.profile)
    check_matvec_edges(gen, dev, report)
    matvec_tile_sweep(gen, dev, proj, report, timed=not args.profile)
    matvec_ptxas_report(report)
    check_matmul_edges(gen, dev, report)
    matmul_tile_sweep(gen, dev, proj, report, timed=not args.profile)
    matmul_ptxas_report(report)
    check_int8_edges(gen, dev, report)
    int8_tile_sweep(gen, dev, int8w, report, timed=not args.profile)
    int8_ptxas_report(report)
    lap("3 smollm")
    print("phase 3 (MoE and dense family): the expert axis at olmoe's "
          "shapes, head_dim 128 attention, the dense family's widths",
          flush=True)
    check_experts(led, gen, dev, report)
    expert_tile_sweep(gen, dev, report, timed=not args.profile)
    check_expert_edges(gen, dev, report)
    check_attn_hd128(led, gen, dev, report)
    check_dense_family_widths(gen, dev, report)
    lap("3 moe+dense")
    print("phase 3 (recurrent families): the contraction kernels at "
          "rwkv6-3b's and zamba2-7b's widths, M = 4 and a 32-row ladder "
          "chunk", flush=True)
    check_ssm_widths(led, gen, dev, report)
    lap("3 recurrent")
    print("phase 3 (frontend families): the contraction kernels at "
          "phi-3-vision-4.2b's and seamless-m4t-medium's widths (K = 160 "
          "padded, M up to 4096), attn_q8 at head_dim 64 with G = 1",
          flush=True)
    check_frontend_widths(led, gen, dev, report)
    lap("3 frontend")
    print("phase 3 (measured cells): fwht and itq3_matmul at phase 18 "
          "(b)'s shapes, M = 32 and 32,768", flush=True)
    check_cell_widths(led, gen, dev)
    lap("3 cells")
    report["kernel_rows"] = led.rows

    # each kernel's launches from the counted run of its own path: the
    # float path (phase 4) for fwht, fwht_kv and the next three, the W3A8
    # path (phase 7: quantize, then serve) for fwht_act and the next three,
    # the paged path (phase 8 a) for the last
    counts = {}
    if not args.kernels_only:
        cfg = get_config("smollm-135m")
        counts, dense_reqs = serve_phase(dev, report, cfg,
                                         profile=args.profile)
        lap("4-6")
        w3a8, w3a8_reqs = w3a8_phase(dev, report, cfg, profile=args.profile)
        lap("7")
        # the FWHT forms count their launches per block size: the line
        # takes the sum
        for form in ("fwht", "fwht_act", "fwht_kv"):
            path = w3a8 if form == "fwht_act" else counts
            counts[form] = sum(v for k, v in path.items()
                               if k.startswith(f"{form}/"))
        counts.update({k: w3a8[k] for k in (
            "itq3_matvec_int8", "itq3_matmul_int8", "quantize_blocks")})
        paged = paged_phase(dev, report, cfg, dense_reqs,
                            profile=args.profile)
        counts["attn_q8_paged"] = paged["attn_q8_paged"]
        lap("8")
        sampled_phase(dev, report, cfg, w3a8_reqs)
        chaos_phase(dev, report, cfg)
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        lap("9")
        report["spec_launches"] = spec_phase(dev, report, cfg, dense_reqs)
        lap("10")
        # the MoE path (phase 11) launches the expert forms and the head_dim
        # 128 attention; phase 12 the rest of the dense family
        moe = moe_phase(dev, report)
        counts.update({k: v for k, v in moe.items() if k.endswith("_experts")})
        counts["attn_q8_hd128"] = moe["attn_q8"]
        lap("11")
        dense_family_phase(dev, report)
        lap("12")
        # phase 13 launches the contraction kernels at the recurrent widths
        recurrent = recurrent_phase(dev, report)
        counts.update({f"{k}_ssm": recurrent.get(k, 0) for k in (
            "itq3_matvec", "itq3_matmul", "itq3_matvec_int8",
            "itq3_matmul_int8")})
        lap("13")
        # phase 14 launches them (and seamless's attention) at the
        # frontend widths
        frontend = frontend_phase(dev, report)
        counts.update({f"{k}_frontend": frontend.get(k, 0) for k in (
            "itq3_matvec", "itq3_matmul", "itq3_matvec_int8",
            "itq3_matmul_int8", "attn_q8")})
        lap("14")
        # phase 15: tensor-parallel serving (its launches are held equal to
        # the single-device runs' inside the phase)
        report["tp_launches"] = tp_phase(dev, report)
        lap("15")
        # phase 16: training, then the trained weights served on the float
        # path (its launches are held to phase 4's contract in the phase)
        report["train_launches"] = train_phase(dev, report)
        lap("16")
        # phase 17: training on a mesh of ranks, then the mesh-trained
        # weights served (held to phase 4's contract in the phase)
        report["mesh_launches"] = mesh_phase(dev, report)
        lap("17")
        # phase 18: the dry-run's records (host processes) and three cells
        # on the card, whose kernel route launches rows 1, 3 and 7
        cells = dryrun_phase(dev, report)
        counts["fwht_cells"] = cells.get("fwht/256", 0)
        counts["itq3_matmul_cells"] = cells.get("itq3_matmul", 0)
        lap("18")
    names = list(laps)
    report["phase_s"] = {b: laps[b] - laps[a] for a, b in zip(names,
                                                               names[1:])}
    print("phase walls (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in report["phase_s"].items()), flush=True)

    # kernel -> (source, the TPU kernel it replaces)
    kernel_table = {
        "fwht": ("fwht", "src/repro/kernels/fwht_kernel.py:39"),
        "fwht_act": ("fwht", "src/repro/kernels/fwht_kernel.py:39 + "
                             "src/repro/core/act_quant.py:41"),
        "fwht_kv": ("fwht", "src/repro/kernels/fwht_kernel.py:39 + "
                            "src/repro/serve/kv_quant.py:47"),
        "itq3_matvec": ("itq3_matvec", "src/repro/kernels/itq3_matvec.py:82"),
        "itq3_matmul": ("itq3_matmul", "src/repro/kernels/itq3_matmul.py:339"),
        "attn_q8": ("attn_q8", "src/repro/kernels/attn_decode.py:230"),
        "itq3_matvec_int8": ("itq3_matvec_int8",
                             "src/repro/kernels/itq3_matvec.py:183"),
        "itq3_matmul_int8": ("itq3_matmul_int8",
                             "src/repro/kernels/itq3_matmul.py:436"),
        "quantize_blocks": ("quantize_blocks",
                            "src/repro/kernels/quantize_kernel.py:51"),
        "attn_q8_paged": ("attn_q8",
                          "src/repro/kernels/attn_decode.py:230 (table)"),
        # the expert axis: the reference vmaps dense over the stacked
        # experts (src/repro/models/moe.py:44), one pallas_call with an
        # extra grid axis
        "itq3_matvec_experts": ("itq3_matvec",
                                "src/repro/kernels/itq3_matvec.py:82 "
                                "(vmapped over experts)"),
        "itq3_matmul_experts": ("itq3_matmul",
                                "src/repro/kernels/itq3_matmul.py:339 "
                                "(vmapped over experts)"),
        "itq3_matvec_int8_experts": ("itq3_matvec_int8",
                                     "src/repro/kernels/itq3_matvec.py:183 "
                                     "(vmapped over experts)"),
        "itq3_matmul_int8_experts": ("itq3_matmul_int8",
                                     "src/repro/kernels/itq3_matmul.py:436 "
                                     "(vmapped over experts)"),
        "attn_q8_hd128": ("attn_q8",
                          "src/repro/kernels/attn_decode.py:230 "
                          "(head_dim 128)"),
        # the recurrent families' widths (phase 13): K = 2560 to 8960, N up
        # to rwkv6's 65,536-column head
        "itq3_matvec_ssm": ("itq3_matvec",
                            "src/repro/kernels/itq3_matvec.py:82 "
                            "(recurrent widths)"),
        "itq3_matmul_ssm": ("itq3_matmul",
                            "src/repro/kernels/itq3_matmul.py:339 "
                            "(recurrent widths)"),
        "itq3_matvec_int8_ssm": ("itq3_matvec_int8",
                                 "src/repro/kernels/itq3_matvec.py:183 "
                                 "(recurrent widths)"),
        "itq3_matmul_int8_ssm": ("itq3_matmul_int8",
                                 "src/repro/kernels/itq3_matmul.py:436 "
                                 "(recurrent widths)"),
        # the frontend families' widths (phase 14): K = 160 (one padded
        # block) to 8192, M up to 4096; the attention at HD 64, G = 1
        "itq3_matvec_frontend": ("itq3_matvec",
                                 "src/repro/kernels/itq3_matvec.py:82 "
                                 "(frontend widths)"),
        "itq3_matmul_frontend": ("itq3_matmul",
                                 "src/repro/kernels/itq3_matmul.py:339 "
                                 "(frontend widths)"),
        "itq3_matvec_int8_frontend": ("itq3_matvec_int8",
                                      "src/repro/kernels/itq3_matvec.py:183 "
                                      "(frontend widths)"),
        "itq3_matmul_int8_frontend": ("itq3_matmul_int8",
                                      "src/repro/kernels/itq3_matmul.py:436 "
                                      "(frontend widths)"),
        "attn_q8_frontend": ("attn_q8",
                             "src/repro/kernels/attn_decode.py:230 "
                             "(head_dim 64, G = 1)"),
        # the measured dry-run cells (phase 18 (b)): M = 32 and 32,768
        "fwht_cells": ("fwht", "src/repro/kernels/fwht_kernel.py:39 "
                               "(M = 32 and 32,768)"),
        "itq3_matmul_cells": ("itq3_matmul",
                              "src/repro/kernels/itq3_matmul.py:339 "
                              "(M = 32 and 32,768)"),
    }
    kernels = []
    for name, (source, replaces) in kernel_table.items():
        s = led.summary(name)
        v = led.summary(name, verify=True)
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{source}.cu",
            replaces=replaces, launches=int(counts.get(name, 0)),
            max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
            bound_ms=s["bound_ms"], bound_by=s["bound_by"],
            library_ms=s["library_ms"], shapes=s["shapes"],
            **({"chain_ms": s["chain_ms"]} if "chain_ms" in s else {}),
            **({"verify": v} if v else {})))
    report["kernels"] = kernels
    DETAILS.parent.mkdir(parents=True, exist_ok=True)
    DETAILS.write_text(json.dumps(report, indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
