"""The scenarios of ``test_torch_tp_engine.py``, run alike by the test
process (one device, no mesh) and by each spawned gloo rank (a
``make_host_mesh(1, 2)`` mesh over a ``file://`` store), so both sides
serve exactly the same engines and requests. It imports torch and the
port only: a spawned rank never loads JAX.

Each scenario returns plain data: the streams, the terminal events in
order, a few ``stats()`` keys and, where named, teacher-forced logits.
"""
import os

import numpy as np
import torch

SLOTS, MAX_LEN, PROMPT_PAD, MAX_NEW, CHUNK, K = 4, 64, 16, 8, 8, 2
# greedy rows, a temperature, top-k / top-p under an explicit seed
MIX = [dict(), dict(temperature=0.8), dict(),
       dict(temperature=1.0, top_k=40, top_p=0.9, seed=3)]
SCENARIOS = {
    # name: (arch, sampled, engine options)
    "dense_q8": ("qwen1.5-0.5b", True, {}),
    "gqa_fallback": ("smollm-135m", False, {}),
    "moe_expert_parallel": ("olmoe-1b-7b", False, {}),
    # 8 experts over 2 ranks, 1 KV head: expert parallel beside the GQA
    # fallback (its full depth waits for a machine with 2 or more cards)
    "qwen3_moe": ("qwen3-moe-235b-a22b", False, {}),
    "hybrid": ("zamba2-7b", True, {"prompt_chunk": CHUNK}),
    "paged": ("qwen1.5-0.5b", True, {"paged": True, "block_size": 8}),
    "w3a8": ("qwen1.5-0.5b", False, {"act_quant": True}),
    "speculative": ("qwen1.5-0.5b", True, {"draft_depth": 1}),
    "from_checkpoint": ("qwen1.5-0.5b", True, {"checkpoint": True}),
    "deadline": ("qwen1.5-0.5b", False, {"deadline": True}),
}
# the deadline scenario: every request may run 5 s; a 10 s clock skip at
# decode step 3 expires the live ones at the next tick
DEADLINE_MS, SKIP_STEP, SKIP_S = 5000.0, 3, 10.0


def prompts(name: str, n: int = SLOTS) -> list:
    """One prompt bucket, one admission wave; the hybrid's prompts are one
    ladder chunk each (the live JAX engine compiles each chunk length
    apart; the ladder itself is ``test_torch_ssm_engine.py``'s)."""
    rng = np.random.default_rng(7)
    lens = ([CHUNK] * n if name == "hybrid"
            else rng.integers(3, PROMPT_PAD + 1, size=n))
    return [rng.integers(0, 512, size=int(m)).astype(np.int32)
            for m in lens]


def requests(name: str, req_cls, sp_cls, **kw) -> list:
    sampled = SCENARIOS[name][1]
    return [req_cls(rid=i, prompt=p, max_new=MAX_NEW,
                    sampling=sp_cls(ignore_eos=True,
                                    **(MIX[i] if sampled else {})), **kw)
            for i, p in enumerate(prompts(name))]


def _engine(name: str, trees: dict, tmp: str, mesh):
    """The scenario's engine, on this process's trees."""
    from repro_torch import configs
    from repro_torch.models.layers import Runtime
    from repro_torch.serve import spec
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.faults import Fault, FaultPlan

    arch, _, opts = SCENARIOS[name]
    opts = dict(opts)
    cfg = configs.reduced(configs.get_config(arch))
    rt = Runtime(kv_quant=True, act_quant=opts.pop("act_quant", False))
    kw = dict(slots=SLOTS, max_len=MAX_LEN, prompt_pad=PROMPT_PAD, rt=rt,
              device="cpu", mesh=mesh, num_draft_tokens=K)
    if opts.pop("deadline", False):
        kw["faults"] = FaultPlan([Fault("clock_skip", step=SKIP_STEP,
                                        dt=SKIP_S)])
    depth = opts.pop("draft_depth", 0)
    if opts.pop("checkpoint", False):
        return ServeEngine.from_checkpoint(os.path.join(tmp, "ckpt"), cfg,
                                           draft_depth=depth, **kw, **opts)
    params = trees[arch]
    if depth:
        kw["draft_params"], kw["draft_cfg"] = spec.draft_from_params(
            params, cfg, depth)
    return ServeEngine(params, cfg, **kw, **opts)


def forced_logits(eng) -> tuple:
    """Teacher-forced logits through the engine's params and runtime: a
    two-row prefill of 12 tokens, then one forced decode step."""
    from repro_torch.models import lm

    rng = np.random.default_rng(3)
    toks = rng.integers(0, eng.cfg.vocab_size, size=(2, 12))
    cache = eng._new_cache(eng.cfg, 2, eng.rt)
    pre, _ = lm.forward(eng.params, toks, eng.rt, eng.cfg, cache=cache,
                        pos=0)
    nxt = rng.integers(0, eng.cfg.vocab_size, size=(2, 1))
    step, _ = lm.decode_step(eng.params, nxt, cache, 12, eng.rt, eng.cfg)
    return pre, step


def run_scenario(name: str, trees: dict, tmp: str, mesh) -> dict:
    from repro_torch.serve.engine import Request, SamplingParams

    opts = SCENARIOS[name][2]
    eng = _engine(name, trees, tmp, mesh)
    extra = ({"deadline_ms": DEADLINE_MS} if opts.get("deadline") else {})
    reqs = requests(name, Request, SamplingParams, **extra)
    events = []
    for ev in eng.generate(reqs):
        events.append((eng.decode_steps, ev.rid, ev.index, ev.token,
                       ev.finish_reason))
    st = eng.stats()
    out = dict(streams=[list(r.out) for r in reqs], events=events,
               reasons=[r.finish_reason for r in reqs],
               stats={k: st.get(k) for k in (
                   "cache_bytes", "cache_bytes_per_device", "devices",
                   "tp_shard_map", "host_syncs", "decode_steps",
                   "prefill_waves", "deadline_expired", "draft_accepted",
                   "spec_steps", "pool_blocks_used")})
    if name in ("dense_q8", "moe_expert_parallel", "hybrid", "w3a8",
                "gqa_fallback"):
        out["logits"] = forced_logits(eng)
    if name == "from_checkpoint" and mesh is not None:
        out["restore"] = _restore_check(tmp, eng.cfg, mesh)
    return out


def _restore_check(tmp: str, cfg, mesh) -> dict:
    """Sharded restore against the plain one: every leaf this rank holds
    equals its rows of the plain restore; counts the leaves split."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.serve import tp

    path = os.path.join(tmp, "ckpt")
    plain, _ = ckpt.restore_params(path, device="cpu")
    sharded, _ = ckpt.restore_params(
        path, device="cpu", shardings=tp.restore_shardings(cfg, mesh))
    places = tp.param_shardings(plain, cfg, tp.serve_rules(mesh, cfg))
    equal = split = leaves = 0

    def walk(a, b, p):
        nonlocal equal, split, leaves
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], p[k])
            return
        if hasattr(a, "data") and isinstance(a.data, dict):  # QTensor
            for k in a.data:
                walk(a.data[k], b.data[k], p.data[k])
            return
        leaves += 1
        equal += torch.equal(b, p(a))
        split += tuple(b.shape) != tuple(a.shape)

    walk(plain, sharded, places)
    return dict(leaves=leaves, equal=equal, split=split)


def edge_checks(mesh) -> dict:
    """The mesh path's rarer leaves and its clock, on each rank: a float-
    format QTensor (its ``w`` is (K, N), so its shard is K rows) and a
    quantized embedding table (V rows of its (D, V) planes) gathered whole
    by ``tp_qmatmul`` / ``full_table``; ``LockstepClock`` giving rank 0's
    time on every rank, one value per tick."""
    from repro_torch import configs
    from repro_torch.core import formats
    from repro_torch.core.qlinear import qmatmul
    from repro_torch.serve import tp

    cfg = configs.reduced(configs.get_config("qwen1.5-0.5b"))
    rules = tp.serve_rules(mesh, cfg)
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(3, 256, generator=gen)
    out = {}
    for fmt in ("fp16", "itq3_s"):
        whole = formats.quantize(torch.randn(256, 64, generator=gen), fmt)
        placed = tp.shard_params({"w": whole}, cfg, rules)["w"]
        out[f"tp_qmatmul_{fmt}"] = torch.equal(
            tp.tp_qmatmul(x, placed, rules, mode="activations",
                          backend="auto"),
            qmatmul(x, whole, mode="activations", backend="auto"))
        out[f"split_{fmt}"] = any(
            v.shape != whole.data[k].shape for k, v in placed.data.items())
    table = formats.quantize(torch.randn(cfg.d_model, cfg.vocab_size,
                                         generator=gen), "itq3_s")
    placed = tp.shard_params({"embed": table}, cfg, rules)["embed"]
    got = tp.full_table(placed, cfg, rules)
    out["full_table"] = all(torch.equal(got.data[k], v)
                            for k, v in table.data.items())
    ticks = iter(range(100, 200)) if mesh.rank == 0 else iter(range(7, 99))
    clock = tp.LockstepClock(lambda: float(next(ticks)), mesh)
    outside = [clock(), clock()]
    clock.begin_tick()
    inside = [clock(), clock()]
    clock.end_tick()
    out["clock"] = outside + inside
    return out


def rank_main(rank: int, world: int, store: str, tmp: str) -> None:
    """One spawned rank: join the gloo group, run every scenario on one
    intra-op thread, save the results for the test process."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    mesh = make_host_mesh(1, world, device=torch.device("cpu"),
                          init_method=store, rank=rank, world_size=world)
    try:
        trees = torch.load(os.path.join(tmp, "trees.pt"), weights_only=False)
        out = {name: run_scenario(name, trees, tmp, mesh)
               for name in SCENARIOS}
        out["edges"] = edge_checks(mesh)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
