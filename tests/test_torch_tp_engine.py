"""Tensor-parallel serving of the port on two gloo ranks, on the CPU.

Two ranks are spawned once for the module (``torch.multiprocessing``, a
``file://`` store under the test's temporary directory, one intra-op
thread each) and run every scenario of ``_torch_tp_worker.py`` through
``ServeEngine(mesh=make_host_mesh(1, 2))``; the test process runs the same
scenarios on one device meanwhile. At ``reduced()`` size, ``itq3_s``
planes bridged from the reference:

* every rank's streams, terminal events (at the same decode step) and
  teacher-forced logits equal the single-process engine's bit for bit,
  and each other's;
* every scenario's streams equal the live JAX single-device engine's
  token for token: dense qwen1.5 on the int8 cache (its 4 KV heads
  divide), smollm (1 KV head: the replicated GQA fallback, so
  ``cache_bytes_per_device == cache_bytes``), olmoe under expert
  parallelism, qwen3-moe-235b-a22b (expert parallel and one KV head), the
  zamba2 hybrid, the paged pool, W3A8, a speculative
  1-layer self-draft (``place_draft``), ``from_checkpoint(mesh=...)``
  after a ``ckpt.save`` (the sharded restore leaf-equal to the plain
  restore's rows, some leaves really split) and a deadline that expires
  mid-stream (both ranks take the same event at the same tick);
* the launcher's ``--mesh`` under ``torchrun`` equals its plain run.
"""
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

import _torch_tp_worker as W
from repro.models.layers import Runtime as JRuntime
from repro.serve import faults as jfaults
from repro.serve import spec as jspec
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import ckpt as tckpt
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import jax_quantized_params, to_numpy_tree

WORLD = 2
ARCHS = sorted({arch for arch, _, _ in W.SCENARIOS.values()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the single-process results, each rank's results) of every
    scenario; the ranks run while the test process serves its own and
    runs the live JAX engine's."""
    tmp = str(tmp_path_factory.mktemp("tp"))
    trees = {arch: params_from_numpy(
        to_numpy_tree(jax_quantized_params(arch, "itq3_s")[1]),
        device="cpu") for arch in ARCHS}
    torch.save(trees, os.path.join(tmp, "trees.pt"))
    tckpt.save(os.path.join(tmp, "ckpt"), 0, trees["qwen1.5-0.5b"])
    ctx = torch.multiprocessing.start_processes(
        W.rank_main, args=(WORLD, f"file://{tmp}/store", tmp),
        nprocs=WORLD, join=False, start_method="spawn")
    try:
        single = {name: W.run_scenario(name, trees, tmp, None)
                  for name in W.SCENARIOS}
        for name in W.SCENARIOS:
            _jax_run(_jax_twin(name))
        while not ctx.join(timeout=600):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return single, ranks


@pytest.mark.parametrize("name", list(W.SCENARIOS))
def test_ranks_equal_single_process_bit_for_bit(runs, name):
    single, ranks = runs
    want = single[name]
    for r, res in enumerate(ranks):
        got = res[name]
        assert got["streams"] == want["streams"], (name, r)
        assert got["events"] == want["events"], (name, r)
        assert got["reasons"] == want["reasons"]
        if "logits" in want:
            assert all(torch.equal(a, b) for a, b in zip(got["logits"],
                                                         want["logits"]))
        st = got["stats"]
        assert st["devices"] == WORLD and st["tp_shard_map"] is True
        for key in ("cache_bytes", "host_syncs", "decode_steps",
                    "prefill_waves", "deadline_expired", "draft_accepted",
                    "spec_steps", "pool_blocks_used"):
            assert st[key] == want["stats"][key], (name, key)
    assert all(len(s) > 0 for s in want["streams"])


def test_cache_is_head_sharded_or_replicated(runs):
    _, ranks = runs
    for res in ranks:
        for name in ("dense_q8", "moe_expert_parallel", "paged", "w3a8"):
            st = res[name]["stats"]
            assert st["cache_bytes_per_device"] * WORLD == st["cache_bytes"]
        # one KV head (smollm, qwen3-moe): the GQA fallback keeps the
        # whole cache
        for name in ("gqa_fallback", "qwen3_moe"):
            st = res[name]["stats"]
            assert st["cache_bytes_per_device"] == st["cache_bytes"]
        # the hybrid's recurrent state stays whole beside its KV shards
        st = res["hybrid"]["stats"]
        assert st["cache_bytes"] / WORLD < st["cache_bytes_per_device"] < \
            st["cache_bytes"]


def test_float_format_leaf_quantized_table_and_clock(runs):
    """The rarer placed leaves gather exactly, and every rank reads rank
    0's clock: one broadcast per read outside a tick, one per tick."""
    _, ranks = runs
    for res in ranks:
        edges = res["edges"]
        assert edges["tp_qmatmul_fp16"] and edges["tp_qmatmul_itq3_s"]
        assert edges["split_fp16"] and edges["split_itq3_s"]
        assert edges["full_table"]
        assert edges["clock"] == [100.0, 101.0, 102.0, 102.0]


def test_sharded_restore_equals_plain_restore(runs):
    single, ranks = runs
    for res in ranks:
        rec = res["from_checkpoint"]["restore"]
        assert rec["equal"] == rec["leaves"] and rec["split"] > 0
    # booted from disk, the streams are those of the params it saved
    assert single["from_checkpoint"]["streams"] == \
        single["dense_q8"]["streams"]


def test_deadline_expires_mid_stream_on_every_rank_at_once(runs):
    single, ranks = runs
    ev = single["deadline"]
    assert set(ev["reasons"]) == {"deadline"}
    assert ev["stats"]["deadline_expired"] == W.SLOTS
    steps = {s for s, _, _, _, reason in ev["events"] if reason == "deadline"}
    assert len(steps) == 1 and steps.pop() >= W.SKIP_STEP
    assert all(0 < len(s) < W.MAX_NEW for s in ev["streams"])
    assert ranks[0]["deadline"]["events"] == ranks[1]["deadline"]["events"]


@functools.lru_cache(maxsize=None)
def _jax_run(name: str):
    """The scenario on the live JAX single-device engine: streams and
    finish reasons."""
    arch, _, opts = W.SCENARIOS[name]
    cfg, jq = jax_quantized_params(arch, "itq3_s")
    kw = dict(slots=W.SLOTS, max_len=W.MAX_LEN, prompt_pad=W.PROMPT_PAD,
              rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True,
                          backend="ref",
                          act_quant=opts.get("act_quant", False)))
    if opts.get("paged"):
        kw.update(paged=True, block_size=opts["block_size"])
    if "prompt_chunk" in opts:
        kw["prompt_chunk"] = opts["prompt_chunk"]
    if opts.get("draft_depth"):
        kw["draft_params"], kw["draft_cfg"] = jspec.draft_from_params(
            jq, cfg, opts["draft_depth"])
        kw["num_draft_tokens"] = W.K
    extra = {}
    if opts.get("deadline"):
        kw["faults"] = jfaults.FaultPlan([jfaults.Fault(
            "clock_skip", step=W.SKIP_STEP, dt=W.SKIP_S)])
        extra = {"deadline_ms": W.DEADLINE_MS}
    reqs = W.requests(name, JRequest, JSamplingParams, **extra)
    JServeEngine(jq, cfg, **kw).run(reqs)
    return [list(r.out) for r in reqs], [r.finish_reason for r in reqs]


def _jax_twin(name: str) -> str:
    """The JAX run a scenario is held to: ``from_checkpoint`` boots the
    dense scenario's params and serves its requests."""
    return "dense_q8" if name == "from_checkpoint" else name


@pytest.mark.parametrize("name", list(W.SCENARIOS))
def test_streams_equal_live_jax_engine(runs, name):
    single, ranks = runs
    streams, reasons = _jax_run(_jax_twin(name))
    assert single[name]["streams"] == streams
    assert single[name]["reasons"] == reasons
    assert ranks[0][name]["streams"] == streams


def test_launcher_mesh_under_torchrun_equals_plain_run(tmp_path):
    args = ["-m", "repro_torch.launch.serve", "--reduced", "--kv-quant",
            "--device", "cpu", "--requests", "3", "--max-new", "4"]
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))

    def ids(out):
        return [line for line in out.splitlines()
                if line.strip().startswith("rid=")]

    plain = subprocess.run([sys.executable, *args], capture_output=True,
                           text=True, env=env, timeout=300, check=True)
    tp = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), *args, "--mesh", f"1,{WORLD}"],
        capture_output=True, text=True, env=env, timeout=300,
        cwd=tmp_path)
    assert tp.returncode == 0, tp.stderr[-3000:]
    assert ids(tp.stdout) == ids(plain.stdout) and len(ids(plain.stdout)) == 3
    assert "serving mesh: {'data': 1, 'model': 2}" in tp.stdout
    assert f"tensor-parallel: {WORLD} ranks" in tp.stdout
    assert tp.stdout.count("served 3 requests") == 1  # only rank 0 prints
