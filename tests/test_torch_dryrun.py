"""The per-cell dry-run (``launch/steps.py``, ``launch/dryrun.py``,
``launch/op_analysis.py``) and what it reads (``configs/base.py``'s
shape cells, ``models/lm.py``'s ``model_flops`` and ``shape_params``), on
the port against the live reference, on the CPU:

* ``SHAPES``, ``runnable_cells()`` and ``model_flops`` (decode and not)
  equal the reference's for every arch x shape;
* the shape-only param trees, float and ``itq3_s``-quantized, have the
  keys, shapes and dtypes of the reference's ``eval_shape`` trees, for
  one config of each family at full width;
* ``_batch_axis_for`` and ``_cache_pspec`` equal the reference's on
  ``AbstractMesh`` (16, 16) and (2, 16, 16), for every cache leaf of each
  family;
* ``param_bytes_per_device`` equals the reference's
  ``_analytic_param_bytes`` for smollm-135m's cells on both meshes;
* ``_op_bytes`` on ``tests/test_hlo_analysis.py``'s four cases, and the
  counter on its fixture (ten (8, 16) @ (16, 16) products and all-reduces
  over a fake group of 4, in a subprocess: a fake group never joins this
  process);
* a reduced smollm-135m ``decode_32k`` cell on one device: its counted
  matmul FLOPs equal the count derived here from the config (the seven
  projections at K padded to the 256-block, the scores, the self score,
  the values, the tied head), and equal the reference's ``analyze_hlo``
  of the same cell exactly (bound 0: both count the same products, the
  FWHT being adds on both sides; there is no term of difference);
* ``python -m repro_torch.launch.dryrun`` on smollm-135m ``decode_32k``,
  ``--mesh both``, writes two ``ok`` records with the reference's keys,
  which ``benchmarks/roofline_report.py`` prints as table rows.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import steps as jsteps
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import lm as jlm
from repro.serve.quantized import quantize_params as jquantize_params
from repro.sharding import rules as jrules
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun, op_analysis, steps
from repro_torch.launch.mesh import local_mesh
from repro_torch.models import lm as tlm
from repro_torch.serve.quantized import QuantPolicy
from repro_torch.sharding import rules as trules
from repro_torch.train import loop as tloop
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FAMILY_ARCHS = ("smollm-135m", "olmoe-1b-7b", "rwkv6-3b", "zamba2-7b",
                "phi-3-vision-4.2b", "seamless-m4t-medium")
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


@functools.lru_cache(maxsize=None)
def _ref_dryrun():
    """``repro.launch.dryrun`` rewrites ``XLA_FLAGS`` when imported: the
    variable is put back at once."""
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return jdryrun


def _abstract(shape: dict):
    return jax.sharding.AbstractMesh(tuple(shape.values()), tuple(shape))


# --- shape cells and model FLOPs ---------------------------------------------

def test_shapes_and_runnable_cells_equal_reference():
    assert {k: (s.name, s.kind, s.seq_len, s.global_batch, s.is_decode)
            for k, s in tbase.SHAPES.items()} == {
        k: (s.name, s.kind, s.seq_len, s.global_batch, s.is_decode)
        for k, s in jbase.SHAPES.items()}
    assert tbase.runnable_cells() == jbase.runnable_cells()
    assert [tbase.get_config(a).sub_quadratic for a in tbase.ARCH_IDS] == [
        jbase.get_config(a).sub_quadratic for a in jbase.ARCH_IDS]


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_model_flops_equal_reference(arch):
    tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    for shape in tbase.SHAPES.values():
        for decode in (False, True):
            got = tlm.model_flops(tcfg, shape.seq_len, shape.global_batch,
                                  decode=decode)
            want = jlm.model_flops(jcfg, shape.seq_len, shape.global_batch,
                                   decode=decode)
            assert got == want, (shape.name, decode)


# --- shape-only trees --------------------------------------------------------

def _flat(tree, prefix=""):
    """{path: (shape, dtype name)}; a QTensor (either package's) by its
    arrays."""
    data = getattr(tree, "data", None)
    if isinstance(data, dict) and hasattr(tree, "meta"):
        tree = {"data": data}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: (tuple(tree.shape),
                     str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_shape_trees_equal_reference_eval_shape(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    jparams = jax.eval_shape(functools.partial(jlm.init_params, cfg=jcfg),
                             jax.random.PRNGKey(0))
    jq = jax.eval_shape(functools.partial(jquantize_params, fmt="itq3_s",
                                          rule="paper"), jparams)
    tparams = tlm.shape_params(tcfg)
    rules = trules.make_rules(SimpleNamespace(shape={"data": 1, "model": 1}),
                              tcfg)
    tq, _ = steps.param_tree(tcfg, "prefill", rules,
                             policy=QuantPolicy.uniform("itq3_s"))
    assert _flat(tparams) == _flat(jparams)
    assert _flat(tq) == _flat(jq)


# --- batch and cache specs -----------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batch_axis_and_cache_pspec_equal_reference(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    for name, shape in MESHES.items():
        am = _abstract(shape)
        jr = jrules.make_rules(am, jcfg)
        tmesh = SimpleNamespace(shape=shape)
        tr = trules.make_rules(tmesh, tcfg)
        for rows in (1, 8, 32, 128, 256):
            assert steps._batch_axis_for(rows, tr, tmesh) == \
                jsteps._batch_axis_for(rows, jr, am), (name, rows)
        for rows, seq in ((128, 32768), (1, 524288)):
            jcache = jax.eval_shape(functools.partial(
                jlm.init_cache, jcfg, rows, seq, dtype=jnp.bfloat16))
            tcache = tlm.init_cache(tcfg, rows, seq, dtype=torch.bfloat16,
                                    device="meta")
            jl, tl = _flat(jcache), {}

            def walk(tree, prefix=""):
                for k, v in tree.items():
                    p = f"{prefix}.{k}" if prefix else k
                    if isinstance(v, dict):
                        walk(v, p)
                    else:
                        tl[p] = v
            walk(tcache)
            assert sorted(tl) == sorted(jl), name
            specs = jax.tree_util.tree_flatten_with_path(jcache)[0]
            for path, leaf in specs:
                key = ".".join(p.key for p in path)
                want = tuple(jsteps._cache_pspec(leaf, jr, am))
                got = steps._cache_pspec(tl[key], tr, tmesh)
                assert got == want, (name, rows, key)


# --- parameter bytes per device --------------------------------------------

@functools.lru_cache(maxsize=None)
def _smollm_tree(kind: str):
    """smollm-135m's whole shape-only argument 0 of a ``train`` or serving
    cell (its specs depend on the mesh, the tree does not)."""
    tcfg = tbase.get_config("smollm-135m")
    rules = trules.make_rules(SimpleNamespace(shape={"data": 1}), tcfg)
    return steps.param_tree(tcfg, kind, rules,
                            policy=QuantPolicy.uniform("itq3_s"))[0]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_bytes_per_device_equal_reference(mesh):
    jdry = _ref_dryrun()
    shape = MESHES[mesh]
    am = _abstract(shape)
    tcfg = tbase.get_config("smollm-135m")
    rules = trules.make_rules(SimpleNamespace(shape=shape), tcfg)
    for cell in ("train_4k", "prefill_32k", "decode_32k"):
        jc = jsteps.build_cell("smollm-135m", cell, am)
        jspecs = jax.tree.map(lambda s: s.spec, jc.in_shardings[0],
                              is_leaf=lambda x: hasattr(x, "spec"))
        want = jdry._analytic_param_bytes(jc.args_sds[0], jspecs, am)
        kind = "train" if cell == "train_4k" else "serve"
        tree = _smollm_tree(kind)
        specs = (tloop.state_specs(tcfg, rules) if kind == "train" else
                 trules.param_pspecs(tree, tcfg, rules))
        got = dryrun.param_bytes_per_device(tree, specs, shape)
        assert got == want, cell


# --- the counter --------------------------------------------------------------

def test_op_bytes_aliasing_model():
    ob = op_analysis._op_bytes
    assert ob("dynamic-update-slice", [1000.0, 10.0], 1000.0) == 20.0
    assert ob("dynamic-slice", [1000.0], 10.0) == 20.0
    assert ob("scatter", [1000.0, 4.0, 10.0], 1000.0) == 24.0
    assert ob("add", [8.0, 8.0], 8.0) == 24.0


def _run(code: str, timeout: int = 240) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=ROOT, text=True, capture_output=True,
                         timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_counter_reproduces_the_reference_fixture():
    """The fixture of ``tests/test_hlo_analysis.py`` run eagerly: a while
    of ten trips of a dot and an all-reduce is ten dispatches of each."""
    out = _run("""
        import json, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        import torch.distributed as dist
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.launch.op_analysis import count_ops
        with fake_world(4), FakeTensorMode():
            x, w = torch.empty(8, 16), torch.empty(16, 16)
            with count_ops() as st:
                for _ in range(10):
                    y = x @ w
                    dist.all_reduce(y)
        assert not dist.is_initialized()
        print(json.dumps(dict(flops=st.flops, dots=st.dot_count,
                              coll=st.collective_bytes,
                              counts=st.collective_counts,
                              whiles=st.dynamic_whiles)))
    """)
    st = json.loads(out.strip().splitlines()[-1])
    assert st["flops"] == 4096 * 10 and st["dots"] == 10
    assert st["coll"] == {"all-reduce": 512 * 10}
    assert st["counts"] == {"all-reduce": 10}
    assert st["whiles"] == 0


def test_counter_refuses_a_kernel_launch():
    """A launch counted by ``kernels/_build.py`` inside the counter (the
    count a wrapper adds where it launches) raises."""
    from repro_torch.kernels import _build
    before = dict(_build.launches)
    try:
        with pytest.raises(RuntimeError, match="csrc"):
            with op_analysis.count_ops():
                _build.launches["fwht/256"] += 1
    finally:
        _build.launches.clear()
        _build.launches.update(before)


def _reduced_decode_flops(cfg, rows: int, seq: int) -> dict:
    """The named matmul terms of one ``decode_32k`` step of ``cfg`` on the
    plain path: every ITQ3_S projection contracts K padded to its
    256-blocks; the attention's scores and values run over the whole
    cache, the token's self score over head_dim; the tied head is a
    float product."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads

    def pad(k):
        return -(-k // 256) * 256
    proj = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
            "wo": (h * hd, d), "gate": (d, cfg.d_ff), "up": (d, cfg.d_ff),
            "down": (cfg.d_ff, d)}
    terms = {name: 2 * rows * pad(k) * n * cfg.num_layers
             for name, (k, n) in proj.items()}
    per_head = rows * h * cfg.num_layers
    terms["scores"] = 2 * per_head * seq * hd
    terms["self score"] = 2 * per_head * hd
    terms["values"] = 2 * per_head * seq * hd
    terms["head"] = 2 * rows * d * cfg.vocab_size
    return terms


def test_reduced_cell_flops_equal_derived_count_and_reference(monkeypatch):
    jcfg = jbase.reduced(jbase.get_config("smollm-135m"))
    tcfg = tbase.reduced(tbase.get_config("smollm-135m"))
    shape = tbase.SHAPES["decode_32k"]
    cell = steps.build_cell("smollm-135m", "decode_32k", local_mesh("cpu"),
                            cfg=tcfg)
    with op_analysis.count_ops() as st:
        cell.run()
    terms = _reduced_decode_flops(tcfg, shape.global_batch, shape.seq_len)
    assert st.flops == sum(terms.values()), terms
    assert st.dot_count == 10 * tcfg.num_layers + 1
    monkeypatch.setattr(jsteps, "get_config", lambda arch: jcfg)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    ref = analyze_hlo(jsteps.build_cell("smollm-135m", "decode_32k", mesh)
                      .lower().compile().as_text())
    assert st.flops == ref.flops
    assert st.dot_count == ref.dot_count


# --- the launcher, read by the reference's report ---------------------------

REF_KEYS = ("arch", "shape", "mesh", "chips", "quant_mode", "status",
            "memory_analysis", "param_bytes_per_device", "hlo_flops",
            "hlo_bytes", "collective_bytes", "collective_counts",
            "dynamic_whiles", "roofline", "bottleneck", "model_flops_global",
            "model_flops_per_device", "useful_flops_frac")


def test_dryrun_cli_records_read_by_roofline_report(tmp_path):
    out_dir = tmp_path / "dryrun"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k", "--mesh", "both", "--out",
         str(out_dir), "--jobs", "2"], cwd=ROOT, text=True, capture_output=True,
        timeout=400, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = [json.loads(p.read_text()) for p in sorted(out_dir.glob("*.json"))]
    assert [r["mesh"] for r in recs] == ["2x16x16", "16x16"]
    for r in recs:
        assert r["status"] == "ok", r
        assert all(k in r for k in REF_KEYS), r.keys()
        assert r["trace_s"] > 0 and r["dynamic_whiles"] == 0
        assert r["constants"] == {"peak_flops": 989.4e12, "hbm_bw": 3.35e12,
                                  "coll_bw": 50e9}
        assert r["collective_counts"]["all-gather"] > 0
        assert 0 < r["useful_flops_frac"] < 1
    report = subprocess.run(
        [sys.executable, "-m", "benchmarks.roofline_report", "--dir",
         str(out_dir)], cwd=ROOT, text=True, capture_output=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert report.returncode == 0, report.stderr[-3000:]
    rows = [ln for ln in report.stdout.splitlines()
            if ln.startswith("| smollm-135m | decode_32k |")]
    assert len(rows) == 2, report.stdout
