"""Tensor-parallel placement of the port (``repro_torch.serve.tp``,
``repro_torch.sharding.rules``) against the live reference's pure-spec
functions, in-process: no process group, a ``FakeMesh`` of m = 2 and 4.

* ``serve_param_pspecs`` and ``cache_pspecs`` leaf by leaf for every
  family's ``reduced()`` config (dense, MoE, rwkv6, the zamba2 hybrid, vlm,
  audio); the paged pool's too. The reference's trees are shapes only
  (``jax.eval_shape``), the port's its own CPU trees;
* ``restore_shardings`` on the reference's own cases, the port's
  placements beside the reference's NamedShardings on an abstract mesh;
* ``can_tp_qmatmul`` and ``_can_tp_heads``;
* the shard launch's cut: a placed shard's launch takes the kernel rule's
  cut at the unsharded (E, N) (``cut_from``), and its columns equal the
  whole launch's bit for bit on the CPU's plain versions;
* the attention's head shards on the CPU: bit for bit with two or more
  KV heads per shard. With one, the self-token score's ``einsum`` takes
  another CPU route at G = 16 (qwen3-moe-235b-a22b's shape), so those
  shards are held to 1e-6 of the largest output (on the card the same
  shards are bit-equal: ``chip_smoke.py`` phase 15 (a)).
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import formats as jformats
from repro.models import lm as jlm
from repro.serve import paged as jpaged
from repro.serve import tp as jtp
from repro.serve.quantized import quantize_params as jquantize_params
from repro.sharding import rules as JR
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.core import qlinear
from repro_torch.core.quantize import QTensor
from repro_torch.kernels import itq3
from repro_torch.kernels.attn_q8 import decode_attn_q8, prefill_attn_q8
from repro_torch.models import lm as tlm
from repro_torch.serve import paged as tpaged
from repro_torch.serve import tp as ttp
from repro_torch.serve.quantized import quantize_params as tquantize_params
from repro_torch.sharding import rules as TR
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import to_numpy_tree

FAMILIES = ("qwen1.5-0.5b", "olmoe-1b-7b", "qwen3-moe-235b-a22b",
            "rwkv6-3b", "zamba2-7b", "phi-3-vision-4.2b",
            "seamless-m4t-medium")
WAYS = (2, 4)


class FakeMesh:
    def __init__(self, data=1, model=2, rank=0):
        self.shape = {"data": data, "model": model}
        self.axis_names = ("data", "model")
        self.rank = rank
        self.device = torch.device("cpu")


def _path_str(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)


def _ref_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {_path_str(p): tuple(s) for p, s in flat}


def _port_specs(tree, prefix=()) -> dict:
    if isinstance(tree, QTensor):
        return {"/".join(prefix + ("data", k)): v
                for k, v in tree.data.items()}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    cfg = jreduced(jget_config(arch))
    shapes = jax.eval_shape(
        lambda k: jquantize_params(jlm.init_params(k, cfg), "itq3_s"),
        jax.random.PRNGKey(0))
    return cfg, shapes


@functools.lru_cache(maxsize=None)
def _port_tree(arch):
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    return cfg, tquantize_params(tlm.init_params(cfg, seed=0, device="cpu"),
                                 "itq3_s")


@pytest.mark.parametrize("ways", WAYS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_specs_equal_reference_leaf_by_leaf(arch, ways):
    jcfg, jshapes = _ref_tree(arch)
    tcfg, tparams = _port_tree(arch)
    mesh = FakeMesh(model=ways)
    want = _ref_specs(jtp.serve_param_pspecs(
        jshapes, jcfg, jtp.serve_rules(mesh, jcfg)))
    got = _port_specs(ttp.serve_param_pspecs(
        tparams, tcfg, ttp.serve_rules(mesh, tcfg)))
    assert got == want
    # the packed planes really shard, and every sharded dim divides
    assert any("model" in s for s in got.values())
    shapes = _port_specs(ttp._map(tparams, lambda _, v: tuple(v.shape)))
    for path, spec in got.items():
        for dim, ax in enumerate(spec):
            if ax is not None:
                assert shapes[path][dim] % ways == 0, (path, spec)


@pytest.mark.parametrize("ways", WAYS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_specs_equal_reference_leaf_by_leaf(arch, ways):
    jcfg, _ = _ref_tree(arch)
    tcfg, _ = _port_tree(arch)
    mesh = FakeMesh(model=ways)
    kvq = arch != "rwkv6-3b"
    jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, 2, 16,
                                                   kv_quant=kvq))
    tcache = tlm.init_cache(tcfg, 2, 16, kv_quant=kvq, device="meta")
    want = _ref_specs(jtp.cache_pspecs(jcache, jcfg,
                                       jtp.serve_rules(mesh, jcfg)))
    got = _port_specs(ttp.cache_pspecs(tcache, tcfg,
                                       ttp.serve_rules(mesh, tcfg)))
    assert got == want
    assert set(want) == set(_port_specs(ttp._map(tcache, lambda _, v: v)))
    if tcfg.family in ("dense", "moe", "vlm"):
        jpool = jax.eval_shape(lambda: jpaged.init_paged_cache(jcfg, 9, 16))
        tpool = tpaged.init_paged_cache(tcfg, 9, 16, device="meta")
        assert _port_specs(ttp.cache_pspecs(
            tpool, tcfg, ttp.serve_rules(mesh, tcfg))) == _ref_specs(
            jtp.cache_pspecs(jpool, jcfg, jtp.serve_rules(mesh, jcfg)))


@pytest.mark.parametrize("ways", WAYS)
def test_rules_and_leaf_specs_equal_reference(ways):
    """make_rules' assignments and the training-side float leaf spec."""
    mesh = FakeMesh(data=2, model=ways)
    for arch in FAMILIES + ("smollm-135m", "nemotron-4-15b"):
        jcfg = jget_config(arch)
        tcfg = tconfigs.get_config(arch)
        for fsdp in (True, False):
            assert (TR.make_rules(mesh, tcfg, fsdp=fsdp).assignments
                    == JR.make_rules(mesh, jcfg, fsdp=fsdp).assignments)
    jr = JR.make_rules(mesh, jget_config("olmoe-1b-7b"))
    tr = TR.make_rules(mesh, tconfigs.get_config("olmoe-1b-7b"))
    for path, shape, stacked in (
            ("layers/attn/wq", (16, 2048, 2048), 1),
            ("layers/attn/wo", (16, 2048, 2048), 1),
            ("layers/moe/gate", (16, 64, 2048, 1024), 1),
            ("layers/ln1/scale", (16, 2048), 1),
            ("embed", (50304, 2048), 0), ("lm_head", (2048, 50304), 0),
            ("mamba_blocks/mamba/A_log", (4, 6, 64), 2),
            ("layers/odd", (16, 96, 48), 1)):
        assert TR._leaf_spec(path, shape, tr, ways, 2, stacked) == tuple(
            JR._leaf_spec(path, shape, jr, ways, 2, stacked)), path
    for parts in (("layers", "attn", "wq"), ("mamba_blocks", "x"),
                  ("encoder", "y"), ("mamba_tail", "z"), ("embed",)):
        assert TR._stack_depth(parts) == JR._stack_depth(parts)
    assert TR._QDATA == JR._QDATA


@pytest.mark.parametrize("ways", WAYS)
def test_restore_shardings_equal_reference(ways):
    """The reference's restore cases: a QTensor's per-array placements
    (with and without a train state's ``params.`` prefix), a replicated
    float leaf, the D-sharded table and None for a non-array."""
    jcfg = jreduced(jget_config("qwen1.5-0.5b"))
    tcfg = tconfigs.reduced(tconfigs.get_config("qwen1.5-0.5b"))
    jplace = jtp.restore_shardings(jcfg, AbstractMesh((1, ways),
                                                      ("data", "model")))
    tplace = ttp.restore_shardings(tcfg, FakeMesh(model=ways))
    w = np.zeros((256, 512), np.float32)
    jqt = jformats.quantize(w, "itq3_s")
    tqt = params_from_numpy(to_numpy_tree({"w": jqt})["w"], device="cpu")
    for dotted in ("lm_head", "params.lm_head", "layers.attn.wq",
                   "layers.moe.gate"):
        want, got = jplace(dotted, jqt), tplace(dotted, tqt)
        assert set(got) == set(want) == set(jqt.data)
        assert {k: v.spec for k, v in got.items()} == {
            k: tuple(v.spec) for k, v in want.items()}, dotted
    assert tplace("lm_head", tqt)["plane2"].spec[0] == "model"
    for dotted, arr in (("layers.ln1", np.zeros((128,), np.float32)),
                        ("embed", np.zeros((512, 128), np.float32)),
                        ("params.embed", np.zeros((512, 130), np.float32))):
        assert tplace(dotted, torch.as_tensor(arr)).spec == tuple(
            jplace(dotted, arr).spec), dotted
    assert tplace("step", 7) is None and jplace("step", 7) is None


def test_placement_takes_this_ranks_rows_of_a_mapped_file(tmp_path):
    """A Placement reads only its rank's rows: each rank's slices of an
    N-sharded plane are disjoint, in rank order, and together the whole
    array (a memory-mapped .npy, as restore-to-sharding reads it)."""
    arr = np.arange(8 * 3 * 4, dtype=np.int16).reshape(8, 3, 4)
    np.save(tmp_path / "a.npy", arr)
    mapped = np.load(tmp_path / "a.npy", mmap_mode="r")
    for ways in WAYS:
        parts = [ttp.Placement(("model", None, None),
                               FakeMesh(model=ways, rank=r))(mapped)
                 for r in range(ways)]
        assert all(p.shape == (8 // ways, 3, 4) for p in parts)
        assert np.array_equal(torch.cat(parts).numpy(), arr)
        for p in parts:
            p += 1  # the rows are a copy, not the read-only map
    whole = ttp.Placement((None, None, None), FakeMesh(model=2))(mapped)
    assert np.array_equal(whole.numpy(), arr)
    # a whole cache sliced per rank has the shapes init_cache allocates
    cfg = tconfigs.reduced(tconfigs.get_config("zamba2-7b"))
    cache = tlm.init_cache(cfg, 2, 16, kv_quant=True, device="cpu")
    cache["attn"]["k"].copy_(torch.arange(cache["attn"]["k"].numel()).view(
        cache["attn"]["k"].shape) % 100)
    for ways in WAYS:
        rules = ttp.serve_rules(FakeMesh(model=ways, rank=ways - 1), cfg)
        local = ttp.shard_cache(cache, cfg, rules)
        zeros = ttp.init_cache(tlm.init_cache(cfg, 2, 16, kv_quant=True,
                                              device="meta"), cfg, rules)
        assert ttp._map(local, lambda _, v: v.shape) == ttp._map(
            zeros, lambda _, v: v.shape)
        per = cfg.num_kv_heads // ways
        assert torch.equal(local["attn"]["k"],
                           cache["attn"]["k"][:, :, -per:])
        assert torch.equal(local["ssm"]["ssm"], cache["ssm"]["ssm"])
        assert ttp.cache_bytes_per_device(local) < ttp.cache_bytes_per_device(
            cache)


@pytest.mark.parametrize("shape", [(256, 512), (256, 24), (512, 96),
                                   (100, 36)])
def test_can_tp_qmatmul_and_heads_equal_reference(rng, shape):
    w = np.asarray(rng.normal(size=shape), np.float32)
    jqt = jformats.quantize(w, "itq3_s")
    tqt = params_from_numpy(to_numpy_tree({"w": jqt})["w"], device="cpu")
    for model in (1, 2, 3, 4, 8):
        mesh = FakeMesh(model=model)
        assert ttp.can_tp_qmatmul(tqt, mesh) == jtp.can_tp_qmatmul(jqt, mesh)
        for kvh in (1, 2, 3, 4, 16):
            assert ttp._can_tp_heads(kvh, mesh) == jtp._can_tp_heads(kvh,
                                                                     mesh)


class _Spy:
    """Records the ``cut`` each contraction wrapper is called with."""

    def __init__(self, monkeypatch):
        self.cuts = []
        for name in ("itq3_matvec", "itq3_matmul", "itq3_matvec_int8",
                     "itq3_matmul_int8"):
            orig = getattr(qlinear, name)

            def spy(*a, _orig=orig, _name=name, **kw):
                self.cuts.append((_name, kw.get("cut")))
                return _orig(*a, **kw)
            monkeypatch.setattr(qlinear, name, spy)


# K x N x E of shards whose own rule's cut differs from the whole's (the
# prefill shapes of qwen1.5-0.5b's gate/up and wq, an expert stack whose
# E/m shard leaves one expert) and ones where it does not
CUT_CASES = [(1024, 2816, 1, 256), (1024, 1024, 1, 256), (2816, 1024, 1, 4),
             (512, 256, 1, 40), (256, 128, 4, 20), (256, 128, 4, 3)]


@pytest.mark.parametrize("k,n,e,m", CUT_CASES)
@pytest.mark.parametrize("act", [False, True])
def test_shard_launch_takes_the_whole_launch_cut(monkeypatch, k, n, e, m,
                                                 act):
    gen = torch.Generator().manual_seed(k + n + e + m)
    lead = (e,) if e > 1 else ()
    qt = qlinear.fmt_mod.quantize(
        torch.randn(*lead, k, n, generator=gen) / k ** 0.5, "itq3_s")
    x = torch.randn(*lead, m, k, generator=gen)
    kb = qt.meta.kb
    rule = (itq3.matmul_tiles if m > 16 else
            itq3.matvec_int8_tiles if act else itq3.matvec_tiles)
    spy = _Spy(monkeypatch)
    if e == 1:
        full = qlinear.qmatmul(x, qt, act_quant=act)
    else:
        full = qlinear.qmatmul_experts(x, qt, act_quant=act)
    assert spy.cuts[-1][1] is None  # an unsharded launch keeps its rule
    differs = 0
    for ways in WAYS:
        for what in ("N", "E") if e > 1 else ("N",):
            size = n if what == "N" else e
            per = size // ways
            axis = 0 if e == 1 or what == "E" else 1
            for r in range(ways):
                sh = QTensor({key: v.narrow(axis, r * per, per).contiguous()
                              for key, v in qt.data.items()}, qt.meta)
                if e == 1:
                    got = ttp.shard_qmatmul(x, sh, mode="activations",
                                            backend="auto", act_quant=act)
                    want = full[:, r * per:(r + 1) * per]
                else:
                    xe = x if what == "N" else x[r * per:(r + 1) * per]
                    got = qlinear.qmatmul_experts(xe, sh, act_quant=act,
                                                  cut_from=(e, n))
                    want = (full[..., r * per:(r + 1) * per] if what == "N"
                            else full[r * per:(r + 1) * per])
                assert spy.cuts[-1][1] == rule(m, n, kb, e)
                assert torch.equal(got, want)
                own = rule(m, per if what == "N" else n, kb,
                           e if what == "N" else per)
                differs += own != rule(m, n, kb, e)
    # the evidence that the cut has to come from the whole launch
    if (k, n, e, m) in ((1024, 2816, 1, 256), (1024, 1024, 1, 256),
                        (256, 128, 4, 3)):
        assert differs > 0


def test_launchers_take_an_explicit_cut_and_validate_it():
    """The four launchers take ``cut``; on the CPU the plain version runs
    whatever the cut (the card's cut only orders the f32 sums)."""
    gen = torch.Generator().manual_seed(3)
    qt = qlinear.fmt_mod.quantize(torch.randn(512, 64, generator=gen),
                                  "itq3_s")
    planes = [qt.data[k] for k in ("plane2", "plane1", "scales", "zps")]
    x = torch.randn(4, 512, generator=gen)
    base = itq3.itq3_matvec(x, *planes, rotate_weights=False)
    assert torch.equal(base, itq3.itq3_matvec(x, *planes,
                                              rotate_weights=False,
                                              cut=(8, 1)))
    assert torch.equal(itq3.itq3_matmul(x, *planes, rotate_weights=False),
                       itq3.itq3_matmul(x, *planes, rotate_weights=False,
                                        cut=(32, 2)))
    assert itq3._matmul_cut(1, 40, 64, 2, cut=(64, 1)) == (64, 1)
    assert itq3._matmul_cut(1, 40, 64, 2) == itq3.matmul_tiles(40, 64, 2)
    assert qlinear.launch_cut(4, 2, act_quant=False, e=1, n=64) == \
        itq3.matvec_tiles(4, 64, 2)
    assert qlinear.launch_cut(4, 2, act_quant=True, e=1, n=64) == \
        itq3.matvec_int8_tiles(4, 64, 2)
    assert qlinear.launch_cut(17, 2, act_quant=True, e=3, n=64) == \
        itq3.matmul_tiles(17, 64, 2, 3)


# (KV heads, query heads per KV head, head_dim): qwen1.5-0.5b's MHA at
# head_dim 64, qwen3-moe-235b-a22b's 4 x 16 at 128, a GQA ratio of 4
ATTN_SHAPES = [(16, 1, 64), (4, 16, 128), (8, 4, 64)]


@pytest.mark.parametrize("kvh,g,hd", ATTN_SHAPES)
def test_attention_head_shards_on_the_cpu(kvh, g, hd):
    """``decode_attn_q8`` / ``prefill_attn_q8`` on each rank's heads (the
    calls ``tp_decode_attn_q8`` / ``tp_prefill_attn_q8`` make) against the
    full call's heads, dense and paged, m = 2 and 4."""
    gen = torch.Generator().manual_seed(kvh * g)
    b, t, bs, tq = 4, 64, 8, 8

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8)

    def scales(*shape):
        return (torch.rand(*shape, generator=gen) * 0.05 + 1e-3).half()

    def planes(lead, length):
        return {"k": codes(lead, kvh, length, hd),
                "v": codes(lead, kvh, length, hd),
                "k_scale": scales(lead, kvh, length, 1),
                "v_scale": scales(lead, kvh, length, 1)}

    maxb = t // bs
    paged = planes(b * maxb + 1, bs)
    paged["table"] = (1 + torch.randperm(b * maxb, generator=gen)).reshape(
        b, maxb).to(torch.int32)
    kv_len = torch.tensor([3, 17, 40, 55])
    kt = (codes(b, kvh, 1, hd), scales(b, kvh, 1, 1))
    vt = (codes(b, kvh, 1, hd), scales(b, kvh, 1, 1))
    qd = torch.randn(b, kvh, g, 1, hd, generator=gen)
    qp = torch.randn(b, kvh, g, tq, hd, generator=gen)
    for cache in (planes(b, t), paged):
        def shard(hs):
            return {k: v if k == "table" else v[:, hs].contiguous()
                    for k, v in cache.items()}
        full_d = decode_attn_q8(qd, cache, kt, vt, kv_len)
        full_p = prefill_attn_q8(qp, cache, kv_len + tq, kv_len)
        for ways in WAYS:
            per = kvh // ways
            for r in range(ways):
                hs = slice(r * per, (r + 1) * per)
                got_d = decode_attn_q8(
                    qd[:, hs].contiguous(), shard(hs),
                    tuple(a[:, hs].contiguous() for a in kt),
                    tuple(a[:, hs].contiguous() for a in vt), kv_len)
                got_p = prefill_attn_q8(qp[:, hs].contiguous(), shard(hs),
                                        kv_len + tq, kv_len)
                assert torch.equal(got_p, full_p[:, hs])
                if per > 1:
                    assert torch.equal(got_d, full_d[:, hs])
                else:
                    err = (got_d - full_d[:, hs]).abs().max()
                    assert err <= 1e-6 * full_d.abs().max()
