"""The port's QuantPolicy, mixed-precision quantization and checkpoints
against the live JAX reference, on the CPU.

``QuantPolicy``/``QuantRule`` round-trip through JSON and match the
reference's dicts; ``quantize_params`` under ``mixed_precision_recipe``
gives the reference's format map and codes (except at rounding ties: the
f32 statistics of Algorithm 1 are summed in another order); the dense
formats dequantize as the reference's do; checkpoints cross over in both
directions, byte for byte; and a quantized tree served from disk gives the
same greedy streams as served from memory, and as the reference engine.
"""
import filecmp
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jconfigs
from repro.core import formats as jformats
from repro.core import packing as jpacking
from repro.core.quantize import QTensor as JQTensor
from repro.models import lm as jlm
from repro.models.layers import Runtime as JRuntime
from repro.serve import quantized as jquantized
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import formats as tformats
from repro_torch.core import packing as tpacking
from repro_torch.core.quantize import QTensor
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve import quantized as tquantized
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_bridge import to_numpy_tree

ARCH = "smollm-135m"
SLOTS, MAX_LEN, MAX_NEW = 4, 128, 8


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


@functools.lru_cache(maxsize=None)
def _fp_params():
    """Reduced smollm-135m fp params from the reference's initializer, on
    both sides."""
    cfg = jconfigs.reduced(jconfigs.get_config(ARCH))
    jp = jax.jit(jlm.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    cfg)
    return cfg, jp, to_numpy_tree(jp)


@functools.lru_cache(maxsize=None)
def _mixed_jax():
    """The reference's mixed-policy tree (jitted, as a deployment runs it)."""
    cfg, jp, _ = _fp_params()
    policy = jquantized.QuantPolicy.from_dict(
        jconfigs.mixed_precision_recipe(cfg))
    return cfg, jax.jit(functools.partial(jquantized.quantize_params,
                                          fmt=policy))(jp)


def _policy():
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    return cfg, tquantized.QuantPolicy.from_dict(
        tconfigs.mixed_precision_recipe(cfg))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}" if path else k)
    else:
        yield path, tree


# --- policy ------------------------------------------------------------------

def test_policy_json_round_trip_matches_reference():
    cfg, policy = _policy()
    d = json.loads(json.dumps(policy.to_dict()))
    assert tquantized.QuantPolicy.from_dict(d) == policy
    jpolicy = jquantized.QuantPolicy.from_dict(
        jconfigs.mixed_precision_recipe(jconfigs.reduced(
            jconfigs.get_config(ARCH))))
    assert policy.to_dict() == jpolicy.to_dict()
    custom = tquantized.QuantPolicy(
        (tquantized.QuantRule(r"(^|\.)wq$", "itq3_s", rule="lloyd",
                              sub_blocks=4, act_quant=False, seed=3),
         {"pattern": r"(^|\.)wk$", "fmt": None},
         (r"(^|\.)wo$", "q4_0")), rule="erfinv", seed=5)
    d = custom.to_dict()
    assert d == jquantized.QuantPolicy.from_dict(d).to_dict()
    assert tquantized.QuantPolicy.from_dict(json.loads(json.dumps(d))) \
        == custom
    assert d["rules"][1] == {"pattern": r"(^|\.)wk$", "fmt": None}
    assert custom.match("layers.attn.wq").act_quant is False
    assert custom.match("layers.mlp.up") is None


def test_policy_rejects_bad_rules():
    with pytest.raises(ValueError, match="unknown format"):
        tquantized.QuantRule("x", "nope")
    with pytest.raises(ValueError, match="sub_blocks"):
        tquantized.QuantRule("x", "q8_0", sub_blocks=4)


def _codes(qt):
    d = qt.data
    if "plane2" in d:
        return tpacking.unpack_codes(d["plane2"], d["plane1"]).numpy()
    return d["q"].numpy()


def test_mixed_policy_quantize_params_matches_reference():
    cfg, jq = _mixed_jax()
    _, _, fp = _fp_params()
    tcfg, policy = _policy()
    tq = tquantized.quantize_params(params_from_numpy(fp, device="cpu"),
                                    policy)
    assert tquantized.describe_quantized(tq) == jquantized.describe_quantized(
        jq)
    assert tquantized.describe_quantized(tq) == {
        "embed": "q8_0", "layers.attn.wq": "itq3_s",
        "layers.attn.wk": "itq3_s", "layers.attn.wv": "itq3_s",
        "layers.attn.wo": "itq3_s", "layers.mlp.gate": "itq3_s_sub",
        "layers.mlp.up": "itq3_s_sub", "layers.mlp.down": "itq3_s_sub"}
    assert tquantized.quantized_bytes(tq) == jquantized.quantized_bytes(jq)
    jflat, tflat = dict(_leaves(jq)), dict(_leaves(tq))
    assert jflat.keys() == tflat.keys()
    for path, jleaf in jflat.items():
        tleaf = tflat[path]
        if not isinstance(jleaf, JQTensor):
            np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
            continue
        assert tleaf.meta.to_dict() == jleaf.meta.to_dict(), path
        assert tleaf.data.keys() == jleaf.data.keys()
        jd = {k: np.asarray(v) for k, v in jleaf.data.items()}
        want = (np.asarray(jpacking.unpack_codes(jd["plane2"], jd["plane1"]))
                if "plane2" in jd else jd["q"])
        got = _codes(tleaf)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert (got != want).mean() <= 1e-4, path  # rounding ties only
        for key in ("scales", "zps"):
            if key in jd:
                assert tleaf.data[key].dtype == torch.float16
                assert (tleaf.data[key].numpy() != jd[key]).mean() <= 1e-3


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0", "fp16", "bf16"])
def test_dense_formats_match_reference(fmt, rng):
    w = (rng.standard_normal((3, 96, 40)) * 0.1).astype(np.float32)
    jqt = _jit(jformats.quantize, fmt=fmt)(jnp.asarray(w))
    want = np.asarray(_jit(jformats.dequantize, dtype=jnp.float32)(jqt))
    tqt = tformats.quantize(torch.from_numpy(w), fmt)
    # the port's meta records one matrix of a stacked leaf, as the
    # reference's vmapped quantize_params does
    assert tqt.meta.to_dict() == _jit(jformats.quantize, fmt=fmt)(
        jnp.asarray(w[0])).meta.to_dict()
    assert tformats.bits_per_weight(fmt) == jformats.bits_per_weight(fmt)
    got = tformats.dequantize(tqt)
    assert got.dtype == torch.float32 and got.shape == w.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if fmt != "bf16":  # bridged planes dequantize alike, too
        bridged = params_from_numpy(to_numpy_tree(jqt), device="cpu")
        np.testing.assert_array_equal(tformats.dequantize(bridged).numpy(),
                                      want)
    x = rng.standard_normal((5, 96)).astype(np.float32)
    np.testing.assert_allclose(
        tformats.get_format(fmt).contract(torch.from_numpy(x),
                                          tformats.quantize(
                                              torch.from_numpy(w[0]), fmt)
                                          ).numpy(),
        x @ want[0], rtol=1e-5, atol=1e-5)


def test_registry_and_shims():
    assert set(tformats.FORMATS) == set(jformats.FORMATS)
    for name, spec in tformats.FORMATS.items():
        assert spec.supports_fused == jformats.get_format(name).supports_fused
    with pytest.raises(ValueError, match="unknown format"):
        tformats.get_format("nope")

    @tformats.register_format
    class Fine(tformats.TernaryFormat):
        def __init__(self):
            super().__init__("itq3_fine_test", sub_blocks=4)
    try:
        qt = tformats.quantize(torch.randn(256, 8), "itq3_fine_test")
        assert qt.data["scales"].shape == (8, 1, 4)
        assert tformats.dequantize(qt).shape == (256, 8)
    finally:
        del tformats.FORMATS["itq3_fine_test"]


# --- checkpoints -------------------------------------------------------------

def _assert_trees_equal(port_tree, jax_tree):
    pflat, jflat = dict(_leaves(port_tree)), dict(_leaves(jax_tree))
    assert pflat.keys() == jflat.keys()
    for path, jleaf in jflat.items():
        pleaf = pflat[path]
        if isinstance(jleaf, JQTensor):
            assert isinstance(pleaf, QTensor)
            assert pleaf.meta.to_dict() == jleaf.meta.to_dict()
            assert pleaf.data.keys() == jleaf.data.keys()
            for k, v in jleaf.data.items():
                v = np.asarray(v)
                assert pleaf.data[k].numpy().dtype == v.dtype
                np.testing.assert_array_equal(pleaf.data[k].numpy(), v)
        else:
            np.testing.assert_array_equal(pleaf.numpy(), np.asarray(jleaf))


def test_checkpoints_cross_over_byte_for_byte(tmp_path):
    _, jq = _mixed_jax()
    tq = params_from_numpy(to_numpy_tree(jq), device="cpu")
    jdir = jckpt.save(str(tmp_path / "jax"), 3, jq)
    tdir = tckpt.save(str(tmp_path / "port"), 3, tq)
    assert os.path.basename(jdir) == os.path.basename(tdir) == "step_00000003"
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert "_COMMITTED" in names and "meta.json" in names
    assert any("__Q__plane2" in n for n in names)
    match, mismatch, errors = filecmp.cmpfiles(jdir, tdir, names,
                                               shallow=False)
    assert not mismatch and not errors, mismatch
    # a JAX-saved checkpoint restores in the port with no template ...
    restored, step = tckpt.restore_params(str(tmp_path / "jax"), device="cpu")
    assert step == 3 and tckpt.latest_step(str(tmp_path / "jax")) == 3
    _assert_trees_equal(restored, jq)
    # ... and a port-saved one in the reference
    jrestored, jstep = jckpt.restore_tree(str(tmp_path / "port"))
    assert jstep == 3
    _assert_trees_equal(tq, jrestored)


def test_checkpoint_commit_protocol_and_gc(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.float16)}}
    d = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_tree(d, device="cpu")
    for step in range(5):
        tckpt.save(d, step, tree, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    os.makedirs(os.path.join(d, "step_00000008"))  # never committed
    assert tckpt.latest_step(d) == 4
    got, step = tckpt.restore_tree(d, device="cpu")
    assert step == 4 and got.keys() == tree.keys()
    assert torch.equal(got["a"], tree["a"]) and torch.equal(
        got["b"]["c"], tree["b"]["c"])
    got, _ = tckpt.restore_params(d, step=3, device="cpu")
    assert torch.equal(got["a"], tree["a"])
    tckpt.save(d, 7, {"params": tree, "step": torch.tensor(7)})
    got, step = tckpt.restore_params(d, device="cpu")
    assert step == 7 and torch.equal(got["b"]["c"], tree["b"]["c"])
    with pytest.raises(TypeError, match="bf16"):
        tckpt.save(d, 8, {"x": torch.ones(2, dtype=torch.bfloat16)})


def _prompts():
    rng = np.random.default_rng(13)
    return [rng.integers(0, 512, size=int(n)).astype(np.int32)
            for n in rng.integers(3, 21, size=6)]


def _port_streams(params, act_quant=True):
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    eng = ServeEngine(params, cfg, slots=SLOTS, max_len=MAX_LEN,
                      rt=TRuntime(kv_quant=True, act_quant=act_quant),
                      device="cpu")
    done = eng.run([Request(rid=i, prompt=p, max_new=MAX_NEW)
                    for i, p in enumerate(_prompts())])
    assert all(r.finish_reason == "length" for r in done)
    return [r.out for r in done]


def test_serve_from_disk_equals_serve_from_memory(tmp_path):
    _, _, fp = _fp_params()
    _, policy = _policy()
    tq = tquantized.quantize_params(params_from_numpy(fp, device="cpu"),
                                    policy)
    tckpt.save(str(tmp_path), 0, tq)
    restored, _ = tckpt.restore_params(str(tmp_path), device="cpu")
    assert isinstance(restored["embed"], QTensor)
    assert restored["embed"].meta.shape == (128, 512)  # (D, V): transposed
    for act in (True, False):
        assert _port_streams(restored, act) == _port_streams(tq, act)


def test_jax_saved_checkpoint_serves_in_port_like_reference(tmp_path):
    """A checkpoint the reference saved, served by the port on the W3A8
    path, streams as the reference engine does from the same tree."""
    cfg, jq = _mixed_jax()
    jckpt.save(str(tmp_path), 0, jq)
    restored, _ = tckpt.restore_params(str(tmp_path), device="cpu")
    jeng = JServeEngine(jq, cfg, slots=SLOTS, max_len=MAX_LEN,
                        rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True,
                                    backend="ref", act_quant=True))
    want = jeng.run([JRequest(rid=i, prompt=p, max_new=MAX_NEW)
                     for i, p in enumerate(_prompts())])
    assert _port_streams(restored) == [r.out for r in want]


def test_cli_quantize_save_then_serve_from_disk(tmp_path, capsys):
    from repro_torch.launch import serve as tserve
    q = str(tmp_path / "q")
    common = ["--reduced", "--kv-quant", "--act-quant", "--device", "cpu",
              "--requests", "3", "--max-new", "4"]
    tserve.main(common + ["--policy", "mixed", "--save-quantized", q])
    first = capsys.readouterr().out
    assert "policy quantized (3 rules -> ['itq3_s', 'itq3_s_sub', 'q8_0'])" \
        in first
    assert "saved quantized tree to" in first and "act_quant: W3A8" in first
    tserve.main(common + ["--load-quantized", q])
    second = capsys.readouterr().out
    assert f"loaded quantized step-0 tree from {q}" in second

    def streams(out):
        return [ln for ln in out.splitlines() if ln.strip().startswith("rid=")]
    assert streams(first) == streams(second) and len(streams(first)) == 3
