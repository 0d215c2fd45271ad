"""The recurrent blocks of the port against the live reference, on the CPU:
``models/ssm.py``'s Mamba2 (reduced zamba2-7b) and RWKV6 (reduced
rwkv6-3b), fp and on ``itq3_s`` leaves bridged from the reference.

* ``mamba2_apply``: prefill over T = 9 and T = 300 (three 128-step
  chunks, a ragged tail) from a nonzero state, then four decode steps
  continuing it; outputs and states (``ssm``, ``conv``) within 1e-5;
* ``_segsum`` at the reference's stability case: the reference's values,
  ``-inf`` above the diagonal, nothing exponentiated above 0;
* ``rwkv6_apply`` in its ``chunked`` and ``scan`` prefill modes (T = 20:
  a ragged 16-step chunk) and in decode, each against the same mode of
  the reference within 1e-5 (states ``wkv``, ``tm_prev``, ``cm_prev``
  too), and the two modes against each other at the reference's own
  chunked-vs-stepwise tolerance;
* the seeded init trees have the reference's keys and shapes (the
  hybrid's doubly stacked ``mamba_blocks``, its tail, the shared block),
  and ``init_quantized_params`` quantizes exactly the reference's leaves.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core.quantize import QTensor as JQTensor
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models.layers import Runtime as JRuntime
from repro.serve.quantized import describe_quantized as jdescribe
from repro.serve.quantized import quantize_params as jquantize_params
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve.quantized import describe_quantized
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import to_numpy_tree

TOL = 1e-5
# the reference's own tolerance between its chunked and stepwise RWKV6
# (tests/test_ssm.py): two algorithms, f32 rounding in different places
MODES_TOL = 2e-4
B = 2
FMTS = [None, "itq3_s"]


def _cfgs(arch):
    return (jreduced(jget_config(arch)),
            tconfigs.reduced(tconfigs.get_config(arch)))


@functools.lru_cache(maxsize=None)
def _params(arch, fmt):
    """The reference's reduced weights (fp, or quantized by the reference)
    and the port's bridged copy."""
    jcfg, _ = _cfgs(arch)
    jp = jax.jit(jlm.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    if fmt is not None:
        jp = jax.jit(functools.partial(jquantize_params, fmt=fmt))(jp)
    return jp, params_from_numpy(to_numpy_tree(jp), device="cpu")


def _x(t, d, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, t, d)).astype(np.float32) * np.float32(0.5)


def _state(empty_tree, seed=5):
    """A nonzero starting state of the reference's shapes."""
    rng = np.random.default_rng(seed)
    return {k: (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in empty_tree.items()}


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _close_state(got, want, tol=TOL):
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], tol, what=k)


def _jrt(**kw):
    return JRuntime(compute_dtype=jnp.float32, backend="ref", **kw)


# --- Mamba2 -----------------------------------------------------------------

def _mamba_block(fmt):
    jp, tp = _params("zamba2-7b", fmt)
    jblock = jax.tree.map(lambda a: a[0, 0], jp["mamba_blocks"])["mamba"]
    return jblock, tlm.layer_params(tp["mamba_blocks"], 0, 0)["mamba"]


@functools.lru_cache(maxsize=None)
def _jmamba(decode: bool):
    jcfg, _ = _cfgs("zamba2-7b")
    return jax.jit(lambda p, x, st: jssm.mamba2_apply(
        p, x, _jrt(), jcfg, state=st, decode=decode))


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("t", [9, 300])
@pytest.mark.parametrize("fmt", FMTS)
def test_mamba2_prefill_matches_reference(fmt, t):
    jcfg, tcfg = _cfgs("zamba2-7b")
    jblock, tblock = _mamba_block(fmt)
    x = _x(t, jcfg.d_model)
    st = _state(jssm.mamba2_empty_state(jcfg, B))
    want, wstate = _jmamba(False)(jblock, jnp.asarray(x),
                                  jax.tree.map(jnp.asarray, st))
    got, gstate = tssm.mamba2_apply(tblock, torch.from_numpy(x), TRuntime(),
                                    tcfg, state=_t(st))
    _close(got, want)
    _close_state(gstate, wstate)
    # without a state: from zeros, no state returned
    got0, none = tssm.mamba2_apply(tblock, torch.from_numpy(x), TRuntime(),
                                   tcfg)
    want0, _ = _jmamba(False)(jblock, jnp.asarray(x),
                              jssm.mamba2_empty_state(jcfg, B))
    assert none is None
    _close(got0, want0)


@pytest.mark.parametrize("fmt", FMTS)
def test_mamba2_decode_continues_state(fmt):
    """A 9-token prefill, then four decode steps (the conv window rolls,
    the state updates in O(1)), each step's output and the state."""
    jcfg, tcfg = _cfgs("zamba2-7b")
    jblock, tblock = _mamba_block(fmt)
    x = _x(13, jcfg.d_model, seed=4)
    jst = jssm.mamba2_empty_state(jcfg, B)
    tst = tssm.mamba2_empty_state(tcfg, B, device="cpu")
    want, jst = _jmamba(False)(jblock, jnp.asarray(x[:, :9]), jst)
    got, tst = tssm.mamba2_apply(tblock, torch.from_numpy(x[:, :9]),
                                 TRuntime(), tcfg, state=tst)
    _close(got, want)
    for i in range(9, 13):
        want, jst = _jmamba(True)(jblock, jnp.asarray(x[:, i:i + 1]), jst)
        got, tst = tssm.mamba2_apply(tblock, torch.from_numpy(
            x[:, i:i + 1]), TRuntime(), tcfg, state=tst, decode=True)
        _close(got, want, what=f"step {i}")
        _close_state(tst, jst)


def test_segsum_matches_reference_stability_case():
    logd = -jnp.abs(jax.random.normal(jax.random.PRNGKey(1), (4, 128)))
    want = np.asarray(jssm._segsum(logd))
    got = tssm._segsum(torch.from_numpy(np.array(logd))).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.all(np.isneginf(got[:, ~np.tril(np.ones((128, 128), bool))]))
    fin = np.isfinite(want)
    _close(got[fin], want[fin])
    assert np.all(np.where(np.isfinite(got), got, 0.0) <= 1e-6)


# --- RWKV6 ------------------------------------------------------------------

def _rwkv_block(fmt):
    jp, tp = _params("rwkv6-3b", fmt)
    return (jax.tree.map(lambda a: a[1], jp["layers"]),
            tlm.layer_params(tp["layers"], 1))


@functools.lru_cache(maxsize=None)
def _jrwkv(mode: str, decode: bool):
    jcfg, _ = _cfgs("rwkv6-3b")
    return jax.jit(lambda p, x, st: jssm.rwkv6_apply(
        p, x, _jrt(rwkv_mode=mode), jcfg, state=st, decode=decode))


@pytest.mark.parametrize("mode", ["chunked", "scan"])
@pytest.mark.parametrize("fmt", FMTS)
def test_rwkv6_prefill_matches_reference(fmt, mode):
    jcfg, tcfg = _cfgs("rwkv6-3b")
    jblock, tblock = _rwkv_block(fmt)
    x = _x(20, jcfg.d_model)
    st = _state(jssm.rwkv6_empty_state(jcfg, B))
    want, wstate = _jrwkv(mode, False)(jblock, jnp.asarray(x),
                                       jax.tree.map(jnp.asarray, st))
    got, gstate = tssm.rwkv6_apply(tblock, torch.from_numpy(x),
                                   TRuntime(rwkv_mode=mode), tcfg,
                                   state=_t(st))
    _close(got, want)
    _close_state(gstate, wstate)
    if mode == "chunked":
        # the port's chunked form against the reference's stepwise scan
        ref_scan, sstate = _jrwkv("scan", False)(
            jblock, jnp.asarray(x), jax.tree.map(jnp.asarray, st))
        _close(got, ref_scan, MODES_TOL)
        _close_state(gstate, sstate, MODES_TOL)


@pytest.mark.parametrize("fmt", FMTS)
def test_rwkv6_decode_matches_reference(fmt):
    jcfg, tcfg = _cfgs("rwkv6-3b")
    jblock, tblock = _rwkv_block(fmt)
    x = _x(12, jcfg.d_model, seed=6)
    jst = jssm.rwkv6_empty_state(jcfg, B)
    tst = tssm.rwkv6_empty_state(tcfg, B, device="cpu")
    want, jst = _jrwkv("chunked", False)(jblock, jnp.asarray(x[:, :8]), jst)
    got, tst = tssm.rwkv6_apply(tblock, torch.from_numpy(x[:, :8]),
                                TRuntime(), tcfg, state=tst)
    _close(got, want)
    for i in range(8, 12):
        want, jst = _jrwkv("chunked", True)(jblock, jnp.asarray(
            x[:, i:i + 1]), jst)
        got, tst = tssm.rwkv6_apply(tblock, torch.from_numpy(x[:, i:i + 1]),
                                    TRuntime(), tcfg, state=tst, decode=True)
        _close(got, want, what=f"step {i}")
        _close_state(tst, jst)


def test_rwkv6_unknown_mode_refused():
    _, tcfg = _cfgs("rwkv6-3b")
    _, tblock = _rwkv_block(None)
    with pytest.raises(ValueError, match="rwkv_mode"):
        tssm.rwkv6_apply(tblock, torch.zeros(1, 2, tcfg.d_model),
                         TRuntime(rwkv_mode="parallel"), tcfg)


# --- init trees -------------------------------------------------------------

def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_init_tree_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    want = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda k: jlm.init_params(k, jcfg), jax.random.PRNGKey(0)))
    got = tlm.init_params(tcfg, device="cpu")
    assert _shapes(got) == want
    if arch == "zamba2-7b":
        m = got["mamba_blocks"]["mamba"]
        np.testing.assert_allclose(
            m["A_log"][1, 2].numpy(),
            np.log(np.linspace(1.0, 16.0, m["A_log"].shape[-1])), rtol=1e-6)
        assert torch.equal(m["D"], torch.ones_like(m["D"]))
        np.testing.assert_allclose(m["dt_bias"].numpy(),
                                   np.log(np.e - 1) - 2.0, rtol=1e-6)
        assert not m["conv_b"].any()
    else:
        layers = got["layers"]
        assert torch.equal(layers["w_base"], -torch.ones_like(
            layers["w_base"]))
        assert 0 <= layers["mu"].min() and layers["mu"].max() < 1
        assert "bias" in layers["ln_out"] and "lm_head" in got


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_quantized_leaves_match_reference(arch):
    """Both seeding paths quantize the reference's leaves and no others
    (``wB``, ``wC``, ``wdt`` and the LoRA stay fp), with the reference's
    plane shapes, the hybrid's stacked twice."""
    jp, tp = _params(arch, "itq3_s")
    want = jdescribe(jp)
    assert describe_quantized(tp) == want
    _, tcfg = _cfgs(arch)
    seeded = tlm.init_quantized_params(tcfg, "itq3_s", device="cpu")
    assert describe_quantized(seeded) == want
    jflat = dict(jax.tree_util.tree_flatten_with_path(
        jp, is_leaf=lambda a: isinstance(a, JQTensor))[0])
    for path, leaf in jflat.items():
        if not isinstance(leaf, JQTensor):
            continue
        node = seeded
        for p in path:
            node = node[p.key]
        assert {k: tuple(v.shape) for k, v in node.data.items()} == {
            k: tuple(v.shape) for k, v in leaf.data.items()}, path
    assert "wB" not in str(want) and "w_lora" not in str(want)
