"""The port's W3A8 integer path against the live JAX reference, on the CPU.

The activation codec (``act_encode``: codes and scales exactly, zero and
padding-only rows included), the plain int8 contraction (``contract_int8``
to 1e-5; the int8 kernels' plain version equal to the reference's
strict-int32 oracle exactly at unit scales and to 1e-6 otherwise), the
``qmatmul`` routing of the ``act_quant`` knob, full-model logits of
reduced smollm-135m and qwen1.5-0.5b, and the engine's greedy streams.

Model logits: both sides compute in f32 but sum in other orders, so the
rows that reach ``act_encode`` (and ``kv_encode``) differ by ~1e-7
relative, and now and then one int8 activation code rounds to its
neighbour on the two sides: a rounding tie, not a port fault. Every code
the two sides emit is recorded; each row is held to atol 1e-4 up to its
first position with an activation or KV tie, and the first tie must be one
rounding step.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import act_quant as jact
from repro.core import formats as jformats
from repro.core.qlinear import qmatmul as jqmatmul
from repro.core.quantize import QTensor as JQTensor
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.models.layers import Runtime as JRuntime
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.core import act_quant as tact
from repro_torch.core import formats as tformats
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.quantize import QTensor, pad_last_dim
from repro_torch.kernels import fwht as tfwht
from repro_torch.kernels import itq3 as titq3
from repro_torch.models import lm as tlm
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_bridge import jax_quantized_params, to_numpy_tree
from test_torch_model import B, MAX_LEN, T, _params

FORMATS = ["iq3_s", "quip3", "itq3_s", "itq3_s_sub", "itq3_x"]
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_ATOL = 1e-4
K_RAGGED, N = 300, 40


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


@functools.lru_cache(maxsize=None)
def _weights(fmt):
    w = (np.random.default_rng(8).standard_normal((K_RAGGED, N))
         / np.sqrt(K_RAGGED)).astype(np.float32)
    jqt = _jit(jformats.quantize, fmt=fmt)(jnp.asarray(w))
    return w, jqt, params_from_numpy(to_numpy_tree(jqt), device="cpu")


def _rows(rng, m=6):
    """Activation rows with an all-zero row and one whose real K elements
    are zero, so only padding remains after ``pad_last_dim``."""
    x = rng.standard_normal((m, K_RAGGED)).astype(np.float32) * 3
    x[1] = 0.0
    x[4, :] = 0.0
    return x


@pytest.mark.parametrize("fmt", ["iq3_s", "quip3", "itq3_s"])
def test_act_encode_matches_reference(fmt, rng):
    _, jqt, tqt = _weights(fmt)
    x = _rows(rng)
    xp = pad_last_dim(torch.from_numpy(x), 256)
    rotate = jqt.meta.rotate
    jq, js = _jit(jact.act_encode, rotate=rotate)(
        jnp.asarray(xp.numpy()), dsign=jqt.data.get("dsign"))
    tq, ts = tact.act_encode(xp, rotate=rotate, dsign=tqt.data.get("dsign"))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (x.shape[0], 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for zero_row in (1, 4):  # scale 0.0 stored, codes 0, no NaN
        assert ts[zero_row, 0] == 0 and (tq[zero_row] == 0).all()
    dec = tact.act_decode(tq, ts)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(
        jact.act_decode(jq, js)))


def test_act_encode_kernel_fwht_hook_and_rounding(rng):
    """The kernel path's codec (``kernels/fwht.py:fwht_act_encode``, which
    rotates and encodes in one launch on the card) gives ``act_encode``'s
    bits; exact halves round to even, as ``jnp.round`` does."""
    x = torch.from_numpy(rng.standard_normal((3, 512)).astype(np.float32))
    a = tfwht.fwht_act_encode(x)
    b = tact.act_encode(x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # 127 * (k + 0.5) / 127.5 ... pick codes that land on .5 exactly
    row = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]])
    q, s = tact.act_encode(row, rotate=False)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]


@pytest.mark.parametrize("fmt", FORMATS)
def test_contract_int8_matches_reference(fmt, rng):
    _, jqt, tqt = _weights(fmt)
    x = rng.standard_normal((2, 5, K_RAGGED)).astype(np.float32)
    want = _jit(jformats.get_format(fmt).contract_int8,
                compute_dtype=jnp.float32)(jnp.asarray(x), jqt)
    got = tformats.get_format(fmt).contract_int8(torch.from_numpy(x), tqt)
    assert got.shape == (2, 5, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("fmt", ["iq3_s", "itq3_s", "itq3_s_sub", "itq3_x"])
def test_int8_plain_version_matches_strict_int32_oracle(fmt, unit, rng):
    """``itq3_matmul_int8_ref`` against ``repro/kernels/ref.py``'s
    strict-int32 oracle: exactly with unit scales, to 1e-6 otherwise."""
    _, jqt, tqt = _weights(fmt)
    meta = jqt.meta
    x = rng.standard_normal((7, meta.kb * 256)).astype(np.float32)
    xq, xs = _jit(jact.act_encode, rotate=meta.rotate)(jnp.asarray(x))
    xq, xs = np.array(xq), np.array(xs)
    scales = np.array(jqt.data["scales"])
    if unit:
        xs, scales = np.ones_like(xs), np.ones_like(scales)
    kw = dict(fivelevel=meta.fivelevel, sub_blocks=meta.sub_blocks)
    want = np.asarray(_jit(jref.itq3_matmul_int8_ref, **kw)(
        jnp.asarray(xq), jnp.asarray(xs), jqt.data["plane2"],
        jqt.data["plane1"], jnp.asarray(scales), jqt.data["zps"]))
    got = titq3.itq3_matmul_int8_ref(
        torch.from_numpy(xq), torch.from_numpy(xs), tqt.data["plane2"],
        tqt.data["plane1"], torch.from_numpy(scales), tqt.data["zps"],
        **kw).numpy()
    if unit:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


class _Spy:
    """Record which contraction wrappers the kernel path calls."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("itq3_matvec", "itq3_matmul", "itq3_matvec_int8",
                     "itq3_matmul_int8"):
            monkeypatch.setattr(tqlinear, name, self._wrap(
                name, getattr(tqlinear, name)))

    def _wrap(self, name, fn):
        def spy(*a, **k):
            self.calls.append(name)
            return fn(*a, **k)
        return spy


@pytest.mark.parametrize("m", [3, 20])
def test_qmatmul_act_quant_routing(m, rng, monkeypatch):
    """The kernel path takes the int8 wrappers (matvec for M <= 16, else
    tiled) and agrees with the ref path; an opted-out QMeta, mode="dequant"
    and a q8_0 leaf all take the float path, bit for bit."""
    spy = _Spy(monkeypatch)
    _, jqt, tqt = _weights("itq3_s")
    x = torch.from_numpy(rng.standard_normal((m, K_RAGGED)).astype(
        np.float32))
    got = tqlinear.qmatmul(x, tqt, act_quant=True)
    assert spy.calls == ["itq3_matvec_int8" if m <= 16 else "itq3_matmul_int8"]
    np.testing.assert_allclose(
        got.numpy(), tqlinear.qmatmul(x, tqt, act_quant=True,
                                      backend="ref").numpy(), **TOL)
    want = _jit(jqmatmul, backend="ref", compute_dtype=jnp.float32,
                act_quant=True)(jnp.asarray(x.numpy()), jqt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not torch.equal(got, tqlinear.qmatmul(x, tqt))  # it is int8

    spy.calls.clear()
    opted_out = QTensor(tqt.data, tqt.meta.__class__(
        **{**tqt.meta.to_dict(), "shape": tqt.meta.shape,
           "act_quant": False}))
    assert torch.equal(tqlinear.qmatmul(x, opted_out, act_quant=True),
                       tqlinear.qmatmul(x, tqt))
    assert spy.calls == ["itq3_matvec" if m <= 16 else "itq3_matmul"] * 2
    for backend in ("auto", "ref"):
        assert torch.equal(
            tqlinear.qmatmul(x, tqt, mode="dequant", act_quant=True,
                             backend=backend),
            tqlinear.qmatmul(x, tqt, mode="dequant", backend=backend))

    w = np.random.default_rng(9).standard_normal((K_RAGGED, N)).astype(
        np.float32)
    jq8 = _jit(jformats.quantize, fmt="q8_0")(jnp.asarray(w))
    tq8 = params_from_numpy(to_numpy_tree(jq8), device="cpu")
    spy.calls.clear()
    got8 = tqlinear.qmatmul(x, tq8, act_quant=True)
    assert spy.calls == []
    assert torch.equal(got8, tqlinear.qmatmul(x, tq8))
    want8 = _jit(jqmatmul, backend="ref", compute_dtype=jnp.float32,
                 act_quant=True)(jnp.asarray(x.numpy()), jq8)
    np.testing.assert_allclose(got8.numpy(), np.asarray(want8), **TOL)


# --- full-model logits -------------------------------------------------------

class _CodeLog:
    """Record the codes of every call of the activation codec ``name`` in
    ``module``, in call order: the reference's ``act_encode``, the port's
    kernel path's ``fwht_act_encode``. On the reference side the codec runs
    inside jit and ``lax.scan``, so the codes come back through an ordered
    ``jax.debug.callback``."""

    def __init__(self, monkeypatch, module, traced=False,
                 name="act_encode"):
        self.calls = []
        orig = getattr(module, name)

        def rec(x, **kw):
            codes, scale = orig(x, **kw)
            if traced:
                jax.debug.callback(
                    lambda c: self.calls.append(np.asarray(c)), codes,
                    ordered=True)
            else:
                self.calls.append(np.asarray(codes))
            return codes, scale
        monkeypatch.setattr(module, name, rec)

    def take(self):
        out, self.calls = self.calls, []
        return out


def _steps(t: np.ndarray, j: np.ndarray) -> np.ndarray:
    """Rounding steps between port and reference values: int8 codes, or
    fp16 scales (adjacent fp16 values differ by one in their bits)."""
    if t.dtype == np.float16:
        t, j = t.view(np.int16), j.view(np.int16)
    return np.abs(t.astype(np.int32) - j.astype(np.int32))


def _first_ties(tcalls, jcalls, tcache, jcache, first, pos0):
    """Lower ``first`` (per batch row, a position) to the row's first
    position where an activation code or a KV code or scale differs
    between port and reference, and check that the difference is one
    rounding step where it first appears, in the forward's order (per
    layer: the q/k/v input, the cache, the wo, gate/up and down inputs).
    Later layers and positions carry it on, so only the first is checked.
    ``tcalls``/``jcalls`` are one forward's act codes, (B, T, K) for
    positions ``pos0[b] + t``."""
    assert len(tcalls) == len(jcalls) > 0 and len(tcalls) % 7 == 0
    quant = "k_scale" in tcache["attn"]
    events = []  # (kind, payload) in forward order
    for layer in range(len(tcalls) // 7):
        acts = [(tc.reshape(jc.shape), jc) for tc, jc in zip(
            tcalls[7 * layer:7 * layer + 7], jcalls[7 * layer:7 * layer + 7])]
        events += [("act", a) for a in acts[:3]]
        if quant:
            events.append(("kv", layer))
        events += [("act", a) for a in acts[3:]]
    for row in range(len(first)):
        found = []  # (position, event index, steps there)
        for i, (kind, payload) in enumerate(events):
            if kind == "act":
                tc, jc = payload
                st = _steps(tc[row], jc[row])  # (T, K)
                pos = pos0[row] + np.arange(st.shape[0])
                diff = st.max(axis=1)
            else:
                st = np.stack([_steps(
                    tcache["attn"][key][payload, row].numpy(),
                    np.asarray(jcache["attn"][key][payload, row])).max(
                        axis=(0, 2)) for key in ("k", "v", "k_scale",
                                                 "v_scale")])  # (4, T)
                pos = np.arange(st.shape[1])
                diff = st.max(axis=0)
            hit = np.nonzero((diff > 0) & (pos < first[row]))[0]
            if len(hit):
                found.append((pos[hit[0]], i, diff[hit[0]]))
        if found:
            p = min(f[0] for f in found)
            step = next(f[2] for f in found if f[0] == p)  # earliest event
            assert step == 1, (row, p, step)
            first[row] = p
    return first


def _jax_fns(cfg, kv_quant):
    """Jitted anew for each test: the traces hold that test's code log."""
    rt = JRuntime(compute_dtype=jnp.float32, kv_quant=kv_quant,
                  backend="ref", act_quant=True)
    return (jax.jit(lambda p, toks, c: jlm.forward(p, toks, rt, cfg, cache=c,
                                                   pos=0)[:2]),
            jax.jit(lambda p, toks, c, pos: jlm.decode_step(p, toks, c, pos,
                                                            rt, cfg)))


CASES = [("smollm-135m", "itq3_s", True), ("smollm-135m", "itq3_s", False),
         ("smollm-135m", "itq3_s_sub", True), ("smollm-135m", "itq3_x", True),
         ("qwen1.5-0.5b", "itq3_s", True), ("qwen1.5-0.5b", "itq3_s", False)]


@pytest.mark.parametrize("arch,fmt,kv_quant", CASES)
def test_act_quant_logits_match_reference(arch, fmt, kv_quant, monkeypatch):
    """Prefill then four teacher-forced decode steps at ragged positions,
    W3A8 on both sides (the reference eager, so its codes can be
    recorded; the port on its kernel path's plain versions)."""
    cfg, jp, tp = _params(arch, fmt)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    jlog = _CodeLog(monkeypatch, jact, traced=True)
    tlog = _CodeLog(monkeypatch, tqlinear, name="fwht_act_encode")
    fwd, dec = _jax_fns(cfg, kv_quant)
    rt = TRuntime(kv_quant=kv_quant, act_quant=True)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, T))
    jl, jcache = fwd(jp, jnp.asarray(toks, jnp.int32),
                     jlm.init_cache(cfg, B, MAX_LEN, dtype=jnp.float32,
                                    kv_quant=kv_quant))
    jax.effects_barrier()
    tcache = tlm.init_cache(tcfg, B, MAX_LEN, kv_quant=kv_quant,
                            device="cpu")
    tl, tcache = tlm.forward(tp, toks, rt, tcfg, cache=tcache, pos=0)
    calls = tlog.take()
    assert len(calls) == 7 * cfg.num_layers
    first = _first_ties(calls, jlog.take(), tcache, jcache,
                        np.full(B, MAX_LEN), np.zeros(B, int))
    compared = 0
    for row in range(B):
        upto = min(first[row], T)
        np.testing.assert_allclose(tl[row, :upto].numpy(),
                                   np.asarray(jl[row, :upto]), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"row {row}")
        compared += upto
    assert compared >= B * T // 2, "rounding ties cut most of the check"
    pos = np.array([T - 3, T], np.int32)
    nxt = np.array(jnp.argmax(jl[np.arange(B), pos - 1], -1))[:, None]
    checked = 0
    for step in range(4):
        jl2, jcache = dec(jp, jnp.asarray(nxt, jnp.int32), jcache,
                          jnp.asarray(pos + step))
        jax.effects_barrier()
        tl2, tcache = tlm.decode_step(tp, nxt, tcache, pos + step, rt, tcfg)
        first = _first_ties(tlog.take(), jlog.take(), tcache, jcache, first,
                            pos + step)
        for row in np.nonzero(first > pos + step)[0]:
            np.testing.assert_allclose(
                tl2[row].numpy(), np.asarray(jl2[row]), rtol=0,
                atol=LOGIT_ATOL, err_msg=f"step {step} row {row}")
            checked += 1
        nxt = np.array(jnp.argmax(jl2[:, 0], -1))[:, None]
    assert checked, "rounding ties cut every decode step"


# --- the engine --------------------------------------------------------------

SLOTS, ENGINE_LEN, MAX_NEW = 4, 128, 8


def _prompts():
    rng = np.random.default_rng(12)
    return [rng.integers(0, 512, size=int(n)).astype(np.int32)
            for n in rng.integers(3, 21, size=6)]


@pytest.mark.parametrize("fmt", ["itq3_s", "itq3_s_sub"])
def test_act_quant_engine_streams_equal_reference_engine(fmt):
    cfg, jp = jax_quantized_params("smollm-135m", fmt)
    jeng = JServeEngine(jp, cfg, slots=SLOTS, max_len=ENGINE_LEN,
                        rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True,
                                    backend="ref", act_quant=True))
    want = jeng.run([JRequest(rid=i, prompt=p, max_new=MAX_NEW)
                     for i, p in enumerate(_prompts())])
    tp = params_from_numpy(to_numpy_tree(jp), device="cpu")
    tcfg = tconfigs.reduced(tconfigs.get_config("smollm-135m"))
    eng = ServeEngine(tp, tcfg, slots=SLOTS, max_len=ENGINE_LEN,
                      rt=TRuntime(kv_quant=True, act_quant=True),
                      device="cpu")
    got = eng.run([Request(rid=i, prompt=p, max_new=MAX_NEW)
                   for i, p in enumerate(_prompts())])
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.finish_reason == "length" for r in got)
    assert eng.stats()["act_quant"] is True
    assert jeng.stats()["act_quant"] is True


def test_jax_qtensor_alias_is_the_reference_class():
    # the bridge helpers hand JAX QTensors over; guard the import used here
    _, jqt, _ = _weights("itq3_s")
    assert isinstance(jqt, JQTensor)
