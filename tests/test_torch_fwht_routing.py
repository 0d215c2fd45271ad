"""Which FWHTs go through the FWHT kernel's wrappers, on the CPU.

On the serving path ``kernels/fwht.py`` launches, per layer: at 256 points
``fwht`` before every float prefill projection (a float decode projection
rotates inside ``itq3_matvec``) or ``fwht_act_encode`` for every W3A8
projection, step and wave alike (rotate and int8-encode in one launch,
no 256-point ``fwht``); one ``fwht_kv_encode`` for the layer's K and V
(through ``serve/kv_quant.py:kv_encode_pair``); and two ``fwht`` at
head_dim points, the attention's query and output rotations
(``decode_attn_q8`` / ``prefill_attn_q8``, through ``fwht_last``). Spies
on the wrappers count the calls of one reduced prefill wave and one
decode step on both paths against that contract, under the launch
counters' names (on a CPU tensor a wrapper runs its plain version, so the
counts are the card's launches). Routed or not, the outputs keep the bits
of ``core/fwht.py``'s plain butterfly; with ``backend="ref"`` nothing goes
through a wrapper; and ``fwht`` takes every power of two from 2 to 1024
and nothing else.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.fwht import fwht as plain_fwht
from repro_torch.kernels import attn_q8 as tattn
from repro_torch.kernels import fwht as tfwht
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.layers import Runtime
from repro_torch.serve import kv_quant as tkv
from repro_torch.serve.quantized import quantize_params

B, T, MAX_LEN = 2, 16, 32


@functools.lru_cache(maxsize=None)
def _model():
    cfg = tconfigs.reduced(tconfigs.get_config("smollm-135m"))
    params = quantize_params(tlm.init_params(cfg, seed=0, device="cpu"),
                             "itq3_s")
    return cfg, params


@pytest.fixture
def spy(monkeypatch):
    """Every call of the FWHT kernel's wrappers, under its launch counter's
    name (``fwht/<block>``, ``fwht_act/256``, ``fwht_kv/<HD>``), and of
    the layer's ``kv_encode_pair`` (``kv_encode_pair``)."""
    calls = []
    real = tfwht.fwht

    def record(x, block=256):
        calls.append(f"fwht/{block}")
        return real(x, block)
    monkeypatch.setattr(tfwht, "fwht", record)
    real_act = tqlinear.fwht_act_encode

    def record_act(x, **kw):
        calls.append(f"fwht_act/{kw.get('block', 256)}")
        return real_act(x, **kw)
    monkeypatch.setattr(tqlinear, "fwht_act_encode", record_act)
    real_kv = tkv.fwht_kv_encode

    def record_kv(k, v):
        calls.append(f"fwht_kv/{k.shape[-1]}")
        return real_kv(k, v)
    monkeypatch.setattr(tkv, "fwht_kv_encode", record_kv)
    real_pair = tlayers.kv_encode_pair

    def record_pair(k, v, **kw):
        calls.append("kv_encode_pair")
        return real_pair(k, v, **kw)
    monkeypatch.setattr(tlayers, "kv_encode_pair", record_pair)
    return calls


def _counts(calls):
    return {b: calls.count(b) for b in sorted(set(calls))}


def _wrappers(calls):
    return [c for c in calls if c != "kv_encode_pair"]


def _wave_and_step(backend, act_quant, spy):
    """The wrapper's calls in one prefill wave (B x T rows) and in the
    decode step after it, and both logits."""
    cfg, params = _model()
    rt = Runtime(kv_quant=True, backend=backend, act_quant=act_quant)
    cache = tlm.init_cache(cfg, B, MAX_LEN, kv_quant=True, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T)))
    logits, cache = tlm.forward(params, tokens, rt, cfg, cache=cache, pos=0,
                                last_only=True)
    wave = _counts(spy)
    spy.clear()
    step_logits, _ = tlm.decode_step(params, logits[:, -1].argmax(-1)[:, None],
                                     cache, torch.full((B,), T), rt, cfg)
    return wave, _counts(spy), logits, step_logits


@pytest.mark.parametrize("act_quant", [False, True])
def test_fwht_calls_follow_the_launch_contract(act_quant, spy):
    cfg, _ = _model()
    layers, hd = cfg.num_layers, cfg.resolved_head_dim
    wave, step, _, _ = _wave_and_step("auto", act_quant, spy)
    per_layer = {f"fwht/{hd}": 2 * layers, f"fwht_kv/{hd}": layers,
                 "kv_encode_pair": layers}
    if act_quant:  # rotate and encode in one launch, step and wave alike
        per_layer["fwht_act/256"] = 7 * layers
        assert wave == step == per_layer
    else:  # a float decode projection rotates inside the fused matvec
        assert step == per_layer
        assert wave == {**per_layer, "fwht/256": 7 * layers}


@pytest.mark.parametrize("act_quant", [False, True])
def test_ref_backend_calls_no_wrapper(act_quant, spy):
    cfg, _ = _model()
    _, _, logits, step = _wave_and_step("ref", act_quant, spy)
    assert _wrappers(spy) == []
    assert spy == ["kv_encode_pair"] * cfg.num_layers  # the step's
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_kv_encode_route_is_bit_equal(hd, spy):
    x = torch.from_numpy(np.random.default_rng(hd).standard_normal(
        (2, 3, 5, hd)).astype(np.float32) * 4)
    codes, scales = tkv.kv_encode(x)
    assert spy == [f"fwht/{hd}"]
    ref_codes, ref_scales = tkv.kv_encode(x, backend="ref")
    assert spy == [f"fwht/{hd}"]
    assert torch.equal(codes, ref_codes) and torch.equal(scales, ref_scales)
    # the layer's pair: one fused call for K and V, the same bits
    spy.clear()
    (kq, ks), (vq, vs) = tkv.kv_encode_pair(x, 2 * x)
    assert spy == [f"fwht_kv/{hd}"]
    assert torch.equal(kq, codes) and torch.equal(ks, scales)
    v_codes, v_scales = tkv.kv_encode(2 * x, backend="ref")
    assert torch.equal(vq, v_codes) and torch.equal(vs, v_scales)


def _attn_inputs(rng, hd, tq):
    """A (B, KV, T, HD) rotated-int8 cache dict and (B, KV, G, TQ, HD)
    queries."""
    b, kv, g, t = 2, 2, 3, 24
    cache = {
        "k": torch.from_numpy(rng.integers(-127, 128, (b, kv, t, hd))
                              .astype(np.int8)),
        "v": torch.from_numpy(rng.integers(-127, 128, (b, kv, t, hd))
                              .astype(np.int8)),
        "k_scale": torch.from_numpy(rng.uniform(1e-3, 0.05, (b, kv, t, 1))
                                    .astype(np.float16)),
        "v_scale": torch.from_numpy(rng.uniform(1e-3, 0.05, (b, kv, t, 1))
                                    .astype(np.float16)),
    }
    q = torch.from_numpy(rng.standard_normal((b, kv, g, tq, hd))
                         .astype(np.float32))
    return q, cache


@pytest.mark.parametrize("hd", [32, 64])
def test_attention_rotations_route_is_bit_equal(hd, spy, monkeypatch):
    rng = np.random.default_rng(hd)
    q, cache = _attn_inputs(rng, hd, 1)
    k_tok = tkv.kv_encode(torch.from_numpy(
        rng.standard_normal((2, 2, 1, hd)).astype(np.float32)))
    v_tok = tkv.kv_encode(torch.from_numpy(
        rng.standard_normal((2, 2, 1, hd)).astype(np.float32)))
    kv_len = torch.tensor([5, 20])
    qp, _ = _attn_inputs(rng, hd, 8)
    offs = torch.tensor([0, 12])
    spy.clear()
    dec = tattn.decode_attn_q8(q, cache, k_tok, v_tok, kv_len)
    pre = tattn.prefill_attn_q8(qp, cache, offs + 8, offs)
    assert spy == [f"fwht/{hd}"] * 4  # query and output, decode then prefill
    # the same calls with the rotations on core/fwht.py's plain butterfly
    monkeypatch.setattr(tattn, "fwht_last",
                        lambda x, backend="auto": plain_fwht(x))
    assert torch.equal(dec, tattn.decode_attn_q8(q, cache, k_tok, v_tok,
                                                 kv_len))
    assert torch.equal(pre, tattn.prefill_attn_q8(qp, cache, offs + 8, offs))
    assert spy == [f"fwht/{hd}"] * 4


def test_fwht_takes_every_power_of_two_from_2_to_1024():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 2048)).astype(np.float32))
    assert tfwht.FWHT_BLOCKS == tuple(2 ** i for i in range(1, 11))
    for block in tfwht.FWHT_BLOCKS:
        got = tfwht.fwht(x, block)
        assert torch.equal(got, tfwht.fwht_ref(x, block))
        # self-inverse
        torch.testing.assert_close(tfwht.fwht(got, block), x, rtol=1e-5,
                                   atol=1e-5)
        last = tfwht.fwht_last(x[:, :block].reshape(3, 1, block))
        assert torch.equal(last, plain_fwht(x[:, :block]).reshape(3, 1, block))
    for block in (3, 1, 2048, 96):
        with pytest.raises(ValueError, match="block"):
            tfwht.fwht(x, block)
    with pytest.raises(ValueError, match="dtype"):
        tfwht.fwht(x.double(), 64)
    with pytest.raises(ValueError, match="backend"):
        tfwht.fwht_last(x, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        tfwht.fwht_last(x, backend="cuda")
