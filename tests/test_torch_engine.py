"""The port's ServeEngine against the live reference engine, on the CPU.

Reduced smollm-135m, itq3_s planes bridged from the reference, rotated-int8
KV cache, 4 slots, 6 greedy requests of prompt lengths 3-20: the token
streams must be equal, with one host sync per decode step (plus one per
admission wave). The rest holds the port's own lifecycle: quarantine of a
poisoned slot, cancellation, malformed requests and the later-slice
options refusing loudly (the paged cache and preemption are in
``test_torch_paged.py``).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import Runtime as JRuntime
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampling import SamplingParams
from test_torch_bridge import jax_quantized_params, to_numpy_tree

SLOTS, MAX_LEN, MAX_NEW = 4, 128, 8


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 512, size=int(n)).astype(np.int32)
            for n in rng.integers(3, 21, size=6)]


def _port_engine(**kw):
    _, jp = jax_quantized_params("smollm-135m", "itq3_s")
    tp = params_from_numpy(to_numpy_tree(jp), device="cpu")
    cfg = tconfigs.reduced(tconfigs.get_config("smollm-135m"))
    kw.setdefault("device", "cpu")
    return ServeEngine(tp, cfg, slots=SLOTS, max_len=MAX_LEN,
                       rt=TRuntime(kv_quant=True), **kw)


def _port_run(eng, prompts=None):
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts or _prompts())]
    return eng.run(reqs)


def test_greedy_streams_equal_reference_engine():
    cfg, jp = jax_quantized_params("smollm-135m", "itq3_s")
    jeng = JServeEngine(jp, cfg, slots=SLOTS, max_len=MAX_LEN,
                        rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True,
                                    backend="ref"))
    want = jeng.run([JRequest(rid=i, prompt=p, max_new=MAX_NEW)
                     for i, p in enumerate(_prompts())])
    eng = _port_engine()
    got = _port_run(eng)
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.done and r.finish_reason == "length" and len(r.out) == MAX_NEW
               for r in got)
    st = eng.stats()
    assert st["prefill_waves"] == 2  # 6 requests over 4 slots
    assert st["host_syncs"] == st["decode_steps"] + st["prefill_waves"]
    assert st["quarantined"] == 0
    assert st["cache_bytes"] == jeng.stats()["cache_bytes"]
    assert st["cache_bytes_per_token"] == jeng.stats()["cache_bytes_per_token"]


def test_poisoned_slot_is_quarantined_and_neighbours_unchanged():
    clean = [r.out for r in _port_run(_port_engine())]
    eng = _port_engine()
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts())]
    zeroed = None
    for ev in eng.generate(reqs):
        if ev.rid == 0 and ev.index == 2:
            eng.cache["attn"]["k_scale"][0, 0] = float("inf")
        if ev.rid == 0 and ev.finished:  # before a new tenant moves in
            zeroed = all((v[:, 0] == 0).all()
                         for v in eng.cache["attn"].values())
    assert reqs[0].finish_reason == "error" and len(reqs[0].out) == 3
    assert eng.stats()["quarantined"] == 1 and zeroed
    for r in reqs[1:]:
        assert r.finish_reason == "length" and r.out == clean[r.rid]


def test_cancel_live_and_queued_requests():
    eng = _port_engine()
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts())]
    events = []
    for ev in eng.generate(reqs):
        events.append(ev)
        if ev.rid == 1 and ev.index == 1:
            assert eng.cancel(1) and eng.cancel(5)  # live, then queued
    assert reqs[1].finish_reason == "cancelled" and len(reqs[1].out) == 2
    assert reqs[5].finish_reason == "cancelled" and reqs[5].out == []
    assert [e.finish_reason for e in events if e.finished].count(
        "cancelled") == 2
    assert not eng.cancel(99)


def test_malformed_request_and_later_slices_refuse():
    eng = _port_engine()
    bad = Request(rid=7, prompt=np.zeros(0, np.int32))
    assert not eng.submit_request(bad)
    assert bad.finish_reason == "error"
    # sampled requests are served since the sampled-decoding slice
    assert eng.submit_request(Request(rid=8, prompt=np.arange(3),
                                      sampling=SamplingParams(temperature=0.8)))
    assert not eng.preempt(0)  # nothing live
    # speculative decoding is served since its slice: a draft without its
    # config is refused as the reference refuses it
    with pytest.raises(ValueError, match="draft_cfg"):
        _port_engine(draft_params={"x": 1})
    # tensor-parallel meshes are served since their slice: a multi-way
    # data axis is refused in the reference's words
    with pytest.raises(ValueError, match="trivial 'data'"):
        _port_engine(mesh=SimpleNamespace(shape={"data": 2, "model": 1}))


def test_cli_serves_a_port_quantized_model_on_cpu(capsys):
    from repro_torch.launch import serve as tserve
    tserve.main(["--reduced", "--kv-quant", "--device", "cpu",
                 "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out


def test_engine_refuses_params_on_another_device():
    with pytest.raises(ValueError, match="params live on"):
        _port_engine(device="meta")
    assert torch.device("cpu") == _port_engine().device
