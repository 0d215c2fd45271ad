"""Booting the port's engine from a checkpoint, and the launcher's flags,
against the live JAX reference on the CPU.

A reduced smollm-135m quantized under the mixed policy is saved by one
side and booted by both with ``ServeEngine.from_checkpoint`` (the port's
and the reference's), on the W3A8 path with the rotated-int8 KV cache: a
batch of greedy and sampled requests must stream the same tokens and leave
the same counters. The port's CLI with the request-lifecycle flags prints
the same token ids on two runs, and ``--stream`` one event per token.
"""
import functools
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jconfigs
from repro.models import lm as jlm
from repro.models.layers import Runtime as JRuntime
from repro.serve import quantized as jquantized
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve import quantized as tquantized
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampling import SamplingParams
from test_torch_bridge import to_numpy_tree

ARCH = "smollm-135m"
SLOTS, MAX_LEN, MAX_NEW = 4, 128, 10
MIX = [dict(), dict(temperature=0.8), dict(temperature=0.8, top_k=40),
       dict(temperature=1.0, top_p=0.9), dict(), dict(temperature=0.9,
                                                     seed=21)]
COUNTERS = ("host_syncs", "tokens_decoded", "decode_steps", "waiting",
            "requests_rejected", "requests_shed", "requests_invalid",
            "deadline_expired", "quarantined", "preemptions", "resumes",
            "stalled_steps", "swapped", "max_concurrent", "scheduler",
            "cache_bytes", "cache_bytes_per_token", "kv_quant", "act_quant")


@functools.lru_cache(maxsize=None)
def _fp_params():
    cfg = jconfigs.reduced(jconfigs.get_config(ARCH))
    jp = jax.jit(jlm.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    cfg)
    return cfg, jp


def _requests(cls, sp_cls):
    rng = np.random.default_rng(17)
    return [cls(rid=i, prompt=rng.integers(0, 512, size=int(n)).astype(
        np.int32), max_new=MAX_NEW, sampling=sp_cls(ignore_eos=True, **m))
        for i, (n, m) in enumerate(zip(rng.integers(3, 21, len(MIX)), MIX))]


def _save(side: str, path: str) -> None:
    cfg, jp = _fp_params()
    if side == "reference":
        policy = jquantized.QuantPolicy.from_dict(
            jconfigs.mixed_precision_recipe(cfg))
        jq = jax.jit(functools.partial(jquantized.quantize_params,
                                       fmt=policy))(jp)
        jckpt.save(path, 0, jq)
    else:
        tcfg = tconfigs.reduced(tconfigs.get_config(ARCH))
        policy = tquantized.QuantPolicy.from_dict(
            tconfigs.mixed_precision_recipe(tcfg))
        tq = tquantized.quantize_params(
            params_from_numpy(to_numpy_tree(jp), device="cpu"), policy)
        tckpt.save(path, 0, tq)


@pytest.mark.parametrize("saved_by", ["reference", "port"])
def test_from_checkpoint_streams_equal_reference(saved_by, tmp_path):
    """Both sides boot the same mixed-policy checkpoint with their own
    ``from_checkpoint`` and serve greedy and sampled requests alike."""
    path = str(tmp_path / "ckpt")
    _save(saved_by, path)
    cfg = _fp_params()[0]
    jeng = JServeEngine.from_checkpoint(
        path, cfg, slots=SLOTS, max_len=MAX_LEN, seed=3,
        rt=JRuntime(compute_dtype=jnp.float32, kv_quant=True, backend="ref",
                    act_quant=True))
    want = jeng.run(_requests(JRequest, JSamplingParams))
    eng = ServeEngine.from_checkpoint(
        path, tconfigs.reduced(tconfigs.get_config(ARCH)), slots=SLOTS,
        max_len=MAX_LEN, seed=3, rt=TRuntime(kv_quant=True, act_quant=True),
        device="cpu")
    got = eng.run(_requests(Request, SamplingParams))
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.finish_reason == "length" for r in got)
    js, ts = jeng.stats(), eng.stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert ts["host_syncs"] == ts["decode_steps"] + ts["prefill_waves"]


def test_from_checkpoint_step_options_and_refusals(tmp_path):
    path = str(tmp_path / "ckpt")
    _save("port", path)
    params, _ = tckpt.restore_params(path, device="cpu")
    tckpt.save(path, 5, params)
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    eng = ServeEngine.from_checkpoint(path, cfg, step=0, device="cpu",
                                      rt=TRuntime(kv_quant=True), paged=True,
                                      max_queue=2)
    assert eng.paged and eng.max_queue == 2 and eng.device.type == "cpu"
    assert eng.params["embed"].device.type == "cpu"
    assert not eng.spec
    spec = ServeEngine.from_checkpoint(path, cfg, device="cpu", draft_depth=1,
                                       rt=TRuntime(kv_quant=True))
    assert spec.spec and spec.draft_cfg.num_layers == 1
    assert spec.draft_params["embed"] is spec.params["embed"]
    with pytest.raises(ValueError, match="trivial 'data'"):
        ServeEngine.from_checkpoint(
            path, cfg, device="cpu",
            mesh=SimpleNamespace(shape={"data": 2, "model": 1}))
    with pytest.raises(ValueError, match="draft_cfg"):
        ServeEngine.from_checkpoint(path, cfg, device="cpu",
                                    draft_params={})


def _cli(argv, capsys):
    from repro_torch.launch import serve as tserve
    tserve.main(argv)
    return capsys.readouterr().out


def test_cli_sampling_flags_same_ids_on_two_runs(tmp_path, capsys):
    """Sampled, with stop tokens and the SJF scheduler, booted from disk:
    two runs print the same ``rid=... ->`` lines."""
    q = str(tmp_path / "q")
    common = ["--reduced", "--kv-quant", "--device", "cpu", "--requests",
              "5", "--max-new", "6", "--temperature", "0.8", "--top-k",
              "40", "--top-p", "0.9", "--sampling-seed", "7",
              "--scheduler", "sjf", "--stop-token", "5", "--stop-token", "9"]
    out = _cli(common + ["--act-quant", "--policy", "mixed",
                         "--save-quantized", q], capsys)
    runs = [_cli(common + ["--act-quant", "--load-quantized", q], capsys)
            for _ in range(2)]
    assert f"loaded quantized step-0 tree from {q}" in runs[0]
    assert "with ServeEngine.from_checkpoint" in runs[0]
    ids = [re.findall(r"rid=\d+ -> \[.*\]", o) for o in (out, *runs)]
    assert len(ids[0]) == 3 and ids[0] == ids[1] == ids[2]
    assert "scheduler=sjf" in runs[0]


def test_cli_stream_prints_one_event_per_token(capsys):
    out = _cli(["--reduced", "--kv-quant", "--device", "cpu", "--requests",
                "4", "--max-new", "5", "--stream", "--scheduler", "priority",
                "--temperature", "0.7", "--sample-on-host"], capsys)
    tokens = re.findall(r"rid=(\d+) token (\d+): (\d+)", out)
    finished = re.findall(r"rid=(\d+) finished \[(\w+)\] (\d+) tokens", out)
    served = int(re.search(r"requests / (\d+) tokens", out).group(1))
    # the terminal event carries the last token: one line per other token
    assert len(tokens) + len(finished) == served
    assert sorted(int(r) for r, _, _ in finished) == [0, 1, 2, 3]
    assert all(reason in ("length", "stop") for _, reason, _ in finished)
