"""The port's MoE block against the live reference's, on the CPU.

``moe_apply`` of reduced olmoe-1b-7b and reduced qwen3-moe-235b-a22b (8
experts, top-2) from the reference's own weights, fp and ``itq3_s``,
bridged bit for bit, at three capacity factors: 0.05 (every expert keeps
one slot, so assignments drop), 1.25 (the serving default) and 64
(dropless). The routing (top-k ids, ranks within experts, the kept
assignments) must be the reference's exactly; the output within 1e-5 and
the Switch aux loss within 1e-6 (f32 sums in XLA's and PyTorch's orders).

A k = 8, E = 16 case pins the combine: the port sums a token's k terms
in ascending expert id from zero, which is the reference's scatter-add
over the expert-sorted assignments (held bit for bit against a sequential
``np.add.at`` and XLA's ``.at[].add`` on the port's own expert outputs).

``qmatmul_experts`` (one expert-axis call) equals the per-expert
``qmatmul`` bit for bit in both modes, with and without ``act_quant``,
and the four expert-axis wrappers equal their per-matrix plain versions;
on CPU tensors they launch nothing.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.layers import Runtime as JRuntime
from repro.models.layers import dense as jdense
from repro.serve.quantized import quantize_params as jquantize_params
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.qlinear import qmatmul, qmatmul_experts
from repro_torch.kernels import _build
from repro_torch.kernels import itq3 as titq3
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serve.quantized import quantize_params
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import to_numpy_tree

B, T = 2, 12
ARCHS = ("olmoe-1b-7b", "qwen3-moe-235b-a22b")
FACTORS = (0.05, 1.25, 64.0)


@functools.lru_cache(maxsize=None)
def _jax_params(cfg, fmt):
    """Reference weights of ``cfg`` (fp, or quantized by the reference)."""
    params = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    if fmt is None:
        return params
    return jax.jit(functools.partial(jquantize_params, fmt=fmt))(params)


def _moe_block(cfg, fmt):
    """Layer 0's MoE block: the reference's, and the port's bridged copy."""
    jp = _jax_params(cfg, fmt)
    jblock = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    tp = params_from_numpy(to_numpy_tree(jp), device="cpu")
    return jblock, tlm.layer_params(tp["layers"], 0)["moe"]


def _x(cfg, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def _jrt(cf):
    return JRuntime(compute_dtype=jnp.float32, backend="ref",
                    capacity_factor=cf)


def _reference_routing(jblock, x, cfg, cf):
    """The reference's top-k ids and its dispatch_row meta (ranks within
    experts, kept assignments) in sorted order, per row."""
    rt = _jrt(cf)
    logits = jdense(jnp.asarray(x), jblock["router"], rt).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                           cfg.experts_per_token)
    idx = np.asarray(idx)
    cap = tmoe.capacity(cfg, TRuntime(capacity_factor=cf), x.shape[1])
    eid = idx.reshape(idx.shape[0], -1)
    order = np.argsort(eid, axis=-1, kind="stable")
    s_eid = np.take_along_axis(eid, order, -1)
    first = np.stack([np.searchsorted(r, r, side="left") for r in s_eid])
    rank = np.arange(eid.shape[1]) - first
    return idx, s_eid, order, rank, rank < cap


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("fmt", [None, "itq3_s"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, fmt, cf):
    jcfg = jreduced(jget_config(arch))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    jblock, tblock = _moe_block(jcfg, fmt)
    x = _x(jcfg)
    want, jaux = jax.jit(lambda p, xx: jmoe.moe_apply(
        p, xx, _jrt(cf), jcfg))(jblock, jnp.asarray(x))
    rt = TRuntime(capacity_factor=cf)  # auto: CPU tensors -> plain
    got, aux = tmoe.moe_apply(tblock, torch.from_numpy(x), rt, tcfg)

    idx, s_eid, order, rank, keep = _reference_routing(jblock, x, jcfg, cf)
    _, tidx, _ = tmoe.route(tblock, torch.from_numpy(x), rt, tcfg)
    dsp = tmoe.dispatch(tidx, tmoe.capacity(tcfg, rt, T))
    np.testing.assert_array_equal(tidx.numpy(), idx)
    for name, ref in (("s_eid", s_eid), ("order", order), ("rank", rank),
                      ("keep", keep)):
        np.testing.assert_array_equal(getattr(dsp, name).numpy(), ref,
                                      err_msg=name)
    if cf == FACTORS[0]:
        assert not keep.all()  # the drop path ran
    if cf == FACTORS[-1]:
        assert keep.all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_combine_sums_in_ascending_expert_order(monkeypatch):
    """k = 8 of E = 16: a token's terms in ascending expert id, from
    zero, sequentially: the reference's sorted scatter-add."""
    jcfg = dataclasses.replace(jreduced(jget_config("olmoe-1b-7b")),
                               num_experts=16, experts_per_token=8)
    tcfg = dataclasses.replace(tconfigs.reduced(
        tconfigs.get_config("olmoe-1b-7b")), num_experts=16,
        experts_per_token=8)
    jblock, tblock = _moe_block(jcfg, None)
    x = _x(jcfg, seed=5)
    seen = {}
    real = tmoe._expert_ffn

    def record(p, xb, rt, act):
        seen["out"] = real(p, xb, rt, act)
        return seen["out"]
    monkeypatch.setattr(tmoe, "_expert_ffn", record)
    rt = TRuntime()
    got, _ = tmoe.moe_apply(tblock, torch.from_numpy(x), rt, tcfg)
    gates, idx, _ = tmoe.route(tblock, torch.from_numpy(x), rt, tcfg)
    cap = tmoe.capacity(tcfg, rt, T)
    dsp = tmoe.dispatch(idx, cap)
    e, k, d = 16, 8, tcfg.d_model
    out_buf = seen["out"].reshape(e, B, cap, d).numpy()
    want = np.zeros((B, T, d), np.float32)
    jwant = []
    for b in range(B):
        tok = dsp.order[b].numpy() // k
        w = (torch.gather(gates.reshape(B, -1)[b], 0, dsp.order[b])
             * dsp.keep[b]).numpy()
        vals = out_buf[dsp.s_eid[b].numpy(), b, dsp.rankc[b].numpy()] \
            * w[:, None]
        np.add.at(want[b], tok, vals)  # unbuffered, in sorted order
        jwant.append(np.asarray(jnp.zeros((T, d)).at[tok].add(vals)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.stack(jwant))
    # and it has teeth: descending expert order gives other bits somewhere
    desc = np.zeros_like(want)
    for b in range(B):
        tok = dsp.order[b].numpy() // k
        w = (torch.gather(gates.reshape(B, -1)[b], 0, dsp.order[b])
             * dsp.keep[b]).numpy()
        vals = out_buf[dsp.s_eid[b].numpy(), b, dsp.rankc[b].numpy()] \
            * w[:, None]
        np.add.at(desc[b], tok[::-1], vals[::-1])
    assert (desc != want).any()
    # the JAX reference agrees within f32 sums
    jout, _ = jax.jit(lambda p, xx: jmoe.moe_apply(p, xx, _jrt(1.25), jcfg))(
        jblock, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


def _stacks():
    """(name, expert stack) pairs: port-quantized (1-D sign diagonal; the
    formats without ternary planes take the plain dequant path) and
    bridged from the reference (quip3's (E, block) diagonal)."""
    cfg = tconfigs.reduced(tconfigs.get_config("olmoe-1b-7b"))
    tp = tlm.init_params(cfg, seed=1, device="cpu")
    out = []
    for fmt in ("itq3_s", "itq3_s_sub", "itq3_x", "quip3", "q8_0", "fp16"):
        q = quantize_params(tp, fmt)
        out.append((f"port-{fmt}",
                    tlm.layer_params(q["layers"], 1)["moe"]["down"]))
    jcfg = jreduced(jget_config("olmoe-1b-7b"))
    _, jq = _moe_block(jcfg, "quip3")
    out.append(("reference-quip3", jq["up"]))
    return out


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("mode", ["activations", "weights"])
def test_qmatmul_experts_equals_per_expert_qmatmul(mode, act):
    rng = np.random.default_rng(7)
    _build.reset_launches()
    for name, qt in _stacks():
        e = next(iter(qt.data.values())).shape[0]
        if name == "reference-quip3":
            assert qt.data["dsign"].shape == (e, 256)
        for m in (3, 16, 20):
            x = torch.from_numpy(rng.standard_normal(
                (e, m, qt.meta.k)).astype(np.float32))
            for backend in ("auto", "ref"):
                got = qmatmul_experts(x, qt, mode=mode, backend=backend,
                                      act_quant=act)
                want = torch.stack([qmatmul(x[i], qt.layer(i), mode=mode,
                                            backend=backend, act_quant=act)
                                    for i in range(e)])
                assert got.shape == (e, m, qt.meta.n)
                assert torch.equal(got, want), (name, m, backend)
    assert not _build.launches  # CPU tensors take the plain versions


def test_qmatmul_experts_refuses_mismatched_stacks():
    (_, qt), *_ = _stacks()
    with pytest.raises(ValueError, match="experts"):
        qmatmul_experts(torch.zeros(3, 2, qt.meta.k), qt)


def test_plain_expert_kernels_equal_per_matrix():
    """The four wrappers on an (E, M, K) stack: their plain versions
    expert by expert, bit for bit; a stack that does not match is
    refused."""
    g = torch.Generator().manual_seed(0)
    e, n, kb = 3, 24, 2
    for fmt, sub in (("itq3_s", 0), ("itq3_s_sub", 8)):
        w = torch.randn(e, kb * 256, n, generator=g)
        qt = quantize_params({"up": w}, fmt)["up"]
        planes = [qt.data[k] for k in ("plane2", "plane1", "scales", "zps")]
        kw = dict(fivelevel=False, sub_blocks=sub)
        for m in (4, 20):
            x = torch.randn(e, m, kb * 256, generator=g)
            float_fn = titq3.itq3_matvec if m <= 16 else titq3.itq3_matmul
            for rotate_x in ((False, True) if m <= 16 else (False,)):
                rkw = dict(rotate_x=True) if rotate_x else {}
                got = float_fn(x, *planes, rotate_weights=False, **rkw, **kw)
                want = torch.stack([float_fn(
                    x[i], *(p[i] for p in planes), rotate_weights=False,
                    **rkw, **kw) for i in range(e)])
                assert torch.equal(got, want)
            xq = torch.randint(-127, 128, (e, m, kb * 256), generator=g,
                               dtype=torch.int8)
            xs = torch.rand(e, m, 1, generator=g) + 0.5
            int8_fn = (titq3.itq3_matvec_int8 if m <= 16
                       else titq3.itq3_matmul_int8)
            got = int8_fn(xq, xs, *planes, **kw)
            want = torch.stack([titq3.itq3_matmul_int8_ref(
                xq[i], xs[i], *(p[i] for p in planes), **kw)
                for i in range(e)])
            assert torch.equal(got, want)
        with pytest.raises(ValueError, match="planes"):
            titq3.itq3_matmul(torch.zeros(e + 1, 20, kb * 256), *planes,
                              rotate_weights=False, **kw)
        with pytest.raises(ValueError, match="xscale"):
            titq3.itq3_matvec_int8(xq[:, :4].contiguous(),
                                   xs[:, :2].contiguous(), *planes, **kw)
    # 64 experts' tiles fill the card unsplit; one matrix's need splits
    assert titq3.matmul_tiles(40, 1024, 8, 64)[1] == 1
    assert titq3.matmul_tiles(40, 1024, 8)[1] > 1
    for rule in (titq3.matvec_tiles, titq3.matvec_int8_tiles):
        assert rule(4, 1024, 8, 64) == titq3.MATVEC_EXPERT_CUT
        assert rule(4, 1024, 8) == (8, 8)  # one matrix: unchanged


def test_init_trees_match_reference():
    for arch in ARCHS:
        jcfg = jreduced(jget_config(arch))
        tcfg = tconfigs.reduced(tconfigs.get_config(arch))
        want = jax.tree.map(lambda a: a.shape, _jax_params(jcfg, None))
        for got in (tlm.init_params(tcfg, device="cpu"),
                    tlm.init_quantized_params(tcfg, _fp_policy(),
                                              device="cpu")):
            assert jax.tree.map(lambda a: tuple(a.shape), got) == want


def _fp_policy():
    from repro_torch.serve.quantized import QuantPolicy
    return QuantPolicy(())  # no rule: every leaf stays fp
