"""The training half of the port's sharding rules and fault tolerance
against the live reference, in-process: no process group.

* ``param_pspecs`` (FSDP on) and ``batch_pspec`` leaf by leaf for the six
  families' ``reduced()`` params on ``FakeMesh``es of (data, model) =
  (2, 1), (4, 1), (2, 2), (4, 2) and (pod, data, model) = (2, 2, 2): the
  reference's trees are shapes only (``jax.eval_shape``), the port's its
  own CPU trees;
* ``Rules.constrain``'s spec against the ``PartitionSpec`` the reference's
  ``constrain`` builds (captured by standing in for ``NamedSharding`` and
  ``with_sharding_constraint``), over shapes that divide and do not, axes
  taken twice, and more dims than names;
* ``plan_remesh`` against the reference over a grid of survivors, TP
  degrees, preferred pods and minimum data, and mirrors of
  ``tests/test_ft.py``'s three remesh tests;
* ``compressed_pod_allreduce``'s per-pod arithmetic (``pod_quantize``) on
  two simulated pods against ``tests/test_train.py``'s numpy model, bit
  for bit, and its identity where the mesh has no pods;
* ``make_production_mesh``: the reference's shapes, and its refusal of
  another world size before joining any group;
* ``Placement`` on two-axis specs and on a ``("pod", "data")`` dim: each
  rank its block by its coordinates, the blocks the whole array;
  ``split_batch`` the rows of each micro-batch by the batch coordinate.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.sharding.rules as JR
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.ft.monitor import plan_remesh as jplan_remesh
from repro.launch import mesh as jmesh
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.ft.monitor import ElasticPlan, plan_remesh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as tlm
from repro_torch.sharding import rules as TR
from repro_torch.train import sharded
from repro_torch.train.grad import compressed_pod_allreduce, pod_quantize
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_tp_rules import _port_specs, _ref_specs

FAMILIES = ("smollm-135m", "olmoe-1b-7b", "rwkv6-3b", "zamba2-7b",
            "phi-3-vision-4.2b", "seamless-m4t-medium")
MESHES = ({"data": 2, "model": 1}, {"data": 4, "model": 1},
          {"data": 2, "model": 2}, {"data": 4, "model": 2},
          {"pod": 2, "data": 2, "model": 2})
MESH_IDS = ["x".join(map(str, m.values())) for m in MESHES]


class FakeMesh:
    """A mesh's shape and one rank's place in it (no process group)."""

    def __init__(self, shape: dict, rank: int = 0):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.device = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _trees(arch):
    jcfg = jreduced(jget_config(arch))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    jshapes = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    return jcfg, jshapes, tcfg, tlm.init_params(tcfg, seed=0, device="meta")


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_and_batch_pspecs_equal_reference(arch, shape):
    jcfg, jshapes, tcfg, tparams = _trees(arch)
    mesh = FakeMesh(shape)
    jrules, trules = JR.make_rules(mesh, jcfg), TR.make_rules(mesh, tcfg)
    want = _ref_specs(JR.param_pspecs(jshapes, jcfg, jrules))
    got = _port_specs(TR.param_pspecs(tparams, tcfg, trules))
    assert got == want
    assert TR.batch_pspec(trules) == tuple(JR.batch_pspec(jrules))
    # the FSDP axis really shards leaves
    assert any("data" in spec for spec in got.values())


CONSTRAIN = (
    ((8, 16, 64), ("batch", "seq", "embed")),
    ((8, 16, 64), ("batch", None, "heads")),
    ((6, 16, 64), ("batch", None, "ffn")),  # 6 rows: divides 2, not 4 or 8
    ((4, 8, 3, 32), ("experts", "batch", None, "ffn")),
    ((512, 64), ("vocab", "embed")),  # both over model: the second drops
    ((8, 32), ("heads", "kv_heads")),
    ((8, 16, 2, 32), ("batch",)),  # more dims than names
    ((0, 16), ("batch", "embed")),  # an empty dim never shards
    ((8, 16), ("batch", "seq_sp")),
    ((8, 16, 64), ("batch", "kv_seq", "kv_heads")),
)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_constrain_equals_reference(shape, monkeypatch):
    monkeypatch.setattr(JR, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    mesh = FakeMesh(shape)
    for arch in ("olmoe-1b-7b", "smollm-135m"):
        jrules = JR.make_rules(mesh, jget_config(arch))
        trules = TR.make_rules(mesh, tconfigs.get_config(arch))
        for dims, names in CONSTRAIN:
            want = jrules.constrain(np.zeros(dims, np.float32), names)
            assert trules.constrain(dims, names) == tuple(want), (
                arch, dims, names)


def _plan(p):
    return None if p is None else (p.data, p.model, p.pod, p.dropped_hosts,
                                   p.devices)


def test_plan_remesh_equals_reference_over_a_grid():
    for alive in range(0, 70):
        for model in (1, 2, 4, 8, 16):
            for pods in (1, 2, 3):
                for min_data in (1, 2, 3):
                    kw = dict(model=model, prefer_pods=pods,
                              min_data=min_data)
                    assert _plan(plan_remesh(alive, **kw)) == _plan(
                        jplan_remesh(alive, **kw)), (alive, kw)
    assert ElasticPlan(data=3, model=2, pod=2).devices == 12
    with pytest.raises(dataclasses.FrozenInstanceError):
        ElasticPlan(data=1, model=1).data = 2


def test_plan_remesh_preserves_tp():
    plan = plan_remesh(240, model=16)
    assert plan.model == 16 and plan.data == 15 and plan.devices == 240


def test_plan_remesh_multi_pod_shrink():
    plan = plan_remesh(srv := 512 - 256, model=16, prefer_pods=2)
    assert plan.pod * plan.data * plan.model <= srv
    assert plan.model == 16


def test_plan_remesh_infeasible():
    assert plan_remesh(8, model=16) is None


def test_pod_arithmetic_equals_the_numpy_model():
    """``tests/test_train.py``'s two pods of 64 over 8 steps: each pod's
    codes, residual and the mean, bit for bit with the model's f32 math;
    then its convergence check."""
    rng = np.random.default_rng(0)
    g_pods = [rng.normal(size=(64,)).astype(np.float32) for _ in range(2)]
    true_mean = np.mean(g_pods, axis=0)
    errs = [np.zeros(64, np.float32) for _ in range(2)]
    terrs = [torch.zeros(64) for _ in range(2)]
    acc = np.zeros(64, np.float64)
    for _ in range(8):
        xs = [g + e for g, e in zip(g_pods, errs)]
        amax = max(np.abs(x).max() for x in xs)
        scale = np.float32(max(amax, np.float32(1e-12))) / np.float32(127)
        qs = [np.clip(np.round(x / scale), -127, 127) for x in xs]
        errs = [x - q * scale for x, q in zip(xs, qs)]
        out = sum(qs) * scale / np.float32(2)
        acc += out
        # the port: each pod's side, the codes summed as int32
        txs = [torch.from_numpy(g) + e for g, e in zip(g_pods, terrs)]
        tamax = torch.maximum(*(x.abs().max() for x in txs))
        parts = [pod_quantize(x, tamax) for x in txs]
        terrs = [p[2] for p in parts]
        tot = parts[0][0] + parts[1][0]
        assert tot.dtype == torch.int32
        tout = tot.to(torch.float32) * parts[0][1] / 2
        assert float(parts[0][1]) == float(scale)
        for q, (tq, _, _) in zip(qs, parts):
            assert np.array_equal(tq.numpy(), q.astype(np.int32))
        for e, te in zip(errs, terrs):
            assert np.array_equal(te.numpy(), e)
        assert np.array_equal(tout.numpy(), out)
    np.testing.assert_allclose(acc / 8, true_mean, atol=scale)


def test_compressed_pod_allreduce_is_the_identity_without_pods():
    g = {"w": torch.ones(1, 4)}
    e = {"w": torch.zeros(1, 4)}
    for shape in ({"data": 2, "model": 1}, {"pod": 1, "data": 2,
                                            "model": 1}):
        out = compressed_pod_allreduce(g, e, FakeMesh(shape))
        assert out[0] is g and out[1] is e


def test_production_mesh_shapes_and_refusal(monkeypatch):
    for multi_pod in (False, True):
        shape = tmesh.production_shape(multi_pod)
        want = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else (
            (16, 16), ("data", "model"))
        assert (tuple(shape.values()), tuple(shape)) == want
        monkeypatch.setenv("WORLD_SIZE", "4")
        with pytest.raises(ValueError, match="takes 256|takes 512"):
            tmesh.make_production_mesh(multi_pod=multi_pod)
        assert not dist.is_initialized()
    # the reference's own function builds the same shapes (its source)
    import inspect
    src = inspect.getsource(jmesh.make_production_mesh)
    assert "(2, 16, 16)" in src and "(16, 16)" in src


def test_placement_on_two_axes_and_a_batch_tuple():
    arr = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    shape = {"data": 2, "model": 2}
    blocks = {}
    for r in range(4):
        mesh = FakeMesh(shape, r)
        assert tmesh.coords_of(shape, r) == {"data": r // 2, "model": r % 2}
        blocks[r] = tmesh.Placement(("data", "model"), mesh)(arr)
        assert blocks[r].shape == (4, 3)
    rows = [torch.cat([blocks[2 * d], blocks[2 * d + 1]], 1) for d in (0, 1)]
    assert np.array_equal(torch.cat(rows).numpy(), arr)
    # ("pod", "data") on one dim: the coordinate pod * data + data
    shape = {"pod": 2, "data": 2, "model": 2}
    parts = {}
    for r in range(8):
        mesh = FakeMesh(shape, r)
        c = tmesh.coords_of(shape, r)
        assert tmesh.axis_index(mesh, ("pod", "data")) == (
            2 * c["pod"] + c["data"], 4)
        part = tmesh.Placement((("pod", "data"), "model"), mesh)(arr)
        parts[(2 * c["pod"] + c["data"], c["model"])] = part
        assert part.shape == (2, 3)
    whole = torch.cat([torch.cat([parts[(i, 0)], parts[(i, 1)]], 1)
                       for i in range(4)])
    assert np.array_equal(whole.numpy(), arr)
    # a mesh of one: gather needs no collective
    one = tmesh.local_mesh("cpu")
    t = torch.ones(3, 2)
    assert tmesh.Placement(("data", "model"), one).gather(t) is t


@pytest.mark.parametrize("num_micro", [1, 2])
def test_split_batch_takes_each_micro_batch_rows(num_micro):
    cfg = tconfigs.reduced(tconfigs.get_config("smollm-135m"))
    tokens = np.arange(8 * 3).reshape(8, 3)
    for shape in ({"data": 2, "model": 2}, {"pod": 2, "data": 2,
                                            "model": 1}):
        rules = TR.make_rules(FakeMesh(shape), cfg)
        ways = 4 if "pod" in shape else 2
        got = {}
        for r in range(4):
            mesh = FakeMesh(shape, r)
            coord, n = tmesh.axis_index(mesh, rules.assignments["batch"])
            assert n == ways
            got.setdefault(coord, sharded.split_batch(
                {"tokens": tokens}, mesh, rules, num_micro)["tokens"])
        per = 8 // num_micro
        for i in range(num_micro):  # each global micro-batch, in order
            rows = np.concatenate([got[c].reshape(num_micro, -1, 3)[i]
                                   for c in range(ways)])
            assert np.array_equal(rows, tokens[i * per:(i + 1) * per])
