"""The port's checkpoints for training and its two launchers, against the
live reference on the CPU.

* ``save_async`` / ``wait_pending`` / ``latest_step`` / gc / template
  ``restore`` (mirrors of ``tests/test_checkpoint.py``, plus a saved
  QTensor rebuilt into an fp template).
* A ``TrainState`` checkpoint byte-equal to the reference's, both ways:
  every file, ``meta.json`` included (leaves in dataclass field order:
  params, the moments, ``opt__step``, ``step``).
* The train launcher, in process with ``--device cpu`` at ``--reduced``,
  resuming from a checkpoint the reference launcher wrote: its logged
  metrics equal the reference launcher's resumed from the same checkpoint
  (as printed) and its final params within 1e-5 (f32 sums in two orders).
  The reference launcher builds its one-device mesh with ``jax.make_mesh``,
  whose axes are Explicit under the installed jax and which its sharding
  constraints refuse; the test hands it an Auto-axis mesh of the same
  shape. Its first run ends on a step ``--ckpt-every`` does not divide:
  where they coincide its async and final saves write one directory at
  once (the port joins the async write first).
* A run interrupted and resumed equal to an uninterrupted one, bit for bit.
* A lone process clamps ``--data``/``--model`` as the reference clamps
  them to its devices; ``build_trainer`` on a wider mesh takes the
  reference's FSDP specs, and a batch that does not divide the batch
  ranks raises; neither launcher falls back to the CPU without
  ``--device cpu``.
* ``serve --ckpt-dir`` on that checkpoint: the same ``rid=... ->`` ids as
  the reference's ``--ckpt-dir`` (2 requests x 4 tokens).
* The serve flags the port lacked: ``--backend ref|cuda`` reaching
  ``Runtime.backend``, ``--tp-shard-map`` accepted, ``--backend pallas``
  refused.
"""
import filecmp
import json
import os
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.data.pipeline import SyntheticCorpus
from repro.models.layers import Runtime as JRuntime
from repro.train import loop as jloop
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.core import formats
from repro_torch.core.quantize import QTensor
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.train import loop as tloop
from repro_torch.train import optim as toptim
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import to_numpy_tree


def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nest": {"b": torch.ones(4, dtype=torch.int32)},
            "state": {"step": torch.tensor(7, dtype=torch.int32)}}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


# --- save_async, wait_pending, gc, template restore -----------------------

def test_roundtrip(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 3, tree())
    restored, step = ckpt.restore(d, tree())
    assert step == 3 and _equal(restored, tree())


def test_async_and_latest(tmp_path):
    d = str(tmp_path)
    th = ckpt.save_async(d, 1, tree())
    ckpt.wait_pending()
    assert not th.is_alive()
    ckpt.save(d, 5, tree())
    assert ckpt.latest_step(d) == 5
    assert _equal(ckpt.restore(d, tree(), step=1)[0], tree())


def test_async_snapshot_is_taken_at_the_call(tmp_path):
    """The write sees the tree as it was when save_async returned."""
    d = str(tmp_path)
    t = tree()
    ckpt.save_async(d, 1, t)
    t["a"].add_(100.0)
    ckpt.wait_pending()
    assert _equal(ckpt.restore(d, tree())[0], tree())


def test_gc_keeps_last(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        ckpt.save_async(d, s, tree(), keep=2)
        ckpt.wait_pending()
    steps = sorted(int(n[5:]) for n in os.listdir(d) if n.startswith("step_"))
    assert steps == [4, 5]


def test_uncommitted_ignored(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 2, tree())
    os.makedirs(os.path.join(d, "step_00000009"))  # a torn save
    assert ckpt.latest_step(d) == 2
    assert ckpt.restore(d, tree())[1] == 2


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), tree())


def test_dtype_cast_on_restore(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"w": torch.ones(2)})
    restored, _ = ckpt.restore(d, {"w": torch.zeros(2, dtype=torch.float16)})
    assert restored["w"].dtype == torch.float16


def test_qtensor_restored_into_fp_template(tmp_path):
    d = str(tmp_path)
    w = torch.randn(256, 64, generator=torch.Generator().manual_seed(0))
    q = {"w": formats.get_format("itq3_s").quantize(w), "b": torch.ones(3)}
    ckpt.save(d, 1, q)
    restored, _ = ckpt.restore(d, {"w": torch.zeros(256, 64),
                                   "b": torch.zeros(3)})
    assert isinstance(restored["w"], QTensor)
    assert restored["w"].meta == q["w"].meta
    assert all(torch.equal(restored["w"].data[k], v)
               for k, v in q["w"].data.items())


# --- TrainState checkpoints against the reference's -----------------------

def _files_equal(a: str, b: str) -> None:
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n


@pytest.fixture(scope="module")
def states():
    """The reference's TrainState of reduced olmoe-1b-7b after one step,
    and the port's copy of it."""
    cfg = jreduced(jget_config("olmoe-1b-7b"))
    js = jloop.init_train_state(jax.random.PRNGKey(0), cfg)
    step = jax.jit(jloop.make_train_step(
        cfg, JRuntime(compute_dtype=jnp.float32), warmup=1))
    b = SyntheticCorpus(cfg.vocab_size, seed=0).batch(0, 2, 8)
    js, _ = step(js, {k: jnp.asarray(v) for k, v in b.items()})
    port = params_from_numpy(to_numpy_tree(
        {"params": js.params, "mu": js.opt.mu, "nu": js.opt.nu}),
        device="cpu")
    ts = tloop.TrainState(port["params"], toptim.OptState(
        port["mu"], port["nu"], torch.tensor(int(js.opt.step),
                                             dtype=torch.int32)),
        torch.tensor(int(js.step), dtype=torch.int32))
    return js, ts


@pytest.mark.parametrize("writer", ["save", "save_async"])
def test_train_state_files_byte_equal_to_reference(states, writer, tmp_path):
    js, ts = states
    jckpt.save(str(tmp_path / "ref"), 1, js)
    getattr(ckpt, writer)(str(tmp_path / "port"), 1, ts)
    ckpt.wait_pending()
    _files_equal(str(tmp_path / "ref" / "step_00000001"),
                 str(tmp_path / "port" / "step_00000001"))
    with open(tmp_path / "port" / "step_00000001" / "meta.json") as f:
        leaves = list(json.load(f)["leaves"])
    assert leaves[-2:] == ["opt__step", "step"]
    assert leaves[0].startswith("params__")


def test_train_state_restored_both_ways(states, tmp_path):
    """The port restores the reference's checkpoint into its own template
    and writes it back byte-equal; the reference restores the port's."""
    js, ts = states
    tcfg = reduced(get_config("olmoe-1b-7b"))
    jckpt.save(str(tmp_path / "ref"), 1, js)
    got, step = ckpt.restore(str(tmp_path / "ref"),
                             tloop.init_train_state(tcfg, device="cpu"))
    assert step == 1 and isinstance(got, tloop.TrainState)
    assert got.step.dtype == got.opt.step.dtype == torch.int32
    ckpt.save(str(tmp_path / "again"), 1, got)
    _files_equal(str(tmp_path / "ref" / "step_00000001"),
                 str(tmp_path / "again" / "step_00000001"))
    ckpt.save(str(tmp_path / "port"), 1, ts)
    back, _ = jckpt.restore(str(tmp_path / "port"), js)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# --- the train launcher ---------------------------------------------------

LAUNCH = ["--reduced", "--batch", "2", "--seq", "16", "--lr", "0.03",
          "--log-every", "1"]
STEP_LINE = re.compile(r"^step +(\d+) loss (\S+) gnorm (\S+) lr (\S+)", re.M)


def _ref_train(argv, monkeypatch):
    import repro.launch.train as jtrain
    monkeypatch.setattr(jtrain, "make_host_mesh", lambda d, m: jax.make_mesh(
        (d, m), ("data", "model"), axis_types=(AxisType.Auto,) * 2))
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain.main()


def _metrics(out: str) -> list:
    return [m.groups()[1:] for m in STEP_LINE.finditer(out)]


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """A checkpoint at step 2 written by the reference launcher."""
    d = tmp_path_factory.mktemp("ref_launch")
    with pytest.MonkeyPatch.context() as mp:
        _ref_train(LAUNCH + ["--steps", "2", "--ckpt-every", "5",
                             "--ckpt-dir", str(d)], mp)
    assert ckpt.latest_step(str(d)) == 2
    return d


def test_port_launcher_resumes_reference_checkpoint(ref_ckpt, tmp_path,
                                                    capsys, monkeypatch):
    shutil.copytree(ref_ckpt, tmp_path / "port")
    shutil.copytree(ref_ckpt, tmp_path / "ref")
    capsys.readouterr()
    ttrain.main(LAUNCH + ["--steps", "4", "--device", "cpu", "--ckpt-dir",
                          str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    _ref_train(LAUNCH + ["--steps", "4", "--ckpt-dir", str(tmp_path / "ref")],
               monkeypatch)
    ref_out = capsys.readouterr().out
    assert "resumed from step 2" in port_out
    assert _metrics(port_out) == _metrics(ref_out)
    assert [int(m.group(1)) for m in STEP_LINE.finditer(port_out)] == [2, 3]
    a, b = (tmp_path / w / "step_00000004" for w in ("port", "ref"))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for n in os.listdir(a):
        if n.endswith(".npy"):
            x, y = np.load(a / n), np.load(b / n)
            assert x.dtype == y.dtype and x.shape == y.shape, n
            if n.startswith("params__"):
                assert float(np.abs(x - y).max()) <= 1e-5, n


def test_interrupted_run_equals_uninterrupted(tmp_path, capsys):
    argv = LAUNCH + ["--device", "cpu", "--ckpt-every", "2"]
    ttrain.main(argv + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    whole = capsys.readouterr().out
    ttrain.main(argv + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    first = capsys.readouterr().out
    ttrain.main(argv + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    rest = capsys.readouterr().out
    assert _metrics(first) + _metrics(rest) == _metrics(whole)
    _files_equal(str(tmp_path / "a" / "step_00000004"),
                 str(tmp_path / "b" / "step_00000004"))


@pytest.mark.parametrize("flag", ["--data", "--model"])
def test_lone_process_clamps_the_mesh_as_the_reference(flag, capsys):
    """One process has one device: ``--data 2`` / ``--model 2`` clamp to
    (1, 1), as the reference's ``make_host_mesh`` clamps them to the
    devices there are (one CPU device here)."""
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    ttrain.main(["--reduced", "--device", "cpu", flag, "2", "--steps", "1",
                 "--batch", "2", "--seq", "8"])
    out = capsys.readouterr().out
    want = dict(jmake_host_mesh(*((2, 1) if flag == "--data" else (1, 2)))
                .shape)
    assert f"mesh={want} devices=1 (cpu)" in out and "done." in out


def _wide_mesh(shape):
    from repro_torch.launch.mesh import Mesh
    return Mesh(shape=shape, rank=0, size=int(np.prod(list(shape.values()))),
                device=torch.device("cpu"), axis_names=tuple(shape))


def test_build_trainer_on_a_wider_mesh_takes_the_reference_specs():
    """``build_trainer`` on a (2, 1) mesh: the state's specs are the
    reference's ``param_pspecs`` with FSDP over data, the step counters
    replicated, the batch over data (built without joining a group)."""
    from repro.sharding import rules as JR
    from test_torch_tp_rules import _port_specs, _ref_specs
    mesh = _wide_mesh({"data": 2, "model": 1})
    cfg = reduced(get_config("smollm-135m"))
    _, specs, rules = ttrain.build_trainer(cfg, mesh)
    jcfg = jreduced(jget_config("smollm-135m"))
    jrules = JR.make_rules(mesh, jcfg)
    want = _ref_specs(JR.param_pspecs(jax.eval_shape(
        lambda k: jloop.init_train_state(k, jcfg).params,
        jax.random.PRNGKey(0)), jcfg, jrules))
    for tree in (specs.params, specs.opt.mu, specs.opt.nu):
        assert _port_specs(tree) == want
    assert specs.step == specs.opt.step == ()
    assert any("data" in s for s in want.values())
    assert rules.assignments == jrules.assignments


@pytest.mark.parametrize("shape,rows", [({"data": 2, "model": 1}, 3),
                                        ({"pod": 2, "data": 2, "model": 1},
                                         6)], ids=["data2-3rows",
                                                   "pod2data2-6rows"])
def test_batch_not_dividing_the_batch_ranks_raises(shape, rows):
    """A batch whose rows do not divide pod * data raises before any
    collective, as jit's in_shardings refuses it."""
    cfg = reduced(get_config("smollm-135m"))
    mesh = _wide_mesh(shape)
    step, specs, _ = ttrain.build_trainer(cfg, mesh)
    state = tloop.init_train_state(cfg, device="cpu", mesh=mesh, specs=specs)
    batch = SyntheticCorpus(cfg.vocab_size, seed=0).batch(0, rows, 8)
    with pytest.raises(ValueError, match="does not split over"):
        step(state, batch)


@pytest.mark.parametrize("launcher", [ttrain, tserve],
                         ids=["train", "serve"])
def test_launchers_do_not_fall_back_to_the_cpu(launcher, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        launcher.main(["--reduced"])


# --- the serve launcher ---------------------------------------------------

SERVE = ["--reduced", "--kv-quant", "--requests", "2", "--max-new", "4"]
RID_LINE = re.compile(r"rid=\d+ -> \[[^\]]*\]")


def test_serve_ckpt_dir_ids_equal_reference(ref_ckpt, capsys, monkeypatch):
    tserve.main(SERVE + ["--device", "cpu", "--ckpt-dir", str(ref_ckpt)])
    port = capsys.readouterr().out
    import repro.launch.serve as jserve
    monkeypatch.setattr(sys, "argv", ["serve"] + SERVE + [
        "--ckpt-dir", str(ref_ckpt)])
    jserve.main()
    ref = capsys.readouterr().out
    assert "restored step-2 weights" in port
    assert RID_LINE.findall(port) == RID_LINE.findall(ref)
    assert len(RID_LINE.findall(port)) == 2


def _engines(monkeypatch) -> list:
    seen = []

    class Spy(tserve.ServeEngine):
        def __init__(self, *a, **kw):
            seen.append(kw["rt"])
            super().__init__(*a, **kw)
    monkeypatch.setattr(tserve, "ServeEngine", Spy)
    return seen


def test_serve_backend_ref_and_tp_shard_map(monkeypatch, capsys):
    seen = _engines(monkeypatch)
    tserve.main(SERVE + ["--device", "cpu", "--backend", "ref",
                         "--tp-shard-map"])
    assert [rt.backend for rt in seen] == ["ref"]
    assert len(RID_LINE.findall(capsys.readouterr().out)) == 2


def test_serve_backend_cuda_reaches_the_runtime(monkeypatch):
    """``--backend cuda`` takes the kernels only, so CPU tensors raise
    where the first quantized product runs."""
    seen = _engines(monkeypatch)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tserve.main(SERVE + ["--device", "cpu", "--backend", "cuda"])
    assert [rt.backend for rt in seen] == ["cuda"]


def test_serve_backend_pallas_refused(capsys):
    with pytest.raises(SystemExit):
        tserve.main(SERVE + ["--device", "cpu", "--backend", "pallas"])
    assert "invalid choice: 'pallas'" in capsys.readouterr().err
