"""Training on a mesh of four gloo ranks, on the CPU, against the port's
single-process step (itself held to the live reference by
``tests/test_torch_train.py``) and the reference's checkpoints.

Four ranks are spawned once for the module (``torch.multiprocessing``, a
``file://`` store under the test's temporary directory, one intra-op
thread each) and run ``_torch_train_worker.py``'s scenarios on a
``(data 4, model 1)`` and a ``(data 2, model 2)`` mesh while the test
process runs them in one process. At ``reduced()`` size, smollm-135m and
olmoe-1b-7b from the seeded state, 8 x 16 tokens a step:

* 1 and 3 steps: every rank's metrics equal each other's bit for bit;
  loss, aux and gnorm within 1e-5 relative of one process's, lr equal;
  each step's gradients within 5e-5 of each leaf's largest element (the
  reductions are f32 sums in another order); then the params within 5e-5,
  an element parting further only at a gradient under 1e-4 of its leaf's
  largest at some step, at most 1e-3 of a leaf (AdamW's first steps move
  a param by about lr * sign(g)), each counted;
* olmoe's aux alone and its gradient (the router's above all) equal to
  one process's: the token means are taken over the global batch and the
  gradient counted once;
* two micro-batches on a mesh, held alike;
* ``compressed_pod_allreduce`` on a (pod 2, data 2) mesh: equal on every
  rank of both pods, and equal to ``tests/test_train.py``'s numpy model of
  the exchange step by step;
* a save from (2, 2): every file byte-equal to a single-process save of
  the gathered state, and restored by the reference's ``ckpt.restore``;
* the launcher under ``torchrun --nproc-per-node 4 --data 2 --model 2``:
  its logged metrics those of the single-process run; its checkpoint
  resumed elastically onto ``plan_remesh``'s (1, 2) mesh under torchrun
  and onto one process, both continuing with the uninterrupted run's
  metrics (printed digits: within one unit of the last).
"""
import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_train_worker as W
from repro.checkpoint import ckpt as jckpt
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.ft.monitor import plan_remesh as jplan_remesh
from repro.train import loop as jloop
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.ft.monitor import plan_remesh
from repro_torch.launch import train as ttrain
from repro_torch.train.tree import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
GRAD_TOL, REL_TOL, PARAM_TOL = 5e-5, 1e-5, 5e-5
NOISE_FLOOR, FLIP_SHARE = 1e-4, 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the single-process results, each rank's results, the directory)."""
    tmp = str(tmp_path_factory.mktemp("train_mesh"))
    ctx = torch.multiprocessing.start_processes(
        W.rank_main, args=(WORLD, f"file://{tmp}/store", tmp),
        nprocs=WORLD, join=False, start_method="spawn")
    try:
        single = W.single()
        while not ctx.join(timeout=600):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return single, ranks, tmp


def _leaves(tree):
    return [t.double().numpy() for t in tree_leaves(tree)]


def _hold_grads(want, got, what):
    for i, (a, b) in enumerate(zip(_leaves(want), _leaves(got))):
        assert a.shape == b.shape, (what, i)
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= GRAD_TOL * scale, (what, i)


def _hold_run(want, got, ranks, what):
    """Metrics, gradients, then params (the flip rule) of a run."""
    for s, (w, g) in enumerate(zip(want, got)):
        for r in ranks:  # every rank's metrics, bit for bit
            assert r[s]["metrics"] == g["metrics"], (what, s)
        wm, gm = w["metrics"], g["metrics"]
        for k in ("loss", "gnorm", "moe_aux"):
            assert abs(gm[k] - wm[k]) <= REL_TOL * max(abs(wm[k]), 1e-30), (
                what, s, k, gm[k], wm[k])
        assert gm["lr"] == wm["lr"]
        _hold_grads(w["grads"], g["grads"], f"{what} step {s}")
    grads = [[np.abs(a) for a in _leaves(w["grads"])] for w in want]
    flips = 0
    for i, (a, b) in enumerate(zip(_leaves(want[-1]["params"]),
                                   _leaves(got[-1]["params"]))):
        apart = np.abs(a - b) > PARAM_TOL
        if not apart.any():
            continue
        floor = np.zeros_like(apart)
        for g in grads:
            floor |= g[i] < NOISE_FLOOR * g[i].max()
        assert (floor | ~apart).all(), (what, i, "beyond the flip rule")
        assert apart.mean() <= FLIP_SHARE, (what, i, apart.mean())
        flips += int(apart.sum())
    print(f"{what}: {len(got)} step(s), {flips} param elements parted by "
          f"more than {PARAM_TOL} (each at a noise-floor gradient)")


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("mesh", list(W.MESHES))
def test_mesh_steps_equal_one_process(runs, mesh, arch, steps):
    single, ranks, _ = runs
    _hold_run(single[(arch, "steps")][:steps],
              ranks[0][(mesh, arch, "steps")][:steps],
              [r[(mesh, arch, "steps")][:steps] for r in ranks],
              f"{mesh} {arch}")


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("mesh", list(W.MESHES))
def test_micro_batches_on_a_mesh(runs, mesh, arch):
    single, ranks, _ = runs
    _hold_run(single[(arch, "micro")], ranks[0][(mesh, arch, "micro")],
              [r[(mesh, arch, "micro")] for r in ranks],
              f"{mesh} {arch} num_micro {W.MICRO}")


@pytest.mark.parametrize("mesh", list(W.MESHES))
def test_moe_aux_and_its_gradient_equal_one_process(runs, mesh):
    single, ranks, _ = runs
    want, wgrads = single["aux"]
    got, ggrads = ranks[0][(mesh, "aux")]
    assert all(r[(mesh, "aux")][0] == got for r in ranks)
    assert abs(got - want) <= 1e-6 * abs(want)
    _hold_grads(wgrads, ggrads, f"{mesh} aux")
    router = ggrads["layers"]["moe"]["router"]
    assert float(router.abs().max()) > 0  # the aux reaches the router
    # counted once: the mean of the ranks' local aux gradients would be
    # off by the batch ranks' count, far outside the tolerance above
    ratio = float(router.abs().max() / wgrads["layers"]["moe"]["router"]
                  .abs().max())
    assert abs(ratio - 1.0) < 1e-4


def _pod_model():
    """``tests/test_train.py``'s numpy model of the exchange, in f32, per
    step: (the mean, each pod's residuals, the scales)."""
    pods = [W.pod_grads(p) for p in range(W.POD_MESH["pod"])]
    errs = [{k: np.zeros_like(v) for k, v in g.items()} for g in pods]
    out = []
    for _ in range(W.POD_STEPS):
        mean, new, scales = {}, [{} for _ in pods], {}
        for k in pods[0]:
            xs = [g[k] + e[k] for g, e in zip(pods, errs)]
            amax = max(np.abs(x).max() for x in xs)
            scale = np.float32(max(amax, np.float32(1e-12))) / np.float32(127)
            qs = [np.clip(np.round(x / scale), -127, 127) for x in xs]
            for p, (x, q) in enumerate(zip(xs, qs)):
                new[p][k] = x - q * scale
            mean[k] = sum(qs) * scale / np.float32(len(pods))
            scales[k] = scale
        errs = new
        out.append((mean, errs, scales))
    return out


def test_compressed_pod_allreduce_on_a_pod_mesh(runs):
    _, ranks, _ = runs
    model = _pod_model()
    for r, res in enumerate(ranks):
        pod = r // (WORLD // W.POD_MESH["pod"])  # row-major: pod first
        for s, ((mean, errs, _), (red, err)) in enumerate(zip(model,
                                                              res["pod"])):
            for k in mean:
                assert red[k].shape == (1,) + mean[k].shape
                assert np.array_equal(red[k][0].numpy(), mean[k]), (r, s, k)
                assert np.array_equal(err[k][0].numpy(), errs[pod][k]), (
                    r, s, k)
    # error feedback: the time-averaged mean is within the last step's
    # scale of the true mean
    for k in model[0][0]:
        truth = np.mean([W.pod_grads(p)[k] for p in range(2)], axis=0)
        avg = np.mean([m[k] for m, _, _ in model], axis=0)
        assert np.abs(avg - truth).max() <= model[-1][2][k], k


def test_mesh_save_byte_equal_and_restored_by_the_reference(runs, tmp_path):
    _, ranks, tmp = runs
    mesh_dir = os.path.join(tmp, "save22", f"step_{W.SAVE_STEP:08d}")
    tckpt.save(str(tmp_path), W.SAVE_STEP, ranks[0]["save22_state"])
    one = tmp_path / f"step_{W.SAVE_STEP:08d}"
    names = sorted(os.listdir(mesh_dir))
    assert names == sorted(os.listdir(one)) and "_COMMITTED" in names
    for n in names:
        with open(os.path.join(mesh_dir, n), "rb") as a, open(one / n,
                                                              "rb") as b:
            assert a.read() == b.read(), n
    jcfg = jreduced(jget_config("smollm-135m"))
    template = jax.eval_shape(lambda k: jloop.init_train_state(k, jcfg),
                              jax.random.PRNGKey(0))
    back, step = jckpt.restore(os.path.join(tmp, "save22"), template)
    assert step == W.SAVE_STEP
    whole = ranks[0]["save22_state"]
    got = jax.tree.leaves(back)
    want = (tree_leaves(whole.params) + tree_leaves(whole.opt.mu)
            + tree_leaves(whole.opt.nu) + [whole.opt.step, whole.step])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_plan_remesh_gives_the_resume_mesh():
    plan = plan_remesh(2, model=2)
    assert (plan.data, plan.model, plan.pod) == (1, 2, 1)
    ref = jplan_remesh(2, model=2)
    assert (ref.data, ref.model, ref.pod) == (1, 2, 1)


# --- the launcher under torchrun ------------------------------------------

LAUNCH = ["--reduced", "--batch", "2", "--seq", "16", "--lr", "0.03",
          "--log-every", "1", "--device", "cpu"]
STEP_LINE = re.compile(r"^step +(\d+) loss (\S+) gnorm (\S+) lr (\S+)", re.M)


def _steps(out: str) -> dict:
    return {int(m.group(1)): tuple(float(x) for x in m.groups()[1:])
            for m in STEP_LINE.finditer(out)}


def _close(got: dict, want: dict) -> None:
    """Logged metrics within one unit of their last printed digit (loss
    4 decimals, gnorm 3, lr 2 significant)."""
    assert got and set(got) <= set(want), (got, want)
    for s, (loss, gnorm, lr) in got.items():
        wl, wg, wr = want[s]
        assert abs(loss - wl) <= 1e-4 and abs(gnorm - wg) <= 1e-3, (s, got,
                                                                    want)
        assert lr == wr


def _torchrun(nproc: int, argv: list, cwd) -> str:
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.train",
         *argv], capture_output=True, text=True, env=env, timeout=300,
        cwd=cwd)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_launcher_under_torchrun_and_elastic_resume(tmp_path, capsys):
    whole_dir, mesh_dir = tmp_path / "whole", tmp_path / "mesh"
    ttrain.main(LAUNCH + ["--steps", "4", "--ckpt-dir", str(whole_dir),
                          "--ckpt-every", "5"])
    whole = _steps(capsys.readouterr().out)
    assert sorted(whole) == [0, 1, 2, 3]
    out = _torchrun(WORLD, LAUNCH + ["--data", "2", "--model", "2",
                                     "--steps", "2", "--ckpt-dir",
                                     str(mesh_dir), "--ckpt-every", "1"],
                    tmp_path)
    assert "mesh={'data': 2, 'model': 2} devices=4" in out
    assert out.count("done.") == 1  # only rank 0 prints
    _close(_steps(out), whole)
    assert tckpt.latest_step(str(mesh_dir)) == 2
    # elastic: two hosts lost, TP kept
    plan = plan_remesh(2, model=2)
    shutil.copytree(mesh_dir, tmp_path / "one")
    out = _torchrun(plan.devices, LAUNCH + [
        "--data", str(plan.data), "--model", str(plan.model), "--steps", "4",
        "--ckpt-dir", str(mesh_dir), "--ckpt-every", "5"], tmp_path)
    assert "resumed from step 2 (elastic onto {'data': 1, 'model': 2})" in out
    _close(_steps(out), whole)
    assert sorted(_steps(out)) == [2, 3]
    ttrain.main(LAUNCH + ["--steps", "4", "--ckpt-dir", str(tmp_path / "one"),
                          "--ckpt-every", "5"])
    out = capsys.readouterr().out
    assert "resumed from step 2 (elastic onto {'data': 1, 'model': 1})" in out
    _close(_steps(out), whole)
    for d in (mesh_dir, tmp_path / "one"):
        a, b = d / "step_00000004", whole_dir / "step_00000004"
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for n in os.listdir(a):
            if n.endswith(".npy"):
                x, y = np.load(a / n), np.load(b / n)
                assert x.dtype == y.dtype and x.shape == y.shape, n
