"""The ``model`` axis's compute split in training (``train/tp.py``), on
four gloo ranks on the CPU, against the port's single-process step
(itself held to the live reference by ``tests/test_torch_train.py``).

Four ranks are spawned once for the module (``torch.multiprocessing``, a
``file://`` store under the test's temporary directory, one intra-op
thread each) and run ``_torch_tp_train_worker.py``'s scenarios while the
test process runs the same steps in one process. At ``reduced()`` size,
8 x 16 tokens a step, from the seeded state:

* the four autograd collectives, ``swap`` and ``max_over`` on (data 1,
  model 4): each forward and the gradient each rank gets equal the plain
  function's on the whole inputs (f64, to rounding); the gather feeding
  replicated compute hands each rank its block of the gradient, not the
  ranks' sum;
* two steps of smollm-135m (4 heads, 1 KV head: the attention splits the
  key sequence, T = 16 over 4 and 2 ranks), qwen1.5-0.5b (4 KV heads: each
  rank its heads; the QKV bias and the tied vocab-parallel head) and
  olmoe-1b-7b (8 experts over the ranks, untied vocab-parallel head) on
  (1, 4) and (2, 2), held by ``test_torch_train_mesh.py``'s bounds and
  flip rule, unchanged: every rank's metrics bit-equal, loss, aux and
  gnorm within 1e-5 relative, gradients within 5e-5 of each leaf's
  largest, params under the flip rule;
* rwkv6-3b, a family that keeps the storage form, on (2, 2), held alike;
* on (1, 4) the step's gathered working set is each leaf's model slice,
  and no gather or swap inside the forward makes a model-split leaf
  whole, but for the one the design states: the key-split attention
  (smollm's) gathers wq, wk and wv whole, in one collective a layer.
"""
import os

import pytest
import torch

import _torch_tp_train_worker as W
from test_torch_train_mesh import _hold_run
from _torch_threads import one_torch_thread  # noqa: F401

WORLD = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the single-process results, each rank's results)."""
    tmp = str(tmp_path_factory.mktemp("train_tp"))
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
    return single, ranks


def _plain_collectives() -> dict:
    """Each case's forward and gradient on the whole inputs in one
    process, before the ranks take their blocks."""
    t = {k: torch.from_numpy(v) for k, v in W.collective_inputs().items()}
    x, w, c = t["X"], t["W"], t["C"]
    return {
        # y = X @ W, loss = sum(y * C): dL/dX = C @ W^T, dL/dW = X^T @ C
        "enter": (x @ w, c @ w.T),
        "leave": (x @ w, c @ w.T),
        "gather_replicated": (w, x.T @ c),
        "gather_split": (w, x.T @ c),
        "swap": (w, x.T @ c),
        "max_over": torch.amax(t["M"], dim=0),
    }


@pytest.mark.parametrize("case", ["enter", "leave", "gather_replicated",
                                  "gather_split", "swap"])
def test_collective_forward_and_gradient_equal_the_plain_function(runs,
                                                                   case):
    _, ranks = runs
    want_y, want_g = _plain_collectives()[case]
    for r, res in enumerate(ranks):
        y, g = res["collectives"][case]
        cols = slice(r * W.N // WORLD, (r + 1) * W.N // WORLD)
        ks = slice(r * W.K // WORLD, (r + 1) * W.K // WORLD)
        # the forward: each rank's block of the columns after enter, the
        # whole product after leave, the whole weight after either gather,
        # the weight's block of rows after swap
        wy = {"enter": want_y[:, cols], "swap": want_y[ks]}.get(case,
                                                                 want_y)
        # the gradient: the whole one for the replicated input of enter,
        # this rank's block of it for the others
        wg = {"enter": want_g, "leave": want_g[:, ks]}.get(case,
                                                           want_g[:, cols])
        assert torch.allclose(y, wy, rtol=1e-12, atol=1e-12), (case, r)
        assert torch.allclose(g, wg, rtol=1e-12, atol=1e-12), (case, r)
        if case == "gather_replicated":
            # a backward summed over the ranks would be WORLD times this
            assert not torch.allclose(g, WORLD * wg), r


def test_max_over_is_the_elementwise_max(runs):
    _, ranks = runs
    want = _plain_collectives()["max_over"]
    for res in ranks:
        assert torch.equal(res["collectives"]["max_over"], want)


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("mesh", list(W.MESHES))
def test_split_steps_equal_one_process(runs, mesh, arch):
    single, ranks = runs
    _hold_run(single[arch], ranks[0][(mesh, arch, "steps")],
              [r[(mesh, arch, "steps")] for r in ranks],
              f"{mesh} {arch} split")


@pytest.mark.parametrize("arch", W.STORAGE_ARCHS)
def test_storage_form_steps_equal_one_process(runs, arch):
    single, ranks = runs
    _hold_run(single[arch], ranks[0][("2x2", arch, "steps")],
              [r[("2x2", arch, "steps")] for r in ranks],
              f"2x2 {arch} storage form")


@pytest.mark.parametrize("arch", W.ARCHS)
def test_working_set_is_the_model_slice(runs, arch):
    _, ranks = runs
    for res in ranks:
        split = 0
        for path, got, whole, spec in res[("1x4", arch,
                                           "working_set")]["leaves"]:
            want = tuple(n // WORLD if ax == "model" else n
                         for n, ax in zip(whole, spec))
            assert got == want, (path, got, whole, spec)
            split += "model" in spec
        # the projections, the MLP or the experts, the table or the head
        assert split >= 6, split


@pytest.mark.parametrize("arch", W.ARCHS)
def test_no_gather_in_the_forward_makes_a_split_leaf_whole(runs, arch):
    _, ranks = runs
    cfg = W.TW.cfg_of(arch)
    res = ranks[1][("1x4", arch, "working_set")]
    held = [(path, whole) for path, _, whole, spec in res["leaves"]
            if "model" in spec]
    # a layer's leaf is gathered a layer at a time: its whole shape
    # without the stack's leading dim
    whole = {s for path, shape in held
             for s in ((shape, shape[1:]) if path.startswith("layers.")
                       else (shape,))}
    hd = cfg.resolved_head_dim
    qkv = (cfg.d_model, (cfg.num_heads + 2 * cfg.num_kv_heads) * hd)
    kinds = {kind for kind, _ in res["gathers"]}
    gathers = {shape for kind, shape in res["gathers"] if kind != "swap"}
    assert gathers  # the embedding's rows, at least
    assert not whole & gathers, whole & gathers
    if cfg.num_kv_heads % WORLD:  # kv_seq: wq, wk, wv whole, by design
        assert qkv in gathers
    else:
        assert qkv not in gathers
    # the tied head: this rank's rows of the table, never the whole table
    assert ("swap" in kinds) == cfg.tie_embeddings
    for kind, shape in res["gathers"]:
        if kind == "swap":
            assert shape == (cfg.vocab_size // WORLD, cfg.d_model), shape


def test_split_plan_names_the_attention_case():
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import loop, tp

    mesh = Mesh(shape={"data": 1, "model": 4}, rank=1, size=4,
                device=torch.device("cpu"))
    want = {"smollm-135m": ("kv_seq", True), "qwen1.5-0.5b": ("heads", True),
            "olmoe-1b-7b": ("heads", True)}
    for arch, (case, vocab) in want.items():
        cfg = W.TW.cfg_of(arch)
        split = tp.plan(cfg, mesh, loop.state_specs(
            cfg, make_rules(mesh, cfg)).params)
        assert (split.attention, split.vocab, split.coord) == (case, vocab,
                                                               1)
        assert split.has("mlp.up" if cfg.family == "dense" else "moe.up")
    for arch in ("rwkv6-3b", "zamba2-7b", "phi-3-vision-4.2b",
                 "seamless-m4t-medium"):
        cfg = W.TW.cfg_of(arch)
        assert tp.plan(cfg, mesh, loop.state_specs(
            cfg, make_rules(mesh, cfg)).params) is None, arch
    one = Mesh(shape={"data": 4, "model": 1}, rank=0, size=4,
               device=torch.device("cpu"))
    cfg = W.TW.cfg_of("smollm-135m")
    assert tp.plan(cfg, one, loop.state_specs(cfg, make_rules(
        one, cfg)).params) is None
