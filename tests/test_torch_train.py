"""The port's training half against the live reference, on the CPU.

At ``reduced()`` sizes, from the reference's own weights carried across
bit for bit (``bridge.params_from_numpy``):

* the synthetic corpus: every batch equal to the reference's bit for bit
  (numpy draws in the same order), and mirrors of ``tests/test_data.py``;
* ``cosine_lr`` within one f32 ulp, ``softmax_xent`` within 1e-6, and
  ``adamw_update`` on identical gradients (params, moments and the norm
  within 1e-6 relative, clipped and not);
* ``forward_xent`` of the six families (dense, MoE, RWKV6, the hybrid,
  a vlm with patch features, the audio model with frames): the loss within
  1e-5, the MoE aux within 1e-6 and every gradient leaf within 5e-5 of
  that leaf's largest reference element (f32 sums in XLA's and PyTorch's
  orders: measured at most 8.4e-6);
* one and three ``make_train_step`` steps of smollm-135m and olmoe-1b-7b:
  each step's gradients held first (5e-5 of each leaf's largest), then the
  metrics (loss and aux 1e-5, gnorm 1e-5 relative, lr within an ulp) and
  the params within 5e-5. AdamW's first steps move a param by about
  ``lr * sign(g)``, so a gradient element at the f32 noise floor of its
  sum can flip sign between the two packages and move its param by up to
  ``2 lr``: an element outside 5e-5 passes only where its reference
  gradient at some step is under 1e-4 of its leaf's largest, at most 1e-3
  of a leaf's elements, each counted and printed;
* mirrors of ``tests/test_train.py``'s single-device tests;
* remat ``"dots"`` and ``"none"`` against no remat: loss and every
  gradient bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.models import lm as jlm
from repro.models.layers import Runtime as JRuntime
from repro.train import loop as jloop
from repro.train import optim as joptim
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.models import lm as tlm
from repro_torch.models.layers import Runtime
from repro_torch.train import loop as tloop
from repro_torch.train import optim as toptim
from repro_torch.train.grad import value_and_grad
from repro_torch.train.tree import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bridge import to_numpy_tree

# qwen1.5-0.5b: the QKV biases and the tied head
FAMILIES = ("smollm-135m", "qwen1.5-0.5b", "olmoe-1b-7b", "rwkv6-3b",
            "zamba2-7b", "phi-3-vision-4.2b", "seamless-m4t-medium")
GRAD_TOL = 5e-5  # of each leaf's largest reference element
LOSS_TOL = 1e-5
PARAM_TOL = 5e-5
NOISE_FLOOR = 1e-4  # |g| under this share of the leaf's largest may flip
FLIP_SHARE = 1e-3
B, T = 2, 16


def _cfgs(arch):
    return jreduced(jget_config(arch)), reduced(get_config(arch))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jcfg, _ = _cfgs(arch)
    return jax.jit(jlm.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      jcfg)


def _port(tree):
    return params_from_numpy(to_numpy_tree(tree), device="cpu")


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _t_leaves(tree):
    return [x.detach().numpy() for x in tree_leaves(tree)]


def _hold_grads(jgrads, tgrads, what):
    jl, tl = _np_leaves(jgrads), _t_leaves(tgrads)
    assert len(jl) == len(tl), what
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert a.shape == b.shape, (what, i)
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(a - b).max()) / scale
        assert err <= GRAD_TOL, (what, i, err)


# --- the corpus -----------------------------------------------------------

def test_deterministic_replay():
    c1 = SyntheticCorpus(512, seed=7)
    c2 = SyntheticCorpus(512, seed=7)
    b1 = c1.batch(42, 4, 32, shard=1, num_shards=4)
    b2 = c2.batch(42, 4, 32, shard=1, num_shards=4)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    assert np.array_equal(b1["labels"], b2["labels"])


def test_labels_are_shifted_tokens():
    b = SyntheticCorpus(512, seed=0).batch(0, 2, 16)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_shards_differ():
    c = SyntheticCorpus(512, seed=0)
    a = c.batch(5, 4, 32, shard=0, num_shards=4)["tokens"]
    b = c.batch(5, 4, 32, shard=1, num_shards=4)["tokens"]
    assert not np.array_equal(a, b)


def test_steps_differ():
    c = SyntheticCorpus(512, seed=0)
    assert not np.array_equal(c.batch(1, 2, 16)["tokens"],
                              c.batch(2, 2, 16)["tokens"])


def test_bigram_structure_learnable():
    c = SyntheticCorpus(128, seed=9, branching=4, reset_prob=0.05)
    b = c.batch(0, 8, 256)
    toks = np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1)
    hits = sum(row[i + 1] in c._table[row[i]]
               for row in toks for i in range(len(row) - 1))
    assert hits / (toks.shape[0] * (toks.shape[1] - 1)) > 0.85


def test_eval_stream_disjoint_from_train():
    c = SyntheticCorpus(512, seed=0)
    train = c.batch(0, 2, 16)["tokens"]
    ev = next(iter(c.eval_batches(1, 2, 16)))["tokens"]
    assert not np.array_equal(train, ev)


@pytest.mark.parametrize("vocab,seed,step,shard,shards", [
    (512, 0, 0, 0, 1), (512, 7, 42, 1, 4), (49152, 17, 3, 0, 1),
    (128, 9, 10_000_000, 0, 1)])
def test_batches_equal_reference(vocab, seed, step, shard, shards):
    got = SyntheticCorpus(vocab, seed=seed).batch(step, 3, 40, shard=shard,
                                                  num_shards=shards)
    want = JCorpus(vocab, seed=seed).batch(step, 3, 40, shard=shard,
                                           num_shards=shards)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        assert np.array_equal(got[k], want[k]), k


def test_eval_batches_equal_reference():
    got = list(SyntheticCorpus(512, seed=3).eval_batches(2, 2, 24))
    want = list(JCorpus(512, seed=3).eval_batches(2, 2, 24))
    for g, w in zip(got, want):
        assert np.array_equal(g["tokens"], w["tokens"])


# --- the schedule, the loss and the optimizer -----------------------------

@pytest.mark.parametrize("step", [0, 3, 10, 11, 55, 100, 140])
def test_cosine_lr_equals_reference(step):
    kw = dict(peak=3e-3, warmup=10, total=100)
    want = np.float32(joptim.cosine_lr(jnp.int32(step), **kw))
    got = toptim.cosine_lr(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= float(np.spacing(want))


def test_softmax_xent_equals_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 64)) * 4).astype(np.float32)
    labels = rng.integers(0, 64, (3, 7)).astype(np.int32)
    want = float(jloop.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tloop.softmax_xent(torch.from_numpy(logits),
                                   torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("grad_scale", [0.1, 100.0], ids=["unclipped",
                                                          "clipped"])
def test_adamw_update_equals_reference(grad_scale):
    """Three updates on the same gradients from the same state: params,
    moments, step and the pre-clip norm."""
    rng = np.random.default_rng(1)
    shapes = {"a": (8, 16), "b": {"c": (32,), "d": (4, 4, 3)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    jp, tp = jax.tree.map(jnp.asarray, params), _port(params)
    jst, tst = joptim.adamw_init(jp), toptim.adamw_init(tp)
    for i in range(3):
        g = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * grad_scale
                                    ).astype(np.float32), params)
        lr = 1e-2 * (i + 1)
        jp, jst, jn = joptim.adamw_update(jax.tree.map(jnp.asarray, g), jst,
                                          jp, jnp.float32(lr))
        tp, tst, tn = toptim.adamw_update(_port(g), tst, tp,
                                          torch.tensor(lr))
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        assert int(tst.step) == int(jst.step) == i + 1
        assert tst.step.dtype == torch.int32
        for want, got in ((jp, tp), (jst.mu, tst.mu), (jst.nu, tst.nu)):
            for a, b in zip(_np_leaves(want), _t_leaves(got)):
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)


def test_adamw_leaves_its_arguments_unchanged():
    p = {"w": torch.ones(4)}
    st = toptim.adamw_init(p)
    before = (p["w"].clone(), st.mu["w"].clone(), st.step.clone())
    toptim.adamw_update({"w": torch.full((4,), 0.5)}, st, p, 0.1)
    assert torch.equal(p["w"], before[0]) and torch.equal(st.mu["w"],
                                                          before[1])
    assert torch.equal(st.step, before[2])


# mirrors of tests/test_train.py

def test_adamw_vs_reference():
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}
    grads = {"w": torch.tensor([0.1, 0.2, -0.3])}
    st = toptim.adamw_init(params)
    new_p, _, gnorm = toptim.adamw_update(grads, st, params, lr=1e-2,
                                          weight_decay=0.0, grad_clip=1e9)
    g = np.asarray([0.1, 0.2, -0.3])
    want = np.asarray([1.0, -2.0, 3.0]) - 1e-2 * g / (np.abs(g) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), want, atol=1e-5)
    assert abs(float(gnorm) - np.linalg.norm(g)) < 1e-6


def test_grad_clip():
    params = {"w": torch.ones(4)}
    grads = {"w": torch.full((4,), 100.0)}
    _, _, gnorm = toptim.adamw_update(grads, toptim.adamw_init(params),
                                      params, lr=0.0, grad_clip=1.0)
    assert float(gnorm) == 200.0  # reported before the clip


def test_cosine_lr():
    def lr(s):
        return float(toptim.cosine_lr(torch.tensor(s, dtype=torch.int32),
                                      peak=1.0, warmup=10, total=100))
    assert lr(0) == 0.0 and abs(lr(10) - 1.0) < 0.01 and lr(100) <= 0.11


def test_loss_decreases():
    cfg = reduced(get_config("smollm-135m"))
    step = tloop.make_train_step(cfg, Runtime(), warmup=5, total_steps=120,
                                 lr_peak=3e-3)
    state = tloop.init_train_state(cfg, device="cpu")
    corpus = SyntheticCorpus(cfg.vocab_size, seed=3)
    losses = []
    for s in range(120):
        state, m = step(state, corpus.batch(s, 16, 64))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.5, (
        losses[:3], losses[-3:])


def test_grad_accumulation_equivalence():
    cfg = reduced(get_config("qwen1.5-0.5b"))
    s1 = tloop.make_train_step(cfg, Runtime(), num_micro=1, total_steps=10)
    s4 = tloop.make_train_step(cfg, Runtime(), num_micro=4, total_steps=10)
    state = tloop.init_train_state(cfg, device="cpu")
    batch = SyntheticCorpus(cfg.vocab_size, seed=1).batch(0, 8, 32)
    st1, m1 = s1(state, batch)
    st4, m4 = s4(state, batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    d = [float((a - b).abs().max()) for a, b in zip(tree_leaves(st1.params),
                                                    tree_leaves(st4.params))]
    assert max(d) < 1e-4


# --- forward_xent of the six families -------------------------------------

def _xent_inputs(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    labels[0, -3:] = -1  # masked positions
    feats = None
    if jcfg.frontend:
        feats = rng.standard_normal(
            (B, jcfg.frontend_len, jcfg.frontend_dim)).astype(np.float32)
    return toks, labels, feats


@functools.lru_cache(maxsize=None)
def _jax_xent(arch):
    """The reference's loss, aux and gradients of forward_xent + 0.01 aux
    (the train step's loss)."""
    jcfg, _ = _cfgs(arch)
    toks, labels, feats = _xent_inputs(jcfg)
    rt = JRuntime(compute_dtype=jnp.float32)

    def loss(p):
        xent, aux = jlm.forward_xent(p, toks, labels, rt, jcfg,
                                     frontend_feats=feats)
        return xent + 0.01 * aux, (xent, aux)
    (_, (xent, aux)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(_jax_params(arch))
    return float(xent), float(aux), grads


def _port_xent(arch, rt=None):
    jcfg, tcfg = _cfgs(arch)
    toks, labels, feats = _xent_inputs(jcfg)
    rt = Runtime() if rt is None else rt

    def loss(p, _):
        xent, aux = tlm.forward_xent(p, toks, labels, rt, tcfg,
                                     frontend_feats=feats)
        return xent + 0.01 * aux, torch.stack([xent, aux])
    (_, parts), grads = value_and_grad(loss, _port(_jax_params(arch)), None)
    return float(parts[0]), float(parts[1]), grads


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_xent_loss_aux_and_grads_equal_reference(arch):
    jxent, jaux, jgrads = _jax_xent(arch)
    txent, taux, tgrads = _port_xent(arch)
    assert abs(txent - jxent) <= LOSS_TOL
    assert abs(taux - jaux) <= 1e-6
    if arch == "olmoe-1b-7b":
        assert jaux > 0  # the MoE aux reaches the loss
    _hold_grads(jgrads, tgrads, arch)


def test_forward_xent_masks_labels_and_chunks():
    """Labels < 0 count 0 and the mean divides by B*T; chunking the head
    changes nothing but the summation order."""
    _, tcfg = _cfgs("smollm-135m")
    p = _port(_jax_params("smollm-135m"))
    toks, labels, _ = _xent_inputs(_cfgs("smollm-135m")[0])
    whole, _ = tlm.forward_xent(p, toks, labels, Runtime(), tcfg)
    chunked, _ = tlm.forward_xent(p, toks, labels, Runtime(), tcfg, chunk=5)
    logits, _ = tlm.forward(p, toks, Runtime(), tcfg)
    lab = torch.from_numpy(labels).long()
    per = (torch.logsumexp(logits, -1)
           - torch.gather(logits, -1, lab.clamp_min(0)[..., None])[..., 0])
    want = float((per * (lab >= 0)).sum()) / (B * T)
    assert abs(float(whole) - want) <= 1e-6 * want
    assert abs(float(chunked) - want) <= 1e-6 * want


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("policy", ["dots", "none"])
def test_remat_bit_equal_to_no_remat(arch, policy):
    base = _port_xent(arch)
    got = _port_xent(arch, Runtime(remat=True, remat_policy=policy))
    assert got[:2] == base[:2]
    for a, b in zip(tree_leaves(base[2]), tree_leaves(got[2])):
        assert torch.equal(a, b)


# --- train steps against the reference's ---------------------------------

STEP_ARCHS = ("smollm-135m", "qwen1.5-0.5b", "olmoe-1b-7b")
STEP_KW = dict(lr_peak=3e-3, warmup=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def _three_steps(arch):
    """Three steps of both packages from the reference's initial state:
    per step, (reference grads, port grads, reference state and metrics,
    port state and metrics). The grads are the step's loss gradients at
    the state it starts from."""
    jcfg, tcfg = _cfgs(arch)
    jstate = jloop.init_train_state(jax.random.PRNGKey(0), jcfg)
    tp = _port(jstate.params)
    tstate = tloop.TrainState(tp, toptim.adamw_init(tp),
                              torch.zeros((), dtype=torch.int32))
    jrt = JRuntime(compute_dtype=jnp.float32, capacity_factor=2.0)
    jstep = jax.jit(jloop.make_train_step(jcfg, jrt, **STEP_KW))
    tstep = tloop.make_train_step(tcfg, Runtime(capacity_factor=2.0),
                                  **STEP_KW)

    def jloss(p, b):
        xent, aux = jlm.forward_xent(p, b["tokens"], b["labels"], jrt, jcfg)
        return xent + 0.01 * aux
    jgrad = jax.jit(jax.grad(jloss))

    def tloss(p, b):
        xent, aux = tlm.forward_xent(p, b["tokens"], b["labels"],
                                     Runtime(capacity_factor=2.0), tcfg)
        return xent + 0.01 * aux, aux
    corpus = SyntheticCorpus(tcfg.vocab_size, seed=3)
    out = []
    for s in range(3):
        batch = corpus.batch(s, 4, 32)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jg = jgrad(jstate.params, jb)
        _, tg = value_and_grad(tloss, tstate.params, batch)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, batch)
        out.append((jg, tg, jstate, jm, tstate, tm))
    return out


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_steps_equal_reference(arch, steps):
    run = _three_steps(arch)[:steps]
    for s, (jg, tg, _, jm, _, tm) in enumerate(run):
        _hold_grads(jg, tg, f"{arch} step {s}")
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
        assert abs(float(tm["moe_aux"]) - float(jm["moe_aux"])) <= LOSS_TOL
        assert abs(float(tm["gnorm"]) - float(jm["gnorm"])) <= (
            1e-5 * float(jm["gnorm"]))
        lr = np.float32(jm["lr"])
        assert abs(float(tm["lr"]) - float(lr)) <= float(np.spacing(lr))
    jstate, tstate = run[-1][2], run[-1][4]
    assert int(tstate.step) == int(jstate.step) == steps
    grads = [[np.abs(g) for g in _np_leaves(r[0])] for r in run]
    flips = 0
    for i, (a, b) in enumerate(zip(_np_leaves(jstate.params),
                                   _t_leaves(tstate.params))):
        apart = np.abs(a - b) > PARAM_TOL
        if not apart.any():
            continue
        floor = np.zeros_like(apart)
        for g in grads:
            floor |= g[i] < NOISE_FLOOR * g[i].max()
        assert (floor | ~apart).all(), (arch, i, "parted beyond the flip "
                                        "explanation")
        assert apart.mean() <= FLIP_SHARE, (arch, i, apart.mean())
        flips += int(apart.sum())
    print(f"{arch}: {steps} steps, {flips} param elements parted by more "
          f"than {PARAM_TOL} (each at a noise-floor gradient)")
    for want, got in ((jstate.opt.mu, tstate.opt.mu),
                      (jstate.opt.nu, tstate.opt.nu)):
        for a, b in zip(_np_leaves(want), _t_leaves(got)):
            scale = max(float(np.abs(a).max()), 1e-30)
            assert float(np.abs(a - b).max()) <= GRAD_TOL * scale
