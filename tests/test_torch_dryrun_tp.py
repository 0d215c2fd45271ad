"""The dry-run's train cells under the ``model`` axis's compute split
(``train/tp.py``): the ``train_4k`` cell of a reduced config, cut to 4
rows of 1,024 tokens (four query chunks of 256 a layer), counted on one
device and on rank 0 of a fake ``(data 1, model 4)`` group (in one
subprocess for the module: a fake group never joins this process). Each
count of matmul FLOPs equals the one derived here from the config, term
by term:

* the plain products (the projections, the router) run once forward and
  twice backward (``dx``, ``dw``): the "dots" remat policy keeps their
  outputs;
* the attention's scores run three times forward (the step, the layer's
  remat, the query chunk's checkpoint) and its values twice (the chunk's
  recompute stops at its last saved tensor), each twice backward;
* the experts' batched products twice forward (the remat recomputes
  them) and twice backward;
* the head four times: forward, its chunk's checkpoint, ``dx``, ``dw``.

Split over 4 ranks, the column- and row-parallel products, the attention
(by KV heads, or by blocks of keys), the experts and the vocab-parallel
head take 1/4 of one device's; the replicated parts are stated: the MoE
router, and, where the KV heads do not divide the axis (``kv_seq``), the
q, k and v projections on the gathered weights. The record's
``layout["model_axis"]`` names the attention case.

The other four families' cells (:data:`CELLS`) are cut further, to 4
rows, a few layers and one or two chunks of their scans, and counted on
the fake group alone, each against :func:`_derived_cell`: there every
batched product of a remat unit runs twice forward (a hybrid's tail,
outside its macroblocks, once), an attention of one query chunk is
:func:`~repro_torch.models.layers._sdpa` itself, a product whose input
needs no gradient (the frontend's features, the scan's zero initial
state) skips that backward, and the scan's final state, which no loss
reads, none. Their replicated terms are named there: RWKV6's time mix
where its 2 heads do not divide 4, Mamba2's wB and wC, the B and C
channels of its convolution and its C.B scores (B and C feed every
head), and the frontend's projection on its gathered weight.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.configs import base

ROOT = Path(__file__).resolve().parents[1]
ROWS, SEQ, WAYS = 4, 1024, 4
ARCHS = ("smollm-135m", "olmoe-1b-7b")
# name -> (arch, tokens a row, config overrides): two RWKV6 chunks of 16,
# one Mamba2 chunk of 128 (a macroblock of 3 layers and a 1-layer tail),
# 248 tokens after phi's 8 patch rows (one query chunk of 256), 256 tokens
# cross-attending seamless's 8 frames
CELLS = {
    "rwkv6-3b": ("rwkv6-3b", 32, {"num_layers": 2}),
    "rwkv6-3b/2 heads": ("rwkv6-3b", 32, {"num_layers": 2, "num_heads": 2}),
    "zamba2-7b": ("zamba2-7b", 128, {"num_layers": 4}),
    "phi-3-vision-4.2b": ("phi-3-vision-4.2b", 248, {"num_layers": 2}),
    "seamless-m4t-medium": ("seamless-m4t-medium", 256, {"num_layers": 2}),
}


def cell_cfg(name: str):
    arch, _, kw = CELLS[name]
    return dataclasses.replace(base.reduced(base.get_config(arch)), **kw)


@pytest.fixture(scope="module")
def counts() -> dict:
    """Per arch of ``ARCHS``: the counted FLOPs on one device and on rank
    0 of the fake group, the record's ``model_axis`` and the collectives'
    counts; per cell of CELLS, those of the fake group (one subprocess
    for the module)."""
    code = textwrap.dedent(f"""
        import dataclasses, json, sys
        sys.path.insert(0, {str(ROOT / "src")!r})
        from repro_torch.configs import base
        from repro_torch.launch import op_analysis, steps
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.launch.mesh import local_mesh, make_mesh
        base.SHAPES["train_4k"] = dataclasses.replace(
            base.SHAPES["train_4k"], seq_len={SEQ})
        out = {{}}
        for arch in {ARCHS!r}:
            cfg = base.reduced(base.get_config(arch))
            cell = steps.build_cell(arch, "train_4k", local_mesh("cpu"),
                                    cfg=cfg, rows={ROWS})
            with op_analysis.count_ops() as st:
                cell.run()
            one = st.flops
            with fake_world({WAYS}):
                mesh = make_mesh({{"data": 1, "model": {WAYS}}},
                                 device="cpu", rank=0, world_size={WAYS})
                cell = steps.build_cell(arch, "train_4k", mesh, cfg=cfg,
                                        rows={ROWS})
                with op_analysis.count_ops() as st:
                    cell.run()
            out[arch] = dict(one=one, split=st.flops,
                             layout=cell.layout["model_axis"],
                             collectives=st.collective_counts)
        train = base.SHAPES["train_4k"]
        for name, (arch, seq, kw) in {CELLS!r}.items():
            base.SHAPES["train_4k"] = dataclasses.replace(train,
                                                          seq_len=seq)
            cfg = dataclasses.replace(base.reduced(base.get_config(arch)),
                                      **kw)
            with fake_world({WAYS}):
                mesh = make_mesh({{"data": 1, "model": {WAYS}}},
                                 device="cpu", rank=0, world_size={WAYS})
                cell = steps.build_cell(arch, "train_4k", mesh, cfg=cfg,
                                        rows={ROWS})
                with op_analysis.count_ops() as st:
                    cell.run()
            out[name] = dict(split=st.flops,
                             layout=cell.layout["model_axis"],
                             collectives=st.collective_counts)
        print(json.dumps(out))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                          capture_output=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _derived(cfg, ways: int) -> float:
    """The step's matmul FLOPs on one rank of a model axis of ``ways``
    (1: one device), from the config: each term's forward FLOPs times
    its passes (module docstring) times its share on the rank."""
    b, t = ROWS, SEQ
    d, f, v, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, \
        cfg.resolved_head_dim
    h, kv, layers = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    tok = b * t
    split = 1.0 / ways
    heads = kv % ways == 0
    # (forward FLOPs of one layer, passes, share on the rank)
    qkv = 2 * tok * d * (h + 2 * kv) * hd
    terms = [(qkv, 3, split if heads else 1.0),  # replicated under kv_seq
             (2 * tok * h * hd * d, 3, split),  # wo, row-parallel
             (2 * b * h * t * t * hd, 5, split),  # scores
             (2 * b * h * t * t * hd, 4, split)]  # values
    if cfg.num_experts:
        e, k = cfg.num_experts, cfg.experts_per_token
        cap = min(t * k, max(1, -(-int(1.25 * t * k) // e)))
        terms += [(2 * tok * d * e, 3, 1.0),  # the router, replicated
                  (2 * e * b * cap * 3 * d * f, 4, split)]  # the experts
    else:
        terms.append((2 * tok * 3 * d * f, 3, split))  # gate, up, down
    total = layers * sum(fl * n * share for fl, n, share in terms)
    return total + 2 * tok * d * v * 4 * split  # the vocab-parallel head


@pytest.mark.parametrize("arch,case",
                         list(zip(ARCHS, ("kv_seq", "heads"))))
def test_split_train_cell_flops_equal_derived_count(counts, arch, case):
    cfg = base.reduced(base.get_config(arch))
    got = counts[arch]
    assert got["one"] == _derived(cfg, 1)
    assert got["split"] == _derived(cfg, WAYS)
    assert got["layout"].startswith("tensor parallel")
    assert f"attention {case}:" in got["layout"], got["layout"]
    assert got["collectives"]["all-reduce"] > 0
    # the split share of the one-device count, for the record
    print(f"{arch}: {got['split'] / got['one']:.4f} of one device's")


def _attention(b, t, tk, cfg, share, fwd):
    """The terms of one attention block of ``t`` queries over ``tk`` keys
    in one query chunk: the projections, then the scores and the values
    ``fwd`` times forward and twice backward."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    return [(2 * b * t * d * h * hd, 3, share),  # wq
            (2 * b * tk * d * 2 * kv * hd, 3, share),  # wk, wv
            (2 * b * t * h * hd * d, 3, share),  # wo, row-parallel
            (2 * b * h * t * tk * hd, fwd + 2, share),  # scores
            (2 * b * h * t * tk * hd, fwd + 2, share)]  # values


def _derived_cell(cfg, seq: int, ways: int) -> float:
    """The matmul FLOPs of a cell of CELLS on one rank of a model axis of
    ``ways``: each term's forward FLOPs times its passes times its share
    on the rank, 1 for the replicated terms (module docstring)."""
    b, t = ROWS, seq
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    tok, m = b * t, 1.0 / ways
    terms = []
    if cfg.family == "ssm":
        h, hd = cfg.num_heads, cfg.resolved_head_dim
        hh, lora = h * hd, max(32, d // 32)
        # the time mix by heads, or replicated on the gathered leaves
        tm = m if h % ways == 0 else 1.0
        lc = 16
        nc = t // lc
        att = 2 * b * h * lc * lc * hd  # r.k scores, then their values
        sq = 2 * b * h * lc * hd * hd  # r . S_in, then the state update
        bonus = 2 * b * lc * h * hd
        # per chunk twice forward; backward: both operands of the scores,
        # values and bonus, r only against the zero state of chunk 0, and
        # no state update after the last chunk
        scan = (nc * (2 * (2 * att + 2 * sq + bonus) + 4 * att + 2 * bonus)
                + (2 * nc - 1) * sq + 2 * (nc - 1) * sq)
        terms += cfg.num_layers * [
            (2 * tok * d * hh, 4 * 3, tm),  # wr, wk, wv, wg
            (2 * tok * hh * d, 3, m),  # wo, row-parallel either way
            (2 * tok * (d * lora + lora * hh), 3, tm),  # the decay LoRA
            (2 * 2 * tok * d * f, 3, m),  # cm_k's columns, cm_v
            (scan, 1, tm)]
    elif cfg.family == "hybrid":
        ed, n, kw = cfg.ssm_expand * d, cfg.ssm_state, cfg.ssm_conv
        hm, p = ed // 64, 64
        every = cfg.attn_every
        units = cfg.num_layers // every
        for i in range(cfg.num_layers):
            fwd = 2 if i < units * every else 1  # the tail: no remat
            if i % every == 0:
                terms += _attention(b, t, t, cfg, m, fwd)
            terms += [(2 * tok * d * ed * 2, 3, m),  # wz, wx
                      (2 * tok * d * n * 2, 3, 1.0),  # wB, wC: whole
                      (2 * tok * d * hm, 3, m),  # wdt's columns
                      (2 * tok * ed * d, 3, m),  # out_proj
                      (2 * tok * ed * kw, fwd + 2, m),  # conv, x channels
                      (2 * tok * 2 * n * kw, fwd + 2, 1.0),  # conv, B, C
                      (2 * b * t * t * n, fwd + 2, 1.0),  # C.B scores
                      (2 * b * hm * t * t * p, fwd + 2, m),  # their values
                      (2 * b * t * n * hm * p, fwd + 1, m),  # C . s_in
                      (2 * b * n * hm * p * t, fwd, m)]  # the final state
    else:
        tt = t + (cfg.frontend_len if cfg.family == "vlm" else 0)
        ffn = 3 if cfg.activation == "swiglu" else 2
        # the features need no gradient: forward and dw; gathered whole
        terms.append((2 * b * cfg.frontend_len * cfg.frontend_dim * d, 2,
                      1.0))
        if cfg.family == "audio":
            s = cfg.frontend_len
            for _ in range(cfg.encoder_layers):
                terms += _attention(b, s, s, cfg, m, 2)
                terms.append((2 * b * s * d * f * ffn, 3, m))
        for _ in range(cfg.num_layers):
            terms += _attention(b, tt, tt, cfg, m, 2)
            if cfg.family == "audio":
                terms += _attention(b, tt, cfg.frontend_len, cfg, m, 2)
            terms.append((2 * b * tt * d * f * ffn, 3, m))
    terms.append((2 * tok * d * v, 4, m))  # the vocab-parallel head
    return sum(fl * n * share for fl, n, share in terms)


# the case each cell's record names
CASES = {"rwkv6-3b": ["layers RWKV6 time mix heads"],
         "rwkv6-3b/2 heads": ["layers RWKV6 time mix replicated"],
         "zamba2-7b": ["mamba_blocks Mamba2 heads", "mamba_tail Mamba2 heads",
                       "shared_attn attention heads"],
         "phi-3-vision-4.2b": ["layers attention heads"],
         "seamless-m4t-medium": ["encoder attention heads",
                                 "layers attention heads",
                                 "layers cross-attention heads"]}


@pytest.mark.parametrize("name", list(CELLS))
def test_split_cell_of_every_family_flops_equal_derived_count(counts,
                                                              name):
    cfg, seq = cell_cfg(name), CELLS[name][1]
    got = counts[name]
    assert got["split"] == _derived_cell(cfg, seq, WAYS)
    assert got["layout"].startswith("tensor parallel")
    assert "storage" not in got["layout"]
    for case in CASES[name]:
        assert case + ":" in got["layout"], (case, got["layout"])
    assert got["collectives"]["all-reduce"] > 0
    print(f"{name}: {got['split'] / _derived_cell(cfg, seq, 1):.4f} of "
          f"one device's")
