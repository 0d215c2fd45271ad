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
"""
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


@pytest.fixture(scope="module")
def counts() -> dict:
    """Per arch of ``ARCHS``: the counted FLOPs on one device and on rank
    0 of the fake group, the record's ``model_axis`` and the collectives'
    counts (one subprocess for the module)."""
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
