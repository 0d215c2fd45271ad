"""Whole-model quantization pass (port of the uniform-format path of
``repro/serve/quantized.py``): params dict -> params dict with QTensor
matmul leaves.

Every leaf whose full dotted path (``"layers.attn.wq"``) matches
``MATMUL_LEAVES`` is quantized into one ternary format, unless it has
fewer than two dims or a reduction dim below ``MIN_REDUCTION``. Stacked
layer leaves (L, K, N) are blocked per matrix, so block statistics are
computed per layer exactly as the reference's nested vmap does. The
embedding table stays fp (the tied head is then a plain fp product).
QuantPolicy and mixed formats land with the mixed-policy slice.
"""
from __future__ import annotations

import re

from repro_torch.core import formats

__all__ = ["quantize_params", "quantized_bytes", "MATMUL_LEAVES",
           "MIN_REDUCTION"]

MATMUL_LEAVES = (r"(^|\.)(wq|wk|wv|wo|wg|wr|wz|wx|gate|up|down|lm_head|"
                 r"out_proj|cm_k|cm_v|frontend_proj)$")
MIN_REDUCTION = 64  # don't quantize degenerate tiny projections


def quantize_params(params, fmt: str = "itq3_s", *, rule: str = "paper"):
    """Quantize every matmul projection of ``params`` into ``fmt``."""
    spec = formats.get_format(fmt)
    pattern = re.compile(MATMUL_LEAVES)

    def visit(path: str, leaf):
        if isinstance(leaf, dict):
            return {k: visit(f"{path}.{k}" if path else k, v)
                    for k, v in leaf.items()}
        if (not pattern.search(path) or leaf.dim() < 2
                or leaf.shape[-2] < MIN_REDUCTION):
            return leaf
        return spec.quantize(leaf, rule=rule)

    return visit("", params)


def quantized_bytes(params) -> int:
    """Bytes held by the tree: packed planes and scales plus fp leaves."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, formats.QTensor):
        return params.nbytes()
    return params.numel() * params.element_size()
