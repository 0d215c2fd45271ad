"""Whole-model quantization pass (port of ``repro/serve/quantized.py``):
params dict -> params dict with QTensor matmul leaves.

Which leaves quantize, and into which format, is decided by a
:class:`QuantPolicy`: an ordered list of :class:`QuantRule` entries matched
against the full dotted path of each leaf (``"layers.attn.wq"``,
``"lm_head"``), first match wins. ``fmt=None`` pins a leaf at full
precision; ``rule``/``seed``/``sub_blocks`` override the policy defaults
per rule, and ``act_quant=False`` pins a path to the float contraction
even under ``Runtime.act_quant``. Policies round-trip through JSON
(``to_dict``/``from_dict``), so a mixed-precision recipe
(``configs.base.mixed_precision_recipe``) is one declarative object.

Leaves with fewer than two dims or a reduction dim below ``MIN_REDUCTION``
stay fp whatever the policy says. Stacked layer leaves (L, K, N) are
blocked per matrix, so block statistics are computed per layer exactly as
the reference's nested vmap does. The embedding table (gathered, not
multiplied) is touched only by an explicit ``embed`` rule and is quantized
transposed, as (D, V). ``quantize_params(params, "itq3_s")`` is
``QuantPolicy.uniform``. ``seed`` is read only by ``quip3``: its sign
diagonal is JAX's threefry draw from that seed (``core/prng.py``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

from repro_torch.core import formats
from repro_torch.core.quantize import QTensor

__all__ = ["QuantRule", "QuantPolicy", "quantize_params", "quantized_bytes",
           "describe_quantized", "MATMUL_LEAVES", "MIN_REDUCTION"]

# Leaf names of every matmul projection across the model zoo, anchored so
# the pattern can sit inside full-path rules.
MATMUL_LEAVES = (r"(^|\.)(wq|wk|wv|wo|wg|wr|wz|wx|gate|up|down|lm_head|"
                 r"out_proj|cm_k|cm_v|frontend_proj)$")
MIN_REDUCTION = 64  # don't quantize degenerate tiny projections


@dataclasses.dataclass(frozen=True)
class QuantRule:
    """One policy entry: regex over the full dotted leaf path -> format
    (``None`` pins full precision), with optional per-rule overrides."""

    pattern: str
    fmt: Optional[str]
    rule: Optional[str] = None  # scale rule: "paper" | "erfinv" | "lloyd"
    seed: Optional[int] = None
    sub_blocks: Optional[int] = None
    act_quant: Optional[bool] = None

    def __post_init__(self):
        re.compile(self.pattern)  # fail fast on bad patterns
        if self.fmt is not None:
            spec = formats.get_format(self.fmt)  # fail fast on unknown names
            if self.sub_blocks is not None and not isinstance(
                    spec, formats.TernaryFormat):
                raise ValueError(
                    f"rule {self.pattern!r}: sub_blocks override requires a "
                    f"ternary format, got {self.fmt!r}")

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None

    def to_dict(self) -> dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None or k in ("pattern", "fmt")}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "QuantRule":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Ordered quantization rules; the first matching rule decides each
    leaf, and leaves no rule matches stay full precision."""

    rules: tuple[QuantRule, ...] = ()
    rule: str = "paper"
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(
            r if isinstance(r, QuantRule)
            else QuantRule(**r) if isinstance(r, dict)
            else QuantRule(*r)
            for r in self.rules))

    @classmethod
    def uniform(cls, fmt: str, *, rule: str = "paper", seed: int = 0,
                include_embed: bool = False) -> "QuantPolicy":
        """Every matmul projection -> ``fmt``."""
        rules = [QuantRule(MATMUL_LEAVES, fmt)]
        if include_embed:
            rules.append(QuantRule(r"(^|\.)embed$", fmt))
        return cls(tuple(rules), rule=rule, seed=seed)

    def match(self, path: str) -> Optional[QuantRule]:
        for r in self.rules:
            if r.matches(path):
                return r
        return None

    def to_dict(self) -> dict[str, Any]:
        return {"rules": [r.to_dict() for r in self.rules],
                "rule": self.rule, "seed": self.seed}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "QuantPolicy":
        return cls(tuple(QuantRule.from_dict(r) for r in d.get("rules", ())),
                   rule=d.get("rule", "paper"), seed=d.get("seed", 0))


def _walk(tree, fn, path: str = ""):
    """Map ``fn(dotted_path, leaf)`` over a nested dict of leaves (tensors
    or QTensors)."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


def quantize_params(params, fmt: "str | QuantPolicy" = "itq3_s", *,
                    rule: str = "paper", include_embed: bool = False,
                    seed: int = 0):
    """Quantize the leaves of ``params`` per policy. ``fmt`` is a format
    name (the uniform policy over every matmul projection) or a
    :class:`QuantPolicy`."""
    policy = fmt if isinstance(fmt, QuantPolicy) else QuantPolicy.uniform(
        fmt, rule=rule, seed=seed, include_embed=include_embed)

    def visit(path: str, leaf):
        if isinstance(leaf, QTensor):
            return leaf
        r = policy.match(path)
        if r is None or r.fmt is None:
            return leaf
        spec = formats.get_format(r.fmt)
        kwargs: dict[str, Any] = dict(
            rule=r.rule or policy.rule,
            seed=policy.seed if r.seed is None else r.seed)
        if r.sub_blocks is not None:
            kwargs["sub_blocks"] = r.sub_blocks
        if path.split(".")[-1] == "embed":
            if leaf.dim() != 2:
                return leaf
            qt = spec.quantize(leaf.T, **kwargs)  # gathered: (D, V) blocks
        elif leaf.dim() < 2 or leaf.shape[-2] < MIN_REDUCTION:
            return leaf
        else:
            qt = spec.quantize(leaf, **kwargs)
        if r.act_quant is not None:
            qt = QTensor(qt.data, dataclasses.replace(
                qt.meta, act_quant=r.act_quant))
        return qt

    return _walk(params, visit)


def quantized_bytes(params) -> int:
    """Bytes held by the tree: packed planes and scales plus fp leaves."""
    total = 0

    def visit(_, leaf):
        nonlocal total
        total += (leaf.nbytes() if isinstance(leaf, QTensor)
                  else leaf.numel() * leaf.element_size())
        return leaf

    _walk(params, visit)
    return total


def describe_quantized(params) -> dict[str, str]:
    """{dotted path: format name} for every quantized leaf."""
    out: dict[str, str] = {}

    def visit(path, leaf):
        if isinstance(leaf, QTensor):
            out[path] = leaf.meta.fmt
        return leaf

    _walk(params, visit)
    return out
