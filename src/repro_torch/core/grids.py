"""Scale constants of Algorithm 1 (from ``repro/core/grids.py``).

Only the numbers the quantizer reads are kept: ``SCALE_RULES`` (the
paper's stated alpha/sigma = 0.7979, the paper's formula sqrt(2)*erfinv(2/3)
and the Lloyd-Max optimum of the round-to-nearest ternary encoder) and
``fivelevel_alpha()``, the MSE-optimal base scale of the five-level escape
grid. Each is recomputed with the reference's own numerics (Newton on erf,
golden-section search over the same closed form or trapezoid integral), so
the values match it bit for bit. The five-level search takes about a
second, so it runs on first use, not at import.
"""
from __future__ import annotations

import functools
import math

import numpy as np

__all__ = ["ALPHA_PAPER", "ALPHA_ERFINV", "ALPHA_LLOYD", "SCALE_RULES",
           "fivelevel_alpha"]


def _erfinv(y: float) -> float:
    # Newton iteration on erf(x) - y = 0; for module-level constants only.
    x = 0.5
    for _ in range(80):
        err = math.erf(x) - y
        deriv = 2.0 / math.sqrt(math.pi) * math.exp(-x * x)
        x -= err / deriv
    return x


def _phi(t):
    return np.exp(-0.5 * np.asarray(t, dtype=np.float64) ** 2) / math.sqrt(
        2.0 * math.pi)


def _Phi(t):
    t = np.asarray(t, dtype=np.float64)
    return 0.5 * (1.0 + np.vectorize(math.erf)(t / math.sqrt(2.0)))


def _ternary_mse(alpha, sigma: float = 1.0):
    """Closed-form MSE of the round-to-nearest ternary quantizer with levels
    {-a, 0, +a} for x ~ N(0, sigma^2)."""
    a = np.asarray(alpha, dtype=np.float64)
    s = float(sigma)
    t = a / (2.0 * s)
    return s * s - 4.0 * a * s * _phi(t) + 2.0 * a * a * (1.0 - _Phi(t))


def _optimize_scalar(fn, lo: float, hi: float, iters: int = 200) -> float:
    gr = (math.sqrt(5.0) - 1.0) / 2.0
    c = hi - gr * (hi - lo)
    d = lo + gr * (hi - lo)
    for _ in range(iters):
        if fn(c) < fn(d):
            hi = d
        else:
            lo = c
        c = hi - gr * (hi - lo)
        d = lo + gr * (hi - lo)
    return 0.5 * (lo + hi)


#: The paper's stated numeric value (Eq. 8, App. A): alpha*/sigma ~= 0.798.
ALPHA_PAPER: float = 0.7979
#: The paper's stated formula sqrt(2)*erfinv(2/3) (which != 0.798).
ALPHA_ERFINV: float = math.sqrt(2.0) * _erfinv(2.0 / 3.0)
#: The MSE optimum of the paper's round-to-nearest ternary encoder.
ALPHA_LLOYD: float = _optimize_scalar(lambda a: float(_ternary_mse(a)),
                                      0.5, 2.5)

SCALE_RULES = {"paper": ALPHA_PAPER, "erfinv": ALPHA_ERFINV,
               "lloyd": ALPHA_LLOYD}


def _fivelevel_mse_scalar(a: float, sigma: float = 1.0) -> float:
    """MSE of the 5-level grid {-2a..+2a} (round to nearest) under
    N(0, sigma^2), by a dense trapezoid rule."""
    xs = np.linspace(-8.0 * sigma, 8.0 * sigma, 100_001)
    f = _phi(xs / sigma) / sigma
    q = np.clip(np.round(xs / a), -2, 2) * a
    return float(np.trapezoid((xs - q) ** 2 * f, xs))


@functools.cache
def fivelevel_alpha() -> float:
    """Optimal base scale (alpha/sigma) for the 5-level escape grid
    (~0.843); the reference's ``FIVELEVEL_ALPHA``."""
    return _optimize_scalar(_fivelevel_mse_scalar, 0.2, 1.5)
