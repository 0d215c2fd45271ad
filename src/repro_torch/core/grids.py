"""Scale constants of Algorithm 1 (from ``repro/core/grids.py``).

Only the two numbers the ternary quantizer reads are kept:
``SCALE_RULES["paper"]`` (the paper's stated alpha/sigma = 0.7979) and
``fivelevel_alpha()``, the MSE-optimal base scale of the five-level escape
grid, recomputed with numpy by the same golden-section search over the same
trapezoid integral as the reference, so the value matches it bit for bit.
The search takes about a second, so it runs on first use, not at import.
"""
from __future__ import annotations

import functools
import math

import numpy as np

__all__ = ["ALPHA_PAPER", "SCALE_RULES", "fivelevel_alpha"]

#: The paper's stated numeric value (Eq. 8, App. A): alpha*/sigma ~= 0.798.
ALPHA_PAPER: float = 0.7979

SCALE_RULES = {"paper": ALPHA_PAPER}


def _phi(t):
    return np.exp(-0.5 * np.asarray(t, dtype=np.float64) ** 2) / math.sqrt(
        2.0 * math.pi)


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
