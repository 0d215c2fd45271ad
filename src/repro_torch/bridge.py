"""Carry a reference params tree into the port, bit for bit.

The caller converts the JAX tree to numpy (every array leaf a numpy
array; every QTensor leaf a ``{"meta": QMeta.to_dict(), "data": {name:
array}}`` dict) and passes it here. :func:`params_from_numpy` returns the
port's param dict with :class:`~repro_torch.core.quantize.QTensor` leaves:
packed planes, fp16 scales and zero-points, and ``dsign`` where present,
with their dtypes and bits unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantize import QMeta, QTensor

__all__ = ["params_from_numpy"]


def _is_qtensor(node) -> bool:
    return isinstance(node, dict) and set(node) == {"meta", "data"}


def params_from_numpy(tree, device="cuda"):
    """numpy params tree -> port params dict on ``device``."""
    if _is_qtensor(tree):
        return QTensor({k: params_from_numpy(v, device)
                        for k, v in tree["data"].items()},
                       QMeta.from_dict(tree["meta"]))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind not in "fiub":
        raise TypeError(f"unsupported leaf dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, order="C")).to(device)
