"""Reference params carried into the PyTorch port bit for bit.

Also home of :func:`to_numpy_tree`, the JAX -> numpy conversion the other
``test_torch_*`` files use to hand the live reference's params to the port
(``repro_torch.bridge.params_from_numpy`` takes numpy only).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced
from repro.core.quantize import QTensor as JQTensor
from repro.models import lm as jlm
from repro.serve.quantized import quantize_params as jquantize_params
from repro_torch.bridge import params_from_numpy
from repro_torch.core.quantize import QTensor


def to_numpy_tree(tree):
    """JAX params tree -> numpy tree: QTensor leaves become
    ``{"meta": QMeta.to_dict(), "data": {name: ndarray}}``."""
    if isinstance(tree, JQTensor):
        return {"meta": tree.meta.to_dict(),
                "data": {k: np.asarray(v) for k, v in tree.data.items()}}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def jax_quantized_params(arch: str, fmt: str, seed: int = 0):
    """Reduced ``arch`` with random weights, quantized by the reference
    (jitted: the eager reference compiles op by op)."""
    cfg = reduced(get_config(arch))
    params = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg)
    return cfg, jax.jit(functools.partial(jquantize_params, fmt=fmt))(params)


def _leaves(tree, path=""):
    if isinstance(tree, (dict,)):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else k)
    else:
        yield path, tree


@pytest.mark.parametrize("fmt", ["itq3_s", "quip3", "itq3_x"])
def test_params_from_numpy_bit_for_bit(fmt):
    _, jparams = jax_quantized_params("smollm-135m", fmt)
    tparams = params_from_numpy(to_numpy_tree(jparams), device="cpu")
    jflat = dict(_leaves(jax.tree.map(
        lambda x: x, jparams, is_leaf=lambda x: isinstance(x, JQTensor))))
    tflat = dict(_leaves(tparams))
    assert jflat.keys() == tflat.keys()
    n_q = 0
    for path, jleaf in jflat.items():
        tleaf = tflat[path]
        if isinstance(jleaf, JQTensor):
            n_q += 1
            assert isinstance(tleaf, QTensor)
            assert tleaf.meta.to_dict() == jleaf.meta.to_dict()
            assert tleaf.data.keys() == jleaf.data.keys()
            for k, v in jleaf.data.items():
                v = np.asarray(v)
                got = tleaf.data[k].numpy()
                assert got.dtype == v.dtype, (path, k)
                np.testing.assert_array_equal(got.view(np.uint8),
                                              v.view(np.uint8))
        else:
            np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    assert n_q == 7  # wq wk wv wo gate up down
    if fmt == "quip3":
        assert tflat["layers.attn.wq"].data["dsign"].dtype == torch.int8


def test_params_from_numpy_rejects_object_leaves():
    with pytest.raises(TypeError):
        params_from_numpy({"x": np.array(["a"])}, device="cpu")


def test_layer_view_slices_stacked_dsign():
    _, jparams = jax_quantized_params("smollm-135m", "quip3")
    qt = params_from_numpy(to_numpy_tree(jparams),
                           device="cpu")["layers"]["attn"]["wq"]
    one = qt.layer(1)
    assert one.data["plane2"].shape == qt.data["plane2"].shape[1:]
    assert one.data["dsign"].shape == (256,)
    np.testing.assert_array_equal(
        one.data["dsign"].numpy(),
        np.asarray(jparams["layers"]["attn"]["wq"].data["dsign"])[1])
