"""The PyTorch port stands alone: it imports without JAX and imports
nothing of the JAX package ``repro``; neither does ``chip_smoke.py``."""
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
# `import repro`, `import repro.x`, `from repro import`, `from repro.x`;
# `repro_torch` does not match
REFERENCE_IMPORT = re.compile(r"^\s*(from|import)\s+repro(\.|\s|$)", re.M)


def test_port_modules_and_chip_smoke_import_without_jax():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None  # any `import jax` now raises
        sys.path[:0] = [{str(ROOT / "src")!r}, {str(ROOT)!r}]
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        loaded = [m for m in sys.modules
                  if m == "repro" or m.startswith("repro.")]
        assert not loaded, loaded
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module was imported


TP_MODULES = ("repro_torch.serve.tp", "repro_torch.sharding.rules",
              "repro_torch.launch.mesh")
# the training slice: its modules join no process group either
TRAIN_MODULES = ("repro_torch.data.pipeline", "repro_torch.train.tree",
                 "repro_torch.train.optim", "repro_torch.train.grad",
                 "repro_torch.train.loop", "repro_torch.launch.train",
                 "repro_torch.train.sharded")


@pytest.mark.parametrize("module", TP_MODULES + TRAIN_MODULES)
def test_tensor_parallel_modules_import_without_jax(module):
    """The tensor-parallel and training slices' modules import with JAX
    unavailable, load nothing of ``repro`` and join no process group at
    import."""
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.path[:0] = [{str(ROOT / "src")!r}]
        importlib.import_module({module!r})
        import torch.distributed as dist
        assert not dist.is_initialized()
        loaded = [m for m in sys.modules
                  if m == "repro" or m.startswith("repro.")]
        assert not loaded, loaded
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_reference_package_import(path):
    text = path.read_text()
    assert not REFERENCE_IMPORT.search(text), path
    assert not re.search(r"^\s*(from|import)\s+jax\b", text, re.M), path


def test_reference_import_pattern():
    assert REFERENCE_IMPORT.search("from repro.core import fwht")
    assert REFERENCE_IMPORT.search("import repro.models.lm as lm")
    assert REFERENCE_IMPORT.search("from repro import configs")
    assert not REFERENCE_IMPORT.search("from repro_torch.core import fwht")


def test_every_port_module_is_checked():
    """The import guards above cover the modules of every slice (the
    W3A8 path, the quantizer kernel, the checkpoints, the paged cache,
    speculative decoding, the recurrent families, tensor-parallel serving
    and training included)."""
    names = {p.relative_to(PORT).with_suffix("").as_posix() for p in SOURCES
             if PORT in p.parents}
    assert {"core/act_quant", "kernels/quantize", "kernels/itq3",
            "checkpoint/ckpt", "serve/quantized", "launch/serve",
            "serve/paged", "core/prng", "serve/faults", "ft/monitor",
            "serve/spec", "models/ssm", "configs/rwkv6_3b",
            "configs/zamba2_7b", "serve/tp", "sharding/rules",
            "launch/mesh", "data/pipeline", "train/tree", "train/optim",
            "train/grad", "train/loop", "launch/train"} <= names
