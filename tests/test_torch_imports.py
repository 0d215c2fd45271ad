"""The PyTorch port stands alone: it imports without JAX and imports
nothing of the JAX package ``repro``; neither does ``chip_smoke.py``."""
import json
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


def test_port_modules_and_chip_smoke_import_without_jax(fresh_imports):
    rec = fresh_imports["every module"]
    assert rec["repro"] == [], rec
    assert rec["modules"] >= 20  # every module was imported


TP_MODULES = ("repro_torch.serve.tp", "repro_torch.sharding.rules",
              "repro_torch.launch.mesh")
# the training slice: its modules join no process group either
TRAIN_MODULES = ("repro_torch.data.pipeline", "repro_torch.train.tree",
                 "repro_torch.train.optim", "repro_torch.train.grad",
                 "repro_torch.train.loop", "repro_torch.launch.train",
                 "repro_torch.train.sharded", "repro_torch.train.tp")


@pytest.fixture(scope="module")
def fresh_imports() -> dict:
    """From one interpreter with JAX unavailable, each import afresh
    (every ``repro`` and ``repro_torch`` module dropped from
    ``sys.modules`` before it): per module of TP_MODULES + TRAIN_MODULES,
    then DRYRUN_MODULES together, then every module of the port and
    ``chip_smoke.py`` (``"every module"``, with their count), whether
    anything of ``repro`` (or, for the dry-run's, the fake process group)
    was loaded and whether a process group was initialized."""
    code = textwrap.dedent(f"""
        import importlib, json, pkgutil, sys
        sys.modules["jax"] = None
        sys.path[:0] = [{str(ROOT / "src")!r}, {str(ROOT)!r}]
        import torch.distributed as dist

        def fresh(names, fake_pg=False):
            for m in [m for m in sys.modules if m.startswith("repro")]:
                del sys.modules[m]
            for name in names:
                importlib.import_module(name)
            return dict(
                repro=[m for m in sys.modules
                       if m == "repro" or m.startswith("repro.")
                       or (fake_pg and m.endswith("fake_pg"))],
                group=dist.is_initialized())
        out = {{name: fresh([name])
               for name in {TP_MODULES + TRAIN_MODULES!r}}}
        out["dry-run"] = fresh({DRYRUN_MODULES!r}, fake_pg=True)
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        out["every module"] = fresh(names + ["chip_smoke"])
        out["every module"]["modules"] = len(names)
        print(json.dumps(out))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("module", TP_MODULES + TRAIN_MODULES)
def test_tensor_parallel_modules_import_without_jax(fresh_imports, module):
    """The tensor-parallel and training slices' modules import with JAX
    unavailable, load nothing of ``repro`` and join no process group at
    import."""
    assert fresh_imports[module] == dict(repro=[], group=False)


# the dry-run slice: its three new modules and the three it changed; none
# joins a process group (the fake one included) at import
DRYRUN_MODULES = ("repro_torch.launch.op_analysis", "repro_torch.launch.steps",
                  "repro_torch.launch.dryrun", "repro_torch.configs.base",
                  "repro_torch.models.lm", "repro_torch.models.layers")


def test_dryrun_modules_import_without_jax(fresh_imports):
    assert fresh_imports["dry-run"] == dict(repro=[], group=False)


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
