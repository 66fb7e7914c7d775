"""The port stands alone: ``repro_torch`` imports with ``jax`` blocked,
no file of it (nor ``chip_smoke.py``) imports jax or the JAX package, and
its entry points refuse to fall back to the CPU when CUDA is absent."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|from\s+repro\.|"
    r"from\s+repro\s+import|import\s+repro\s*$)", re.M)


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in [m for m in sys.modules\n"
        "                     if sys.modules[m] is not None]\n"
        "assert not any(m == 'repro' or m.startswith('repro.')\n"
        "               for m in sys.modules)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = _FORBIDDEN.findall(path.read_text())
    assert not bad, f"{path} imports {bad}"


def test_source_scan_catches_forbidden_imports():
    for line in ("import jax", "from jax import numpy", "import repro.api",
                 "from repro.core import flat", "from repro import models",
                 "    import jax.numpy as jnp"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import flat",
                 "# import jax would be wrong"):
        assert not _FORBIDDEN.search(line), line


def test_engine_without_device_needs_cuda():
    from repro_torch.configs import get_config
    from repro_torch.engine import TrainEngine
    from repro_torch.optim import sgd_momentum
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainEngine(get_config("cifar-resnet18"), sgd_momentum(0.0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainEngine(get_config("cifar-resnet18"), sgd_momentum(0.0),
                    device="cuda")


def _entry_points():
    import numpy as np

    from repro_torch import convert, models
    from repro_torch.configs import get_config
    from repro_torch.core.flat import flat_spec
    from repro_torch.models import resnet
    cfg = get_config("cifar-resnet18")
    gen = torch.Generator().manual_seed(0)
    arr = np.zeros((2, 3), np.float32)
    spec = flat_spec({"w": torch.zeros(3, 5)})
    return {
        "models.init_params": lambda d: models.init_params(cfg, gen,
                                                           device=d),
        "resnet.init_params": lambda d: resnet.init_params(cfg, gen,
                                                           device=d),
        "convert.tensor_from_numpy": lambda d: convert.tensor_from_numpy(
            arr, d),
        "convert.params_from_numpy": lambda d: convert.params_from_numpy(
            {"a": arr}, d),
        "FlatSpec.zeros_stacked": lambda d: spec.zeros_stacked(2, d),
    }


@pytest.mark.parametrize("name", list(_entry_points()))
def test_entry_point_without_device_needs_cuda(name):
    make = _entry_points()[name]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(None)
    out = make("cpu")
    leaves = out.values() if isinstance(out, dict) else [out]
    assert all(t.device.type == "cpu" for t in leaves
               if isinstance(t, torch.Tensor))


def test_kernel_wrappers_refuse_other_devices():
    from repro_torch.kernels.dbl_merge import dbl_apply_flat2d
    p2 = torch.zeros(8, 128, device="meta")
    with pytest.raises(ValueError, match="no dbl_apply_flat2d kernel"):
        dbl_apply_flat2d(p2, torch.zeros_like(p2), lr=0.1)
