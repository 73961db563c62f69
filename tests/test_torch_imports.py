"""The port stands alone: neither ``foundationpose_tpu_torch`` nor
``chip_smoke.py`` imports jax, flax, optax, orbax or anything of the JAX
package, and the port imports without h5py, cv2, PIL, sklearn or yaml."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "foundationpose_tpu_torch")
FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax)\b", re.M),
    # word-bounded so that foundationpose_tpu_torch passes
    re.compile(r"\bfoundationpose_tpu\."),
    re.compile(r"\bfrom\s+foundationpose_tpu\s"),
    re.compile(r"\bimport\s+foundationpose_tpu\b(?!_)"),
    re.compile(r"libfp_native"),
]


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        if "_build" in d or "__pycache__" in d:
            continue
        files += [os.path.join(d, n) for n in names if n.endswith((".py", ".cu", ".cuh", ".cpp"))]
    return sorted(files)


def test_sources_found():
    names = {os.path.relpath(f, ROOT) for f in _sources()}
    for must in ("chip_smoke.py", "foundationpose_tpu_torch/ops/raster_cuda.py",
                 "foundationpose_tpu_torch/ops/kernels.py",
                 "foundationpose_tpu_torch/csrc/raster.cu",
                 "foundationpose_tpu_torch/ops/depth_cuda.py",
                 "foundationpose_tpu_torch/csrc/depth_preprocess.cu",
                 "foundationpose_tpu_torch/engine/estimator.py",
                 "foundationpose_tpu_torch/field/runner.py",
                 "foundationpose_tpu_torch/slam/ba.py", "foundationpose_tpu_torch/slam/online.py",
                 "foundationpose_tpu_torch/parallel/mesh.py",
                 "foundationpose_tpu_torch/parallel/multihost.py",
                 "foundationpose_tpu_torch/utils/profiling.py",
                 "foundationpose_tpu_torch/native/__init__.py",
                 "foundationpose_tpu_torch/native/cluster.cpp"):
        assert must in names


def _module_files(pkg):
    out = set()
    for d, _, names in os.walk(os.path.join(ROOT, pkg)):
        if "_build" in d or "__pycache__" in d:
            continue
        out |= {os.path.relpath(os.path.join(d, n), os.path.join(ROOT, pkg)) for n in names
                if n.endswith((".py", ".cpp"))}
    return out


def test_every_module_of_the_jax_package_has_a_counterpart():
    """A diff of the two packages' module lists shows only the port's own
    additions and two modules with no counterpart to write: the Pallas
    rasterizer (the port's is ``ops/raster_cuda.py`` + ``csrc/``) and XLA's
    persistent compile cache (eager PyTorch compiles nothing; the port's
    kernels are cached in ``_build/``)."""
    missing = _module_files("foundationpose_tpu") - _module_files("foundationpose_tpu_torch")
    assert missing == {"ops/raster_pallas.py", "utils/jaxcache.py"}, missing


@pytest.mark.parametrize("path", [os.path.relpath(f, ROOT) for f in _sources()])
def test_no_jax_in_port_source(path):
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    for pat in FORBIDDEN:
        hit = pat.search(text)
        assert hit is None, f"{path}: forbidden reference {hit.group(0)!r}"


def test_importing_the_port_loads_no_jax():
    """Import every module of the port in a fresh interpreter and look at
    ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import foundationpose_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'foundationpose_tpu')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_port_imports_without_cv2_or_pil():
    """Every module of the port imports with cv2 and PIL blocked: the card's
    machine has neither, and nothing the port runs there may need them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['cv2'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import foundationpose_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from foundationpose_tpu_torch.io import datareader\n"
        "try:\n"
        "    datareader._imread_rgb('x.jpg')\n"
        "except ImportError as e:\n"
        "    assert 'PIL' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('a .jpg read without PIL')\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_port_imports_without_h5py():
    """Every module of the port imports with h5py blocked (the card's machine
    need not have it): ``models/h5data.py`` imports it where it is used, and
    says so when it is missing."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['h5py'] = None\n"
        "import foundationpose_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from foundationpose_tpu_torch.models import h5data\n"
        "try:\n"
        "    h5data.PairH5Dataset('x.h5')\n"
        "except ImportError as e:\n"
        "    assert 'h5py' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('an archive opened without h5py')\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_port_imports_without_sklearn_or_yaml():
    """Every module of the port imports with sklearn and yaml blocked (the
    card's machine need not have them): the field's bounds cluster with
    scipy, and a YAML config names PyYAML when it is missing."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['sklearn'] = None\n"
        "sys.modules['yaml'] = None\n"
        "import foundationpose_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import numpy as np\n"
        "from foundationpose_tpu_torch.field import bounds\n"
        "pts = np.random.default_rng(0).normal(0, 0.01, (50, 3))\n"
        "assert len(bounds.biggest_cluster(pts, 0.06)) == 50\n"
        "from foundationpose_tpu_torch.utils import config\n"
        "try:\n"
        "    config.load_field_config('x.yml')\n"
        "except ImportError as e:\n"
        "    assert 'PyYAML' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('a YAML file read without yaml')\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_chip_smoke_fails_without_a_card():
    """Without a CUDA device the smoke script exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "kernels" not in out.stdout
