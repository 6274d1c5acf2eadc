"""gprf_torch as a package: it imports without JAX, pins float32 products to
full precision, and chip_smoke.py refuses to run without a CUDA device."""

import importlib.util
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import torch

import gprf_torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(gprf_torch.__path__, "gprf_torch."))


def test_imports_without_jax_optax_or_gprf_tpu():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['optax'] = None\n"
        "import importlib\n"
        f"for name in ['gprf_torch'] + {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'gprf_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|optax|gprf_tpu)\b", re.M)
    files = [SMOKE]
    for root, _, names in os.walk(os.path.dirname(gprf_torch.__file__)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path
    assert len(files) >= 15


def test_float32_products_run_at_full_precision():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # importable: nothing runs at import
    assert callable(mod.main)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, SMOKE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert '"ok"' not in r.stdout
    # alone in a directory (without the package) it fails as well
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_kernel_build_is_lazy_and_keyed_on_the_sources():
    from gprf_torch.ops import _build

    assert _build.load.cache_info().currsize == 0  # nothing built at import
    srcs = [p.name for p in _build._sources()]
    assert {"chol_inv.cu", "mvn.cu", "tri_inv.cu", "common.cuh"} <= set(srcs)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
