"""gprf_torch as a package: it imports without JAX, pins float32 products to
full precision, chip_smoke.py and the CLI refuse to run without a CUDA
device unless the CPU is asked for, and the device loop stands below the
command line."""

import importlib.util
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest
import torch

import gprf_torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(gprf_torch.__path__, "gprf_torch."))


def test_the_import_check_covers_the_entry_points():
    assert {"gprf_torch.cli.gprfopt", "gprf_torch.optim.lbfgs", "gprf_torch.data.sampled",
            "gprf_torch.data.synthetic", "gprf_torch.analysis.results",
            "gprf_torch.model.gprf", "gprf_torch.optim.driver",
            "gprf_torch.partition.layout", "gprf_torch.cli.run_seismic",
            "gprf_torch.sparse.native", "gprf_torch.model.fused_seismic",
            "gprf_torch.model.kernelized", "gprf_torch.model.sparse_llgrad",
            "gprf_torch.cli.analyze", "gprf_torch.utils.profiling",
            "gprf_torch.data.pipeline.catalog"} <= set(_modules())


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
    assert len(files) >= 30


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
    assert {"chol_inv.cu", "mvn.cu", "tri_inv.cu", "mvn_inv.cu", "se_kernel.cu", "common.cuh",
            "blocked.cuh"} == set(srcs)
    assert {"gprf_chol_inv", "gprf_mvn_ll", "gprf_tri_inv", "gprf_mvn_ll_inv",
            "gprf_cholesky", "gprf_se_kernel", "gprf_se_kernel_bwd",
            "gprf_chol_inv_ctas_per_sm", "gprf_tri_inv_ctas_per_sm",
            "gprf_mvn_ctas_per_sm", "gprf_mvn_inv_ctas_per_sm"} == set(_build.SIGNATURES)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where there is no GPU")
def test_cli_and_bench_default_to_the_card_and_raise_without_one(tmp_path, monkeypatch):
    """Nothing carries on on the CPU unless ``--device cpu`` asks for it."""
    from gprf_torch.cli import gprfopt

    monkeypatch.setenv("GPRF_EXPERIMENTS", str(tmp_path))
    argv = ["--ntrain", "100", "--ntest", "10", "--nblocks", "4", "--lscale", "0.2"]
    assert gprfopt.build_parser().parse_args(argv).device == "cuda"
    for engine in ("host", "device"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            gprfopt.main(argv + ["--engine", engine])
    with pytest.raises(RuntimeError, match="--device cpu"):
        gprfopt.do_run(str(tmp_path), 0.2, 110, 100, 4, 3)
    assert os.listdir(tmp_path) == []  # refused before anything was sampled or written


def test_the_dispatch_loop_does_not_load_the_command_line_layer():
    """The device loop's layer stands below the command line: importing it
    loads neither the CLI nor the data, analysis and scipy-driver modules."""
    code = ("import sys, gprf_torch.optim.lbfgs\n"
            "layers = ('gprf_torch.cli', 'gprf_torch.data', 'gprf_torch.analysis',"
            " 'gprf_torch.optim.driver')\n"
            "bad = [m for m in sys.modules if m.startswith(layers)]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_model_classes_take_their_device_explicitly():
    """GPRF and build_gprf have no default device to fall back to."""
    import inspect

    from gprf_torch.data.sampled import SampledData
    from gprf_torch.model.gprf import GPRF

    for f in (GPRF.__init__, SampledData.build_gprf):
        params = inspect.signature(f).parameters
        for name in ("device", "dtype"):
            assert params[name].kind is inspect.Parameter.KEYWORD_ONLY
            assert params[name].default is inspect.Parameter.empty
