"""A wheel of the repo carries what the PyTorch port reads at run time
beside its Python modules: every CUDA source and header the kernel builds
reach (``kernels/_build.source_files``), the host C++ of ``native/`` and
the CGCNN feature table. The wheel is built offline from a copy of the
tree in a temporary directory."""

import glob
import os
import shutil
import subprocess
import sys
import zipfile

from scann_tpu_torch.kernels import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torch_wheel_ships_kernel_sources_native_code_and_assets(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for f in ("pyproject.toml", "README.md"):
        shutil.copy(os.path.join(ROOT, f), src / f)
    for pkg in ("scann_tpu", "scann_tpu_torch"):
        shutil.copytree(os.path.join(ROOT, pkg), src / pkg,
                        ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "*.so"))
    out = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", ".", "--no-deps", "--no-build-isolation",
         "--no-index", "-q", "-w", str(tmp_path / "dist")],
        cwd=src, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PIP_NO_INPUT="1", PIP_DISABLE_PIP_VERSION_CHECK="1"))
    assert out.returncode == 0, out.stdout + out.stderr
    wheel, = glob.glob(str(tmp_path / "dist" / "*.whl"))
    names = set(zipfile.ZipFile(wheel).namelist())

    want = set()
    for name in _build.SOURCES + _build.SHAPE_SOURCES + _build.PROBES:
        for path in _build.source_files(name):
            want.add(os.path.relpath(path, ROOT))
    native = glob.glob(os.path.join(ROOT, "scann_tpu_torch", "native", "*.cc"))
    assert len(native) == 2
    want.update(os.path.relpath(p, ROOT) for p in native)
    want.add("scann_tpu_torch/data/assets/cgcnn_features.npz")
    assert any(p.endswith(".cuh") for p in want)
    assert sorted(want - names) == []
    # the JAX package's asset is still there too
    assert "scann_tpu/data/assets/cgcnn_features.npz" in names
