"""The PyTorch port stands alone: importing it (and its API, training,
serving and CLI modules) in a fresh interpreter loads neither JAX nor any
module of the JAX package ``scann_tpu``, and needs neither yaml nor h5py."""

import json
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules_after(code: str) -> list:
    probe = (code + "\nimport json, sys\n"
             "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_torch_port_imports_no_jax_and_no_scann_tpu():
    mods = _modules_after(
        "import scann_tpu_torch, scann_tpu_torch.api, scann_tpu_torch.serve\n"
        "import scann_tpu_torch.cli.serve, scann_tpu_torch.cli.predict_files\n"
        "import scann_tpu_torch.compat, scann_tpu_torch.kernels.scann_forward\n"
        "import scann_tpu_torch.kernels.scann_backward, scann_tpu_torch.ops.dropout\n"
        "import scann_tpu_torch.kernels.scann_loop, scann_tpu_torch.kernels.local_attention\n"
        "import scann_tpu_torch.train.loop, scann_tpu_torch.train.schedules\n"
        "import scann_tpu_torch.data.pipeline, scann_tpu_torch.data.synthetic\n"
        "import scann_tpu_torch.data.featurize, scann_tpu_torch.kernels._build\n"
        "import scann_tpu_torch.cli.train, scann_tpu_torch.cli.predict_model\n"
        "import scann_tpu_torch.utils, scann_tpu_torch.utils.flops\n"
        "import scann_tpu_torch.utils.roofline, scann_tpu_torch.utils.profiling\n"
        "import scann_tpu_torch.data.native, scann_tpu_torch.data.native_voronoi")
    assert "scann_tpu_torch.train.loop" in mods
    assert "scann_tpu_torch.utils.roofline" in mods
    assert "scann_tpu_torch.data.native_voronoi" in mods
    assert "scann_tpu_torch.api" in mods
    assert "scann_tpu_torch.kernels.scann_loop" in mods
    assert "scann_tpu_torch.kernels.local_attention" in mods
    assert "scann_tpu_torch.kernels._build" in mods
    leaked = [m for m in mods
              if m in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "h5py")
              or m.startswith(("jax.", "jaxlib.", "flax.", "optax.", "orbax."))
              or m == "scann_tpu" or m.startswith("scann_tpu.")]
    assert leaked == []


def test_torch_port_sources_name_no_jax_package():
    """No source file of the port imports JAX or the JAX package."""
    pkg = os.path.join(ROOT, "scann_tpu_torch")
    bad = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            for line in open(os.path.join(dirpath, f)):
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    mod = words[1].split(".")[0].rstrip(",")
                    if mod in ("jax", "jaxlib", "flax", "optax", "orbax", "scann_tpu"):
                        bad.append(f"{f}: {line.strip()}")
    assert bad == []


def test_torch_port_kernel_sources_stand_alone():
    """Every CUDA source the port builds exists, includes only headers of its
    own directory, and those exist; the crystal loop backward is one of them
    and the module that wraps it exposes the JAX package's names."""
    sys.path.insert(0, ROOT)
    from scann_tpu_torch.kernels import _build, scann_loop

    assert set(_build.SOURCES) == {"scann_forward", "scann_backward", "scann_loop",
                                   "scann_loop_backward", "local_attention"}
    for name in _build.SOURCES:
        files = _build.source_files(name)
        assert files[0].endswith(f"{name}.cu")
        for f in files:
            assert os.path.dirname(f) == _build.SRC_DIR and os.path.exists(f), f
            assert "#include <torch" not in open(f).read()     # a plain C interface
    for fn in ("loop_scann_forward", "loop_scann_grad", "loop_scann_train_grads",
               "loop_scann_apply", "launch_loop_backward", "reference_loop_grad",
               "reference_loop_train_grads", "loop_backward_flops", "loop_recompute_flops"):
        assert callable(getattr(scann_loop, fn))
    assert scann_loop.BACKWARD_SOURCE == "scann_tpu_torch/csrc/scann_loop_backward.cu"
