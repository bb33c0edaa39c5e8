"""The PyTorch port stands alone: importing it (and its API, training,
serving, dataset builders, CLI, build-cache and data-parallel modules) in a
fresh interpreter loads
neither JAX nor any module of the JAX package ``scann_tpu``, and needs
neither yaml nor h5py."""

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
        "import scann_tpu_torch.data.native, scann_tpu_torch.data.native_voronoi\n"
        "import scann_tpu_torch.data.builders, scann_tpu_torch.cli.preprocess\n"
        "import scann_tpu_torch.cli.export, scann_tpu_torch.utils.exec_cache\n"
        "import scann_tpu_torch.parallel, scann_tpu_torch.parallel.distributed\n"
        "import scann_tpu_torch.parallel.mesh, scann_tpu_torch.kernels.sharded")
    assert "scann_tpu_torch.train.loop" in mods
    assert "scann_tpu_torch.utils.roofline" in mods
    assert "scann_tpu_torch.data.native_voronoi" in mods
    assert "scann_tpu_torch.api" in mods
    assert "scann_tpu_torch.kernels.scann_loop" in mods
    assert "scann_tpu_torch.kernels.local_attention" in mods
    assert "scann_tpu_torch.kernels._build" in mods
    assert "scann_tpu_torch.data.builders.trajectories" in mods
    assert "scann_tpu_torch.cli.export" in mods
    for mod in ("utils.exec_cache", "parallel", "parallel.distributed", "parallel.mesh",
                "kernels.sharded"):
        assert f"scann_tpu_torch.{mod}" in mods
    leaked = [m for m in mods
              if m in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "h5py")
              or m.startswith(("jax.", "jaxlib.", "flax.", "optax.", "orbax."))
              or m == "scann_tpu" or m.startswith("scann_tpu.")]
    assert leaked == []


def test_torch_port_sources_name_no_jax_package():
    """No source file of the port, nor ``chip_smoke.py``, imports JAX or the
    JAX package, at module level or inside a function."""
    pkg = os.path.join(ROOT, "scann_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    bad = []
    for path in paths:
        for line in open(path):
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0].rstrip(",")
                if mod in ("jax", "jaxlib", "flax", "optax", "orbax", "scann_tpu"):
                    bad.append(f"{os.path.relpath(path, ROOT)}: {line.strip()}")
    assert bad == []


def test_torch_port_kernel_sources_stand_alone():
    """Every CUDA source the port builds exists, includes only headers of its
    own directory, and those exist; the crystal loop backward is one of them
    and the module that wraps it exposes the JAX package's names."""
    sys.path.insert(0, ROOT)
    from scann_tpu_torch.kernels import _build, scann_loop

    assert set(_build.SOURCES) == {"scann_forward", "scann_backward", "scann_loop",
                                   "scann_loop_backward", "local_attention",
                                   "scann_backward_bf16", "scann_loop_backward_bf16"}
    assert set(_build.SHAPE_SOURCES) == {
        "local_attention_wide", "scann_loop_wide", "scann_loop_backward_wide",
        "scann_loop_tall", "scann_loop_backward_tall", "scann_loop_backward_wide_bf16",
        "scann_loop_backward_tall_bf16", "scann_forward_d256", "scann_loop_tall_d256",
        "scann_loop_wide_d256", "local_attention_d256", "local_attention_wide_d256",
        "scann_loop_backward_tall_d256", "scann_loop_backward_wide_d256",
        "scann_loop_backward_tall_d256_bf16", "scann_loop_backward_wide_d256_bf16",
        "scann_forward_d512", "scann_loop_tall_d512", "scann_loop_wide_d512",
        "local_attention_d512", "local_attention_wide_d512",
        "scann_loop_backward_tall_d512", "scann_loop_backward_wide_d512",
        "scann_loop_backward_tall_d512_bf16", "scann_loop_backward_wide_d512_bf16"}
    for name in _build.SOURCES + _build.SHAPE_SOURCES:
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


def test_torch_twins_name_no_jax_package():
    """No line of the port's user-facing scripts (``examples_torch/``,
    ``tools/*_torch.py``) imports JAX or the JAX package, at module level or
    inside a function (``interpretability.demo_model`` too), and each names
    the JAX script it mirrors."""
    twins = {os.path.join("examples_torch", f): os.path.join("examples", f)
             for f in sorted(os.listdir(os.path.join(ROOT, "examples_torch")))
             if f.endswith(".py")}
    twins.update({os.path.join("tools", f"{n}_torch.py"): os.path.join("tools", f"{n}.py")
                  for n in ("make_notebooks", "run_accuracy")})
    assert len(twins) == 6
    bad = []
    for twin, jax_script in twins.items():
        assert os.path.exists(os.path.join(ROOT, jax_script)), jax_script
        text = open(os.path.join(ROOT, twin)).read()
        assert f"``{jax_script}``" in text, twin
        assert "scann_tpu_torch" in text and 'default="cuda"' in text, twin
        for line in text.splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0].rstrip(",")
                if mod in ("jax", "jaxlib", "flax", "optax", "orbax", "scann_tpu"):
                    bad.append(f"{twin}: {line.strip()}")
    assert bad == []
