"""scann-tpu-torch: the PyTorch/CUDA port of ``scann_tpu`` for NVIDIA Hopper.

A package of its own beside the JAX package: it imports ``torch`` and never
``jax`` or anything of ``scann_tpu``, and keeps its own copies of the host
code it needs. The layout mirrors the JAX package:

- ``scann_tpu_torch.config``  — the config dataclasses (yaml imported lazily).
- ``scann_tpu_torch.data``    — element tables, ``Structure`` and parsers,
  Voronoi featurization (the port's C++ in ``native/``, or scipy/Qhull) and
  the dataset packer.
- ``scann_tpu_torch.ops``     — plain PyTorch RBF, activations, attention cores.
- ``scann_tpu_torch.models``  — the SCANN / SCANN+ model over a flat
  parameter dict keyed like the flax tree.
- ``scann_tpu_torch.kernels`` — hand-written CUDA kernels (``csrc/``), built
  with nvcc at first use and loaded with ctypes, each beside its plain
  PyTorch version.
- ``scann_tpu_torch.compat``  — Keras H5 weights and flax trees -> params.
- ``scann_tpu_torch.utils``   — timing spans, ``torch.profiler`` traces, the
  FLOP model and the card's measured rates.
- ``scann_tpu_torch.api`` / ``serve`` / ``cli`` — inference, HTTP serving.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from scann_tpu_torch.config import ScannConfig, load_config, save_config  # noqa: F401
