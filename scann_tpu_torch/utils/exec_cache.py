"""The kernel build cache under the JAX package's name (port of
``scann_tpu/utils/exec_cache.py``).

What the JAX package caches as a compiled executable is, on this card, the
library nvcc builds from ``csrc/<name>.cu``: the first process pays the
build (about 100 s for the five kernels, in parallel), every later one
loads it in milliseconds. ``kernels/_build.py`` owns building, keying and
publishing, ``ExecutableCache`` and ``env_fingerprint`` included, and its
docstring states the JAX class's contract as it holds here; this module
re-exports them.

Not ported, for want of a CUDA meaning: executable serialization (the
library is the serialized form), ``_placing_wrapper`` (a kernel launches
on the device of its tensors), ``zeros_like_args`` and the validation of a
disk load on dummies (a library that loads has the symbols the wrappers
call, and each launch checks its own return code), ``args_signature`` and
``batch_signature`` (the kernels take any shape their gates accept; one
library serves every shape).
"""

from scann_tpu_torch.kernels._build import ExecutableCache, env_fingerprint

__all__ = ["ExecutableCache", "env_fingerprint"]
