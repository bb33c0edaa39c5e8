"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
nvcc compiles it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/scann_tpu_torch/lib<name>_<hash>.so csrc/<name>.cu

The build runs at first use, into ``build/scann_tpu_torch/`` beside the
package, keyed by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads at once. The hash covers the source
and every header it includes (``philox.cuh``, ``scann_common.cuh``,
``scann_grad_common.cuh``, ``scann_mma.cuh``, ``scann_forward_common.cuh``), so
an edited header rebuilds every library that includes it. ``-Xptxas -v``
makes the compiler report each kernel's registers and spills:
``build_logs`` keeps what nvcc printed and ``kernel_resources`` reads it.
``build_all`` starts one nvcc per source, all at once. ``SOURCES`` are the
ports of the TPU kernels, ``PROBES`` the rate probes of
``utils/roofline.py``. Nothing here is imported from or built at module
import time, and nothing falls back: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "scann_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("scann_forward", "scann_backward", "scann_loop", "scann_loop_backward",
           "local_attention")
# Sources of the port that are not ports of a TPU kernel: the rate probes of
# utils/roofline.py. Built and loaded the same way.
PROBES = ("roofline_probe",)
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

_ENTRY = re.compile(r"Compiling entry function '(\w+)'.*?Used (\d+) registers", re.S)
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}   # name -> nvcc's output of the build made by this process


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def source_files(name: str) -> List[str]:
    """``csrc/<name>.cu`` and every ``#include "..."`` it reaches, in
    first-seen order: all of them go into the build's hash."""
    seen: List[str] = []
    todo = [os.path.join(SRC_DIR, f"{name}.cu")]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path) as f:
            for m in _INCLUDE.finditer(f.read()):
                todo.append(os.path.join(os.path.dirname(path), m.group(1)))
    return seen


def kernel_resources(name: str) -> List[Tuple[str, int, int, int]]:
    """(mangled kernel name, registers per thread, bytes of spill stores,
    bytes of spill loads) of every kernel of ``csrc/<name>.cu``, from what
    ``ptxas -v`` printed when this process built it (empty if it did not)."""
    out = []
    for m in _ENTRY.finditer(build_logs.get(name, "")):
        spill = _SPILL.search(m.group(0))
        out.append((m.group(1), int(m.group(2)),
                    int(spill.group(1)) if spill else 0, int(spill.group(2)) if spill else 0))
    return out


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _start(name: str) -> subprocess.Popen:
    out = library_path(name)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.scann_paths = (tmp, out)  # type: ignore[attr-defined]
    return proc


def build_all(names: Iterable[str] = SOURCES, force: bool = False) -> Dict[str, str]:
    """Compile every missing library (every one with ``force``) in
    parallel; returns name -> .so path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {n: _start(n) for n in names
             if force or not os.path.exists(library_path(n))}
    errors = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        tmp, out = proc.scann_paths
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _libs[name] = ctypes.CDLL(path)
        return lib
