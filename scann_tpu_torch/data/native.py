"""Host C++ of the port, built with g++ and loaded with ctypes (the
counterpart of ``scann_tpu/data/native.py``), and the binding of the
dataset packer ``native/packer.cc``.

``build_shared_library`` compiles one of the port's ``native/*.cc`` at
first use:

    g++ -O3 -march=native -shared -fPIC native/<name>.cc \\
        -o build/scann_tpu_torch/host/lib<name>_<hash>.so

into the ignored ``build/`` beside the package, keyed by a hash of the
source bytes, the flags and the host CPU's model name (``-march=native``
code runs only on the CPU it was built for), written to a temporary name
and moved into place with ``os.replace``, so concurrent builders never
load half a file. A failed build raises: nothing falls back to numpy.
``data/pipeline.pack_bucket_plain`` and ``structure_sizes_plain`` are the
numpy version of the packer, kept for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Callable, Dict

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "scann_tpu_torch", "host")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def cpu_model() -> str:
    """The host CPU's model name (``/proc/cpuinfo``), else the machine type."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine() or "unknown"


def library_path(src: str) -> str:
    """Where the build of ``src`` goes: named by a hash of its bytes, the
    flags and the CPU model."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0" + cpu_model().encode())
    with open(src, "rb") as f:
        digest.update(b"\0" + f.read())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_shared_library(src: str, force: bool = False) -> str:
    """Compile ``src`` (a C++ file) with g++ unless its build is there;
    returns the library's path. Raises when g++ is missing or fails."""
    out = library_path(src)
    if os.path.exists(out) and not force:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp], capture_output=True,
                              text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the port builds {os.path.basename(src)} "
                           "at first use") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed for {os.path.basename(src)}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The built library of ``native/<name>.cc``, building it if needed;
    ``declare`` sets its functions' ctypes signatures once, when it loads."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_shared_library(os.path.join(SRC_DIR, f"{name}.cc")))
            declare(lib)
            _libs[name] = lib
        return lib


I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _declare_packer(lib: ctypes.CDLL) -> None:
    lib.pack_bucket.argtypes = [
        I32P, ctypes.c_int64,          # rows
        I64P, I64P,                    # atom/nbr offsets
        I32P, I32P, F32P, F32P,        # atomic, nbr_index, weight, dist
        ctypes.c_int64, ctypes.c_int64,  # M, N
        I32P, F32P, I32P, F32P, F32P, F32P,  # outputs
    ]
    lib.pack_bucket.restype = None
    lib.structure_sizes.argtypes = [I64P, ctypes.c_int64, I64P, I32P, I32P]
    lib.structure_sizes.restype = None


def get_lib() -> ctypes.CDLL:
    """The packer library, built at first use."""
    return load_library("packer", _declare_packer)


def pack_bucket_native(rows, atom_offsets, nbr_offsets, atomic, nbr_index,
                       nbr_weight, nbr_dist, M: int, N: int) -> Dict[str, np.ndarray]:
    """The padded arrays of the structures ``rows`` (atomic numbers, before
    any feature expansion), filled by ``native/packer.cc``: atoms beyond M
    and neighbours beyond N are cut, as the numpy fill cuts them."""
    S = len(rows)
    out = {
        "atomic": np.zeros((S, M), np.int32),
        "atom_mask": np.zeros((S, M, 1), np.float32),
        "neighbors": np.zeros((S, M, N), np.int32),
        "neighbor_mask": np.zeros((S, M, N), np.float32),
        "neighbor_weight": np.zeros((S, M, N), np.float32),
        "neighbor_distance": np.zeros((S, M, N), np.float32),
    }
    rows = np.ascontiguousarray(rows, np.int32)
    if S and (rows.min() < 0 or rows.max() >= len(atom_offsets) - 1):
        raise IndexError(f"rows out of range for {len(atom_offsets) - 1} structures")
    get_lib().pack_bucket(
        rows, S, np.ascontiguousarray(atom_offsets, np.int64),
        np.ascontiguousarray(nbr_offsets, np.int64), np.ascontiguousarray(atomic, np.int32),
        np.ascontiguousarray(nbr_index, np.int32), np.ascontiguousarray(nbr_weight, np.float32),
        np.ascontiguousarray(nbr_dist, np.float32), M, N,
        out["atomic"], out["atom_mask"], out["neighbors"], out["neighbor_mask"],
        out["neighbor_weight"], out["neighbor_distance"])
    return out


def structure_sizes_native(atom_offsets, nbr_offsets):
    """(atom count, largest neighbour count) of every structure."""
    atom_offsets = np.ascontiguousarray(atom_offsets, np.int64)
    n_struct = len(atom_offsets) - 1
    n_atoms = np.zeros(n_struct, np.int32)
    max_nbrs = np.zeros(n_struct, np.int32)
    get_lib().structure_sizes(atom_offsets, n_struct,
                              np.ascontiguousarray(nbr_offsets, np.int64), n_atoms, max_nbrs)
    return n_atoms, max_nbrs
