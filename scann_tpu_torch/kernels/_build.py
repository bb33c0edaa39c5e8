"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
nvcc compiles it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build dir>/lib<name>_<hash>.so csrc/<name>.cu

The build runs at first use, keyed by a hash of the flags, the output of
``nvcc --version`` and of the host compiler's ``--version`` (each read once
a process), the source and every header it includes (``philox.cuh``,
``scann_common.cuh``, ``scann_grad_common.cuh``, ``scann_mma.cuh``,
``scann_forward_common.cuh``): an edited source or header or another
toolchain rebuilds, an unchanged one loads at once. The libraries live in
a build directory, the kernel build cache (``ExecutableCache``, under
its JAX name in ``utils/exec_cache.py``): ``build/scann_tpu_torch/``
beside the package, or a per-user cache directory where that one cannot
be written, or whatever ``set_build_dir`` chose (``tpu.exec_cache_dir``,
``Scann.enable_exec_cache``, ``--exec-cache``), so a second process loads
what the first one built. ``-Xptxas -v`` makes the compiler report each
kernel's registers and spills: the build keeps what nvcc printed beside
the library (``<lib>.so.log``) and in ``build_logs``, and
``kernel_resources`` reads it. ``build_all`` starts one nvcc per source,
all at once. ``SOURCES`` are the ports of the TPU kernels, ``WIDE_SOURCES``
and ``TALL_SOURCES`` their wide and tall builds, ``BF16_SHAPE_SOURCES`` the
wide and tall builds of #4 in the bf16 operand mode, ``WIDTH_SOURCES`` the
builds of widths past 128 (built when a shape or a width needs one;
``SHAPE_SOURCES`` all of these), ``PROBES`` the rate
probes of ``utils/roofline.py``. Nothing here is built at module
import time, and nothing falls back: a failed build raises, and a library
that fails to load is removed and rebuilt once, then raises.

``ExecutableCache`` keeps the JAX class's contract where it has a meaning
here:

- the key covers everything that changes the library (``library_key``:
  flags, nvcc's and the host compiler's versions, the source and its
  headers), so a stale build is never loaded;
- directories are created with mode ``0o700``: a loaded library runs code
  in the loading process, as an unpickled executable does, so whoever can
  write the directory can run code in every process that shares it;
- a library is published by ``os.replace`` of a finished file, so a
  concurrent loader never sees half a file; a builder holds the
  directory's lock (``flock``) while it builds, so the ranks of a job that
  share a directory build each library once: the first builds, the others
  wait and load what it published;
- a library that fails to load is counted (``load_errors``), removed and
  rebuilt once (``compiles``); if the rebuild fails to load too, the load
  raises. This is a rebuild of the same source, never a fallback;
- ``stats`` counts ``mem_hits`` (loaded by this process already),
  ``disk_hits`` (loaded from the directory), ``compiles`` (nvcc runs that
  published a library), ``load_errors``, ``save_errors`` (builds that
  failed) and ``invalidated``; ``invalidate(name)`` drops an entry.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
DEFAULT_BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "scann_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# The two backward kernels' bf16 operand mode (model.dtype "bfloat16") is a
# source of its own each, which includes the f32 one: nvcc compiles the two
# instantiations of the longest builds in parallel.
SOURCES = ("scann_forward", "scann_backward", "scann_loop", "scann_loop_backward",
           "local_attention", "scann_backward_bf16", "scann_loop_backward_bf16")
# The wide builds of kernels #5, #3 and #4 (neighbour lists longer than a
# chunk of rows): sources of their own that include the narrow ones, built
# at the first wide launch (or by ``build_all`` where a caller knows that a
# shape needs one), so the default build is the narrow one.
WIDE_SOURCES = ("local_attention_wide", "scann_loop_wide", "scann_loop_backward_wide")
# The tall builds of kernels #3 and #4 (structures whose centers do not fit a
# block's shared memory beside the narrow plan): the same arrangement, built
# at the first tall launch.
TALL_SOURCES = ("scann_loop_tall", "scann_loop_backward_tall")
# The wide and tall builds of kernel #4 in the bf16 operand mode: a source of
# their own each, as the narrow one has (#3's wide and tall builds hold both
# modes in one library, as its narrow build does), built at the first bf16
# wide or tall launch.
BF16_SHAPE_SOURCES = ("scann_loop_backward_wide_bf16", "scann_loop_backward_tall_bf16")
# The builds of widths past 128 (D, G, O up to 256: 8 values of a row a lane
# in the warp LayerNorms): one source each for #1, the tall and wide #3 and
# the narrow and wide #5, each holding both operand modes, and for the tall
# and wide #4, one a mode as its other builds; the same sources with
# SCANN_WIDTH_256 defined, built at the first launch (or training launch) of
# a wider model, so the builds of widths up to 128 are the ones they were.
# Past 256 (D, G, O up to 512: 16 values a lane, SCANN_WIDTH_512 beside
# SCANN_WIDTH_256) the forwards #1, #3 (tall, wide) and #5 (narrow, wide)
# have one source each too, and the tall and wide #4 one a mode, built the
# same way at the first launch (or training launch) of a model that wide.
WIDTH_SOURCES = ("scann_forward_d256", "scann_loop_tall_d256", "scann_loop_wide_d256",
                 "local_attention_d256", "local_attention_wide_d256",
                 "scann_loop_backward_tall_d256", "scann_loop_backward_wide_d256",
                 "scann_loop_backward_tall_d256_bf16", "scann_loop_backward_wide_d256_bf16",
                 "scann_forward_d512", "scann_loop_tall_d512", "scann_loop_wide_d512",
                 "local_attention_d512", "local_attention_wide_d512",
                 "scann_loop_backward_tall_d512", "scann_loop_backward_wide_d512",
                 "scann_loop_backward_tall_d512_bf16", "scann_loop_backward_wide_d512_bf16")
# Every build made for some shapes only.
SHAPE_SOURCES = WIDE_SOURCES + TALL_SOURCES + BF16_SHAPE_SOURCES + WIDTH_SOURCES
# Sources of the port that are not ports of a TPU kernel: the rate probes of
# utils/roofline.py. Built and loaded the same way.
PROBES = ("roofline_probe",)
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

_ENTRY = re.compile(r"Compiling entry function '(\w+)'.*?Used (\d+) registers", re.S)
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")

_lock = threading.Lock()
_cache = None       # the ExecutableCache that load_library and build_all go through
build_logs: Dict[str, str] = {}   # name -> nvcc's output of the build made by this process
# name -> wall seconds of that build's nvcc, from its start to its exit
build_seconds: Dict[str, float] = {}


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


@functools.lru_cache(maxsize=None)
def tool_version(tool: str) -> str:
    """What ``tool --version`` prints, read once a process ("<tool>: not
    found" where there is no such program: the key still computes, and a
    build would fail on its own)."""
    try:
        out = subprocess.run([tool, "--version"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return f"{tool}: not found"
    return out.stdout + out.stderr


def nvcc_version() -> str:
    try:
        return tool_version(nvcc_path())
    except RuntimeError:
        return "nvcc: not found"


def host_compiler_version() -> str:
    """The version of the host compiler nvcc runs (``NVCC_CCBIN``, which
    nvcc reads too, else ``g++``)."""
    return tool_version(os.environ.get("NVCC_CCBIN") or "g++")


def _writable_dir(path: str) -> bool:
    try:
        os.makedirs(path, mode=0o700, exist_ok=True)
    except OSError:
        return False
    return os.access(path, os.W_OK | os.X_OK)


def user_cache_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(base, "scann_tpu_torch", "build")


def default_build_dir() -> str:
    """``build/scann_tpu_torch/`` beside the package where it can be written
    (a checkout), else the per-user cache directory (an installed package)."""
    return DEFAULT_BUILD_DIR if _writable_dir(DEFAULT_BUILD_DIR) else user_cache_dir()


def cache():
    """The kernel build cache this process builds into and loads from
    (``default_build_dir()`` until ``set_build_dir``)."""
    global _cache
    with _lock:
        if _cache is None:
            _cache = ExecutableCache(default_build_dir())
        return _cache


def set_build_dir(path: str):
    """Build into and load from ``path`` from now on, for the whole process
    (libraries already loaded stay loaded); returns its ``ExecutableCache``.
    Raises OSError where the directory cannot be created."""
    global _cache
    path = os.path.abspath(os.path.expanduser(path))
    with _lock:
        if _cache is None or _cache.cache_dir != path:
            _cache = ExecutableCache(path)
        return _cache


def build_dir() -> str:
    return cache().cache_dir


def kernel_resources(name: str) -> List[Tuple[str, int, int, int]]:
    """(mangled kernel name, registers per thread, bytes of spill stores,
    bytes of spill loads) of every kernel of ``csrc/<name>.cu``, from what
    ``ptxas -v`` printed when this process built it, else from the log kept
    beside the cached library (empty if neither exists)."""
    log = build_logs.get(name)
    if log is None:
        try:
            with open(library_path(name) + ".log") as f:
                log = f.read()
        except OSError:
            log = ""
    out = []
    for m in _ENTRY.finditer(log):
        spill = _SPILL.search(m.group(0))
        out.append((m.group(1), int(m.group(2)),
                    int(spill.group(1)) if spill else 0, int(spill.group(2)) if spill else 0))
    return out


def library_key(name: str) -> str:
    """The hash of everything that changes the library of ``csrc/<name>.cu``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(b"\0nvcc\0" + nvcc_version().encode())
    digest.update(b"\0host\0" + host_compiler_version().encode())
    for path in source_files(name):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return digest.hexdigest()[:16]


def library_path(name: str, directory: Optional[str] = None) -> str:
    return os.path.join(directory or build_dir(), f"lib{name}_{library_key(name)}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    """Start nvcc on ``csrc/<name>.cu`` into a temporary file beside ``out``
    (``proc.scann_tmp``); the caller publishes it."""
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.scann_tmp = tmp  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: subprocess.Popen, t0: float) -> None:
    """Wait for one nvcc started at ``t0`` (read its output to the end) and
    keep its log and wall seconds in ``build_logs`` and ``build_seconds``."""
    build_logs[name], _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0


def build_all(names: Iterable[str] = SOURCES, force: bool = False) -> Dict[str, str]:
    """Compile every missing library (every one with ``force``) in
    parallel, into the build cache; returns name -> .so path."""
    return cache().build(tuple(names), force)


def load_library(name: str):
    """The built library for ``csrc/<name>.cu`` (a ``ctypes.CDLL``),
    through the build cache: building it if needed."""
    return cache().get_or_compile(name)


def env_fingerprint() -> str:
    """The environment of this process's builds and launches: torch and
    its CUDA runtime, the card's name and compute capability, nvcc's
    version (the part of it that changes a library is in the key)."""
    import torch

    dev = {"device": None, "capability": None}
    if torch.cuda.is_available():
        dev = {"device": torch.cuda.get_device_name(0),
               "capability": list(torch.cuda.get_device_capability(0))}
    return json.dumps({"torch": torch.__version__, "cuda_runtime": torch.version.cuda,
                       "nvcc": nvcc_version().strip(), **dev},
                      sort_keys=True)


@contextmanager
def _directory_lock(path: str):
    """An exclusive ``flock`` on the directory ``path``, across processes
    (and across the threads of one, each with its own descriptor)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)        # closing the descriptor releases the lock


class ExecutableCache:
    """Disk and in-process cache of the kernels' built libraries, keyed by
    ``library_key`` (the contract is in the module docstring). Thread-safe:
    one build or load at a time."""

    def __init__(self, cache_dir: str):
        self.cache_dir = os.path.abspath(cache_dir)
        # mode= applies to the directories makedirs creates; one that exists
        # keeps its permissions
        os.makedirs(self.cache_dir, mode=0o700, exist_ok=True)
        self._libs: Dict[str, ctypes.CDLL] = {}
        self._lock = threading.Lock()
        self.stats = {"mem_hits": 0, "disk_hits": 0, "compiles": 0,
                      "load_errors": 0, "save_errors": 0, "invalidated": 0}

    def path(self, name: str) -> str:
        return library_path(name, self.cache_dir)

    def _compile(self, names: Iterable[str], force: bool) -> Dict[str, str]:
        paths = {n: self.path(n) for n in names}
        with _directory_lock(self.cache_dir):
            # what another process published while this one waited is not built again
            t0 = time.perf_counter()
            procs = {n: _start(n, p) for n, p in paths.items()
                     if force or not os.path.exists(p)}
            errors = []
            # one waiter a build, so that each build's seconds end at its own exit
            waiters = [threading.Thread(target=_finish, args=(name, proc, t0))
                       for name, proc in procs.items()]
            for t in waiters:
                t.start()
            for t in waiters:
                t.join()
            for name, proc in procs.items():
                log = build_logs[name]
                out, tmp = paths[name], proc.scann_tmp
                if proc.returncode != 0:
                    if os.path.exists(tmp):
                        os.remove(tmp)
                    self.stats["save_errors"] += 1
                    errors.append(f"nvcc failed for {name}.cu:\n{log}")
                    continue
                with open(tmp + ".log", "w") as f:
                    f.write(log)
                os.replace(tmp + ".log", out + ".log")
                os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
                self.stats["compiles"] += 1
        if errors:
            raise RuntimeError("\n".join(errors))
        return paths

    def build(self, names: Iterable[str], force: bool = False) -> Dict[str, str]:
        """Compile every missing library of ``names`` (every one with
        ``force``), one nvcc each, all at once; returns name -> path."""
        with self._lock:
            return self._compile(names, force)

    def get_or_compile(self, name: str) -> ctypes.CDLL:
        """The loaded library of ``csrc/<name>.cu``: this process's, else
        the directory's, else a fresh build. A library that fails to load
        is removed and rebuilt once; a second failure raises OSError."""
        with self._lock:
            lib = self._libs.get(name)
            if lib is not None:
                self.stats["mem_hits"] += 1
                return lib
            path = self.path(name)
            if os.path.exists(path):
                try:
                    lib = ctypes.CDLL(path)
                    self.stats["disk_hits"] += 1
                except OSError:
                    self.stats["load_errors"] += 1
                    os.remove(path)
            if lib is None:
                self._compile([name], force=False)
                lib = ctypes.CDLL(path)
            self._libs[name] = lib
            return lib

    def invalidate(self, name: str) -> None:
        """Drop ``name``'s library from this cache and its directory, so the
        next ``get_or_compile`` builds it anew (a library this process has
        loaded stays mapped: the loader cannot take it back)."""
        with self._lock:
            self._libs.pop(name, None)
            self.stats["invalidated"] += 1
            path = self.path(name)
            for f in (path, path + ".log"):
                try:
                    os.remove(f)
                except FileNotFoundError:
                    pass
