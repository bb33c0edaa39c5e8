"""Multi-process data parallelism over ``torch.distributed`` (port of
``scann_tpu/parallel/distributed.py``).

PyTorch's idiom: one process per GPU. Every process runs the same
deterministic pipeline (same dataset files, same split seed) and holds the
same buckets and the same parameters; each step, each rank runs its slice
of the batch's rows through the same kernel launch a single process would
(``kernels/sharded.py``), and the raw gradients are gathered and summed in
rank order, so every rank applies the same update and a run repeats bit
for bit.

- ``initialize`` joins the process group. Its arguments resolve as the JAX
  package's do: explicit arguments, then ``SCANN_TPU_COORDINATOR`` /
  ``SCANN_TPU_NUM_PROCESSES`` / ``SCANN_TPU_PROCESS_ID``, then torchrun's
  ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``;
  ``SCANN_TPU_DISTRIBUTED=1`` asks for the job without naming it. The
  backend is the caller's or, by default, ``"nccl"`` for CUDA and
  ``"gloo"`` for the CPU; nothing switches it at run time. Two ranks on one
  card need ``"gloo"``: NCCL refuses them.
- A rank drives one card, ``local_device()``: ``cuda:{LOCAL_RANK}``
  (torchrun), else its rank modulo the host's cards. On NCCL ``initialize``
  makes it the current device before it joins, and the collectives run
  there; ``mesh.make_mesh`` and the Trainer, given just ``"cuda"``, place
  the rank's work there too.
- Replica consistency is checked, not assumed: ``put_replicated(check=True)``
  gathers a crc32 digest of each rank's copy and raises on divergence.
- Exactly-once side effects (config.yaml, metrics.jsonl, report.txt,
  hist_data.json, checkpoints) are written by ``is_primary()`` only.
"""

from __future__ import annotations

import os
import zlib
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize",
    "is_multiprocess",
    "is_primary",
    "process_count",
    "process_index",
    "put_replicated",
    "fetch",
    "check_replicas_match",
    "gather_ordered",
    "local_device",
]


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Idempotent ``torch.distributed.init_process_group``.

    ``coordinator_address`` is ``host:port`` of rank 0. Returns True if the
    process group is (now) initialized, False if nothing indicated a
    multi-process job. A second call is a no-op."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("SCANN_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("SCANN_TPU_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("SCANN_TPU_PROCESS_ID")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if (coordinator_address is None and num_processes is None and process_id is None
            and os.environ.get("SCANN_TPU_DISTRIBUTED") != "1"):
        return False
    missing = [n for n, v in (("coordinator address", coordinator_address),
                              ("number of processes", num_processes),
                              ("process id", process_id)) if v is None]
    if missing:
        raise ValueError(
            f"a multi-process job needs {', '.join(missing)}: pass them, set "
            "SCANN_TPU_COORDINATOR / SCANN_TPU_NUM_PROCESSES / SCANN_TPU_PROCESS_ID, or "
            "start under torchrun (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        # every rank's collectives on its own card: NCCL refuses two on one
        torch.cuda.set_device(_local_index(int(process_id)))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    return True


def _local_index(rank: int) -> int:
    local = _env_int("LOCAL_RANK")
    if local is not None:
        return local
    return rank % max(torch.cuda.device_count(), 1)


def local_device() -> torch.device:
    """The card this process drives: ``cuda:{LOCAL_RANK}`` where torchrun
    set it, else, in a job, the rank modulo the host's cards (ranks are
    numbered host by host), else the current device."""
    if _env_int("LOCAL_RANK") is not None or dist.is_initialized():
        return torch.device("cuda", _local_index(process_index()))
    return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on the process that owns exactly-once side effects (writes of
    metrics, report, config and checkpoints)."""
    return process_index() == 0


def _leaves(tree: Any, path: str = ""):
    """(path, leaf) pairs of a tree of dicts, lists and tuples, dict keys
    sorted, as ``jax.tree_util`` orders them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree_digest(tree: Any) -> int:
    """Order-stable crc32 of a tree's structure, shapes, dtypes and bytes.
    Not cryptographic: it guards against honest divergence (different
    files, a featurization order that differs), not adversaries."""
    crc = 0
    for path, leaf in _leaves(tree):
        a = _host(leaf)
        crc = zlib.crc32(str((path, a.shape, a.dtype.str)).encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc


def _collective_device() -> torch.device:
    """Where a tensor handed to a collective must live for this backend."""
    if dist.get_backend() == "nccl":
        return local_device()
    return torch.device("cpu")


def gather_ordered(t: torch.Tensor) -> list:
    """Every rank's ``t`` (same shape and dtype on every rank), in rank
    order, on ``t``'s device. Through a host copy where the backend needs
    one (gloo with CUDA tensors)."""
    if not is_multiprocess():
        return [t]
    dev = _collective_device()
    src = t.detach().contiguous().to(dev)
    parts = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(parts, src)
    return [p.to(t.device) for p in parts]


def check_replicas_match(tree: Any, what: str = "data") -> None:
    """Raise if ``tree``'s content differs across processes: replicated
    buckets are correct only when every process supplies the same bytes."""
    if not is_multiprocess():
        return
    digest = torch.tensor([_tree_digest(tree)], dtype=torch.int64)
    all_digests = [int(d) for d in gather_ordered(digest)]
    if len(set(all_digests)) != 1:
        raise RuntimeError(
            f"multi-process replica mismatch for {what!r}: per-process "
            f"content digests {all_digests} differ. Every "
            "process must load identical data (same dataset files, same "
            "split seed) for the replicated-bucket layout; check that "
            "preprocessing is deterministic and the filesystems agree.")


def _to_device(x: Any, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x)).to(device)


def put_replicated(tree: Any, device, check: bool = False, what: str = "data") -> Any:
    """A tree of host arrays as tensors on ``device``, the same tree on
    every rank; ``check=True`` first verifies that the ranks' copies agree
    (one small gather)."""
    if check:
        check_replicas_match(tree, what=what)
    device = torch.device(device)

    def put(t):
        if isinstance(t, dict):
            return {k: put(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(put(v) for v in t)
        return _to_device(t, device)

    return put(tree)


def fetch(tree: Any) -> Any:
    """Host numpy copy of a tree of tensors (every rank holds the whole
    replicated state, so each reads its own copy)."""
    if isinstance(tree, dict):
        return {k: fetch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch(v) for v in tree)
    return _host(tree)
