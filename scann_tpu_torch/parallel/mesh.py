"""The rank layout of a data-parallel job (port of
``scann_tpu/parallel/mesh.py``).

The JAX package lays a 1-D ``('data',)`` mesh over every chip of a job and
lets XLA insert the gradient all-reduce. Here one process drives one GPU:
the layout is this process's rank, the world size and its device,
``distributed.local_device()`` (``cuda:{LOCAL_RANK}`` under torchrun). Parameters and buckets are replicated on every
rank, and each step's batch rows are split into equal contiguous slices in
rank order (``batch_shard``), which ``kernels/sharded.py`` runs and
gathers back in that order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from scann_tpu_torch.parallel.distributed import (
    local_device,
    process_count,
    process_index,
)


class RankLayout(NamedTuple):
    """World size, this process's rank and the device it drives."""

    world: int
    rank: int
    device: torch.device


def hierarchical_order(devices: Sequence) -> list:
    """Order devices node-major: stable sort on (node, local rank, device
    index), each read from the attribute of that name (``node_index``,
    ``local_rank``, ``index``; 0 where absent), so each node's ranks stay
    contiguous in the rank order and a collective keeps its traffic on the
    shortest links (NVLink inside a node) before it crosses nodes. The
    JAX function's contract with (slice, process, device id)."""
    keyed = []
    for i, d in enumerate(devices):
        idx = getattr(d, "index", None)
        keyed.append(((getattr(d, "node_index", 0) or 0, getattr(d, "local_rank", 0) or 0,
                       idx if idx is not None else i), d))
    keyed.sort(key=lambda kv: kv[0])
    return [d for _, d in keyed]


def make_mesh(n_devices: Optional[int] = None) -> RankLayout:
    """This process's place in the job: the process group's world size and
    rank (1 and 0 without one) and its card, ``local_device()``. ``n_devices``, when
    given, must equal the world size: one process drives one GPU."""
    world, rank = process_count(), process_index()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"need {n_devices} processes (one a GPU), the job has {world}: start "
                         "one process a GPU (torchrun --nproc-per-node, or "
                         "parallel.initialize in each)")
    return RankLayout(world, rank, local_device())


def batch_shard(rank: int, world: int, B: int) -> slice:
    """The rows of a batch of ``B`` that ``rank`` owns: the rank-th of
    ``world`` equal contiguous slices. ``B`` must be a multiple of
    ``world``, as the JAX mesh's batch sharding requires."""
    if B % world:
        raise ValueError(f"a batch of {B} rows does not split over {world} ranks: the batch "
                         "must be a multiple of the world size")
    b = B // world
    return slice(rank * b, (rank + 1) * b)


def batch_sharding(mesh: RankLayout, B: int) -> slice:
    """The rows of a batch of ``B`` that this layout's rank owns (the JAX
    name: its ``P('data')`` sharding of the leading axis)."""
    return batch_shard(mesh.rank, mesh.world, B)


def replicated_sharding(mesh: RankLayout) -> torch.device:
    """Where this rank keeps its copy of what every rank holds (parameters,
    buckets): its device (the JAX name: its ``P()`` sharding)."""
    return mesh.device
