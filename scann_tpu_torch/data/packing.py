"""Structure packing: several structures per padded (M, N) slot (port of
``scann_tpu/data/packing.py``; the host arrays are the JAX module's,
element for element).

The default pipeline (``pipeline.pack_dataset``) pads one structure per
slot inside (M, N) buckets, and the whole-model kernels spend their time on
rows whether or not they hold atoms. This module bin-packs whole
structures into fixed-capacity slots instead:

- one static (M, N) shape for the whole dataset;
- slot occupancy set by best-fit-decreasing bin packing (``plan_slots``,
  deterministic) instead of the size distribution;
- exactness: neighbour indices are per structure and get offset to the
  structure's rows, so LocalAttention is untouched; every cross-structure
  reduction (the GA readout, the loss) becomes per segment through a
  [slot, M, S] one-hot (``ops.attention.global_attention_core``) or, in the
  kernels, a per-row segment id (``ops.attention.segment_ids``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from scann_tpu_torch.data.atomic_data import get_atomic_features
from scann_tpu_torch.data.pipeline import _round_up, build_csr


@dataclasses.dataclass
class PackedSlots:
    """Fixed-shape packed arrays: ``slots`` structures per padded row block.

    ``inputs`` carries the standard model keys plus ``segment_onehot``
    [S, M, SEG] and ``segment_mask`` [S, SEG]; ``targets``/``indices`` are
    [S, SEG] (``indices`` = original dataset index, -1 for an empty segment).
    """

    inputs: Dict[str, np.ndarray]
    targets: np.ndarray
    indices: np.ndarray

    @property
    def num_structures(self) -> int:
        return int((self.indices >= 0).sum())

    @property
    def num_slots(self) -> int:
        return len(self.targets)

    @property
    def num_segments(self) -> int:
        return self.targets.shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        m = self.inputs["atomic"].shape[1]
        n = self.inputs["neighbors"].shape[2]
        return m, n

    @property
    def occupancy(self) -> float:
        """Fraction of slot rows that hold real atoms."""
        am = self.inputs["atom_mask"]
        return float(am.sum() / (am.shape[0] * am.shape[1]))


def packed_slot_batch(batch_size: int, n_slots: int, n_structs: int,
                      n_devices: int = 1) -> int:
    """Slots per optimizer step so each step sees ~``batch_size`` STRUCTURES.

    The ``tpu.pack_preserve_batch`` rounding of the JAX package, kept as
    it is so both packages train on the same slot batch: round down to a
    multiple of 16, falling back to 4, and to a multiple of ``n_devices``
    (the JAX package's batch tiles divide the batch and its mesh splits
    it; the CUDA kernels take any batch)."""
    import math

    slot_bs = max(1, round(batch_size * n_slots / max(1, n_structs)))
    mult = n_devices
    for cand in (16, 4):
        if slot_bs >= math.lcm(cand, n_devices):
            mult = math.lcm(cand, n_devices)
            break
    return max(mult, (slot_bs // mult) * mult)


def plan_slots(
    atom_counts: np.ndarray,
    capacity: int,
    max_segments: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Best-fit-decreasing bin packing of structures into capacity-row slots.

    Returns (slot_of, offset_of, segment_of, n_slots, max_used_segments):
    structure i occupies rows [offset_of[i], offset_of[i] + atom_counts[i])
    of slot slot_of[i] as its segment_of[i]-th segment. Deterministic
    (stable sort) so packings reproduce across runs.
    """
    atom_counts = np.asarray(atom_counts, np.int64)
    if len(atom_counts) and int(atom_counts.max()) > capacity:
        big = int(np.argmax(atom_counts))
        raise ValueError(
            f"structure {big} has {int(atom_counts[big])} atoms > slot "
            f"capacity {capacity}")
    if len(atom_counts) and int(atom_counts.min()) <= 0:
        raise ValueError("structures must have at least one atom")

    order = np.argsort(-atom_counts, kind="stable")
    slot_of = np.empty(len(atom_counts), np.int64)
    offset_of = np.empty(len(atom_counts), np.int64)
    segment_of = np.empty(len(atom_counts), np.int64)

    # open slots bucketed by remaining space; by_space[r] = slot ids with
    # exactly r free rows (LIFO — recently opened first)
    by_space: List[List[int]] = [[] for _ in range(capacity + 1)]
    rows_used: List[int] = []
    segs_used: List[int] = []

    for i in order:
        na = int(atom_counts[i])
        # best fit: the smallest adequate remaining space
        slot = -1
        for space in range(na, capacity + 1):
            bucket = by_space[space]
            if bucket:
                slot = bucket.pop()
                break
        if slot == -1:
            slot = len(rows_used)
            rows_used.append(0)
            segs_used.append(0)
        slot_of[i] = slot
        offset_of[i] = rows_used[slot]
        segment_of[i] = segs_used[slot]
        rows_used[slot] += na
        segs_used[slot] += 1
        rem = capacity - rows_used[slot]
        if rem > 0 and segs_used[slot] < max_segments:
            by_space[rem].append(slot)

    n_slots = len(rows_used)
    max_used = max(segs_used) if segs_used else 1
    return slot_of, offset_of, segment_of, n_slots, max_used


def pack_dataset_slots(
    records: List[dict],
    neighbors: List[list],
    g_update: bool = False,
    feature: str = "atomic",
    use_ring: bool = False,
    atoms_multiple: int = 8,
    neighbors_multiple: int = 8,
    capacity: Optional[int] = None,
    max_segments: int = 8,
    converter: float = 1.0,
    csr_cache_path: Optional[str] = None,
    csr_source_path: Optional[str] = None,
    orig_indices: Optional[np.ndarray] = None,
    neighbors_capacity: Optional[int] = None,
    segments_capacity: Optional[int] = None,
    csr=None,
) -> PackedSlots:
    """Pack the whole dataset into one static-(M, N)-shape slot tensor.

    Mirrors ``pipeline.pack_dataset``'s feature semantics (weight column by
    ``g_update``, cgcnn expansion, ring channel, eV->meV ``converter``) but
    emits ONE PackedSlots instead of per-size buckets. ``capacity`` defaults
    to the max atom count rounded up to ``atoms_multiple``.

    ``neighbors_capacity`` / ``segments_capacity`` pin the N / SEG dims so
    several packings (e.g. the train/valid/test splits) share one (M, N,
    SEG) shape, so each kernel sees one launch shape and its shared-memory
    plan is decided once.

    The ragged->packed fill is fully vectorized (flat destination-index
    scatter over the CSR arrays) — no per-structure Python loop.
    """
    # ``csr``: a prebuilt CsrDataset for these records (e.g. a split carved
    # via CsrDataset.subset from the cached full-dataset CSR) — skips the
    # ragged-list flattening pass entirely
    if csr is None:
        csr = build_csr(records, neighbors, csr_cache_path,
                        source_path=csr_source_path)
    S = len(csr.targets)
    atom_counts = np.diff(csr.atom_offsets)
    if capacity is None:
        capacity = _round_up(int(atom_counts.max()), atoms_multiple)
    nbr_counts = np.diff(csr.nbr_offsets)
    N = (int(neighbors_capacity) if neighbors_capacity is not None
         else _round_up(max(int(nbr_counts.max()), 1), neighbors_multiple))
    if len(nbr_counts) and int(nbr_counts.max()) > N:
        raise ValueError(f"neighbors_capacity {N} < max neighbor count "
                         f"{int(nbr_counts.max())}")
    M = int(capacity)

    slot_of, offset_of, segment_of, n_slots, max_seg = plan_slots(
        atom_counts, M, max_segments)
    if segments_capacity is not None:
        if max_seg > int(segments_capacity):
            raise ValueError(f"segments_capacity {segments_capacity} < "
                             f"packing plan's {max_seg} segments")
        max_seg = int(segments_capacity)

    # --- vectorized fill ----------------------------------------------------
    # per-atom destination row (into the flattened [n_slots * M] row space)
    struct_of_atom = np.repeat(np.arange(S), atom_counts)
    local_atom = np.arange(len(struct_of_atom)) - np.repeat(
        csr.atom_offsets[:-1], atom_counts)
    dest_row = (slot_of[struct_of_atom] * M
                + offset_of[struct_of_atom] + local_atom)

    atomic = np.zeros(n_slots * M, np.int32)
    atomic[dest_row] = csr.atomic
    atom_mask = np.zeros(n_slots * M, np.float32)
    atom_mask[dest_row] = 1.0
    seg_id = np.full(n_slots * M, -1, np.int64)
    seg_id[dest_row] = segment_of[struct_of_atom]

    # per-neighbor destination (dest_row of the owning atom, position within
    # its neighbor list)
    atom_of_nbr = np.repeat(np.arange(len(nbr_counts)), nbr_counts)
    pos = np.arange(len(atom_of_nbr)) - np.repeat(
        csr.nbr_offsets[:-1], nbr_counts)
    dest_nbr = dest_row[atom_of_nbr] * N + pos

    nbr_idx = np.zeros(n_slots * M * N, np.int32)
    # neighbor indices are within-structure -> offset to the packed rows
    nbr_idx[dest_nbr] = (
        csr.nbr_index
        + offset_of[struct_of_atom[atom_of_nbr]].astype(np.int32))
    nbr_mask = np.zeros(n_slots * M * N, np.float32)
    nbr_mask[dest_nbr] = 1.0
    weights = csr.weight_raw if g_update else csr.weight_norm
    nbr_weight = np.zeros(n_slots * M * N, np.float32)
    nbr_weight[dest_nbr] = weights
    nbr_dist = np.zeros(n_slots * M * N, np.float32)
    nbr_dist[dest_nbr] = csr.nbr_dist

    inputs = {
        "atomic": atomic.reshape(n_slots, M),
        "atom_mask": atom_mask.reshape(n_slots, M, 1),
        "neighbors": nbr_idx.reshape(n_slots, M, N),
        "neighbor_mask": nbr_mask.reshape(n_slots, M, N),
        "neighbor_weight": nbr_weight.reshape(n_slots, M, N),
        "neighbor_distance": nbr_dist.reshape(n_slots, M, N),
    }

    seg_id = seg_id.reshape(n_slots, M)
    onehot = np.zeros((n_slots, M, max_seg), np.float32)
    valid = seg_id >= 0
    sl, at = np.nonzero(valid)
    onehot[sl, at, seg_id[valid]] = 1.0
    inputs["segment_onehot"] = onehot

    targets = np.zeros((n_slots, max_seg), np.float32)
    indices = np.full((n_slots, max_seg), -1, np.int64)
    targets[slot_of, segment_of] = csr.targets * converter
    # ``orig_indices``: the records' ORIGINAL dataset indices (matching
    # pipeline.subset_buckets semantics), so split-carved packings compose
    # with bucketed subsets in Trainer.predict; defaults to positional.
    indices[slot_of, segment_of] = (
        np.arange(S) if orig_indices is None
        else np.asarray(orig_indices, np.int64))
    inputs["segment_mask"] = (indices >= 0).astype(np.float32)

    if feature == "cgcnn":
        table = get_atomic_features()
        max_z = max(int(k) for k in table)
        feat_table = np.zeros((max_z + 1, 92), np.float32)
        for k, v in table.items():
            feat_table[int(k)] = v
        am = inputs["atom_mask"][..., 0] > 0
        inputs["atomic"] = feat_table[inputs["atomic"]] * am[..., None]

    if use_ring:
        if csr.ring is None:
            raise ValueError("use_ring=True but records have no 'ring' data")
        ring = np.zeros((n_slots * M, csr.ring.shape[1]), np.float32)
        ring[dest_row] = csr.ring
        inputs["ring_aromatic"] = ring.reshape(n_slots, M, -1)

    return PackedSlots(inputs=inputs, targets=targets, indices=indices)


def pack_padded_inputs(
    inputs: Dict[str, np.ndarray],
    capacity: Optional[int] = None,
    max_segments: int = 8,
    atoms_multiple: int = 8,
) -> PackedSlots:
    """Pack already-padded model inputs ([B, M, ...], one structure per row
    block with real atoms in a prefix) into PackedSlots — the padded-tensor
    analogue of ``pack_dataset_slots`` (used to pack golden-fixture batches
    and serving batches without going back to ragged records).

    ``indices`` carries each structure's original batch row; targets are
    zeros (callers scatter their own by ``indices``).
    """
    am = np.asarray(inputs["atom_mask"])[..., 0]
    B, M0 = am.shape
    counts = am.sum(1).astype(np.int64)
    # the packed-layout math assumes each structure's atoms occupy a prefix
    prefix = np.arange(M0)[None, :] < counts[:, None]
    if not np.array_equal(am > 0, prefix):
        raise ValueError("atom_mask rows must be prefix-ones to pack")
    if capacity is None:
        capacity = _round_up(int(counts.max()), atoms_multiple)
    M = int(capacity)
    slot_of, offset_of, segment_of, n_slots, max_seg = plan_slots(
        counts, M, max_segments)

    src_b = np.repeat(np.arange(B), counts)
    local = np.arange(len(src_b)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    dst_slot = slot_of[src_b]
    dst_row = offset_of[src_b] + local

    def scatter_rows(x, fill=0):
        out = np.full((n_slots, M) + x.shape[2:], fill, x.dtype)
        out[dst_slot, dst_row] = x[src_b, local]
        return out

    packed = {}
    nmask = scatter_rows(np.asarray(inputs["neighbor_mask"], np.float32))
    for k, v in inputs.items():
        v = np.asarray(v)
        if k == "neighbor_mask":
            packed[k] = nmask
        elif k == "neighbors":
            # within-structure indices -> offset into the segment's rows
            nb = scatter_rows(v.astype(np.int32))
            nb[dst_slot, dst_row] += offset_of[src_b][:, None].astype(np.int32)
            packed[k] = (nb * (nmask > 0)).astype(np.int32)
        else:
            packed[k] = scatter_rows(v)

    onehot = np.zeros((n_slots, M, max_seg), np.float32)
    onehot[dst_slot, dst_row, segment_of[src_b]] = 1.0
    packed["segment_onehot"] = onehot
    indices = np.full((n_slots, max_seg), -1, np.int64)
    indices[slot_of, segment_of] = np.arange(B)
    packed["segment_mask"] = (indices >= 0).astype(np.float32)
    return PackedSlots(inputs=packed,
                       targets=np.zeros((n_slots, max_seg), np.float32),
                       indices=indices)


def unpack_predictions(packed: PackedSlots, preds: np.ndarray) -> np.ndarray:
    """Scatter per-segment predictions [S, SEG] back to ascending order of
    the structures' (possibly non-contiguous) original indices."""
    valid = packed.indices >= 0
    idx = packed.indices[valid]
    return np.asarray(preds)[valid][np.argsort(idx)].astype(np.float32)
