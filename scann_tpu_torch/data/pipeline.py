"""Dataset loading, splitting and bucketing (port of
``scann_tpu/data/pipeline.py``).

- ``load_dataset`` reads the reference's ``.npy`` object-array pair,
  ``split_data`` draws the train/valid/test permutation with exact sizes
  (``general.py:79-101``), and ``subset_buckets`` carves the splits out of
  one packing pass.
- ``pack_dataset`` pads every structure into one of a few (M, N) shape
  buckets (``choose_buckets``), through a flat CSR view of the ragged
  neighbour lists (``CsrDataset``/``build_csr``, cached on disk next to the
  neighbour file in the JAX package's format). ``pack_bucket`` and
  ``structure_sizes`` fill through the port's C++ packer
  (``native/packer.cc`` via ``data/native.py``, built at first use);
  ``pack_bucket_plain`` and ``structure_sizes_plain`` are the same fill in
  numpy, which the tests hold the packer to.

Same semantics as the reference: the raw solid angle is the neighbour
weight for SCANN+ and the max-normalised one otherwise, atoms pad with 0 and
a mask, padded neighbours point at atom 0 with a separate mask.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from scann_tpu_torch.data.atomic_data import get_atomic_features
from scann_tpu_torch.data.native import pack_bucket_native, structure_sizes_native


# --- loading (reference .npy object-array format) ----------------------------

def load_dataset(
    data_energy_path: str,
    data_neighbor_path: str,
    target: str,
    use_ref: bool = False,
    use_ring: bool = False,
):
    """Load the preprocessed dataset pair.

    Returns (records, neighbors): ``records[i]`` is a dict with keys
    ``atomic`` (int array), ``target`` (float) and optionally ``ring``
    ([n_atoms, 2] float); ``neighbors[i]`` is the per-atom ragged neighbor
    list in the reference record layout.
    """
    data_full = np.load(data_energy_path, allow_pickle=True)
    data_neighbor = np.load(data_neighbor_path, allow_pickle=True)
    if len(data_full) != len(data_neighbor):
        raise ValueError(
            f"energy/neighbor length mismatch: {len(data_full)} vs {len(data_neighbor)}"
        )

    records = []
    for d in data_full:
        y = float(d["Properties"][target])
        if use_ref:
            y -= float(d["Properties"]["Ref_energy"])
        rec = {"atomic": np.asarray(d["Atomic"], dtype=np.int32), "target": y}
        if use_ring:
            feats = d["Features"]
            rec["ring"] = np.stack([np.asarray(feats[k], dtype=np.float32)
                                    for k in feats], axis=-1)
        records.append(rec)
    return records, list(data_neighbor)


def split_data(
    len_data: int,
    test_percent: float = 0.1,
    train_size: Optional[int] = None,
    test_size: Optional[int] = None,
    seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random permutation split with exact sizes (reference general.py:79-101:
    train / valid / test where valid absorbs the remainder).

    Divergence from the reference: ``train_size`` set with ``test_size``
    unset derives the test count from ``test_percent`` instead of crashing
    (the reference passes ``None`` into ``np.split``), and an explicit
    ``train_size=0`` is honored rather than falling into the percentage
    path."""
    if train_size is not None:
        n_train = int(train_size)
        n_test = (int(test_size) if test_size is not None
                  else int(len_data * test_percent))
    else:
        n_train = int(len_data * (1 - test_percent * 2))
        n_test = int(len_data * test_percent)
    n_val = len_data - n_train - n_test
    if n_val < 0:
        raise ValueError(
            f"split sizes exceed dataset: train {n_train} + test {n_test} > {len_data}"
        )
    rng = np.random.default_rng(seed) if seed is not None else np.random
    perm = rng.permutation(len_data)
    return (perm[:n_train],
            perm[n_train:n_train + n_val],
            perm[n_train + n_val:n_train + n_val + n_test])


# --- packing into static-shape buckets ---------------------------------------

@dataclasses.dataclass
class PackedBucket:
    """Fixed-shape padded arrays for one (M, N) bucket."""

    inputs: Dict[str, np.ndarray]   # atomic [S,M], neighbors [S,M,N], masks...
    targets: np.ndarray             # [S]
    indices: np.ndarray             # original dataset indices [S]

    @property
    def num_structures(self) -> int:
        return len(self.targets)

    @property
    def shape(self) -> Tuple[int, int]:
        m = self.inputs["atomic"].shape[1]
        n = self.inputs["neighbors"].shape[2]
        return m, n


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def choose_buckets(
    sizes: Sequence[Tuple[int, int]],
    atoms_multiple: int = 8,
    neighbors_multiple: int = 8,
    max_buckets: int = 4,
) -> List[Tuple[int, int]]:
    """Pick <= max_buckets (M, N) shapes covering all (n_atoms, max_nbr) sizes.

    Shapes are chosen at even quantiles of the atom-count distribution
    (the reference pre-sorts datasets by atom count for the same reason —
    ``qm9.py:160``), each rounded up to hardware-friendly multiples. N is the
    max neighbor count among structures assigned to the bucket.
    """
    sizes_arr = np.asarray(sizes)
    m_vals = sizes_arr[:, 0]
    qs = np.linspace(0, 1, max_buckets + 1)[1:]
    m_cuts = sorted({_round_up(int(np.quantile(m_vals, q)), atoms_multiple) for q in qs})
    buckets = []
    prev = 0
    for cut in m_cuts:
        sel = (m_vals > prev) & (m_vals <= cut)
        if not sel.any():
            prev = cut
            continue
        n_max = int(sizes_arr[sel, 1].max())
        buckets.append((cut, _round_up(max(n_max, 1), neighbors_multiple)))
        prev = cut
    return buckets


class CsrDataset:
    """Flat CSR view of the ragged dataset (built once, then packed).

    Arrays: ``atom_offsets [S+1]``, ``nbr_offsets [total_atoms+1]``,
    ``atomic [total_atoms]``, ``nbr_index/weight_raw/weight_norm/dist
    [total_nbrs]``, ``targets [S]``, optional ``ring [total_atoms, 2]``.
    """

    def __init__(self, records, neighbors):
        S = len(records)
        atom_counts = np.fromiter((len(r["atomic"]) for r in records),
                                  np.int64, count=S)
        for i, (rec, nbr) in enumerate(zip(records, neighbors)):
            if len(rec["atomic"]) != len(nbr):
                raise ValueError(
                    f"structure {i} has {len(rec['atomic'])} atoms but "
                    f"{len(nbr)} neighbor lists")
        self.atom_offsets = np.zeros(S + 1, np.int64)
        np.cumsum(atom_counts, out=self.atom_offsets[1:])

        nbr_counts = np.fromiter(
            (len(lc) for p in neighbors for lc in p), np.int64,
            count=int(self.atom_offsets[-1]))
        self.nbr_offsets = np.zeros(len(nbr_counts) + 1, np.int64)
        np.cumsum(nbr_counts, out=self.nbr_offsets[1:])

        self.atomic = np.concatenate(
            [np.asarray(r["atomic"], np.int32) for r in records]
        ) if S else np.zeros(0, np.int32)
        flat = [x for p in neighbors for lc in p for x in lc]
        self.nbr_index = np.fromiter((int(x[1]) for x in flat), np.int32,
                                     count=len(flat))
        self.weight_raw = np.fromiter((float(x[2]) for x in flat), np.float32,
                                      count=len(flat))
        self.weight_norm = np.fromiter((float(x[3]) for x in flat), np.float32,
                                       count=len(flat))
        self.nbr_dist = np.fromiter((float(x[-1]) for x in flat), np.float32,
                                    count=len(flat))
        self.targets = np.fromiter((float(r["target"]) for r in records),
                                   np.float32, count=S)
        self.ring = None
        if records and "ring" in records[0]:
            self.ring = np.concatenate(
                [np.asarray(r["ring"], np.float32).reshape(len(r["atomic"]), -1)
                 for r in records])

    _CACHE_FIELDS = ("atom_offsets", "nbr_offsets", "atomic", "nbr_index",
                     "weight_raw", "weight_norm", "nbr_dist", "ring")

    def subset(self, indices) -> "CsrDataset":
        """Carve a compact per-structure subset (fully vectorized) — used to
        split one cached full-dataset CSR into train/valid/test without
        re-flattening the ragged neighbor lists per split."""
        idx = np.asarray(indices, np.int64)
        obj = CsrDataset.__new__(CsrDataset)
        a0 = self.atom_offsets[idx]
        counts = self.atom_offsets[idx + 1] - a0
        obj.atom_offsets = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(counts, out=obj.atom_offsets[1:])
        atom_sel = (np.repeat(a0, counts) + np.arange(int(counts.sum()))
                    - np.repeat(obj.atom_offsets[:-1], counts))
        obj.atomic = self.atomic[atom_sel]
        obj.ring = self.ring[atom_sel] if self.ring is not None else None
        n0 = self.nbr_offsets[atom_sel]
        ncounts = self.nbr_offsets[atom_sel + 1] - n0
        obj.nbr_offsets = np.zeros(len(atom_sel) + 1, np.int64)
        np.cumsum(ncounts, out=obj.nbr_offsets[1:])
        nbr_sel = (np.repeat(n0, ncounts) + np.arange(int(ncounts.sum()))
                   - np.repeat(obj.nbr_offsets[:-1], ncounts))
        for f in ("nbr_index", "weight_raw", "weight_norm", "nbr_dist"):
            setattr(obj, f, getattr(self, f)[nbr_sel])
        obj.targets = self.targets[idx]
        return obj

    def save(self, path: str,
             source_stat: Optional[np.ndarray] = None) -> None:
        data = {k: getattr(self, k) for k in self._CACHE_FIELDS
                if getattr(self, k) is not None}
        if source_stat is not None:
            data["_source_stat"] = source_stat
        np.savez_compressed(path, **data)

    @classmethod
    def from_cache(cls, path: str, records,
                   source_stat: Optional[np.ndarray] = None,
                   want_ring: bool = False) -> "CsrDataset":
        obj = cls.__new__(cls)
        with np.load(path) as data:
            for k in cls._CACHE_FIELDS:
                setattr(obj, k, data[k] if k in data.files else None)
            cached_stat = (data["_source_stat"]
                           if "_source_stat" in data.files else None)
        # staleness: re-featurizing at the same path with the same structure
        # count (e.g. different Voronoi d_t/w_t) must not silently serve old
        # neighbor data — compare the recorded source (mtime_ns, size)
        if source_stat is not None and (
                cached_stat is None
                or not np.array_equal(cached_stat, source_stat)):
            raise ValueError("CSR cache is stale (source file changed)")
        if want_ring and obj.ring is None:
            raise ValueError(
                "CSR cache predates the records' ring data")
        # targets are run-dependent (target property / use_ref / scaling) —
        # always taken from the records, never the cache
        obj.targets = np.fromiter((float(r["target"]) for r in records),
                                  np.float32, count=len(records))
        if len(obj.atom_offsets) != len(records) + 1:
            raise ValueError("CSR cache does not match the dataset size")
        return obj


def build_csr(records, neighbors, cache_path: Optional[str] = None,
              source_path: Optional[str] = None) -> "CsrDataset":
    """CsrDataset with an optional on-disk cache.

    The Python flattening pass over the ragged object arrays is the slowest
    host step for big datasets (~minutes for full QM9); the cache reduces it
    to an npz load. ``source_path`` (the neighbor ``.npy`` the records came
    from) pins the cache to its (mtime, size) so a re-featurized file with
    the same structure count invalidates it."""
    import os

    source_stat = None
    if source_path and os.path.exists(source_path):
        st = os.stat(source_path)
        source_stat = np.array([st.st_mtime_ns, st.st_size], np.int64)
    want_ring = bool(records) and "ring" in records[0]
    if cache_path and os.path.exists(cache_path):
        try:
            return CsrDataset.from_cache(cache_path, records,
                                         source_stat=source_stat,
                                         want_ring=want_ring)
        except Exception as e:  # stale/corrupt cache: rebuild
            print(f"CSR cache {cache_path} unusable ({e}); rebuilding")
    csr = CsrDataset(records, neighbors)
    if cache_path:
        csr.save(cache_path, source_stat=source_stat)
    return csr


def pack_dataset(
    records: List[dict],
    neighbors: List[list],
    g_update: bool = False,
    feature: str = "atomic",
    use_ring: bool = False,
    atoms_multiple: int = 8,
    neighbors_multiple: int = 8,
    max_buckets: int = 4,
    converter: float = 1.0,
    csr_cache_path: Optional[str] = None,
    csr_source_path: Optional[str] = None,
) -> List[PackedBucket]:
    """Pad every structure into its (M, N) bucket and return the buckets.

    The ragged->padded fill runs in the native packer (``pack_bucket``).
    ``converter`` mirrors the reference's optional eV->meV factor
    (``datagenerator.py:54-57``).
    """
    csr = build_csr(records, neighbors, csr_cache_path,
                    source_path=csr_source_path)
    n_atoms_arr, max_nbrs_arr = structure_sizes(csr.atom_offsets, csr.nbr_offsets)
    sizes = list(zip(n_atoms_arr.tolist(), max_nbrs_arr.tolist()))
    buckets = choose_buckets(sizes, atoms_multiple, neighbors_multiple, max_buckets)

    bucket_m = np.asarray([bm for bm, _ in buckets])
    bucket_n = np.asarray([bn for _, bn in buckets])
    # first bucket that fits both dims
    fits = (n_atoms_arr[:, None] <= bucket_m) & (max_nbrs_arr[:, None] <= bucket_n)
    assign_idx = np.argmax(fits, axis=1)
    if not fits[np.arange(len(sizes)), assign_idx].all():
        bad = int(np.nonzero(~fits.any(axis=1))[0][0])
        raise AssertionError(f"no bucket for size {sizes[bad]} in {buckets}")

    # SCANN+ uses the raw solid angle, SCANN the normalized one
    # (reference datagenerator.py:48-50: weight_index 2 vs 3)
    weights = csr.weight_raw if g_update else csr.weight_norm
    feat_table = None
    if feature == "cgcnn":
        table = get_atomic_features()
        max_z = max(int(k) for k in table)
        feat_table = np.zeros((max_z + 1, 92), np.float32)
        for k, v in table.items():
            feat_table[int(k)] = v

    packed = []
    for bi, (bm, bn) in enumerate(buckets):
        rows = np.nonzero(assign_idx == bi)[0]
        if len(rows) == 0:
            continue
        inputs = pack_bucket(rows, csr.atom_offsets, csr.nbr_offsets, csr.atomic,
                             csr.nbr_index, weights, csr.nbr_dist, bm, bn)
        if feature == "cgcnn":
            am = inputs["atom_mask"][..., 0] > 0
            inputs["atomic"] = feat_table[inputs["atomic"]] * am[..., None]
        if use_ring:
            if csr.ring is None:
                raise ValueError("use_ring=True but records have no 'ring' data")
            ring = np.zeros((len(rows), bm, csr.ring.shape[1]), np.float32)
            for r, s in enumerate(rows):
                a0, a1 = csr.atom_offsets[s], csr.atom_offsets[s + 1]
                ring[r, : a1 - a0] = csr.ring[a0:a1]
            inputs["ring_aromatic"] = ring
        packed.append(PackedBucket(
            inputs=inputs,
            targets=csr.targets[rows] * converter,
            indices=rows,
        ))
    return packed


def subset_buckets(buckets: List[PackedBucket], indices: np.ndarray) -> List[PackedBucket]:
    """Restrict packed buckets to a subset of original dataset indices
    (used to carve train/valid/test out of one packing pass)."""
    index_set = np.zeros(max(int(b.indices.max()) for b in buckets) + 1, dtype=bool)
    index_set[indices] = True
    out = []
    for b in buckets:
        keep = index_set[b.indices]
        if not keep.any():
            continue
        out.append(PackedBucket(
            inputs={k: v[keep] for k, v in b.inputs.items()},
            targets=b.targets[keep],
            indices=b.indices[keep],
        ))
    return out


# The fill of pack_dataset is the native packer (data/native.py); the two
# *_plain functions below are the same fill in numpy, which the tests hold it to.
structure_sizes = structure_sizes_native
pack_bucket = pack_bucket_native


def structure_sizes_plain(atom_offsets: np.ndarray, nbr_offsets: np.ndarray):
    """``structure_sizes`` in numpy (the JAX package's fallback path)."""
    n_struct = len(atom_offsets) - 1
    n_atoms = np.diff(atom_offsets).astype(np.int32)
    counts = np.diff(nbr_offsets)
    max_nbrs = np.zeros(n_struct, np.int32)
    for s in range(n_struct):
        max_nbrs[s] = counts[atom_offsets[s]:atom_offsets[s + 1]].max(initial=0)
    return n_atoms, max_nbrs


def pack_bucket_plain(rows, atom_offsets, nbr_offsets, atomic, nbr_index, nbr_weight,
                      nbr_dist, M: int, N: int) -> Dict[str, np.ndarray]:
    """``pack_bucket`` in numpy (the JAX package's fallback path,
    ``scann_tpu/data/native.py:127-148``)."""
    S = len(rows)
    out = {
        "atomic": np.zeros((S, M), np.int32),
        "atom_mask": np.zeros((S, M, 1), np.float32),
        "neighbors": np.zeros((S, M, N), np.int32),
        "neighbor_mask": np.zeros((S, M, N), np.float32),
        "neighbor_weight": np.zeros((S, M, N), np.float32),
        "neighbor_distance": np.zeros((S, M, N), np.float32),
    }
    for r, s in enumerate(rows):
        a0, a1 = atom_offsets[s], atom_offsets[s + 1]
        na = min(a1 - a0, M)
        out["atomic"][r, :na] = atomic[a0:a0 + na]
        out["atom_mask"][r, :na, 0] = 1.0
        for a in range(na):
            n0, n1 = nbr_offsets[a0 + a], nbr_offsets[a0 + a + 1]
            k = min(n1 - n0, N)
            out["neighbors"][r, a, :k] = nbr_index[n0:n0 + k]
            out["neighbor_mask"][r, a, :k] = 1.0
            out["neighbor_weight"][r, a, :k] = nbr_weight[n0:n0 + k]
            out["neighbor_distance"][r, a, :k] = nbr_dist[n0:n0 + k]
    return out
