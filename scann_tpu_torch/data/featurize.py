"""Offline featurization of dataset records (port of the record half of
``scann_tpu/data/featurize.py``): structures -> ragged Voronoi neighbour
lists in the reference's ``.npy`` object-array format, so preprocessed
datasets of either package load in the other."""

from __future__ import annotations

from typing import List

import numpy as np

from scann_tpu_torch.data.structure import Structure
from scann_tpu_torch.data.voronoi import compute_voronoi_neighbors


def structure_from_record(rec: dict) -> Structure:
    """A Structure from a dataset record ({Atoms, Coords, [Lattice],
    [Cartesian]}, the schema the reference's builders emit)."""
    species = list(rec["Atoms"])
    coords = np.asarray(rec["Coords"], dtype=np.float64)
    if "Lattice" in rec:
        lattice = np.asarray(rec["Lattice"], dtype=np.float64).reshape(3, 3)
        if rec.get("Cartesian", True):
            return Structure(species, coords, lattice)
        return Structure.from_frac(species, coords, lattice)
    return Structure(species, coords)


def featurize_record(rec: dict, d_t: float = 4.0, w_t: float = 0.4,
                     box: float = 10.0) -> List[List[list]]:
    """The Voronoi neighbour records of one dataset record."""
    struct = structure_from_record(rec).as_periodic(box)
    return compute_voronoi_neighbors(struct, cutoff=7.0, d_thresh=d_t, w_thresh=w_t)


def as_object_array(items) -> np.ndarray:
    """A guaranteed 1-D object array: ``np.asarray(items, dtype=object)``
    collapses nested lists into an N-D array when every structure has the
    same atom and neighbour counts, which breaks the on-disk schema."""
    arr = np.empty(len(items), dtype=object)
    for i, r in enumerate(items):
        arr[i] = r
    return arr
