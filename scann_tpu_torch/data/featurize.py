"""Offline featurization of dataset records (port of
``scann_tpu/data/featurize.py``): structures -> ragged Voronoi neighbour
lists in the reference's ``.npy`` object-array format, so preprocessed
datasets of either package load in the other.

``parallel_compute_neighbors`` fans the records over a pool of ``spawn``
processes (reference ``scann/utils/voronoi_neighbor.py:93-130``). A worker
imports only this module and what it imports (numpy and the data modules;
scipy only if a structure takes the scipy path; never torch), since its
caller may be a process with CUDA and PyTorch's thread pools up, which must
not be forked, and a worker's imports are most of its start-up.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

import numpy as np

from scann_tpu_torch.data import native_voronoi
from scann_tpu_torch.data.structure import Structure
from scann_tpu_torch.data.voronoi import compute_voronoi_neighbors, native_voronoi_enabled


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


def parallel_compute_neighbors(
    dataset_path: str,
    save_path: str,
    d_t: float = 4.0,
    w_t: float = 0.4,
    pool: int = 8,
    chunk: int = 64,
    log_every: int = 1000,
) -> None:
    """Compute the neighbour lists of every structure in ``dataset_path``
    (an energy ``.npy``) on ``pool`` processes and save them to
    ``save_path``. Chunks of ``chunk`` records are placed by their start, so
    the output does not depend on the pool size."""
    dataset = np.load(dataset_path, allow_pickle=True)
    n = len(dataset)
    print(f"Voronoi featurization: {n} structures, {pool} processes "
          f"(d_t={d_t}, w_t={w_t}) -> {save_path}")

    results: List[Optional[list]] = [None] * n
    if pool <= 1:
        for i, rec in enumerate(dataset):
            results[i] = featurize_record(rec, d_t, w_t)
            if log_every and i % log_every == 0:
                print(f"  {i}/{n}")
    else:
        if native_voronoi_enabled():
            native_voronoi.get_lib()    # built here once, so the workers only load it
        with ProcessPoolExecutor(pool, mp_context=multiprocessing.get_context("spawn")) as ex:
            with _main_module_hidden():     # the workers start at the first submit
                futures = {ex.submit(_featurize_chunk, list(dataset[start:start + chunk]),
                                     d_t, w_t): start for start in range(0, n, chunk)}
            done = 0
            for fut, start in futures.items():
                out = fut.result()
                results[start:start + len(out)] = out
                done += len(out)
                if log_every and done % log_every < chunk:
                    print(f"  {done}/{n}")

    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    np.save(save_path, as_object_array(results))
    print(f"saved {n} neighbor lists to {save_path}")


@contextlib.contextmanager
def _main_module_hidden():
    """While the pool starts its workers, hide the caller's main module from
    ``multiprocessing``: a ``spawn`` worker runs the main script of a
    ``python script.py`` process, or the module of ``python -m module``,
    again (``multiprocessing.spawn.get_preparation_data``), and with it
    whatever that imports at its top, torch included. The workers need
    nothing of it: they run ``_featurize_chunk`` of this module."""
    main = sys.modules.get("__main__")
    saved = {k: getattr(main, k) for k in ("__file__", "__spec__") if hasattr(main, k)}
    if "__file__" in saved:
        del main.__file__
    if "__spec__" in saved:
        main.__spec__ = None
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(main, k, v)


def _featurize_chunk(recs, d_t, w_t):
    return [featurize_record(r, d_t, w_t) for r in recs]


def neighbor_file_name(dataset: str, d_t: float, w_t: float) -> str:
    """Cache-file naming matching the reference
    (``preprocess_data.py:31-36``)."""
    return f"{dataset}_data_neighbor_dt{d_t}_wt{w_t}.npy"
