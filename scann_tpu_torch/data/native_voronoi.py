"""ctypes binding of the port's per-atom Voronoi cell featurizer
``native/voronoi_cell.cc`` (counterpart of
``scann_tpu/data/native_voronoi.py``).

The C++ builds each home atom's Voronoi cell by incremental half-space
clipping (Voro++-style) instead of one global scipy/Qhull tessellation:
the same facets, solid angles and distances to floating-point noise, at a
fraction of the host's time. It is ``data/voronoi._voronoi_facets``'s
default path. A cell the clipping flags as degenerate (coincident points,
a ring that does not close) makes ``voronoi_facets_native`` return None,
and the caller takes the scipy path for that structure, as the JAX package
does; a library that fails to build raises (``data/native.py``).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from scann_tpu_torch.data.native import F64P, I32P, I64P, load_library

MAX_FACETS = 4096     # the facet budget a cell may grow to before scipy takes it


def _declare(lib: ctypes.CDLL) -> None:
    lib.scann_voronoi_facets.argtypes = [
        F64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        I32P, I64P, F64P, F64P,
    ]
    lib.scann_voronoi_facets.restype = ctypes.c_int


def get_lib() -> ctypes.CDLL:
    """The Voronoi library, built at first use."""
    return load_library("voronoi_cell", _declare)


def voronoi_facets_native(
    points: np.ndarray, n_home: int, base_idx: np.ndarray
) -> Optional[List[List[Tuple[int, float, float]]]]:
    """Per-home-atom Voronoi facets ``(neighbor_base_index, solid_angle,
    distance)`` over the candidate cloud ``points`` (home atoms first): the
    native counterpart of ``voronoi._voronoi_facets_scipy``, in
    candidate-distance order. The facet budget starts at 64 a cell and
    grows x4 up to ``MAX_FACETS``. Returns None when some atom's cell is
    degenerate or outgrows the budget (the caller takes the scipy path)."""
    lib = get_lib()
    pts = np.ascontiguousarray(points, np.float64)
    P = len(pts)
    max_f = 64
    while True:
        counts = np.zeros(n_home, np.int32)
        nbr = np.zeros(n_home * max_f, np.int64)
        sa = np.zeros(n_home * max_f, np.float64)
        dist = np.zeros(n_home * max_f, np.float64)
        rc = lib.scann_voronoi_facets(pts, P, n_home, max_f, counts, nbr, sa, dist)
        if rc == 0:
            break
        max_f *= 4
        if max_f > MAX_FACETS:
            return None
    if (counts < 0).any():
        return None
    out: List[List[Tuple[int, float, float]]] = []
    for i in range(n_home):
        c = int(counts[i])
        o = i * max_f
        out.append([
            (int(base_idx[nbr[o + f]]), float(sa[o + f]), float(dist[o + f]))
            for f in range(c)
        ])
    return out
