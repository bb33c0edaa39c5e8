"""Voronoi-tessellation neighbor featurization.

Re-implements the behavior of the reference featurizer
(``scann/utils/voronoi_neighbor.py``, which delegates to pymatgen's
``VoronoiNN(weight="solid_angle")``) without pymatgen:

- each home atom's Voronoi cell over the home cell + enough periodic images
  to cover ``cutoff``: by default clipped per atom in C++
  (``native/voronoi_cell.cc``), or from one scipy/Qhull tessellation per
  structure (``SCANN_TPU_NATIVE_VORONOI=0``, and for a structure whose
  cells the clipping flags as degenerate) — instead of the reference's one
  tessellation per atom,
- facet solid angles at each home atom via the van Oosterom–Strackee formula
  over the (plane-ordered) ridge polygon,
- the same neighbor filters: ``solid_angle >= w_thresh`` AND
  ``solid_angle / max_solid_angle >= 0.2`` AND ``distance <= d_thresh``
  (reference ``voronoi_neighbor.py:48-50``),
- the same output record per neighbor:
  ``[species, base_index, solid_angle, solid_angle/max, distance]``
  (reference ``voronoi_neighbor.py:39-51``).

Molecules are boxed into a >=10 A periodic cell first (reference
``voronoi_neighbor.py:82-87``). Note this makes molecular featurization
weakly FRAME-DEPENDENT (an artifact shared with the reference): the box is
axis-aligned, so its images bound the Voronoi cells of surface atoms, and a
generic rotation of the coordinates perturbs kept solid angles (measured up
to ~10% relative on Thymine) and can flip borderline filter decisions;
distances are frame-exact, and box-congruent motions (signed axis
permutations + translations) reproduce records to fp noise
(``tests/test_invariance.py``).
"""

from __future__ import annotations

import itertools
import os
from typing import List

import numpy as np
from scipy.spatial import Voronoi
from scipy.spatial import QhullError

from scann_tpu_torch.data import native_voronoi
from scann_tpu_torch.data.structure import Structure


def _cross3(a, b):
    """Component-wise cross product (np.cross's moveaxis machinery is ~5x
    slower on the small arrays this hot path uses)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return np.stack([a1 * b2 - a2 * b1,
                     a2 * b0 - a0 * b2,
                     a0 * b1 - a1 * b0], axis=-1)


def _fan_solid_angle(v: np.ndarray) -> float:
    """Solid angle at the origin of the triangle fan (v[0], v[i], v[i+1])
    over an ordered polygon ``v`` [k, 3] (van Oosterom & Strackee 1983),
    all triangles evaluated in one vectorized pass — this is the serving
    hot loop (~100 ms/structure when done with per-triangle Python)."""
    r1 = v[0]
    r2 = v[1:-1]                                   # [t, 3]
    r3 = v[2:]                                     # [t, 3]
    n1 = np.sqrt(r1 @ r1)
    n2 = np.sqrt(np.einsum("ij,ij->i", r2, r2))
    n3 = np.sqrt(np.einsum("ij,ij->i", r3, r3))
    numer = np.abs(_cross3(r2, r3) @ r1)
    denom = (n1 * n2 * n3
             + (r2 @ r1) * n3
             + (r3 @ r1) * n2
             + np.einsum("ij,ij->i", r2, r3) * n1)
    return float(2.0 * np.sum(np.arctan2(numer, denom)))


def solid_angle(center: np.ndarray, polygon: np.ndarray) -> float:
    """Solid angle subtended at ``center`` by the planar polygon ``polygon``
    [k, 3]. Vertices may be in arbitrary order; they are sorted around the
    polygon plane first."""
    v = np.asarray(polygon, dtype=np.float64) - np.asarray(center, dtype=np.float64)
    if len(v) < 3:
        return 0.0
    centroid = v.mean(axis=0)
    rel = v - centroid
    # polygon-plane normal from the vertex scatter (largest cross product of
    # centroid-relative vertex pairs — robust to near-collinear pairs)
    normal = _cross3(rel[0], rel[1])
    for j in range(2, len(rel)):
        if normal @ normal > 1e-20:
            break
        normal = _cross3(rel[0], rel[j])
    nn = np.sqrt(normal @ normal)
    if nn < 1e-12:
        return 0.0  # degenerate (collinear) polygon
    normal = normal / nn
    # in-plane basis
    u = rel[0] - np.dot(rel[0], normal) * normal
    un = np.sqrt(u @ u)
    if un < 1e-12:
        return 0.0
    u /= un
    w = _cross3(normal, u)
    order = np.argsort(np.arctan2(rel @ w, rel @ u))
    return _fan_solid_angle(v[order])


def _image_ranges(lattice: np.ndarray, cutoff: float) -> List[int]:
    """Number of periodic image cells per axis so every point within
    ``cutoff`` of the home cell is included."""
    inv = np.linalg.inv(lattice)
    # slab height along axis k = V / |a_i x a_j| = 1 / |COLUMN_k of inv|
    # (rows of inv are NOT the reciprocal vectors under the row-vector
    # lattice convention — using them under-counts the skewed axis of a
    # monoclinic/triclinic cell and silently corrupts solid angles)
    heights = 1.0 / np.linalg.norm(inv, axis=0)
    return [int(np.ceil(cutoff / h)) for h in heights]


def compute_voronoi_neighbors(
    struct: Structure,
    cutoff: float = 7.0,
    d_thresh: float = 4.0,
    w_thresh: float = 0.4,
    max_cutoff: float = 30.0,
) -> List[List[list]]:
    """Per-atom filtered Voronoi neighbor lists.

    Returns, for each atom, a list of
    ``[species, neighbor_base_index, solid_angle, solid_angle/max, distance]``
    — the exact record layout the reference emits
    (``voronoi_neighbor.py:39-51``), so downstream batching is interchangeable.
    """
    struct = struct.as_periodic()
    n_home = len(struct)
    lattice = struct.lattice
    home = struct.coords

    while True:
        try:
            raw = _voronoi_facets(home, lattice, n_home, cutoff)
            break
        except QhullError:
            cutoff += 5.0
            if cutoff > max_cutoff:
                raise RuntimeError(
                    "Voronoi tessellation failed up to max cutoff "
                    f"{max_cutoff} A"
                )

    out = []
    for i in range(n_home):
        facets = raw[i]
        if not facets:
            out.append([])
            continue
        max_w = max(f[1] for f in facets)
        kept = [
            [struct.species[f[0]], int(f[0]), float(f[1]), float(f[1] / max_w), float(f[2])]
            for f in facets
            if f[1] >= w_thresh and f[1] / max_w >= 0.2 and f[2] <= d_thresh
        ]
        # canonical order — strongest facet first, then nearest, then index.
        # The model is permutation-invariant over neighbors (masked sum), but
        # a canonical order (a) decouples output from qhull's arbitrary ridge
        # enumeration and (b) keeps the most important neighbors if a
        # downstream bucket ever truncates the neighbor axis.
        kept.sort(key=lambda r: (-r[2], r[4], r[1]))
        out.append(kept)
    return out


def _solid_angles_batch(centers: np.ndarray, polys: np.ndarray) -> np.ndarray:
    """Vectorized ``solid_angle`` over F facets of equal vertex count k:
    ``centers`` [F, 3], ``polys`` [F, k, 3] -> [F] solid angles.

    Same algorithm as the scalar function (plane-sort the vertices, then the
    van Oosterom–Strackee triangle fan); facets whose leading normal
    estimate degenerates (near-collinear first vertex pair — rare) are
    recomputed through the scalar path with its full fallback scan.
    """
    v = polys - centers[:, None, :]                       # [F, k, 3]
    rel = v - v.mean(axis=1, keepdims=True)
    normal = _cross3(rel[:, 0], rel[:, 1])                # [F, 3]
    nsq = np.einsum("ij,ij->i", normal, normal)
    bad = nsq <= 1e-20                                    # scalar-path rescue
    nn = np.sqrt(np.where(bad, 1.0, nsq))
    normal = normal / nn[:, None]
    u = rel[:, 0] - np.einsum("ij,ij->i", rel[:, 0], normal)[:, None] * normal
    un = np.sqrt(np.einsum("ij,ij->i", u, u))
    degen = un < 1e-12
    u = u / np.where(degen, 1.0, un)[:, None]
    w = _cross3(normal, u)
    order = np.argsort(np.arctan2(np.einsum("ikj,ij->ik", rel, w),
                                  np.einsum("ikj,ij->ik", rel, u)), axis=1)
    vs = np.take_along_axis(v, order[:, :, None], axis=1)  # [F, k, 3]

    # triangle fan (vs[0], vs[i], vs[i+1]), all facets and triangles at once
    r1 = vs[:, 0]                                          # [F, 3]
    r2 = vs[:, 1:-1]                                       # [F, t, 3]
    r3 = vs[:, 2:]                                         # [F, t, 3]
    n1 = np.sqrt(np.einsum("ij,ij->i", r1, r1))
    n2 = np.sqrt(np.einsum("itj,itj->it", r2, r2))
    n3 = np.sqrt(np.einsum("itj,itj->it", r3, r3))
    d21 = np.einsum("itj,ij->it", r2, r1)
    d31 = np.einsum("itj,ij->it", r3, r1)
    d23 = np.einsum("itj,itj->it", r2, r3)
    numer = np.abs(np.einsum("itj,ij->it", _cross3(r2, r3), r1))
    denom = n1[:, None] * n2 * n3 + d21 * n3 + d31 * n2 + d23 * n1[:, None]
    sa = 2.0 * np.sum(np.arctan2(numer, denom), axis=1)
    sa = np.where(degen, 0.0, sa)

    if bad.any():
        for i in np.nonzero(bad)[0]:
            sa[i] = solid_angle(centers[i], polys[i])
    return sa


def _image_cloud(home: np.ndarray, lattice: np.ndarray, n_home: int, cutoff: float):
    """The candidate point cloud both tessellation paths share: home atoms
    first, then every periodic image within ``cutoff`` of the home cell.
    Returns (points [P, 3], base_idx [P])."""
    na, nb, nc = _image_ranges(lattice, cutoff)

    shifts = [
        np.array(s, dtype=np.float64)
        for s in itertools.product(range(-na, na + 1), range(-nb, nb + 1), range(-nc, nc + 1))
        if s != (0, 0, 0)
    ]

    points = [home]
    base_idx = [np.arange(n_home)]
    for s in shifts:
        points.append(home + s @ lattice)
        base_idx.append(np.arange(n_home))
    # NOTE on a rejected optimization (measured round 3): pruning image
    # points beyond ``cutoff`` of the home bounding box halves qhull time
    # but perturbs KEPT facet solid angles by up to ~1e-2 — far points
    # shape the rim vertices of strong facets — which would break the
    # Monte-Carlo oracle's validation of the true periodic Voronoi
    # geometry. The full image shell stays (both paths).
    return np.concatenate(points, axis=0), np.concatenate(base_idx, axis=0)


def native_voronoi_enabled() -> bool:
    """Whether the native path is on: it is unless
    ``SCANN_TPU_NATIVE_VORONOI=0`` (the JAX package's switch)."""
    return os.environ.get("SCANN_TPU_NATIVE_VORONOI", "1") != "0"


def _voronoi_facets(home: np.ndarray, lattice: np.ndarray, n_home: int, cutoff: float,
                    force: str | None = None):
    """All Voronoi facets of the home atoms.

    Returns per home atom a list of (neighbor_base_index, solid_angle,
    distance) over every facet of its Voronoi cell. Takes the native C++
    cell-clipping path (``native/voronoi_cell.cc`` through
    ``data/native_voronoi.py``: exact per-atom cells, no global
    tessellation) unless ``SCANN_TPU_NATIVE_VORONOI=0``, and the
    scipy/Qhull path for a structure whose cells the clipping flags as
    degenerate. ``force`` pins a path: "scipy" skips the native one,
    "native" returns None instead of taking scipy for a degenerate
    structure. A native library that fails to build raises.

    Facet values agree between the paths to floating-point noise (both
    compute the cells of the same point cloud); the per-atom facet order
    differs (clipping emits in candidate-distance order, Qhull in ridge
    order), and ``compute_voronoi_neighbors`` sorts the records, so its
    neighbour lists are the same on both paths.
    """
    points, base_idx = _image_cloud(home, lattice, n_home, cutoff)
    if force != "scipy" and (force == "native" or native_voronoi_enabled()):
        res = native_voronoi.voronoi_facets_native(points, n_home, base_idx)
        if res is not None or force == "native":
            return res
    return _voronoi_facets_scipy(points, base_idx, n_home)


def _voronoi_facets_scipy(points: np.ndarray, base_idx: np.ndarray, n_home: int):
    """The scipy/Qhull path: one global Voronoi tessellation of the cloud,
    solid angles evaluated in vectorized batches grouped by facet vertex
    count (the scalar per-facet path was ~65% of featurization time)."""
    try:
        vor = Voronoi(points)
    except QhullError:
        vor = Voronoi(points, qhull_options="Qbb Qc Qz QJ")

    # One evaluation task per (home atom, ridge) side. The whole ridge scan
    # is vectorized: the ragged ridge_vertices list flattens once through a
    # C-speed iterator, per-ridge length/min come from cumsum/reduceat, and
    # polygons are gathered in batches grouped by vertex count. Task
    # sequence numbers preserve the original per-ridge emission order
    # (p side before q side), so the per-atom facet — and hence downstream
    # neighbor — ORDER is identical to a scalar per-ridge walk.
    rv = vor.ridge_vertices
    R = len(rv)
    if R == 0:
        return [[] for _ in range(n_home)]
    rp = vor.ridge_points
    lens = np.fromiter(map(len, rv), np.int64, R)
    total = int(lens.sum())
    flat = np.fromiter(itertools.chain.from_iterable(rv), np.int64, total)
    offsets = np.zeros(R, np.int64)
    np.cumsum(lens[:-1], out=offsets[1:])
    # per-ridge min vertex id (-1 marks an unbounded ridge: image shell too
    # thin for that pair; home-cell cells are closed by construction).
    # Zero-length rows (never observed from Qhull) cannot go through
    # reduceat: an empty trailing segment would need start == len(flat),
    # and clamping that start would silently truncate the PREVIOUS ridge's
    # segment. Run reduceat over non-empty rows only; empty rows get -1,
    # which the mins >= 0 filter rejects like the lens >= 3 filter already
    # does.
    mins = np.full(R, -1, np.int64)
    nonempty = lens > 0
    if nonempty.any():
        mins[nonempty] = np.minimum.reduceat(flat, offsets[nonempty])

    p, q = rp[:, 0], rp[:, 1]
    pside = p < n_home
    qside = q < n_home
    valid = (pside | qside) & (lens >= 3) & (mins >= 0)
    vr = np.nonzero(valid)[0]
    if len(vr) == 0:
        return [[] for _ in range(n_home)]
    vp = pside[vr]
    vq = qside[vr]
    counts = vp.astype(np.int64) + vq.astype(np.int64)
    starts = np.zeros(len(vr), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])

    # task arrays: p-side tasks first within each ridge
    ridge_t = np.concatenate([vr[vp], vr[vq]])
    center_t = np.concatenate([p[vr][vp], q[vr][vq]])
    other_t = np.concatenate([q[vr][vp], p[vr][vq]])
    seq_t = np.concatenate([starts[vp], (starts + vp)[vq]])

    n_tasks = len(ridge_t)
    sa_all = np.empty(n_tasks, np.float64)
    dist_all = np.linalg.norm(points[center_t] - points[other_t], axis=1)
    ks = lens[ridge_t]
    for k in np.unique(ks):
        m = ks == k
        vid = flat[offsets[ridge_t[m]][:, None] + np.arange(k)]
        sa_all[m] = _solid_angles_batch(points[center_t[m]],
                                        vor.vertices[vid])

    order = np.argsort(seq_t, kind="stable")
    facets = [[] for _ in range(n_home)]
    for t in order:
        sa = sa_all[t]
        if sa > 0:
            facets[center_t[t]].append(
                (int(base_idx[other_t[t]]), float(sa), float(dist_all[t])))
    return facets
