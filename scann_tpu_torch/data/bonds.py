"""Bond-graph features: ring membership and aromaticity flags.

The reference derives per-atom ``Ring``/``Aromatic`` flags with OpenBabel
(``qm9.py:134-135``). OpenBabel is not a dependency here; we derive them from
the geometric bond graph:

- bonds: pairs with distance < 1.2 x (sum of covalent radii),
- ring membership: an atom is in a ring iff it is incident to a non-bridge
  edge (exactly the atoms lying on some cycle — leaf pruning alone yields
  the 2-core, which wrongly flags pure linker chains between two rings),
- aromaticity (heuristic): membership in a 5- or 6-cycle whose atoms are all
  sp2-compatible (C/N/O/S with <= 3 bonds). This reproduces OpenBabel's flags
  for the common organic rings (benzene, pyridine, furan...) but is a
  geometric approximation, not a full Hueckel perception — documented
  divergence from the reference.
"""

from __future__ import annotations

from typing import List, Set, Tuple

import numpy as np

from scann_tpu_torch.data.atomic_data import atomic_numbers, covalent_radii

_SP2_ELEMENTS = {"C", "N", "O", "S"}


def bond_graph(species: List[str], coords: np.ndarray, tol: float = 1.2):
    """Adjacency list from covalent-radius distance criterion."""
    z = np.array([atomic_numbers[s] for s in species])
    r = covalent_radii[z]
    coords = np.asarray(coords, dtype=np.float64)
    d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    cut = tol * (r[:, None] + r[None, :])
    np.fill_diagonal(d, np.inf)
    adj = [np.nonzero(d[i] < cut[i])[0].tolist() for i in range(len(species))]
    return adj


def _bridges(adj) -> Set[frozenset]:
    """Bridge edges of the bond graph (iterative Tarjan — no recursion
    limit concerns on large graphene-sheet molecules)."""
    n = len(adj)
    disc = [-1] * n
    low = [0] * n
    bridges: Set[frozenset] = set()
    timer = 0
    for root in range(n):
        if disc[root] != -1 or not adj[root]:
            continue
        disc[root] = low[root] = timer
        timer += 1
        # stack frames: (vertex, parent, skipped_parent_once, neighbor_pos)
        stack = [[root, -1, False, 0]]
        while stack:
            frame = stack[-1]
            v, parent, skipped, pos = frame
            if pos < len(adj[v]):
                frame[3] += 1
                w = adj[v][pos]
                # skip the tree edge back to the parent exactly once (the
                # geometric bond graph has no parallel edges or self-loops)
                if w == parent and not skipped:
                    frame[2] = True
                    continue
                if disc[w] == -1:
                    disc[w] = low[w] = timer
                    timer += 1
                    stack.append([w, v, False, 0])
                else:
                    low[v] = min(low[v], disc[w])
            else:
                stack.pop()
                if stack:
                    pv = stack[-1][0]
                    low[pv] = min(low[pv], low[v])
                    if low[v] > disc[pv]:
                        bridges.add(frozenset((pv, v)))
    return bridges


def ring_atoms(adj) -> Set[int]:
    """Atoms lying on any cycle.

    A vertex is on a simple cycle iff it is incident to a non-bridge edge
    (every non-bridge edge lies on a cycle, and every cycle edge is a
    non-bridge). This matches OpenBabel's ``IsInRing`` semantics; the
    previous leaf-pruning computed the 2-core, which also kept pure linker
    chains between two rings."""
    bridges = _bridges(adj)
    out: Set[int] = set()
    for v, nbrs in enumerate(adj):
        for w in nbrs:
            if frozenset((v, w)) not in bridges:
                out.add(v)
                break
    return out


def _cycles_through(adj, alive: Set[int], max_len: int = 6):
    """All simple cycles of length 3..max_len within the ring subgraph."""
    cycles = []
    alive_adj = {i: [j for j in adj[i] if j in alive] for i in alive}

    def dfs(start, current, path, visited):
        for nxt in alive_adj[current]:
            if nxt == start and len(path) >= 3:
                if min(path) == start:  # canonical start to dedupe rotations
                    cycles.append(tuple(path))
            elif nxt not in visited and len(path) < max_len and nxt > start:
                dfs(start, nxt, path + [nxt], visited | {nxt})

    for s in sorted(alive):
        dfs(s, s, [s], {s})
    # dedupe reflections
    seen = set()
    out = []
    for c in cycles:
        key = frozenset(c)
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


def ring_aromatic_flags(species: List[str], coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-atom (ring, aromatic) 0/1 flags."""
    n = len(species)
    adj = bond_graph(species, coords)
    in_ring = ring_atoms(adj)
    ring = np.zeros(n, np.int32)
    for i in in_ring:
        ring[i] = 1

    aromatic = np.zeros(n, np.int32)
    if in_ring:
        for cyc in _cycles_through(adj, in_ring, max_len=6):
            if len(cyc) in (5, 6) and all(
                species[i] in _SP2_ELEMENTS and len(adj[i]) <= 3 for i in cyc
            ):
                for i in cyc:
                    aromatic[i] = 1
    return ring, aromatic
