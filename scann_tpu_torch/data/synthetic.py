"""Synthetic dataset generation (port of ``scann_tpu/data/synthetic.py``).

Fabricates QM9-like molecules or MP2018-like crystals with a learnable
synthetic target (a smooth function of composition and geometry), writes
them in the on-disk schema the reference builders emit (``qm9.py:139-161``)
and runs them through the Voronoi featurizer, so the whole pipeline (load
-> pack -> train -> eval) runs without a network. For the same seed it
draws the same structures as the JAX package's generator.
"""

from __future__ import annotations

import os

import numpy as np

from scann_tpu_torch.data.atomic_data import atomic_numbers
from scann_tpu_torch.data.featurize import as_object_array, featurize_record


def _random_molecule(rng, n_atoms: int, species=("H", "C", "N", "O", "F")):
    """Random molecule grown atom by atom with bond-ish distances."""
    syms = [str(rng.choice(species))]
    coords = [np.zeros(3)]
    for _ in range(n_atoms - 1):
        base = coords[rng.integers(0, len(coords))]
        for _attempt in range(50):
            direction = rng.normal(size=3)
            direction /= np.linalg.norm(direction)
            pos = base + direction * rng.uniform(1.0, 1.6)
            if all(np.linalg.norm(pos - c) > 0.9 for c in coords):
                break
        coords.append(pos)
        syms.append(str(rng.choice(species)))
    return syms, np.asarray(coords)


def _random_crystal(rng, n_atoms: int, species=("Si", "O", "Al", "Fe", "Mg")):
    """Jittered-grid placement at solid-like density (~16 A^3/atom).

    The cell volume scales with the atom count and every pair keeps a
    guaranteed minimum separation — uniform positions in a fixed-size cell
    (the previous scheme) put large synthetic crystals at unphysical
    density with near-coincident atoms, which degenerates the Voronoi
    cells that featurization is built on."""
    g = int(np.ceil(n_atoms ** (1.0 / 3.0)))
    pitch = rng.uniform(2.3, 2.7)  # ~ bond-length scale
    sites = np.stack(
        np.meshgrid(*[np.arange(g)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pick = rng.choice(len(sites), size=n_atoms, replace=False)
    coords = (sites[pick] + 0.5 + rng.uniform(-0.2, 0.2, (n_atoms, 3))) * pitch
    lattice = np.diag([g * pitch] * 3)
    syms = [str(rng.choice(species)) for _ in range(n_atoms)]
    return syms, coords, lattice


def _synthetic_target(syms, coords) -> float:
    """Smooth, learnable composition+geometry function (arbitrary units)."""
    z = np.array([atomic_numbers[s] for s in syms], dtype=np.float64)
    d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    pair = np.exp(-d / 2.0) * np.sqrt(z[:, None] * z[None, :])
    return float(0.05 * z.sum() + 0.2 * pair.sum() / len(syms))


def synthetic_records(
    name: str = "synth",
    n_structures: int = 256,
    min_atoms: int = 5,
    max_atoms: int = 20,
    periodic: bool = False,
    seed: int = 0,
    with_ring: bool = False,
    target_names=("homo", "lumo"),
) -> list:
    """The records ``make_synthetic_dataset`` writes, sorted by atom count
    (the reference's implicit length bucketing, ``qm9.py:160``), without
    featurizing them."""
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n_structures):
        n_atoms = int(rng.integers(min_atoms, max_atoms + 1))
        if periodic:
            syms, coords, lattice = _random_crystal(rng, n_atoms)
        else:
            syms, coords = _random_molecule(rng, n_atoms)
            lattice = None
        y = _synthetic_target(syms, coords)
        rec = {
            "id": f"{name}_{i:06d}",
            "Atoms": syms,
            "Atomic": np.array([atomic_numbers[s] for s in syms], dtype=np.int32),
            "Coords": coords.astype(np.float32),
            "Properties": {t: y + 0.01 * k for k, t in enumerate(target_names)},
        }
        rec["Properties"]["Ref_energy"] = 0.01  # exercised by use_ref
        if lattice is not None:
            rec["Lattice"] = lattice.astype(np.float32)
            rec["Cartesian"] = True
        if with_ring:
            rec["Features"] = {
                "Ring": rng.integers(0, 2, n_atoms).astype(np.float32),
                "Aromatic": rng.integers(0, 2, n_atoms).astype(np.float32),
            }
        records.append(rec)
    records.sort(key=lambda r: len(r["Atoms"]))
    return records


def make_synthetic_dataset(
    out_dir: str,
    name: str = "synth",
    n_structures: int = 256,
    min_atoms: int = 5,
    max_atoms: int = 20,
    periodic: bool = False,
    d_t: float = 4.0,
    w_t: float = 0.4,
    seed: int = 0,
    with_ring: bool = False,
    target_names=("homo", "lumo"),
):
    """Write ``{name}_data_energy.npy`` + ``{name}_data_neighbor_dt..wt...npy``.

    Returns the two paths.
    """
    records = synthetic_records(name, n_structures, min_atoms, max_atoms, periodic, seed,
                                with_ring, target_names)
    os.makedirs(out_dir, exist_ok=True)
    energy_path = os.path.join(out_dir, f"{name}_data_energy.npy")
    np.save(energy_path, np.asarray(records, dtype=object))

    neighbors = [featurize_record(r, d_t, w_t) for r in records]
    nbr_path = os.path.join(out_dir, f"{name}_data_neighbor_dt{d_t}_wt{w_t}.npy")
    np.save(nbr_path, as_object_array(neighbors))
    return energy_path, nbr_path
